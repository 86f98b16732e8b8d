"""unitrace — synchronized on-demand torch.profiler capture across hosts.

The port's copy of ``dynolog_tpu/fleet/unitrace.py`` (reference:
scripts/pytorch/unitrace.py): discover the job's hosts, pick one
absolute start timestamp far enough in the future that every daemon
receives its config first, then fire the trace RPC at every host in
parallel. Each host's daemon hands the config to its registered PyTorch
processes, which write Chrome traces (.pt.trace.json) locally and
stream a copy to their daemon (SURVEY.md §3.3); `--report` pulls those
copies back over RPC where no shared filesystem shows them. The
config's "type" stays "xplane": the daemon, `dyno` and both client
shims take that string for an on-demand capture.

Host discovery modes:
  --hosts h1,h2            explicit (host or host:port)
  --hostfile FILE          one host per line
  --slurm-job-id ID        scontrol show hostnames (reference's mode)
  --tpu-name NAME          GCE TPU pod: gcloud compute tpus tpu-vm
                           describe --format networkEndpoints (needs
                           gcloud; TPU VMs reach each other over DCN)

Usage:
  python -m dynolog_tpu_torch.fleet.unitrace --hosts h1,h2 \
      --job-id 42 --log-dir /tmp/traces --duration-ms 2000
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import subprocess
import sys
import time

from dynolog_tpu_torch.utils.rpc import (
    DEFAULT_PORT, AsyncDynoClient, RetryPolicy, fan_out)


def hosts_from_slurm(job_id: str) -> list[str]:
    """squeue resolves the job's nodelist; scontrol expands the compact
    h[1-4] form (reference flow: scripts/pytorch/unitrace.py). Failures
    raise RuntimeError carrying the scheduler's stderr."""
    out = subprocess.run(
        ["squeue", "-j", job_id, "-h", "-o", "%N"],
        capture_output=True, text=True)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(
            f"slurm host discovery failed for job {job_id}: {out.stderr}")
    expand = subprocess.run(
        ["scontrol", "show", "hostnames", out.stdout.strip()],
        capture_output=True, text=True)
    if expand.returncode != 0:
        raise RuntimeError(
            f"scontrol hostname expansion failed: {expand.stderr}")
    return [h for h in expand.stdout.split() if h]


def hosts_from_gcloud(tpu_name: str, zone: str | None) -> list[str]:
    cmd = ["gcloud", "compute", "tpus", "tpu-vm", "describe", tpu_name,
           "--format", "json"]
    if zone:
        cmd += ["--zone", zone]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"gcloud discovery failed: {out.stderr}")
    desc = json.loads(out.stdout)
    return [ep["ipAddress"] for ep in desc.get("networkEndpoints", [])]


def resolve_hosts(args) -> list[str]:
    if args.hosts:
        return [h for h in args.hosts.split(",") if h]
    if args.hostfile:
        with open(args.hostfile) as f:
            return [line.strip() for line in f if line.strip()]
    if args.slurm_job_id:
        return hosts_from_slurm(args.slurm_job_id)
    if args.tpu_name:
        return hosts_from_gcloud(args.tpu_name, args.zone)
    if getattr(args, "root", ""):
        # Tree mode discovers the hosts from the gang-trace response
        # itself; an explicit list is only the flat-fallback safety net.
        return []
    raise SystemExit(
        "no hosts: pass --hosts, --hostfile, --slurm-job-id, "
        "--tpu-name, or --root")


def build_config(args, start_time_ms: int | None) -> str:
    config = {
        "type": "xplane",
        "log_dir": args.log_dir,
        "duration_ms": args.duration_ms,
        "host_tracer_level": args.host_tracer_level,
        "python_tracer": bool(args.python_tracer),
    }
    if args.iterations > 0:
        config["iterations"] = args.iterations
        config["iteration_roundup"] = args.iteration_roundup
    if start_time_ms:
        config["start_time_ms"] = start_time_ms
    return json.dumps(config)


def _addr(host: str) -> tuple[str, int]:
    name, _, port = host.partition(":")
    return name, int(port) if port else DEFAULT_PORT


def trigger_hosts(hosts: list[str], args, config: str) -> list[dict]:
    """The trigger RPC to every host as one fan_out wave (shared async
    event loop, no thread pool), with bounded per-host retries
    (transient refusals during a daemon restart window are the common
    case a pod fan-out hits). Every outcome — success or final failure —
    is a per-host record carrying the attempt count and elapsed time, so
    the merged run output can say not just WHICH hosts died but how hard
    the fan-out tried before giving up."""
    request = {"fn": "setOnDemandTraceRequest", "config": config,
               "job_id": str(args.job_id), "pids": [],
               "process_limit": args.process_limit}
    recs = fan_out(
        [(*_addr(h), request) for h in hosts],
        timeout=args.rpc_timeout_s,
        retry=RetryPolicy(
            attempts=max(1, args.rpc_retries),
            backoff_s=args.rpc_retry_backoff_s,
            deadline_s=args.rpc_deadline_s),
        parallelism=args.parallelism)
    results = []
    for host, rec in zip(hosts, recs):
        if rec["ok"]:
            resp = rec["response"]
            resp["host"] = host
            resp["ok"] = len(
                resp.get("activityProfilersTriggered", [])) > 0
            resp["attempts"] = rec["attempts"]
            resp["elapsed_s"] = rec["elapsed_s"]
            results.append(resp)
        else:  # one bad host must not abort the pod fan-out
            results.append(
                {"host": host, "ok": False, "error": rec["error"],
                 "attempts": rec["attempts"],
                 "elapsed_s": rec["elapsed_s"],
                 # When the host went dark, for the merged report's
                 # dead-host markers (epoch ms like every trace
                 # timestamp).
                 "t_failed_ms": int(time.time() * 1000)})
    return results


def resolve_tree_root(addr: str, timeout_s: float = 10.0,
                      max_hops: int = 8) -> tuple[str | None, str]:
    """Follows fleet-tree `root` hints from any tree member to the
    CURRENT root (bounded hops, cycle-guarded) — `--root <seed>` keeps
    working after the original root died and a surviving seed promoted
    itself. Returns (root_addr, "") or (None, why)."""
    visited = set()
    for _ in range(max_hops):
        visited.add(addr)
        name, port = _addr(addr)
        client = AsyncDynoClient(host=name, port=port, timeout=timeout_s)
        try:
            ft = client.status().get("fleettree") or {}
        except Exception as exc:
            return None, f"{addr} unreachable ({exc})"
        node, hint = ft.get("node"), ft.get("root")
        if not hint or not node or hint == node:
            return addr, ""
        if hint in visited:
            return None, f"root hint cycle at {hint}"
        addr = hint
    return None, f"root hint chain exceeded {max_hops} hops"


def trigger_tree(root: str, args, config: str) -> tuple[list | None, str]:
    """Gang trigger through the relay tree: resolve the current root
    (so a re-ask after a promotion can't double-arm a subtree), then ONE
    fleetTrace RPC — the root applies the config locally and every node
    forwards down its fresh edges in parallel, O(depth) delivery instead
    of N flat RPCs (and correspondingly less --start-time-delay-s
    headroom burned before the synchronized start). Returns
    (per-host records shaped like trigger_hosts() output, "") or
    (None, why) for the flat fallback."""
    addr, reason = resolve_tree_root(root, timeout_s=args.rpc_timeout_s)
    if addr is None:
        return None, reason
    name, port = _addr(addr)
    client = AsyncDynoClient(host=name, port=port,
                             timeout=max(args.rpc_timeout_s, 30.0))
    t0 = time.time()
    try:
        resp = client.fleet_trace(config, str(args.job_id),
                                  process_limit=args.process_limit)
    except Exception as exc:
        return None, f"fleetTrace via {addr} failed ({exc})"
    if resp.get("status") != "ok":
        return None, f"{addr}: {resp.get('error', 'unknown error')}"
    elapsed = time.time() - t0
    results = []
    for rec in resp.get("hosts", []):
        rec.setdefault("host", "?")
        rec.setdefault("ok", False)
        rec.setdefault("attempts", 1)
        rec.setdefault("elapsed_s", round(elapsed, 3))
        if not rec["ok"] and "error" not in rec:
            rec["error"] = "no processes"
        results.append(rec)
    return results, ""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hosts", default="")
    p.add_argument("--hostfile", default="")
    p.add_argument("--slurm-job-id", default="")
    p.add_argument("--tpu-name", default="")
    p.add_argument("--zone", default=None)
    p.add_argument("--job-id", default="0",
                   help="Trace-registry job id the PyTorch processes used.")
    p.add_argument("--log-dir", default="/tmp/dynolog_tpu_traces")
    p.add_argument("--duration-ms", type=int, default=2000)
    p.add_argument("--iterations", type=int, default=0)
    p.add_argument("--iteration-roundup", type=int, default=10)
    p.add_argument("--host-tracer-level", type=int, default=2)
    p.add_argument("--python-tracer", action="store_true")
    p.add_argument("--process-limit", type=int, default=3)
    p.add_argument("--rpc-timeout-s", type=float, default=10.0)
    p.add_argument(
        "--rpc-retries", type=int, default=3,
        help="Total RPC attempts per host including the first (1 = no "
             "retry). Retries use jittered exponential backoff.")
    p.add_argument(
        "--rpc-retry-backoff-s", type=float, default=0.25,
        help="Base backoff before the first retry; doubles per retry, "
             "jittered +-50%%.")
    p.add_argument(
        "--rpc-deadline-s", type=float, default=None,
        help="Total per-host budget across attempts and backoff sleeps "
             "(default: bounded by retries x timeout).")
    p.add_argument(
        "--start-time-delay-s", type=int, default=10,
        help="Synchronized start: every host begins capture at now+delay "
             "(covers RPC fan-out + poll latency; reference default 10s). "
             "0 disables synchronization.")
    p.add_argument("--parallelism", type=int, default=64)
    p.add_argument(
        "--report", action="store_true",
        help="After the captures finish, merge the per-host "
             "dynolog_manifest.json files under --log-dir into one "
             "Chrome-trace timeline (<log-dir>/trace_report.json). Only "
             "meaningful where the capture dirs are reachable from this "
             "host (shared filesystem, or a single-host/mini fleet).")
    p.add_argument(
        "--report-wait-s", type=float, default=30.0,
        help="Extra time past the capture window to wait for manifests "
             "before merging the report.")
    p.add_argument(
        "--diff-host", default=None,
        help="Force the merged report's trace-diff pass to anchor on "
             "this host (default: derived from the --health-check "
             "verdict — worst LINK_BOUND edge low side, else worst "
             "straggler).")
    p.add_argument(
        "--health-check", action="store_true",
        help="Before triggering, sweep the fleet's windowed aggregates "
             "(fleet/fleetstatus.py) and print any straggler hosts — a "
             "trace of a sick pod mostly measures the sickness. "
             "Advisory: the capture proceeds either way; the verdict "
             "rides along in the run output under 'health'.")
    p.add_argument("--health-window-s", type=int, default=300,
                   help="Aggregation window the health check scores.")
    p.add_argument("--health-z-threshold", type=float, default=3.5)
    p.add_argument(
        "--health-root", default="",
        help="Relay-tree root (host or host:port) for --health-check: "
             "one getFleetStatus RPC covers the subtree (O(depth)); "
             "falls back to the flat per-host sweep when unusable. "
             "Defaults to --root when that is set.")
    p.add_argument(
        "--root", default="",
        help="Gang-trace through the relay tree: one fleetTrace RPC to "
             "this tree member (any seed works — root hints are "
             "followed through promotions) arms the whole fleet "
             "root-down, and committed streamed artifacts pull back "
             "leaf-up through the same edges. No host list needed; "
             "--hosts, when also given, is the flat-fallback safety "
             "net.")
    return p


def run(args, hosts=None) -> dict:
    """Programmatic entry: fans the trace RPC out and returns
    {results, start_time_ms, ok} — tests and wrappers use this to check
    the synchronized window against the exact broadcast timestamp."""
    if hosts is None:
        hosts = resolve_hosts(args)
    health = None
    if getattr(args, "health_check", False):
        from dynolog_tpu_torch.fleet import fleetstatus

        root = (getattr(args, "health_root", "")
                or getattr(args, "root", ""))
        if root:
            # Tree-first: one RPC to the relay root covers the whole
            # subtree; any failure falls through to the flat sweep.
            health = fleetstatus.tree_sweep(
                root, window_s=args.health_window_s,
                z_threshold=args.health_z_threshold,
                timeout_s=args.rpc_timeout_s)
        if health is None:
            health = fleetstatus.sweep(
                hosts, window_s=args.health_window_s,
                z_threshold=args.health_z_threshold,
                timeout_s=args.rpc_timeout_s,
                retries=max(1, args.rpc_retries))
        print(fleetstatus.render(health))
        if health["outliers"] or health.get("link_bound"):
            print("health check: proceeding anyway — the trace will "
                  "include the flagged host(s)/link(s) above",
                  file=sys.stderr)
    start_time_ms = (
        int(time.time() * 1000) + args.start_time_delay_s * 1000
        if args.start_time_delay_s > 0 and args.iterations == 0 else None)
    config = build_config(args, start_time_ms)

    sync = (f", synchronized start at start_time_ms={start_time_ms} "
            f"(now+{args.start_time_delay_s}s)" if start_time_ms else "")
    results = None
    if getattr(args, "root", ""):
        print(f"gang-triggering through relay tree via {args.root}, "
              f"job_id={args.job_id}{sync}")
        results, reason = trigger_tree(args.root, args, config)
        if results is None:
            if not hosts:
                print(f"tree gang-trace via {args.root} failed "
                      f"({reason}) and no flat host list to fall back "
                      "to", file=sys.stderr)
                return {"results": [], "start_time_ms": start_time_ms,
                        "ok": 0, "hosts": [], "failed_hosts": [],
                        "error": reason}
            print(f"tree gang-trace via {args.root} unusable: {reason}; "
                  "falling back to flat fan-out", file=sys.stderr)
        else:
            hosts = [r["host"] for r in results]
    if results is None:
        print(f"triggering {len(hosts)} host(s), job_id={args.job_id}"
              + sync)
        results = trigger_hosts(hosts, args, config)

    # Per-host capture manifest: which pids will write traces, and where
    # (clients write to <log_dir>/<hostname>_<pid>/ on their own host —
    # the daemon never moves trace bytes, reference design SURVEY.md §3.3).
    ok = sum(1 for r in results if r["ok"])
    print("capture manifest:")
    for r in results:
        status = "ok" if r["ok"] else f"FAILED ({r.get('error', 'no processes')})"
        if r.get("attempts", 1) > 1:
            status += f" after {r['attempts']} attempts"
        pids = r.get("activityProfilersTriggered", [])
        pid_list = " ".join(str(p) for p in pids) or "-"
        dirs = " ".join(
            f"{args.log_dir}/<host>_{pid}/" for pid in pids) or "-"
        print(f"  {r['host']}: {status}, {len(pids)} process(es) "
              f"[{pid_list}] -> {dirs}")
    print(f"{ok}/{len(hosts)} hosts triggered; traces will appear under "
          f"{args.log_dir} on each host")
    out = {"results": results, "start_time_ms": start_time_ms,
           "ok": ok, "hosts": hosts,
           "failed_hosts": [r["host"] for r in results if not r["ok"]]}
    if health is not None:
        out["health"] = health
    if getattr(args, "report", False):
        out["report_path"] = _merged_report(args, results, start_time_ms,
                                            health=health)
    return out


def diff_hint_from_health(health: dict | None) -> str | None:
    """The anomalous host a trace diff should anchor on, straight from
    the pre-capture health verdict: the worst LINK_BOUND edge's low
    side (asymmetric) or first endpoint (low_bandwidth) wins — a slow
    link is what the diff's collective-op ranking localizes — else the
    worst straggler, else the worst host-bound host, else None (healthy
    fleet: no diff pass)."""
    if not health:
        return None
    for lb in health.get("link_bound", []):
        host = lb.get("low_side") or (lb.get("hosts") or [None])[0]
        if host:
            return host
    for o in health.get("outliers", []):
        if o.get("host"):
            return o["host"]
    for hb in health.get("host_bound_hosts", []):
        if hb.get("host"):
            return hb["host"]
    return None


def pull_artifacts(hosts: list[str], log_dir: str,
                   timeout_s: float = 10.0) -> int:
    """Downloads committed streamed artifacts (streamed.pt.trace.json)
    from each host's daemon over RPC (listTraceArtifacts + chunked
    getTraceArtifact) into `<log_dir>/<capture-dir>/<daemon-side name>`
    — the report no longer depends on a shared filesystem making the
    daemon-side files visible to a glob.
    Artifacts already present locally (shared FS, or a prior pull) are
    skipped. Returns the number of files written; pull failures warn and
    move on (the report degrades to whatever is visible locally)."""
    pulled = 0
    for host in hosts:
        name, port = _addr(host)
        client = AsyncDynoClient(host=name, port=port, timeout=timeout_s)
        try:
            arts = client.list_trace_artifacts().get("artifacts", [])
        except Exception:
            continue  # old daemon or dead host: nothing to pull
        for a in arts:
            path = a.get("path", "")
            if not path:
                continue
            # The daemon-side parent dir name IS the capture dir name
            # (<hostname>_<pid>), so the local mirror lands where
            # trace_report.find_artifact looks.
            local_dir = os.path.join(
                log_dir, os.path.basename(os.path.dirname(path)))
            # The daemon lists every committed stream whatever its name;
            # the file keeps it, so a JSON trace never lands under
            # another format's name.
            dest = os.path.join(local_dir, os.path.basename(path))
            if os.path.isfile(dest):
                continue
            try:
                buf = bytearray()
                offset = 0
                while True:
                    chunk = client.get_trace_artifact(path, offset=offset)
                    if "error" in chunk:
                        raise RuntimeError(chunk["error"])
                    data = base64.b64decode(chunk.get("data", ""))
                    buf += data
                    offset += len(data)
                    if chunk.get("eof") or not data:
                        break
                os.makedirs(local_dir, exist_ok=True)
                tmp = dest + ".pulling"
                with open(tmp, "wb") as f:
                    f.write(buf)
                os.replace(tmp, dest)  # atomic like the daemon's commit
                pulled += 1
            except Exception as e:
                print(f"artifact pull failed for {host} {path}: {e}",
                      file=sys.stderr)
    return pulled


def pull_artifacts_tree(root: str, log_dir: str,
                        timeout_s: float = 10.0) -> int:
    """Tree twin of pull_artifacts: ONE listFleetArtifacts to a tree
    member enumerates every committed artifact below it (node-tagged),
    and each chunk fetch proxies leaf→up through the tree edges — the
    puller never dials a leaf. Returns files written; failures warn and
    move on like the flat pull."""
    name, port = _addr(root)
    client = AsyncDynoClient(host=name, port=port, timeout=timeout_s)
    try:
        listing = client.list_fleet_artifacts()
    except Exception:
        return 0
    if listing.get("status") != "ok":
        return 0
    pulled = 0
    for a in listing.get("artifacts", []):
        path, node = a.get("path", ""), a.get("node", "")
        if not path or not node:
            continue
        local_dir = os.path.join(
            log_dir, os.path.basename(os.path.dirname(path)))
        dest = os.path.join(local_dir, os.path.basename(path))
        if os.path.isfile(dest):
            continue
        try:
            buf = bytearray()
            offset = 0
            while True:
                chunk = client.get_fleet_artifact(node, path,
                                                  offset=offset)
                if "error" in chunk:
                    raise RuntimeError(chunk["error"])
                data = base64.b64decode(chunk.get("data", ""))
                buf += data
                offset += len(data)
                if chunk.get("eof") or not data:
                    break
            os.makedirs(local_dir, exist_ok=True)
            tmp = dest + ".pulling"
            with open(tmp, "wb") as f:
                f.write(buf)
            os.replace(tmp, dest)
            pulled += 1
        except Exception as e:
            print(f"tree artifact pull failed for {node} {path}: {e}",
                  file=sys.stderr)
    return pulled


def _merged_report(args, results, start_time_ms, health=None) -> str | None:
    """Waits out the capture window, then merges the per-host span
    manifests into one Chrome-trace timeline (fleet/trace_report.py).
    Returns the report path, or None when too few manifests appeared
    (remote hosts without a shared filesystem land here — run
    trace_report on a host that can see the capture dirs instead).

    Artifact wait: once every manifest has either the daemon-committed
    `streamed.pt.trace.json` or an exported .pt.trace.json beside it,
    the report builds immediately (the torch shim sends its manifest
    after both are on disk); a manifest without either triggers an RPC
    pull of the committed streams, then rides the deadline."""
    from dynolog_tpu_torch.fleet import trace_report

    expected = sum(
        len(r.get("activityProfilersTriggered", [])) for r in results)
    if expected == 0:
        return None
    # Manifests land after each capture closes: start delay + window +
    # poll/flush slack, bounded by --report-wait-s.
    delay_s = (max(0.0, start_time_ms / 1000.0 - time.time())
               if start_time_ms else 0.0)
    deadline = (time.time() + delay_s + args.duration_ms / 1000.0
                + args.report_wait_s)
    triggered = [r["host"] for r in results if r.get("ok")]
    while time.time() < deadline:
        manifests = trace_report.collect_manifests(args.log_dir)
        if len(manifests) >= expected:
            if all(trace_report.find_artifact(m["_dir"])
                   for m in manifests):
                break
            # Missing artifacts: pull committed streamed uploads from
            # the daemons over RPC instead of waiting on a shared-FS
            # glob — the pulled copies satisfy find_artifact directly.
            # Tree runs pull through the tree (one listing, proxied
            # chunk fetches); flat runs dial each triggered host.
            root = getattr(args, "root", "")
            pulled = (
                pull_artifacts_tree(root, args.log_dir,
                                    timeout_s=args.rpc_timeout_s)
                if root else
                pull_artifacts(triggered, args.log_dir,
                               timeout_s=args.rpc_timeout_s))
            if pulled:
                continue
        time.sleep(0.2)
    # Hosts the fan-out gave up on become dead-host markers in the
    # merged timeline — a degraded gang trace still yields a report that
    # says exactly which hosts are missing and when they went dark.
    failures = [r for r in results if not r.get("ok")]
    # A health verdict that flagged a LINK_BOUND edge or straggler arms
    # the diff pass: the merged report aligns that host's capture
    # against a healthy sibling's with zero extra per-host RPCs.
    diff_hint = (getattr(args, "diff_host", None)
                 or diff_hint_from_health(health))
    if diff_hint:
        print(f"trace diff: anchoring on flagged host {diff_hint}")
    try:
        path = trace_report.write_report(args.log_dir, failures=failures,
                                         diff_hint=diff_hint)
    except FileNotFoundError as e:
        print(f"trace report skipped: {e}", file=sys.stderr)
        return None
    n = len(trace_report.collect_manifests(args.log_dir))
    print(f"merged trace-delivery timeline ({n}/{expected} process "
          f"manifest(s)) -> {path}")
    with open(path) as f:
        md = json.load(f).get("metadata", {})
    arts = md.get("artifacts", [])
    if arts:
        streamed = sum(1 for a in arts if a.get("source") == "streamed")
        print(f"artifacts: {streamed} streamed (pulled at stop-commit), "
              f"{len(arts) - streamed} via disk export")
    if "trigger" in md:
        t = md["trigger"]
        print(f"auto-capture trigger: rule {t.get('rule', '?')} on "
              f"{t.get('host', '?')} ({t.get('metric', '?')}="
              f"{t.get('value', '?')})")
    return path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Discovery failures (scheduler errors, squeue/gcloud not installed)
    # are operator errors, not tracebacks. Narrow scope: an OSError from
    # the fan-out phase must not masquerade as a discovery failure.
    try:
        hosts = resolve_hosts(args)
    except (RuntimeError, OSError) as e:
        print(f"host discovery failed: {e}", file=sys.stderr)
        return 2
    out = run(args, hosts=hosts)
    if out.get("error"):
        return 2
    return 0 if out["ok"] == len(out["hosts"]) else 1


if __name__ == "__main__":
    sys.exit(main())
