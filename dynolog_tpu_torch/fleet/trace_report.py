"""trace-report — merge per-host capture manifests into one timeline.

After a gang trace (fleet/unitrace.py), every profiled process's trace
directory `<log_dir>/<hostname>_<pid>/` holds a `dynolog_manifest.json`
written by that host's daemon. The manifest carries the client shim's
flight-recorder spans (client/spans.py) and the capture's timing phases.
This module stitches them into ONE Chrome-trace/Perfetto JSON file —
open it in chrome://tracing or ui.perfetto.dev — with one process track
per host showing register / poll / deliver / capture spans, so fan-out
cost, config-delivery latency, and capture-start skew across the pod are
readable off a single timeline instead of reconstructed from N logs.

The native CLI twin is `dyno trace-report` (native/src/cli/Cli.cpp);
both read the same manifests and emit the same event shape.

Usage:
  python -m dynolog_tpu_torch.fleet.trace_report /tmp/dynolog_tpu_traces \
      [--out report.json]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys

from dynolog_tpu_torch.client.spans import chrome_events

MANIFEST_NAME = "dynolog_manifest.json"

# Written by the daemon's CaptureOrchestrator when a --watch action rule
# fires (native/src/autocapture/CaptureOrchestrator.cpp): the merged
# report then says WHY the capture exists, not just what it contains.
TRIGGER_NAME = "autocapture_trigger.json"

# The daemon-committed streamed upload: the torch shim exports its
# Chrome trace, streams the bytes to the daemon, which verifies, fsyncs
# and renames them into the capture dir under this name, and only then
# sends the manifest grant.
STREAMED_ARTIFACT = "streamed.pt.trace.json"

# What the torch shim exports on its own disk:
# <log_dir>/<host>_<pid>/<host>_<pid>.pt.trace.json.
EXPORTED_SUFFIX = ".pt.trace.json"

# Written by each daemon's flight-recorder export (RetroStore::exportTo)
# into `<log_dir>/retro_<host>-<pid>/` when a watch rule fires: the
# retroactive ring of pre-trigger windows that turns the merged report
# into onset + aftermath instead of aftermath alone.
RETRO_MANIFEST_NAME = "retro_manifest.json"

# trace_timing phase pairs -> synthesized span names, for manifests from
# clients that predate the span recorder (or whose span ring rolled
# over): the timeline stays complete from timing phases alone.
_TIMING_SPANS = (
    ("deliver", "config_received", "trace_start"),
    ("capture", "trace_start", "trace_stop"),
    # Streamed-stop decomposition (clients with enable_stream): the fast
    # serialize on the critical path, the chunked upload to the daemon,
    # and the background disk export it overlapped. Absent from
    # plain-stop timing records — _spans_for skips missing keys.
    ("serialize", "stop_begin", "serialized"),
    ("stream", "serialized", "stream_commit"),
    ("export", "serialized", "export_done"),
)


def collect_manifests(log_dir: str) -> list[dict]:
    """All per-process manifests under log_dir (one directory level deep,
    matching the client's `<log_dir>/<hostname>_<pid>/` layout). Each
    result carries its source dir as "_dir". Unparseable files are
    skipped — one corrupt host must not sink the pod's report."""
    manifests = []
    for path in sorted(
            glob.glob(os.path.join(log_dir, "*", MANIFEST_NAME))):
        try:
            with open(path) as f:
                m = json.load(f)
        except (OSError, ValueError):
            print(f"trace-report: skipping unreadable {path}",
                  file=sys.stderr)
            continue
        if isinstance(m, dict):
            m["_dir"] = os.path.dirname(path)
            manifests.append(m)
    return manifests


def collect_retro(log_dir: str) -> list[dict]:
    """All flight-recorder export manifests under log_dir (the
    `retro_<host>-<pid>/` dirs CaptureOrchestrator fans out via the
    exportRetro verb when a trace action fires). Each result carries its
    source dir as "_dir". Unparseable files are skipped — a corrupt ring
    export must not sink the forward capture's report."""
    manifests = []
    for path in sorted(glob.glob(
            os.path.join(log_dir, "retro_*", RETRO_MANIFEST_NAME))):
        try:
            with open(path) as f:
                m = json.load(f)
        except (OSError, ValueError):
            print(f"trace-report: skipping unreadable {path}",
                  file=sys.stderr)
            continue
        if isinstance(m, dict):
            m["_dir"] = os.path.dirname(path)
            manifests.append(m)
    return manifests


def retro_events(retro: list[dict], base_pid: int) -> list[dict]:
    """Chrome-trace events for the pre-trigger flight-recorder rings:
    one `retro:<host>` process track per exporting daemon, one "X"
    duration event per persisted window (epoch-ms bounds from the ring,
    so they land left of the trigger marker on the shared timeline), and
    a global instant marker wherever the ring has a coverage gap
    (gap_before: a window whose predecessor was evicted or lost)."""
    events: list[dict] = []
    for idx, m in enumerate(retro):
        pid = base_pid + idx
        host = m.get("host") or os.path.basename(
            m.get("_dir", "")).removeprefix("retro_") or "?"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"retro:{host}"}})
        for w in m.get("windows", []):
            if not isinstance(w, dict):
                continue
            t0, t1 = w.get("t0_ms"), w.get("t1_ms")
            if not isinstance(t0, (int, float)) or \
                    not isinstance(t1, (int, float)):
                continue
            events.append({
                "ph": "X",
                "name": f"retro window {w.get('seq', '?')}",
                "ts": round(float(t0) * 1e3, 1),   # epoch us
                "dur": round((float(t1) - float(t0)) * 1e3, 1),
                "pid": pid,
                "tid": int(w.get("pid", 0)),
                "args": {k: w[k] for k in
                         ("seq", "pid", "bytes", "file") if k in w},
            })
            if w.get("gap_before"):
                events.append({
                    "name": f"retro gap: {host}",
                    "ph": "i", "s": "g", "pid": pid, "tid": 0,
                    "ts": round(float(t0) * 1e3, 1),
                    "args": {"host": host, "seq": w.get("seq")},
                })
    return events


def read_retro_window(path: str) -> dict:
    """One exported flight-recorder window, decoded to its Chrome trace.
    The daemon names every window ``win-<seq>-….xpb`` whatever it holds
    (native/src/storage/RetroStore.cpp:windowFilename), so the content
    says what it is: gzip's magic bytes, or the ``{`` of a JSON trace.
    Raises ValueError on anything else."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if raw.lstrip()[:1] != b"{":
        raise ValueError(f"{path}: not a Chrome trace window")
    return json.loads(raw)


def read_trigger(log_dir: str) -> dict | None:
    """The autocapture trigger sidecar for this capture round, or None
    (operator-initiated captures have none). Unparseable sidecars are
    treated as absent — the report itself must still build."""
    path = os.path.join(log_dir, TRIGGER_NAME)
    try:
        with open(path) as f:
            t = json.load(f)
    except (OSError, ValueError):
        return None
    return t if isinstance(t, dict) else None


def find_artifact(manifest_dir: str) -> tuple[str, str] | None:
    """The capture dir's best Chrome-trace artifact as (path, source).
    The daemon-streamed copy wins — the daemon commits it before the
    manifest lands; otherwise the newest exported .pt.trace.json (the
    only artifact a shim with streaming off, or an old daemon,
    produces)."""
    streamed = os.path.join(manifest_dir, STREAMED_ARTIFACT)
    if os.path.isfile(streamed):
        return streamed, "streamed"
    exported = [p for p in glob.glob(
        os.path.join(manifest_dir, "**", "*" + EXPORTED_SUFFIX),
        recursive=True)
        if os.path.basename(p) != STREAMED_ARTIFACT]
    if exported:
        return max(exported, key=os.path.getmtime), "export"
    return None


def _spans_for(manifest: dict) -> list[dict]:
    spans = [s for s in manifest.get("spans", [])
             if isinstance(s, dict) and "t_start" in s]
    have = {s.get("name") for s in spans}
    timing = manifest.get("trace_timing", {})
    for name, k0, k1 in _TIMING_SPANS:
        if name not in have and k0 in timing and k1 in timing:
            t0, t1 = float(timing[k0]), float(timing[k1])
            spans.append({"name": name, "t_start": t0, "t_end": t1,
                          "dur_ms": round((t1 - t0) * 1e3, 3),
                          "from": "trace_timing"})
    return spans


def _label_for(manifest: dict) -> str:
    """Track label: the capture dir's basename when known — in the
    shim's layout that IS "<hostname>_<pid>", and it stays unique for
    mini-fleet fakes sharing one real host/pid."""
    if manifest.get("_dir"):
        return os.path.basename(manifest["_dir"])
    return (f"{manifest.get('hostname', 'host')}"
            f"_{manifest.get('pid', '?')}")


def phase_events(manifest: dict, pid: int) -> list[dict]:
    """Chrome-trace duration events for the shim's completed
    client.phase() spans (manifest "phase_spans"), on a dedicated
    `phases:<host>` track with tid = nesting depth so nested phases
    stack visually. Spans still open at manifest time (t_end None) are
    skipped — the report must not invent end times."""
    spans = [s for s in manifest.get("phase_spans", [])
             if isinstance(s, dict) and "name" in s
             and isinstance(s.get("t_start"), (int, float))
             and isinstance(s.get("t_end"), (int, float))]
    if not spans:
        return []
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": f"phases:{_label_for(manifest)}"}}]
    for s in spans:
        events.append({
            "ph": "X",
            "name": str(s["name"]),
            "ts": round(float(s["t_start"]) * 1e6, 1),
            "dur": round((float(s["t_end"]) - float(s["t_start"])) * 1e6, 1),
            "pid": pid,
            "tid": int(s.get("depth", 0)),
            "args": {},
        })
    return events


def _op_stats_of(manifest: dict) -> list[dict]:
    return [o for o in manifest.get("op_stats", [])
            if isinstance(o, dict) and "name" in o
            and isinstance(o.get("total_ms"), (int, float))]


def _total_op_ms(manifest: dict) -> float:
    return sum(float(o["total_ms"]) for o in _op_stats_of(manifest))


def select_diff_pair(manifests: list[dict], hint: str
                     ) -> tuple[dict, dict] | tuple[None, str]:
    """The (slow, healthy) manifest pair for the diff pass, or
    (None, why) when no pair exists — structured, never silent.

    `hint` names the anomalous host (a fleetstatus LINK_BOUND low side /
    edge endpoint, a straggler, or --diff-host). Manifests matching the
    hint's hostname form the slow-candidate pool; when none match (fake
    fleets share one real hostname; the hint may be host:port), every
    manifest with op stats is a candidate and the slowest wins — the
    hint narrows, total op time decides. The healthy sibling is the
    remaining manifest whose op names overlap the slow one's most
    (a diff against a host running different code is noise), tie-broken
    toward the lowest total op time — the healthiest look-alike."""
    withops = [m for m in manifests if _op_stats_of(m)]
    if len(withops) < 2:
        return None, (f"need op_stats from >= 2 hosts to diff, have "
                      f"{len(withops)} (clients opt in via "
                      "record_op_stats)")
    hint_host = hint.partition(":")[0]
    candidates = [m for m in withops
                  if hint_host and (m.get("hostname") == hint_host
                                    or _label_for(m).startswith(hint_host))]
    if not candidates:
        candidates = withops
    slow = max(candidates, key=_total_op_ms)
    siblings = [m for m in withops if m is not slow]
    slow_names = {o["name"] for o in _op_stats_of(slow)}

    def affinity(m):
        names = {o["name"] for o in _op_stats_of(m)}
        return (len(slow_names & names), -_total_op_ms(m))

    healthy = max(siblings, key=affinity)
    if not (slow_names & {o["name"] for o in _op_stats_of(healthy)}):
        return None, "no common op names between any two hosts' op_stats"
    return slow, healthy


def diff_manifests(slow: dict, healthy: dict) -> dict:
    """Aligns the anomalous host's capture against a healthy sibling's:
    per-op wall/CPU deltas for ops both ran (collective ops first — a
    slow link surfaces as collective time on every gang member — then
    by slowdown, worst first) and per-phase wall deltas from the shims'
    phase_spans. All times ms."""
    ops_s = {o["name"]: o for o in _op_stats_of(slow)}
    ops_h = {o["name"]: o for o in _op_stats_of(healthy)}
    ops = []
    for name in ops_s.keys() & ops_h.keys():
        s, h = ops_s[name], ops_h[name]
        s_ms, h_ms = float(s["total_ms"]), float(h["total_ms"])
        entry = {"name": name,
                 "collective": bool(s.get("collective")
                                    or h.get("collective")),
                 "slow_ms": round(s_ms, 3), "healthy_ms": round(h_ms, 3),
                 "delta_ms": round(s_ms - h_ms, 3),
                 # Healthy floor of 1us keeps the ratio finite (and the
                 # report strict-JSON) when the sibling barely ran the op.
                 "slowdown": round(s_ms / max(h_ms, 1e-3), 3),
                 "slow_count": int(s.get("count", 1)),
                 "healthy_count": int(h.get("count", 1))}
        if isinstance(s.get("cpu_ms"), (int, float)) and \
                isinstance(h.get("cpu_ms"), (int, float)):
            entry["cpu_delta_ms"] = round(
                float(s["cpu_ms"]) - float(h["cpu_ms"]), 3)
        ops.append(entry)
    ops.sort(key=lambda o: (not o["collective"], -o["slowdown"]))

    def phase_totals(manifest):
        totals: dict[str, float] = {}
        for s in manifest.get("phase_spans", []):
            if (isinstance(s, dict) and "name" in s
                    and isinstance(s.get("t_start"), (int, float))
                    and isinstance(s.get("t_end"), (int, float))):
                totals[str(s["name"])] = (
                    totals.get(str(s["name"]), 0.0)
                    + (float(s["t_end"]) - float(s["t_start"])) * 1e3)
        return totals

    ph_s, ph_h = phase_totals(slow), phase_totals(healthy)
    phases = [{"name": name, "slow_ms": round(ph_s[name], 3),
               "healthy_ms": round(ph_h[name], 3),
               "delta_ms": round(ph_s[name] - ph_h[name], 3)}
              for name in ph_s.keys() & ph_h.keys()]
    phases.sort(key=lambda p: -p["delta_ms"])
    return {"slow": _label_for(slow), "healthy": _label_for(healthy),
            "ops": ops,
            "slow_only": sorted(ops_s.keys() - ops_h.keys()),
            "healthy_only": sorted(ops_h.keys() - ops_s.keys()),
            "phases": phases,
            "total_delta_ms": round(
                _total_op_ms(slow) - _total_op_ms(healthy), 3)}


def diff_events(diff: dict, slow: dict, pid: int) -> list[dict]:
    """Chrome-trace events for one diff pass: a `diff:<slow>vs<healthy>`
    process track where each op both hosts ran is an "X" event whose
    DURATION is the slow host's excess time on that op (delta_ms,
    clamped at 0 — the track literally shows where the extra time
    went), laid end to end from the slow host's capture start in the
    diff's rank order (collectives first, then worst slowdown). Phase
    deltas ride tid 1 the same way. Full numbers in each event's args
    and in metadata["diff"]."""
    timing = slow.get("trace_timing", {})
    base_us = float(timing.get("trace_start", 0.0)) * 1e6
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": f"diff:{diff['slow']}"
                                f"vs{diff['healthy']}"}}]
    cursor = base_us
    for op in diff["ops"]:
        dur = max(float(op["delta_ms"]), 0.0) * 1e3  # ms -> us
        events.append({
            "ph": "X",
            "name": (f"{'[collective] ' if op['collective'] else ''}"
                     f"{op['name']} +{max(op['delta_ms'], 0.0):.1f}ms "
                     f"({op['slowdown']}x)"),
            "ts": round(cursor, 1), "dur": round(max(dur, 1.0), 1),
            "pid": pid, "tid": 0,
            "args": dict(op),
        })
        cursor += max(dur, 1.0)
    cursor = base_us
    for ph in diff["phases"]:
        dur = max(float(ph["delta_ms"]), 0.0) * 1e3
        events.append({
            "ph": "X",
            "name": f"phase {ph['name']} +{max(ph['delta_ms'], 0.0):.1f}ms",
            "ts": round(cursor, 1), "dur": round(max(dur, 1.0), 1),
            "pid": pid, "tid": 1, "args": dict(ph),
        })
        cursor += max(dur, 1.0)
    return events


def build_report(manifests: list[dict],
                 failures: list[dict] | None = None,
                 trigger: dict | None = None,
                 retro: list[dict] | None = None,
                 diff_hint: str | None = None) -> dict:
    """Merged Chrome-trace object: {"traceEvents": [...], "metadata":
    {...}}. One pid per manifest (= per host process), labeled
    `<hostname>_<pid>`; metadata summarizes delivery and capture-start
    skew across hosts — the gang-sync claim as numbers.

    `failures` (unitrace per-host records with ok=False) marks hosts
    that never delivered a capture: each becomes a metadata entry under
    "dead_hosts" plus a global instant event pinning the failure moment
    on the timeline, so a partially-degraded gang trace reads as "these
    hosts, at these points" instead of a silently smaller report.

    `trigger` (the autocapture sidecar, read_trigger) lands verbatim in
    metadata["trigger"] and as a global instant marker at the firing
    moment — the detect→diagnose loop's joint: the anomaly that caused
    the capture, pinned on the capture's own timeline.

    `retro` (flight-recorder export manifests, collect_retro) becomes
    per-host pre-trigger tracks left of that marker plus a
    metadata["retro"] summary — the merged report then shows the onset
    (the ring's retroactive windows) AND the aftermath (the forward
    capture) on one timeline.

    `diff_hint` (a host flagged anomalous — a fleetstatus LINK_BOUND
    edge endpoint, a straggler, or --diff-host) turns on the diff pass:
    the flagged host's op_stats are aligned against a healthy sibling's
    (select_diff_pair / diff_manifests) and land as a
    `diff:<slow>vs<healthy>` track plus metadata["diff"]. A hint that
    cannot be diffed (no op stats, no sibling) yields
    metadata["diff"] = {status: "unavailable", reason} — structured,
    never silent."""
    events: list[dict] = []
    starts: list[float] = []
    delivers: list[float] = []
    deliveries: dict = {}
    streamed_hosts = 0
    for idx, manifest in enumerate(manifests):
        label = _label_for(manifest)
        spans = _spans_for(manifest)
        events.extend(chrome_events(spans, pid=idx, process_name=label))
        timing = manifest.get("trace_timing", {})
        if "trace_start" in timing:
            starts.append(float(timing["trace_start"]))
        # Actuation-path accounting: which hosts got the config pushed
        # vs collected by the interval poll, and which streamed their
        # trace to the daemon at stop time.
        mode = timing.get("delivery")
        if isinstance(mode, str):
            deliveries[mode] = deliveries.get(mode, 0) + 1
        if "stream_commit" in timing:
            streamed_hosts += 1
        for s in spans:
            if s.get("name") == "deliver":
                delivers.append(float(s.get("dur_ms", 0.0)))
    # Phase tracks live past the control-plane pid block (pid = N + idx)
    # so the eventlog merge (which starts at max-pid + 1) stays clear.
    phase_hosts = 0
    for idx, manifest in enumerate(manifests):
        ev = phase_events(manifest, pid=len(manifests) + idx)
        if ev:
            phase_hosts += 1
            events.extend(ev)
    metadata: dict = {"hosts": len(manifests)}
    if phase_hosts:
        metadata["phase_hosts"] = phase_hosts
    if starts:
        # The headline gang-trace number: how far apart the hosts'
        # capture windows actually opened.
        metadata["capture_start_skew_ms"] = round(
            (max(starts) - min(starts)) * 1e3, 3)
    if delivers:
        metadata["deliver_ms_max"] = round(max(delivers), 3)
    if deliveries:
        metadata["delivery_modes"] = deliveries
    if streamed_hosts:
        metadata["streamed_hosts"] = streamed_hosts
    dead = []
    for rec in failures or []:
        if rec.get("ok"):
            continue
        entry = {"host": rec.get("host", "?")}
        for key in ("error", "attempts", "elapsed_s"):
            if key in rec:
                entry[key] = rec[key]
        dead.append(entry)
        if rec.get("t_failed_ms"):
            # Global instant (ph "i", scope "g"): a full-height marker at
            # the moment the fan-out gave up on the host.
            events.append({
                "name": f"host dead: {entry['host']}",
                "ph": "i", "s": "g", "pid": 0, "tid": 0,
                "ts": rec["t_failed_ms"] * 1000,  # epoch us
                "args": entry,
            })
    if dead:
        metadata["dead_hosts"] = dead
    # Per-process artifact inventory: which trace file each track's bytes
    # live in, and whether it arrived via the daemon stream (commit-time)
    # or the background disk export.
    artifacts = []
    for manifest in manifests:
        if not manifest.get("_dir"):
            continue
        found = find_artifact(manifest["_dir"])
        if found:
            artifacts.append({"process": _label_for(manifest),
                              "path": found[0], "source": found[1]})
    if artifacts:
        metadata["artifacts"] = artifacts
    if retro:
        # Retro tracks live past both pid blocks (control 0..N-1, phases
        # N..2N-1) so the eventlog merge (max-pid + 1) stays clear.
        events.extend(retro_events(retro, base_pid=2 * len(manifests)))
        metadata["retro"] = {
            "hosts": len(retro),
            "windows": sum(len(m.get("windows", [])) for m in retro),
            "coverage_ms": round(sum(
                float(m.get("coverage_ms", 0) or 0) for m in retro), 3),
            "gaps": sum(int(m.get("gaps", 0) or 0) for m in retro),
        }
    if trigger:
        metadata["trigger"] = trigger
        ts_ms = trigger.get("ts_ms")
        if isinstance(ts_ms, (int, float)):
            events.append({
                "name": f"autocapture trigger: {trigger.get('rule', '?')}",
                "ph": "i", "s": "g", "pid": 0, "tid": 0,
                "ts": ts_ms * 1000,  # epoch us
                "args": trigger,
            })
    if diff_hint:
        # Diff track lands past every other pid block (control 0..N-1,
        # phases N..2N-1, retro after that) so the eventlog merge
        # (max-pid + 1) stays clear of it too.
        slow, healthy_or_why = select_diff_pair(manifests, diff_hint)
        if slow is None:
            metadata["diff"] = {"status": "unavailable",
                                "hint": diff_hint,
                                "reason": healthy_or_why}
        else:
            diff = diff_manifests(slow, healthy_or_why)
            diff["status"] = "ok"
            diff["hint"] = diff_hint
            events.extend(diff_events(
                diff, slow,
                pid=2 * len(manifests) + len(retro or [])))
            metadata["diff"] = diff
    return {"traceEvents": events, "metadata": metadata}


def write_report(log_dir: str, out_path: str | None = None,
                 failures: list[dict] | None = None,
                 diff_hint: str | None = None) -> str:
    """Collect + merge + write; returns the output path. Raises
    FileNotFoundError when no manifests exist yet (the captures may
    still be flushing — callers decide whether to wait and retry).
    `failures` are unitrace per-host records for dead-host marking;
    `diff_hint` names an anomalous host to trace-diff against a healthy
    sibling (see build_report)."""
    manifests = collect_manifests(log_dir)
    if not manifests:
        raise FileNotFoundError(
            f"no {MANIFEST_NAME} under {log_dir}/*/ — captures not "
            "finished, or the daemon never received the 'tdir' grant")
    report = build_report(manifests, failures=failures,
                          trigger=read_trigger(log_dir),
                          retro=collect_retro(log_dir),
                          diff_hint=diff_hint)
    out_path = out_path or os.path.join(log_dir, "trace_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("log_dir", help="Gang-trace output dir (the unitrace "
                   "--log-dir) holding <host>_<pid>/ subdirs.")
    p.add_argument("--out", default=None,
                   help="Output path (default <log_dir>/trace_report.json)")
    p.add_argument("--diff-host", default=None,
                   help="Trace-diff this host's capture against a "
                        "healthy sibling's (per-op/per-phase deltas on "
                        "a diff: track; needs op_stats in >= 2 "
                        "manifests). unitrace --report derives this "
                        "automatically from its health check's "
                        "LINK_BOUND/straggler verdict.")
    args = p.parse_args(argv)
    manifests = collect_manifests(args.log_dir)
    if not manifests:
        print(f"trace-report: no {MANIFEST_NAME} under {args.log_dir}/*/ "
              "— captures not finished, or the daemon never received the "
              "'tdir' grant", file=sys.stderr)
        return 1
    report = build_report(manifests, trigger=read_trigger(args.log_dir),
                          retro=collect_retro(args.log_dir),
                          diff_hint=args.diff_host)
    out = args.out or os.path.join(args.log_dir, "trace_report.json")
    with open(out, "w") as f:
        json.dump(report, f)
    md = report["metadata"]
    print(f"merged {md['hosts']} host manifest(s) -> {out}")
    if "retro" in md:
        r = md["retro"]
        print(f"flight recorder: {r['windows']} pre-trigger window(s) "
              f"from {r['hosts']} host(s), {r['coverage_ms']} ms "
              f"coverage, {r['gaps']} gap(s)")
    if "trigger" in md:
        t = md["trigger"]
        print(f"auto-captured: rule {t.get('rule', '?')} fired on "
              f"{t.get('host', '?')} ({t.get('metric', '?')}="
              f"{t.get('value', '?')})")
    if "diff" in md:
        d = md["diff"]
        if d.get("status") == "ok":
            worst = d["ops"][0] if d.get("ops") else None
            print(f"trace diff: {d['slow']} vs {d['healthy']}"
                  + (f"; worst op {worst['name']} "
                     f"+{worst['delta_ms']}ms ({worst['slowdown']}x)"
                     if worst else ""))
        else:
            print(f"trace diff unavailable: {d.get('reason', '?')}",
                  file=sys.stderr)
    if "capture_start_skew_ms" in md:
        print(f"capture start skew: {md['capture_start_skew_ms']} ms")
    if "deliver_ms_max" in md:
        print(f"slowest config delivery: {md['deliver_ms_max']} ms")
    print("open in chrome://tracing or ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
