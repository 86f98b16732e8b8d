"""eventlog — drain fleet journals into one merged event timeline.

Every daemon keeps a bounded, seq-numbered journal of what HAPPENED —
collector lifecycle, client registrations, trace-config handoffs,
watch-rule crossings (native/src/events/EventJournal.h). This module
drains those journals across hosts and merges the events into the
gang-trace timeline as Chrome-trace instant markers (ph "i"), one
track per host — so "host 3's HBM watch fired 40 s before the
straggler verdict" is readable off the same trace_report.json screen
as the capture spans, in chrome://tracing or ui.perfetto.dev.

Two drain paths (docs/Subscriptions.md):
 - With --root, ONE fleet-scoped `subscribe` at that tree member
   replays every subtree journal through in-tree relay feeds — one
   connection total instead of a getEvents polling wave per host.
   Hosts the stream never catches up (and old roots that answer
   subscribe with "unknown fn") fall back to the polling sweep.
 - With --hosts (or --poll), the classic fan-out getEvents cursor
   sweep, one drain loop per host.

Usage:
  python -m dynolog_tpu_torch.fleet.eventlog --hosts h1[:port],h2,... \
      [--log-dir /tmp/dynolog_tpu_traces] [--out report.json] \
      [--since-seq N]

With --log-dir, events merge into that directory's existing
trace_report.json (written by fleet/trace_report.py or `dyno
trace-report`); without one, a fresh events-only report is written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from dynolog_tpu_torch.utils.rpc import (
    DEFAULT_PORT, DynoClient, RetryPolicy, SubscribeUnsupported, fan_out)


def _parse_host(spec: str, default_port: int) -> tuple[str, int]:
    host, sep, port = spec.rpartition(":")
    if sep and port.isdigit():
        return host, int(port)
    return spec, default_port


def fetch_all_events(client: DynoClient, since_seq: int = 0,
                     limit: int = 256, max_batches: int = 64) -> dict:
    """Drains one daemon's journal from since_seq: follows next_seq
    cursors until an empty batch (bounded by max_batches so a daemon
    emitting faster than we read cannot pin the sweep). Returns
    {"events": [...], "dropped": N, "next_seq": cursor} — `dropped`
    totals the ring-wrap gaps the daemon reported, so the caller knows
    the record is incomplete rather than silently shorter."""
    events: list[dict] = []
    dropped = 0
    cursor = since_seq
    for _ in range(max_batches):
        resp = client.get_events(since_seq=cursor, limit=limit)
        dropped += int(resp.get("dropped", 0))
        batch = resp.get("events", [])
        events.extend(batch)
        cursor = int(resp.get("next_seq", cursor))
        if not batch:
            break
    return {"events": events, "dropped": dropped, "next_seq": cursor}


def sweep(hosts: list[str], port: int = DEFAULT_PORT,
          timeout: float = 5.0, retry: RetryPolicy | None = None,
          since_seq: int = 0, limit: int = 256,
          max_batches: int = 64, max_failed_waves: int = 2) -> list[dict]:
    """Concurrent journal drain across hosts: waves of getEvents on the
    shared fan_out event loop (no thread pool), each wave advancing
    every still-draining host's cursor until its batch comes back empty
    (bounded by max_batches, like fetch_all_events). One record per
    host: ok=True carries events/dropped/next_seq; ok=False carries the
    error and the failure moment (t_failed_ms) so the merge can mark
    the dead host on the timeline, mirroring unitrace's fan-out
    records — plus whatever events the partial drain DID collect.

    A host that dies mid-sweep keeps its cursor and partial events and
    gets max_failed_waves whole retry waves to come back (a daemon
    restart under a supervisor lands well inside that). When it does,
    the response's instance_epoch/storage pair decides the resume: a
    new epoch with a durable tier (`storage` true) resumes from the
    SAME cursor — the durable tier replays the gap, no re-read — while
    a new epoch without one rewinds to seq 0 (the new instance's ring
    restarted there; the old cursor points past its live edge and would
    silently skip everything). Batches are deduped per (epoch, seq) so
    the rewind cannot double-count, which is what used to duplicate
    Chrome-trace instant markers after a mid-sweep restart."""
    retry = retry or RetryPolicy(attempts=3, backoff_s=0.2,
                                 deadline_s=timeout * 3)
    state: dict[str, dict] = {
        spec: {"host": spec, "ok": True, "attempts": 0,
               "events": [], "dropped": 0, "next_seq": since_seq,
               "_epoch": 0, "_failed_waves": 0, "_seen": set()}
        for spec in hosts}
    active = list(hosts)
    for _ in range(max_batches):
        if not active:
            break
        calls = []
        for spec in active:
            host, p = _parse_host(spec, port)
            calls.append((host, p, {
                "fn": "getEvents",
                "since_seq": state[spec]["next_seq"], "limit": limit}))
        recs = fan_out(calls, timeout=timeout, retry=retry)
        still = []
        for spec, rec in zip(active, recs):
            st = state[spec]
            st["attempts"] = max(st["attempts"], rec["attempts"])
            if not rec["ok"]:
                st["_failed_waves"] += 1
                if st["_failed_waves"] <= max_failed_waves:
                    still.append(spec)  # cursor + partial events intact
                    continue
                st["ok"] = False
                st["error"] = rec["error"]
                st["t_failed_ms"] = time.time() * 1e3
                continue
            st["_failed_waves"] = 0
            resp = rec["response"]
            epoch = int(resp.get("instance_epoch", 0))
            if st["_epoch"] and epoch and epoch != st["_epoch"] \
                    and not resp.get("storage", False):
                st["_epoch"] = epoch
                st["next_seq"] = 0
                still.append(spec)  # rewind into the new instance
                continue
            st["_epoch"] = epoch or st["_epoch"]
            st["dropped"] += int(resp.get("dropped", 0))
            batch = resp.get("events", [])
            for e in batch:
                key = (epoch, e.get("seq"))
                if key in st["_seen"]:
                    continue
                st["_seen"].add(key)
                st["events"].append(e)
            st["next_seq"] = int(resp.get("next_seq", st["next_seq"]))
            if batch:
                still.append(spec)
        active = still
    records = [state[spec] for spec in hosts]
    for st in records:  # drop the drain-internal bookkeeping keys
        for k in ("_epoch", "_failed_waves", "_seen"):
            st.pop(k, None)
    return records


def sweep_subscribe(root: str, port: int = DEFAULT_PORT,
                    timeout: float = 5.0, since_seq: int = 0,
                    expected: list[str] | None = None,
                    max_wait_s: float = 30.0,
                    idle_grace_s: float = 2.0) -> list[dict]:
    """Drains the whole subtree through ONE fleet-scoped subscription
    at `root` (a relay-tree member): the daemon replays each node's
    journal from since_seq through its in-tree relay feeds and this
    client just collects delta/gap frames — steady-state RPC cost is
    the one registration, not a polling wave per host.

    Termination: every node in `expected` (tree node ids, host:port)
    has pushed caught_up, or — with no expectation list — the stream
    has gone idle for idle_grace_s after at least one caught_up.
    max_wait_s bounds the whole drain. Returns sweep()-shaped records:
    one per node heard from, plus a not-ok record for every expected
    node that never caught up (the caller's cue to poll it directly).
    Raises SubscribeUnsupported against a pre-subscription root."""
    host, p = _parse_host(root, port)
    client = DynoClient(host=host, port=p, timeout=timeout,
                        client_id="eventlog")
    sub = client.subscribe(events=True, scope="fleet",
                           since_seq=since_seq)
    per: dict[str, dict] = {}
    deadline = time.monotonic() + max_wait_s
    try:
        while time.monotonic() < deadline:
            try:
                frame = sub.recv(timeout=idle_grace_s)
            except (TimeoutError, OSError):
                if expected is None and sub.caught_up:
                    break  # idle past the grace with the edge reached
                continue
            node = str(frame.get("node", ""))
            push = frame.get("push")
            if push in ("delta", "gap"):
                st = per.setdefault(
                    node, {"host": node, "ok": True, "attempts": 1,
                           "events": [], "dropped": 0, "next_seq": 0})
                if push == "delta":
                    st["events"].extend(frame.get("events", []))
                else:
                    st["dropped"] += int(frame.get("dropped", 0))
                st["next_seq"] = sub.cursors.get(node, st["next_seq"])
            if expected is not None and set(expected) <= sub.caught_up:
                break
    finally:
        sub.close()
    for node in sub.caught_up:
        st = per.setdefault(
            node, {"host": node, "ok": True, "attempts": 1,
                   "events": [], "dropped": 0, "next_seq": 0})
        st["next_seq"] = sub.cursors.get(node, st["next_seq"])
    for node in expected or []:
        if node not in sub.caught_up:
            per[node] = {"host": node, "ok": False,
                         "error": "never caught up over subscription",
                         "attempts": 1, "t_failed_ms": time.time() * 1e3}
    order = list(expected or [])
    order += [n for n in sorted(per) if n not in order]
    return [per[n] for n in order if n in per]


def chrome_instants(events: list[dict], pid: int,
                    host: str = "") -> list[dict]:
    """Journal events as Chrome-trace instant markers on one host's
    track: process-scoped (s "p") so the marker spans the host's track
    but not the whole report, with the full event (plus the owning
    host, the dedupe key half) in args."""
    out = []
    for e in events:
        name = str(e.get("type", "event"))
        if e.get("metric"):
            name += f" {e['metric']}"
        out.append({
            "name": name,
            "ph": "i", "s": "p", "pid": pid, "tid": 0,
            "ts": float(e.get("ts_ms", 0)) * 1000.0,  # epoch us
            "args": {"host": host, **e},
        })
    return out


def merge_into_report(report: dict, records: list[dict]) -> dict:
    """Adds one event track per swept host to a Chrome-trace report
    (fresh or an existing trace_report.json). Track pids continue past
    the report's highest existing pid so manifest tracks keep theirs;
    a host that already owns an events track (a re-run sweep merging
    into the same report) keeps its pid instead of growing a second
    track. Markers are deduped by (host, seq) against both the report's
    existing instants and this batch — a resumed or overlapping sweep
    can only ADD events, never double-mark one. metadata["event_hosts"]
    records the host -> pid assignment plus per-host event/dropped
    counts (and errors for unreachable hosts), so tooling can find
    "host X's track" without parsing labels. A host that died mid-sweep
    still contributes the events its partial drain collected — its
    summary entry carries both the counts and the error."""
    events = report.setdefault("traceEvents", [])
    used = [ev.get("pid") for ev in events
            if isinstance(ev.get("pid"), (int, float))]
    next_pid = int(max(used)) + 1 if used else 0
    host_pids: dict[str, int] = {}
    seen: set[tuple[str, int]] = set()
    for prev in report.get("metadata", {}).get("event_hosts", []):
        if "pid" in prev:
            host_pids[prev.get("host", "?")] = prev["pid"]
    for ev in events:
        args = ev.get("args", {})
        if ev.get("ph") == "i" and isinstance(args, dict) \
                and args.get("host") and "seq" in args:
            seen.add((args["host"], args["seq"]))
    summary = []
    for rec in records:
        entry: dict = {"host": rec.get("host", "?")}
        if not rec.get("ok"):
            entry["error"] = rec.get("error", "unreachable")
        fresh = [e for e in rec.get("events", [])
                 if (entry["host"], e.get("seq")) not in seen]
        seen.update((entry["host"], e.get("seq")) for e in fresh)
        if not rec.get("ok") and not fresh:
            summary.append(entry)  # nothing heard: error-only entry
            continue
        pid = host_pids.get(entry["host"])
        if pid is None:
            pid = next_pid
            next_pid += 1
            host_pids[entry["host"]] = pid
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"events:{entry['host']}"},
            })
        events.extend(chrome_instants(fresh, pid, host=entry["host"]))
        entry.update(pid=pid, events=len(fresh),
                     dropped=int(rec.get("dropped", 0)))
        summary.append(entry)
    report.setdefault("metadata", {})["event_hosts"] = summary
    return report


def hosts_from_tree(root: str, timeout_s: float = 10.0) -> list[str]:
    """Enumerates the fleet from one relay-tree member: every host with
    a fresh record in getFleetAggregates (node ids are host:port and
    dialable). Raises RuntimeError when the tree path is unusable so
    the caller can surface why."""
    host, sep, port = root.rpartition(":")
    if not (sep and port.isdigit()):
        host, port = root, str(DEFAULT_PORT)
    client = DynoClient(host=host, port=int(port), timeout=timeout_s)
    agg = client.fleet_aggregates()
    if agg.get("status") != "ok":
        raise RuntimeError(agg.get("error", "getFleetAggregates failed"))
    return sorted(agg.get("hosts", {}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hosts", default="",
                   help="Daemon hosts, CSV as host[:port].")
    p.add_argument("--root", default="",
                   help="Relay-tree member (host[:port]) to enumerate "
                        "the fleet from instead of --hosts: every host "
                        "with a fresh tree record is drained. One "
                        "address follows the fleet through re-parents "
                        "and root promotions.")
    p.add_argument("--port", type=int, default=DEFAULT_PORT,
                   help="Default RPC port for hosts without one.")
    p.add_argument("--log-dir", default=None,
                   help="Gang-trace dir whose trace_report.json the "
                        "events merge into (created if absent).")
    p.add_argument("--out", default=None,
                   help="Output path (default <log_dir>/trace_report.json"
                        ", or stdout with no --log-dir).")
    p.add_argument("--since-seq", type=int, default=0,
                   help="Journal cursor to resume each host from.")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="Per-RPC timeout seconds.")
    p.add_argument("--poll", action="store_true",
                   help="Force the per-host getEvents polling sweep "
                        "even when --root could serve one fleet-scoped "
                        "subscription instead.")
    p.add_argument("--max-wait", type=float, default=30.0,
                   help="Subscription drain bound (seconds) before "
                        "hosts that have not caught up fall back to "
                        "polling.")
    args = p.parse_args(argv)

    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    if args.root:
        try:
            hosts = hosts_from_tree(args.root, timeout_s=args.timeout)
        except Exception as e:
            if not hosts:
                print(f"eventlog: tree enumeration via {args.root} "
                      f"failed ({e}) and no --hosts to fall back to",
                      file=sys.stderr)
                return 2
            print(f"eventlog: tree enumeration via {args.root} failed "
                  f"({e}); using --hosts", file=sys.stderr)
    if not hosts:
        print("eventlog: pass --hosts or --root", file=sys.stderr)
        return 2

    records = None
    if args.root and not args.poll:
        # One fleet-scoped subscription at the root replays every
        # subtree journal; only hosts the stream never caught up (or a
        # root that predates the verb) cost a polling pass.
        try:
            records = sweep_subscribe(
                args.root, port=args.port, timeout=args.timeout,
                since_seq=args.since_seq, expected=hosts,
                max_wait_s=args.max_wait)
        except SubscribeUnsupported:
            print("eventlog: root does not accept subscribe; falling "
                  "back to getEvents polling", file=sys.stderr)
        else:
            behind = [r["host"] for r in records if not r.get("ok")]
            if behind:
                print(f"eventlog: {len(behind)} host(s) not caught up "
                      "over subscription; polling them directly",
                      file=sys.stderr)
                polled = {r["host"]: r for r in sweep(
                    behind, port=args.port, timeout=args.timeout,
                    since_seq=args.since_seq)}
                records = [polled.get(r["host"], r)
                           if not r.get("ok") else r for r in records]
    if records is None:
        records = sweep(hosts, port=args.port, timeout=args.timeout,
                        since_seq=args.since_seq)

    report: dict = {"traceEvents": [], "metadata": {}}
    out_path = args.out
    if args.log_dir:
        out_path = out_path or os.path.join(args.log_dir,
                                            "trace_report.json")
        try:
            with open(out_path) as f:
                existing = json.load(f)
            if isinstance(existing, dict):
                report = existing
        except (OSError, ValueError):
            pass  # no report yet: start an events-only one

    merge_into_report(report, records)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f)
    else:
        json.dump(report, sys.stdout)
        print()

    up = [r for r in records if r.get("ok")]
    total = sum(len(r.get("events", [])) for r in up)
    dropped = sum(int(r.get("dropped", 0)) for r in up)
    dest = out_path or "stdout"
    print(f"eventlog: {total} event(s) from {len(up)}/{len(records)} "
          f"host(s) ({dropped} evicted before read) -> {dest}",
          file=sys.stderr)
    for r in records:
        if not r.get("ok"):
            print(f"  unreachable: {r['host']}: {r.get('error')}",
                  file=sys.stderr)
    return 0 if up else 1


if __name__ == "__main__":
    sys.exit(main())
