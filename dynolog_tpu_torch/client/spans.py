"""Self-telemetry span recorder: the shim measuring itself.

The BASELINE claim ("<1% step-time overhead, traces in seconds") is a
claim about this monitoring stack, yet only the daemon's collector ticks
were self-profiled (native/src/common/TickStats.h). This module closes
the client-side blind spot: every hop of the on-demand trace flow and
the always-on telemetry push records a timestamped span into a small
ring buffer, Dapper-style (PAPERS.md) but in-process — no collection
infrastructure, just a deque the size of a few seconds of activity.

The recorded spans are exported through two existing channels, so no new
wire machinery is needed:

  * the trace manifest ("tdir" message): the daemon copies unknown body
    keys verbatim into dynolog_manifest.json (ipc/IpcMonitor.cpp), so a
    "spans" key rides for free and `dyno trace-report` /
    fleet/trace_report.py can merge per-host manifests into one
    Chrome-trace timeline;
  * the telemetry push ("tmet" message): `self_metrics()` flattens the
    aggregates into a `dyno_self_*` key family merged into every device
    record, which TpuMonitor.ingestClientMetrics forwards verbatim to
    the logger pipeline — the shim's own cost lands in Prometheus next
    to the chip metrics it ships.

Thread-safety: record()/incr() are called from the training thread, the
poll thread, and capture threads; one lock guards the ring and the
aggregates (the critical sections are a few dict ops — far below the
fabric-send cost already on these paths).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Iterator

# Ring capacity: at the default 1 s poll / 10 s metrics cadence this
# holds many minutes of control-plane activity; a pathological caller
# cannot grow memory unboundedly.
_DEFAULT_MAXLEN = 512


class SpanRecorder:
    """Ring buffer of completed spans + monotonic counters + per-name
    duration aggregates. All methods are thread-safe."""

    def __init__(self, maxlen: int = _DEFAULT_MAXLEN):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=maxlen)
        self._counters: dict[str, int] = {}
        # name -> {count, last_ms, total_ms, max_ms}; O(#names) state so
        # self_metrics() never walks the ring.
        self._agg: dict[str, dict[str, float]] = {}

    # -- recording ---------------------------------------------------------

    def record(self, name: str, t_start: float, t_end: float | None = None,
               **attrs: Any) -> dict:
        """Record a completed span. Timestamps are epoch seconds (same
        clock as trace_timing, so manifest spans and timing phases line
        up in the merged report)."""
        if t_end is None:
            t_end = time.time()
        dur_ms = max(0.0, (t_end - t_start) * 1e3)
        span = {"name": name, "t_start": t_start, "t_end": t_end,
                "dur_ms": round(dur_ms, 3)}
        if attrs:
            span.update(attrs)
        with self._lock:
            self._ring.append(span)
            agg = self._agg.setdefault(
                name, {"count": 0, "last_ms": 0.0, "total_ms": 0.0,
                       "max_ms": 0.0})
            agg["count"] += 1
            agg["last_ms"] = dur_ms
            agg["total_ms"] += dur_ms
            if dur_ms > agg["max_ms"]:
                agg["max_ms"] = dur_ms
        return span

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[dict]:
        """Context manager form; the yielded dict accepts extra attrs:

            with spans.span("poll") as s:
                ...
                s["ok"] = True
        """
        extra: dict = dict(attrs)
        t0 = time.time()
        try:
            yield extra
        finally:
            self.record(name, t0, time.time(), **extra)

    def incr(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + n

    # -- export ------------------------------------------------------------

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def snapshot(self) -> list[dict]:
        """Every span still in the ring, oldest first (copies)."""
        with self._lock:
            return [dict(s) for s in self._ring]

    def export(self, limit: int = 64) -> list[dict]:
        """The most recent `limit` spans, for the trace manifest. The
        manifest rides a <64 KB datagram shared with trace_timing and
        metadata, so this is deliberately a trimmed view (~100 bytes per
        span leaves ample headroom at the default)."""
        with self._lock:
            ring = list(self._ring)
        return [dict(s) for s in ring[-limit:]]

    def self_metrics(self, extra: dict[str, Any] | None = None
                     ) -> dict[str, float]:
        """Flat `dyno_self_*` numeric family for the telemetry push.

        Per span name: `dyno_self_<name>_ms_last`, `_ms_max`, `_count`.
        Per counter: `dyno_self_<counter>_total`. `extra` (e.g. fabric
        transport counters) is merged under the same prefix; only
        numeric values ride — the daemon forwards numeric record keys
        verbatim into logger records (TpuMonitor.ingestClientMetrics).
        """
        out: dict[str, float] = {}
        with self._lock:
            for name, agg in self._agg.items():
                out[f"dyno_self_{name}_ms_last"] = round(agg["last_ms"], 3)
                out[f"dyno_self_{name}_ms_max"] = round(agg["max_ms"], 3)
                out[f"dyno_self_{name}_count"] = float(agg["count"])
            for counter, n in self._counters.items():
                out[f"dyno_self_{counter}_total"] = float(n)
        if extra:
            for key, value in extra.items():
                if isinstance(value, (int, float)) and not isinstance(
                        value, bool):
                    out[f"dyno_self_{key}"] = float(value)
        return out


def chrome_events(spans: list[dict], pid: int = 0, tid: int = 0,
                  process_name: str | None = None) -> list[dict]:
    """Convert recorded spans to Chrome-trace complete events ("ph": "X",
    microsecond timestamps) — the format chrome://tracing and Perfetto
    open directly. One call per host/process; `pid` separates hosts in
    the merged timeline and `process_name` labels the track."""
    events: list[dict] = []
    if process_name:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": tid, "args": {"name": process_name}})
    for s in spans:
        if "t_start" not in s or "name" not in s:
            continue  # foreign manifest content; skip, don't crash
        args = {k: v for k, v in s.items()
                if k not in ("name", "t_start", "t_end", "dur_ms")}
        events.append({
            "ph": "X",
            "name": str(s["name"]),
            "ts": round(float(s["t_start"]) * 1e6, 1),
            "dur": round(float(s.get("dur_ms", 0.0)) * 1e3, 1),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return events
