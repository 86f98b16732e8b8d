"""fleetstatus — fleet-wide straggler detection from in-daemon aggregates.

Fans ``getAggregates`` to every host in parallel (same fan-out spine as
unitrace), reduces each host's per-chip windowed summaries to one scalar
per watched metric, then scores hosts against the fleet with robust
z-scores (median/MAD — a straggler must not be able to hide by dragging
the mean toward itself). A host is flagged when its score crosses the
threshold in the metric's bad direction:

  tensorcore_duty_cycle_pct   low is bad (chip starved of work)
  hbm_util_pct                low is bad (input pipeline stall)
  ici_bw_asymmetry_pct        high is bad (lopsided interconnect traffic;
                              derived as 100*|tx-rx|/(tx+rx) from the
                              ici_tx/rx_bytes_per_s window means)

Hosts started with --ici_topology additionally advertise a per-link
``ici`` block in getStatus (which already rides the sweep's batched
status probe); the sweep joins both endpoints' views of every ring link
into a named edge ("hostA<->hostB:link1"), robust-z-scores edge
bandwidth across the ring, and emits LINK_BOUND verdicts naming the
slow edge and its bandwidth deficit — see score_ici_edges. Low edge
bandwidth that BOTH endpoints agree on is a degraded link
(reason "low_bandwidth"); endpoints disagreeing about the same physical
link beyond --ici-asymmetry-pct is one-sided degradation (reason
"asymmetric", naming the low side). Edges below --ici-min-traffic-bps
are quiet, not degraded, and are excluded — an idle fleet reports OK.

Beyond relative (z-scored) straggling, the sweep applies one absolute
rule: a host whose ``step`` phase burns nearly a full core of host CPU
(``phase_cpu_util.<phase>`` p50 >= --host-bound-cpu-min) while its TPUs
sit idle (mean duty-cycle p50 <= --host-bound-duty-max) is HOST_BOUND —
the input pipeline or host-side work is the bottleneck, not the chip.
This is absolute rather than z-scored on purpose: if *every* host is
host-bound (the common case for a fleet-wide input bottleneck), no host
deviates from the fleet median and z-scoring is blind to it. Flagged
hosts land in `host_bound_hosts` with a WARN verdict and exit 1 under
--fail-on-outlier.

Hosts whose daemon reports a non-running supervised collector (see
getStatus `collector_health`: quarantined, restarting) are EXCLUDED
from the z-scoring and surfaced in a `degraded_hosts` field with a WARN
verdict instead: their series are stale by construction — a quarantined
tpu collector stops updating duty cycle, and letting that host into the
fleet reduction would either flag it as a straggler (wrong diagnosis:
the collector is sick, not the chip) or drag the fleet median toward
stale values. Degradation is a supervision problem with its own
runbook, not a straggler.

The statistics intentionally match the daemon's native implementation
(native/src/metric_frame/Aggregator.cpp): z = 0.6745*(x-median)/MAD,
falling back to 0.7979*(x-median)/meanAbsDev when MAD degenerates to 0
(Iglewicz-Hoaglin modified z-score), default threshold 3.5. Note the
fallback saturates at |z| = 0.7979*n for a lone deviant among identical
values — with small fleets the jitterless case is undetectable by
construction, which is fine: real telemetry always carries jitter.

Usage:
  python -m dynolog_tpu_torch.fleet.fleetstatus --hosts h1,h2,h3,h4 \
      --window-s 300 --fail-on-outlier
Exit codes: 0 healthy, 1 outliers found (with --fail-on-outlier),
2 sweep unusable (no host reachable / discovery failed).
"""

from __future__ import annotations

import argparse
import json
import sys

from dynolog_tpu_torch.fleet.sketch import RELATIVE_ERROR_BOUND, merge_all
from dynolog_tpu_torch.utils.rpc import (
    DEFAULT_PORT, AsyncDynoClient, RetryPolicy, fan_out)

# metric -> bad direction ("low": flag z < -threshold; "high": z > threshold)
DEFAULT_WATCHLIST = {
    "tensorcore_duty_cycle_pct": "low",
    "hbm_util_pct": "low",
    "ici_bw_asymmetry_pct": "high",
}

# Must track native/src/metric_frame/Aggregator.cpp robustZScores().
MAD_SCALE = 0.6745
MEAN_AD_SCALE = 0.7979

# HOST_BOUND defaults: step-phase host CPU utilization at/above CPU_MIN
# while mean TPU duty cycle is at/below DUTY_MAX (percent).
HOST_BOUND_PHASE = "step"
HOST_BOUND_CPU_MIN = 0.75
HOST_BOUND_DUTY_MAX = 20.0

# ICI scoring floors (must track native FleetTree IciEdgeOptions): below
# MIN_TRAFFIC_BPS an edge (or a host's tx+rx, for the asymmetry scalar)
# is quiet, not degraded — an idle host's tx=3/rx=0 would otherwise read
# as 100% asymmetry and z-score as a straggler. Edges whose two
# endpoints disagree by more than ASYMMETRY_PCT are flagged one-sided.
ICI_MIN_TRAFFIC_BPS = 1024.0
ICI_ASYMMETRY_PCT = 25.0


def median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def robust_z_scores(xs: list[float]) -> dict:
    """Modified z-scores; mirrors the daemon's robustZScores() so a value
    that crosses 3.5 here crosses it in `dyno fleetstatus` too."""
    n = len(xs)
    if n < 2:
        return {"median": xs[0] if xs else 0.0, "mad": 0.0,
                "used_fallback": False, "z": [0.0] * n}
    med = median(xs)
    dev = [abs(x - med) for x in xs]
    mad = median(dev)
    if mad > 0:
        return {"median": med, "mad": mad, "used_fallback": False,
                "z": [MAD_SCALE * (x - med) / mad for x in xs]}
    mean_ad = sum(dev) / n
    if mean_ad == 0:  # perfectly flat fleet: nobody is an outlier
        return {"median": med, "mad": 0.0, "used_fallback": True,
                "z": [0.0] * n}
    return {"median": med, "mad": 0.0, "used_fallback": True,
            "z": [MEAN_AD_SCALE * (x - med) / mean_ad for x in xs]}


def base_key(key: str) -> str:
    """Strip the entity suffix: hbm_util_pct.dev3 -> hbm_util_pct."""
    return key.split(".", 1)[0]


def host_scalars(window: dict, metrics) -> dict:
    """One scalar per watched metric from a host's per-key summaries:
    the mean of per-chip p50s (p50 per chip rejects within-window spikes;
    mean across chips keeps a single dead chip visible in the host
    scalar). ici_bw_asymmetry_pct is synthesized from the tx/rx window
    means.

    Summaries carrying an explicit count below 2 are excluded: a
    single-sample window's p50 is just that sample and its slope is 0
    by construction, so letting it into the fleet reduction would let
    one freshly-restarted host read as a straggler (summaries without
    a count key — hand-built in tests — are kept)."""
    per_metric: dict[str, list[float]] = {}
    for key, s in window.items():
        if s.get("count", 2) < 2:
            continue
        per_metric.setdefault(base_key(key), []).append(s)
    out = {}
    for m in metrics:
        if m == "ici_bw_asymmetry_pct":
            tx = [s["mean"] for s in per_metric.get("ici_tx_bytes_per_s", [])]
            rx = [s["mean"] for s in per_metric.get("ici_rx_bytes_per_s", [])]
            if tx and rx:
                t, r = sum(tx) / len(tx), sum(rx) / len(rx)
                # Traffic floor: idle interconnects don't get an
                # asymmetry scalar at all (absent != 0 — a zero would
                # drag the fleet median, absence just shrinks the pool).
                if (t + r) >= ICI_MIN_TRAFFIC_BPS:
                    out[m] = 100.0 * abs(t - r) / (t + r)
            continue
        chips = [s["p50"] for s in per_metric.get(m, [])]
        if chips:
            out[m] = sum(chips) / len(chips)
    return out


def host_bound_check(window: dict, phase: str = HOST_BOUND_PHASE,
                     cpu_min: float = HOST_BOUND_CPU_MIN,
                     duty_max: float = HOST_BOUND_DUTY_MAX) -> dict | None:
    """Absolute host-bound test on one host's window: step-phase host CPU
    pegged while the chips starve. Returns {phase, cpu_util, duty_cycle}
    when the rule fires, else None. Hosts not publishing the phase series
    (no phase annotations, or --enable_phase_cpu=false) or duty cycle are
    never flagged — absence of evidence stays silent."""
    s = window.get(f"phase_cpu_util.{phase}")
    if not isinstance(s, dict) or s.get("count", 2) < 2 or "p50" not in s:
        return None
    duty = [v["p50"] for k, v in window.items()
            if base_key(k) == "tensorcore_duty_cycle_pct"
            and isinstance(v, dict) and v.get("count", 2) >= 2
            and "p50" in v]
    if not duty:
        return None
    mean_duty = sum(duty) / len(duty)
    if s["p50"] >= cpu_min and mean_duty <= duty_max:
        return {"phase": phase, "cpu_util": round(s["p50"], 3),
                "duty_cycle": round(mean_duty, 2)}
    return None


def _ici_link_view(blk: dict, want_link: int,
                   stalls: list[float]) -> float | None:
    """One endpoint's view of a link: mean of whichever tx/rx rates the
    block advertises for local link `want_link` (absent rates = no view,
    distinct from a link genuinely reading zero). Accumulates the link's
    stall rate into stalls[0] either way. Mirrors the daemon's
    iciLinkView (native/src/fleettree/FleetTree.cpp)."""
    for link in blk.get("links", []):
        if not isinstance(link, dict) or link.get("link") != want_link:
            continue
        if "stalls_per_s" in link:
            stalls[0] += float(link["stalls_per_s"])
        rates = [float(link[f]) for f in
                 ("tx_bytes_per_s", "rx_bytes_per_s") if f in link]
        return sum(rates) / len(rates) if rates else None
    return None


def _ici_unavailable(status: str, reason: str,
                     missing: list[str]) -> dict:
    scoring = {"status": status, "reason": reason}
    if missing:
        scoring["missing_hosts"] = missing
    return {"edges": {}, "link_bound": [], "link_scoring": scoring}


def score_ici_edges(ici_by_node: dict, z_threshold: float = 3.5,
                    min_traffic_bps: float = ICI_MIN_TRAFFIC_BPS,
                    asymmetry_pct: float = ICI_ASYMMETRY_PCT) -> dict:
    """Fleet-wide ICI edge scoring: joins both endpoints' views of each
    ring link into one named edge and robust-z-scores edge bandwidth
    across the ring, flagging LINK_BOUND edges. Mirrors the daemon's
    scoreIciEdges (native/src/fleettree/FleetTree.cpp) byte-for-byte so
    a flat fleetstatus sweep and a getFleetStatus tree sweep agree.

    ici_by_node maps host -> its getStatus `ici` block (or None for
    hosts that advertised none). Returns:

      edges: {"<a><->"<b>:link1": {hosts: [a, b], bw_bytes_per_s,
              view_a?, view_b?, asymmetry_pct?, stalls_per_s, z?,
              below_floor?, no_data?}}
      link_bound: [{edge, hosts, reason: "low_bandwidth"|"asymmetric",
                    bw_bytes_per_s, median, deficit_pct, z?, low_side?,
                    asymmetry_pct?}]  (sorted by deficit, worst first)
      link_scoring: {status: "ok"|"unavailable"|"host_only_fallback",
                     reason?, missing_hosts?, ring_size?, ...}

    Degradation is structured, never silent: a sweep over old daemons
    (no ici blocks) or a torn topology names WHY edges were not scored.
    Edge e joins ring index e (its link 1) and index e+1 (its link 0);
    the global name is "<host[e]><-><host[e+1]>:link1" — one name no
    matter which endpoint reports it (native/src/common/IciTopology.h).
    """
    missing: list[str] = []
    node_by_index: dict[int, str] = {}
    block_by_index: dict[int, dict] = {}
    ring_size = -1
    for node in sorted(ici_by_node):
        blk = ici_by_node[node]
        if (not isinstance(blk, dict) or "links" not in blk
                or "index" not in blk):
            missing.append(node)
            continue
        if blk.get("topology") != "ring":
            return _ici_unavailable(
                "unavailable",
                f'unsupported topology "{blk.get("topology", "")}" '
                f"from {node}", [])
        size = int(blk.get("size", 0))
        idx = int(blk.get("index", -1))
        if ring_size == -1:
            ring_size = size
        elif size != ring_size:
            return _ici_unavailable(
                "unavailable", f"ring size disagreement at {node}", [])
        if idx < 0 or idx >= size or idx in node_by_index:
            return _ici_unavailable(
                "unavailable",
                f"invalid or duplicate ring index {idx} at {node}", [])
        node_by_index[idx] = node
        block_by_index[idx] = blk
    if not node_by_index:
        return _ici_unavailable("unavailable", "no_topology", missing)
    if missing or len(node_by_index) != ring_size:
        # Mixed-version fleet (some daemons predate --ici_topology) or
        # an unreachable ring member: host scoring still stands, edge
        # scoring cannot — every edge needs both endpoints' views.
        return _ici_unavailable(
            "host_only_fallback", "incomplete_topology", missing)

    edges = []
    for e in range(ring_size):
        a, b = node_by_index[e], node_by_index[(e + 1) % ring_size]
        stalls = [0.0]
        view_a = _ici_link_view(block_by_index[e], 1, stalls)
        view_b = _ici_link_view(
            block_by_index[(e + 1) % ring_size], 0, stalls)
        views = [v for v in (view_a, view_b) if v is not None]
        edges.append({
            "name": f"{a}<->{b}:link1", "a": a, "b": b,
            "view_a": view_a, "view_b": view_b,
            "has_data": bool(views),
            "bw": sum(views) / len(views) if views else 0.0,
            "stalls": stalls[0]})

    # Traffic floor: a near-idle edge is quiet, not degraded — score
    # only edges actually carrying traffic (idle-fleet false-positive
    # fix).
    scored = [e for e in range(ring_size)
              if edges[e]["has_data"]
              and edges[e]["bw"] >= min_traffic_bps]
    below_floor = sum(1 for e in range(ring_size)
                      if edges[e]["has_data"]
                      and edges[e]["bw"] < min_traffic_bps)
    rs = robust_z_scores([edges[e]["bw"] for e in scored])
    z_by_edge = dict(zip(scored, rs["z"]))

    edges_json: dict = {}
    bound: list[dict] = []
    for e in range(ring_size):
        ed = edges[e]
        j: dict = {"hosts": [ed["a"], ed["b"]]}
        if not ed["has_data"]:
            j["no_data"] = True
            edges_json[ed["name"]] = j
            continue
        j["bw_bytes_per_s"] = round(ed["bw"], 1)
        j["stalls_per_s"] = round(ed["stalls"], 3)
        if ed["view_a"] is not None:
            j["view_a"] = round(ed["view_a"], 1)
        if ed["view_b"] is not None:
            j["view_b"] = round(ed["view_b"], 1)
        asym = -1.0
        if (ed["view_a"] is not None and ed["view_b"] is not None
                and (ed["view_a"] + ed["view_b"]) > 0):
            asym = (100.0 * abs(ed["view_a"] - ed["view_b"])
                    / (ed["view_a"] + ed["view_b"]))
            j["asymmetry_pct"] = round(asym, 2)
        if e not in z_by_edge:
            j["below_floor"] = True
            edges_json[ed["name"]] = j
            continue
        z = z_by_edge[e]
        j["z"] = round(z, 2)
        is_bound = False
        if z < -z_threshold and rs["median"] > 0:
            lb = {"edge": ed["name"], "hosts": j["hosts"],
                  "reason": "low_bandwidth",
                  "bw_bytes_per_s": round(ed["bw"], 1),
                  "median": round(rs["median"], 1),
                  "deficit_pct": round(
                      100.0 * (rs["median"] - ed["bw"]) / rs["median"],
                      1),
                  "z": round(z, 2)}
            if asym >= 0:
                lb["asymmetry_pct"] = round(asym, 2)
            bound.append(lb)
            is_bound = True
        if not is_bound and asym > asymmetry_pct:
            # One-sided degradation: the two endpoints disagree about
            # the same physical link — the side reading low is the sick
            # one, even when the edge's joined mean keeps its z tame.
            hi = max(ed["view_a"], ed["view_b"])
            lo = min(ed["view_a"], ed["view_b"])
            bound.append({
                "edge": ed["name"], "hosts": j["hosts"],
                "reason": "asymmetric",
                "bw_bytes_per_s": round(ed["bw"], 1),
                "median": round(rs["median"], 1),
                "deficit_pct": round(
                    100.0 * (hi - lo) / hi if hi > 0 else 0.0, 1),
                "asymmetry_pct": round(asym, 2),
                "low_side": (ed["a"] if ed["view_a"] <= ed["view_b"]
                             else ed["b"])})
        edges_json[ed["name"]] = j
    bound.sort(key=lambda lb: -lb["deficit_pct"])

    return {"edges": edges_json, "link_bound": bound,
            "link_scoring": {
                "status": "ok", "ring_size": ring_size,
                "edges_scored": len(scored),
                "edges_below_floor": below_floor,
                "min_traffic_bps": min_traffic_bps,
                "z_threshold": z_threshold,
                "asymmetry_pct_threshold": asymmetry_pct}}


def parse_degraded(status: dict) -> tuple[list[dict], str | None]:
    """Non-running supervised collectors and storage state from one
    getStatus response: ([{collector, state, ...}], storage_mode).
    Advisory: a daemon too old to report health yields ([], None) — the
    host is then scored normally, exactly the pre-supervision behavior.
    storage_mode is the daemon's `storage.mode` ("ok"/"evicting"/
    "degraded"), or None for daemons without a durable tier."""
    storage = status.get("storage")
    storage_mode = (storage.get("mode")
                    if isinstance(storage, dict) else None)
    health = status.get("collector_health")
    if not isinstance(health, dict):
        return [], storage_mode
    degraded = []
    for name in sorted(health):
        h = health[name]
        if not isinstance(h, dict):
            continue
        state = h.get("state", "running")
        if state == "running":
            continue
        entry = {"collector": name, "state": state,
                 "consecutive_failures": h.get("consecutive_failures", 0),
                 "restarts": h.get("restarts", 0)}
        if h.get("last_error"):
            entry["last_error"] = h["last_error"]
        degraded.append(entry)
    return degraded, storage_mode


def probe_health(client) -> tuple[list[dict], str | None]:
    """parse_degraded over one live getStatus call; a failed status RPC
    (after a successful aggregates read) stays advisory: ([], None)."""
    try:
        status = client.call("getStatus")
    except Exception:
        return [], None
    return parse_degraded(status)


def _addr(host: str) -> tuple[str, int]:
    name, _, port = host.partition(":")
    return name, int(port) if port else DEFAULT_PORT


def _record_from_replies(host: str, agg_resp: dict, st_resp: dict,
                         window_s: int, attempts: int,
                         elapsed_s: float) -> dict:
    """One per-host record from an aggregates reply + a status reply,
    shared by the batched and legacy fetch paths so both produce
    byte-identical record shapes."""
    agg_err = None
    if "error" in agg_resp:
        agg_err = "RuntimeError: " + str(agg_resp["error"])
    status_ok = "error" not in st_resp
    degraded, storage_mode = (
        parse_degraded(st_resp) if status_ok else ([], None))
    rec = {"host": host, "attempts": attempts,
           "elapsed_s": round(elapsed_s, 3)}
    if agg_err is not None:
        rec.update(ok=False, error=agg_err, status_ok=status_ok,
                   degraded=degraded, storage=storage_mode)
    else:
        window = agg_resp.get("windows", {}).get(str(window_s), {})
        # Per-series serialized quantile sketches for this window
        # (daemons predating include_sketches just omit the block).
        sketches = agg_resp.get("sketches", {}).get(str(window_s), {})
        rec.update(ok=True, window=window,
                   sketches=sketches if isinstance(sketches, dict)
                   else {},
                   degraded=degraded, storage=storage_mode)
    # Per-link ICI view (getStatus `ici` block; only daemons started
    # with --ici_topology advertise it). Rides the same status reply the
    # sweep already paid for — edge scoring costs zero extra RPCs.
    if status_ok and isinstance(st_resp.get("ici"), dict):
        rec["ici"] = st_resp["ici"]
    return rec


def fetch_all(hosts: list[str], window_s: int, timeout_s: float = 10.0,
              retries: int = 3, parallelism: int = 64) -> list[dict]:
    """Every host's getAggregates + getStatus as ONE batched call per
    host on one fan_out event loop — a sweep costs one connection per
    host instead of two, and the daemon's admission control charges it
    as a single request. One record per host, in order:

      ok:   {host, ok: True, window, degraded, storage, attempts,
             elapsed_s}
      down: {host, ok: False, error, status_ok: bool, attempts,
             elapsed_s} — status_ok distinguishes "daemon alive but
             aggregates failed" (WARN: the host must not silently drop
             out of z-scoring) from a truly dark host, and carries
             degraded/storage when the status probe answered.

    Daemons predating the `batch` verb answer "unknown fn: batch"; the
    sweep then falls back to the legacy two-wave shape for every host
    (mixed fleets stay consistent rather than half-batched).
    """
    retry = RetryPolicy(attempts=max(1, retries), backoff_s=0.25)
    batch_req = {"fn": "batch", "client_id": "fleetstatus",
                 "requests": [
                     {"fn": "getAggregates", "windows_s": [window_s],
                      "include_sketches": True},
                     {"fn": "getStatus"}]}
    recs = fan_out([(*_addr(h), batch_req) for h in hosts],
                   timeout=timeout_s, retry=retry,
                   parallelism=parallelism)
    records = []
    for host, rec in zip(hosts, recs):
        if rec["ok"] and "unknown fn" in str(
                rec["response"].get("error", "")):
            # At least one pre-batch daemon in the fleet: redo the whole
            # sweep the old way so every record came off the same path.
            return _fetch_all_legacy(
                hosts, window_s, timeout_s=timeout_s, retries=retries,
                parallelism=parallelism)
        if not rec["ok"]:
            records.append({"host": host, "ok": False,
                            "error": rec["error"], "status_ok": False,
                            "degraded": [], "storage": None,
                            "attempts": rec["attempts"],
                            "elapsed_s": rec["elapsed_s"]})
            continue
        replies = rec["response"].get("replies")
        if not isinstance(replies, list) or len(replies) != 2:
            err = rec["response"].get("error", "malformed batch reply")
            records.append({"host": host, "ok": False,
                            "error": f"RuntimeError: {err}",
                            "status_ok": False, "degraded": [],
                            "storage": None,
                            "attempts": rec["attempts"],
                            "elapsed_s": rec["elapsed_s"]})
            continue
        agg_resp = replies[0] if isinstance(replies[0], dict) else {}
        st_resp = replies[1] if isinstance(replies[1], dict) else {}
        records.append(_record_from_replies(
            host, agg_resp, st_resp, window_s,
            attempts=rec["attempts"], elapsed_s=rec["elapsed_s"]))
    return records


def _fetch_all_legacy(hosts: list[str], window_s: int,
                      timeout_s: float = 10.0, retries: int = 3,
                      parallelism: int = 64) -> list[dict]:
    """Pre-`batch` fetch path: getAggregates + getStatus as two fan_out
    waves (two connections per host). Kept for fleets with daemons too
    old for the batch verb."""
    retry = RetryPolicy(attempts=max(1, retries), backoff_s=0.25)
    agg_recs = fan_out(
        [(*_addr(h), {"fn": "getAggregates", "windows_s": [window_s],
                      "include_sketches": True})
         for h in hosts],
        timeout=timeout_s, retry=retry, parallelism=parallelism)
    # Second wave probes health on EVERY host — including aggregates
    # failures, where it is the liveness classifier, not just advisory.
    status_recs = fan_out(
        [(*_addr(h), {"fn": "getStatus"}) for h in hosts],
        timeout=timeout_s, retry=retry, parallelism=parallelism)
    records = []
    for host, agg, st in zip(hosts, agg_recs, status_recs):
        if not agg["ok"]:
            status_ok = bool(st["ok"]) and "error" not in st["response"]
            degraded, storage_mode = (
                parse_degraded(st["response"]) if status_ok
                else ([], None))
            records.append({
                "host": host, "ok": False, "error": agg["error"],
                "status_ok": status_ok, "degraded": degraded,
                "storage": storage_mode,
                "attempts": max(agg["attempts"], st["attempts"]),
                "elapsed_s": round(
                    agg["elapsed_s"] + st["elapsed_s"], 3)})
            continue
        st_resp = (st["response"]
                   if st["ok"] and isinstance(st["response"], dict)
                   else {"error": "status probe failed"})
        records.append(_record_from_replies(
            host, agg["response"], st_resp, window_s,
            attempts=max(agg["attempts"], st["attempts"]),
            elapsed_s=agg["elapsed_s"] + st["elapsed_s"]))
    return records


def sweep(hosts: list[str], window_s: int = 300,
          metrics: dict | None = None, z_threshold: float = 3.5,
          parallelism: int = 64, timeout_s: float = 10.0,
          retries: int = 3, host_bound_phase: str = HOST_BOUND_PHASE,
          host_bound_cpu_min: float = HOST_BOUND_CPU_MIN,
          host_bound_duty_max: float = HOST_BOUND_DUTY_MAX,
          ici_min_traffic_bps: float = ICI_MIN_TRAFFIC_BPS,
          ici_asymmetry_pct: float = ICI_ASYMMETRY_PCT) -> dict:
    """Fans getAggregates to every host, scores the fleet, returns the
    machine-readable verdict:

      {window_s, z_threshold, hosts: [...], unreachable: [{host,error}],
       aggregates_failed: [{host, error}],  # daemon answered getStatus
                               # but not getAggregates: WARN + excluded
                               # from scoring, never silently dropped
       degraded_hosts: [{host, collectors: [{collector, state, ...}]}],
       storage: {host: mode},  # per-host durable tier: ok/evicting/
                               # degraded (hosts without storage omitted)
       metrics: {name: {median, mad, used_fallback,
                        values: {host: x}, z: {host: z}}},
       outliers: [{host, metric, value, median, z, direction}],
       host_bound_hosts: [{host, phase, cpu_util, duty_cycle}],
       edges: {...}, link_bound: [...], link_scoring: {...},
                    # ICI edge verdict (see score_ici_edges); scored
                    # from the same status replies the sweep already
                    # fetched, zero extra RPCs
       warn: bool,  # degraded collectors, host-bound hosts, aggregates
                    # failures, or non-ok storage (WARN, not straggler)
       ok: bool}    # ok = sweep usable AND no outliers AND no
                    # LINK_BOUND edges
    """
    metrics = dict(metrics or DEFAULT_WATCHLIST)
    results = fetch_all(hosts, window_s, timeout_s=timeout_s,
                        retries=retries, parallelism=parallelism)
    up = [r for r in results if r["ok"]]
    # A live daemon whose aggregates verb failed (timeout mid-reply,
    # transient error) is a WARN, not an unreachable host — dropping it
    # silently would shrink the z-scored fleet without anyone noticing.
    aggregates_failed = [{"host": r["host"], "error": r["error"]}
                         for r in results
                         if not r["ok"] and r.get("status_ok")]
    unreachable = [{"host": r["host"], "error": r["error"]}
                   for r in results
                   if not r["ok"] and not r.get("status_ok")]
    degraded_hosts = [{"host": r["host"], "collectors": r["degraded"]}
                      for r in results if r.get("degraded")]
    # Durable-tier state per host (hosts without --storage_dir omitted).
    # Non-ok storage warns but does NOT exclude the host from scoring:
    # its live series are fine — only durability is impaired.
    storage = {r["host"]: r["storage"] for r in results if r.get("storage")}
    storage_warn = any(mode != "ok" for mode in storage.values())
    verdict: dict = {"window_s": window_s, "z_threshold": z_threshold,
                     "hosts": hosts, "unreachable": unreachable,
                     "aggregates_failed": aggregates_failed,
                     "degraded_hosts": degraded_hosts,
                     "storage": storage,
                     "metrics": {}, "outliers": [],
                     "host_bound_hosts": [],
                     "warn": bool(degraded_hosts) or storage_warn,
                     "ok": bool(up)}
    # Degraded hosts don't enter the fleet reduction: their series are
    # stale (the collector that feeds them is quarantined/restarting),
    # and a stale flatline is a supervision incident, not a straggler.
    degraded = {d["host"] for d in degraded_hosts}
    # Absolute host-bound rule (degraded hosts excluded for the same
    # staleness reason; see host_bound_check for why this isn't z-scored).
    for r in up:
        if r["host"] in degraded:
            continue
        hb = host_bound_check(r["window"], phase=host_bound_phase,
                              cpu_min=host_bound_cpu_min,
                              duty_max=host_bound_duty_max)
        if hb:
            verdict["host_bound_hosts"].append({"host": r["host"], **hb})
    verdict["warn"] = bool(degraded_hosts or verdict["host_bound_hosts"]
                           or aggregates_failed or storage_warn)
    scalars = {r["host"]: host_scalars(r["window"], metrics)
               for r in up if r["host"] not in degraded}
    for m, direction in metrics.items():
        have = [h for h in scalars if m in scalars[h]]
        if not have:
            continue
        xs = [scalars[h][m] for h in have]
        rs = robust_z_scores(xs)
        verdict["metrics"][m] = {
            "median": rs["median"], "mad": rs["mad"],
            "used_fallback": rs["used_fallback"],
            "values": dict(zip(have, xs)),
            "z": dict(zip(have, rs["z"]))}
        for h, x, z in zip(have, xs, rs["z"]):
            bad = (z < -z_threshold if direction == "low"
                   else z > z_threshold)
            if bad:
                verdict["outliers"].append(
                    {"host": h, "metric": m, "value": x,
                     "median": rs["median"], "z": round(z, 3),
                     "direction": direction})
    verdict["outliers"].sort(key=lambda o: -abs(o["z"]))
    # True fleet quantiles: merge every healthy host's per-chip window
    # sketches (additive bucket counts — exact), so the p99 below is the
    # fleet distribution's p99, not a mean of per-host p50s. Hosts
    # answering without sketches (older daemons, empty stores) still
    # ride the scalar z-scoring above; they just contribute no buckets.
    host_sources = {r["host"]: ("sketch" if r.get("sketches")
                                else "scalar")
                    for r in up if r["host"] not in degraded}
    fleet_quantiles: dict = {}
    for m in metrics:
        if m == "ici_bw_asymmetry_pct":
            continue  # derived ratio of window means: no sample stream
        payloads = [wire
                    for r in up if r["host"] not in degraded
                    for key, wire in (r.get("sketches") or {}).items()
                    if base_key(key) == m
                    and isinstance(wire, dict) and wire.get("c", 0) >= 2]
        merged = merge_all(payloads)
        if merged is not None:
            fleet_quantiles[m] = {"count": merged.count,
                                  "p50": merged.quantile(0.50),
                                  "p95": merged.quantile(0.95),
                                  "p99": merged.quantile(0.99)}
    verdict["quantile_sources"] = host_sources
    if fleet_quantiles:
        verdict["fleet_quantiles"] = fleet_quantiles
        verdict["quantile_error_bound"] = RELATIVE_ERROR_BOUND
    # ICI edge scoring over every host's `ici` status block (hosts that
    # advertised none — unreachable, or daemons predating
    # --ici_topology — count as missing and degrade the scoring status
    # structurally, never silently).
    edge_verdict = score_ici_edges(
        {r["host"]: r.get("ici") for r in results},
        z_threshold=z_threshold,
        min_traffic_bps=ici_min_traffic_bps,
        asymmetry_pct=ici_asymmetry_pct)
    verdict["edges"] = edge_verdict["edges"]
    verdict["link_bound"] = edge_verdict["link_bound"]
    verdict["link_scoring"] = edge_verdict["link_scoring"]
    verdict["ok"] = (bool(up) and not verdict["outliers"]
                     and not verdict["link_bound"])
    return verdict


def tree_sweep_ex(root: str, window_s: int = 300,
                  z_threshold: float = 3.5, timeout_s: float = 10.0,
                  metrics: dict | None = None,
                  max_hops: int = 8) -> tuple[dict | None, str]:
    """One getFleetStatus call to a relay-tree node: the daemon reduces
    its whole subtree in-tree (same watchlist, same robust-z math), so
    the sweep is O(depth) instead of O(N) RPCs. Returns
    (verdict, reason): the flat-sweep verdict shape with source="tree"
    and reason "", or (None, why) when the tree path is unusable —
    root unreachable, daemon too old for the verb, window mismatch with
    the tree's reduction window, or a custom watchlist (the tree
    pre-reduces the default metrics only) — so the caller can SAY why
    it fell back to a flat fan-out.

    The address may be ANY tree member, not just the current root:
    verdicts carry a `root` hint (the answerer's view of the top of the
    tree) and the sweep follows it — bounded hops, cycle-guarded — so
    `--root <seed>` keeps working after the original root died and a
    surviving seed promoted itself."""
    if metrics is not None and dict(metrics) != DEFAULT_WATCHLIST:
        return None, ("custom --metrics watchlist (the tree pre-reduces "
                      "the default watchlist only)")
    addr = root
    visited = set()
    for _ in range(max_hops):
        visited.add(addr)
        name, port = _addr(addr)
        client = AsyncDynoClient(host=name, port=port, timeout=timeout_s)
        try:
            verdict = client.fleet_status(
                window_s=window_s, z_threshold=z_threshold)
        except Exception as exc:
            return None, f"{addr} unreachable ({exc})"
        if verdict.get("status") != "ok":
            err = verdict.get("error", "unknown error")
            if "tree_window_s" in verdict:
                err = (f"window mismatch: the tree reduces "
                       f"window_s={verdict['tree_window_s']}, requested "
                       f"{verdict.get('requested_window_s', window_s)}")
            return None, f"{addr}: {err}"
        hint = verdict.get("root")
        node = verdict.get("node")
        if hint and node and hint != node and hint not in visited:
            # The answerer is not the root; re-ask the top of its
            # ancestry so the verdict covers the WHOLE fleet, not just
            # this node's subtree.
            addr = hint
            continue
        verdict.pop("status", None)
        return verdict, ""
    return None, f"root hint chain exceeded {max_hops} hops (cycle?)"


def tree_sweep(root: str, window_s: int = 300, z_threshold: float = 3.5,
               timeout_s: float = 10.0,
               metrics: dict | None = None) -> dict | None:
    """tree_sweep_ex without the reason — verdict or None."""
    verdict, _ = tree_sweep_ex(
        root, window_s=window_s, z_threshold=z_threshold,
        timeout_s=timeout_s, metrics=metrics)
    return verdict


def render(verdict: dict) -> str:
    """Human table; the JSON verdict is the machine interface."""
    via = " via relay tree" if verdict.get("source") == "tree" else ""
    lines = [f"fleet health over last {verdict['window_s']}s{via} "
             f"({len(verdict['hosts']) - len(verdict['unreachable'])}"
             f"/{len(verdict['hosts'])} hosts reporting, "
             f"robust-z threshold {verdict['z_threshold']}):"]
    rows = [("metric", "host", "value", "median", "robust_z", "src", "")]
    flagged = {(o["host"], o["metric"]) for o in verdict["outliers"]}
    # Per-host quantile source: "sketch" when the host's reduction rode
    # merged sketches, "scalar" when only mean-of-p50 scalars were
    # available (older daemon / empty store). Both flat and tree
    # verdicts carry the same key.
    sources = verdict.get("quantile_sources") or {}
    for m, stats in verdict["metrics"].items():
        for h in sorted(stats["values"]):
            rows.append((m, h, f"{stats['values'][h]:.2f}",
                         f"{stats['median']:.2f}",
                         f"{stats['z'][h]:+.2f}",
                         sources.get(h, ""),
                         "STRAGGLER" if (h, m) in flagged else ""))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        lines.append("  " + "  ".join(
            c.ljust(w) for c, w in zip(r, widths)).rstrip())
    fq = verdict.get("fleet_quantiles") or {}
    if fq:
        bound = verdict.get("quantile_error_bound", RELATIVE_ERROR_BOUND)
        for m in sorted(fq):
            q = fq[m]
            lines.append(
                f"  fleet {m}: p50={q['p50']:.2f} p95={q['p95']:.2f} "
                f"p99={q['p99']:.2f} over {int(q['count'])} samples "
                f"(merged sketch; relative error <= {bound:g})")
    for u in verdict["unreachable"]:
        lines.append(f"  UNREACHABLE {u['host']}: {u['error']}")
    for a in verdict.get("aggregates_failed", []):
        lines.append(f"  AGG-FAILED {a['host']}: {a['error']} "
                     "(daemon alive; excluded from straggler scoring)")
    for d in verdict.get("degraded_hosts", []):
        ailing = ", ".join(f"{c['collector']} {c['state']}"
                           for c in d["collectors"])
        lines.append(f"  DEGRADED {d['host']}: {ailing} "
                     "(excluded from straggler scoring)")
    for hb in verdict.get("host_bound_hosts", []):
        lines.append(
            f"  HOST_BOUND {hb['host']}: phase '{hb['phase']}' host CPU "
            f"{hb['cpu_util']:.2f} with TPU duty {hb['duty_cycle']:.1f}% "
            "(host-side bottleneck)")
    for lb in verdict.get("link_bound", []):
        detail = f"deficit {lb['deficit_pct']:.1f}%, {lb['reason']}"
        if lb.get("low_side"):
            detail += f", low side {lb['low_side']}"
        lines.append(
            f"  LINK_BOUND {lb['edge']}: {lb['bw_bytes_per_s']:.1f} B/s "
            f"vs median {lb['median']:.1f} ({detail})")
    link_scoring = verdict.get("link_scoring") or {}
    if (link_scoring.get("status") not in (None, "ok")
            and link_scoring.get("reason") != "no_topology"):
        # A topologized fleet whose edges could NOT be scored says so
        # (mixed-version or torn ring); untopologized fleets stay quiet.
        note = link_scoring.get("reason", "")
        miss = link_scoring.get("missing_hosts") or []
        if miss:
            note += ": missing " + ", ".join(miss)
        lines.append(
            f"  link scoring: {link_scoring['status']} ({note})")
    bad_storage = {h: m for h, m in
                   sorted(verdict.get("storage", {}).items()) if m != "ok"}
    for h, mode in bad_storage.items():
        note = ("telemetry not being persisted; memory-only mode"
                if mode == "degraded"
                else "disk budget reached; oldest history being evicted")
        lines.append(f"  STORAGE {h}: {mode} ({note})")
    # Relay overload is structured, never silent: hosts reporting at
    # reduced fidelity (their uplink degraded under fan-in pressure) and
    # the answering node's shed/split tallies both surface here. Tree
    # verdicts only — flat sweeps have no relay path to degrade.
    for h, level in sorted((verdict.get("fidelity") or {}).items()):
        note = ("liveness heartbeat only; scalars and sketches dropped"
                if level == "digest"
                else "sketches dropped; scalar summaries intact")
        lines.append(f"  FIDELITY {h}: {level} ({note})")
    relay = verdict.get("relay") or {}
    if relay.get("sheds") or relay.get("splits"):
        lines.append(
            f"  relay overload: {relay.get('sheds', 0)} shed report(s), "
            f"{relay.get('splits', 0)} subtree split(s) at the answering "
            "node (see relay_overloaded/relay_subtree_split journal "
            "events)")
    if verdict["outliers"]:
        worst = verdict["outliers"][0]
        lines.append(
            f"verdict: {len(verdict['outliers'])} outlier reading(s); "
            f"worst: {worst['host']} {worst['metric']}="
            f"{worst['value']:.2f} (z={worst['z']:+.2f})")
    elif verdict.get("link_bound"):
        worst = verdict["link_bound"][0]
        lines.append(
            f"verdict: {len(verdict['link_bound'])} LINK_BOUND edge(s); "
            f"worst: {worst['edge']} "
            f"(deficit {worst['deficit_pct']:.1f}%, {worst['reason']})")
    elif not verdict["ok"]:
        lines.append("verdict: UNUSABLE — no host reachable")
    elif verdict.get("host_bound_hosts"):
        lines.append(
            f"verdict: WARN — {len(verdict['host_bound_hosts'])} "
            "host-bound host(s) (see HOST_BOUND lines); no stragglers")
    elif verdict.get("degraded_hosts"):
        lines.append(
            f"verdict: WARN — {len(verdict['degraded_hosts'])} host(s) "
            "with degraded collectors (see DEGRADED lines); no "
            "stragglers among healthy hosts")
    elif verdict.get("aggregates_failed"):
        lines.append(
            f"verdict: WARN — {len(verdict['aggregates_failed'])} live "
            "host(s) failed getAggregates (see AGG-FAILED lines); no "
            "stragglers among scored hosts")
    elif bad_storage:
        lines.append(
            f"verdict: WARN — {len(bad_storage)} host(s) with non-ok "
            "durable storage (see STORAGE lines); no stragglers")
    elif verdict.get("fidelity"):
        lines.append(
            f"verdict: WARN — {len(verdict['fidelity'])} host(s) "
            "reporting at reduced fidelity (see FIDELITY lines); no "
            "stragglers")
    else:
        lines.append("verdict: healthy")
    return "\n".join(lines)


def resolve_hosts(args) -> list[str]:
    if args.hosts:
        return [h for h in args.hosts.split(",") if h]
    if args.hostfile:
        with open(args.hostfile) as f:
            return [line.strip() for line in f if line.strip()]
    if getattr(args, "root", ""):
        return []  # tree-only invocation: the root enumerates the fleet
    raise SystemExit("no hosts: pass --hosts, --hostfile, or --root")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hosts", default="", help="CSV of host or host:port.")
    p.add_argument("--hostfile", default="")
    p.add_argument("--root", default="",
                   help="Relay-tree root (host or host:port): ask this "
                        "one daemon for the whole subtree's verdict "
                        "(O(depth)); falls back to a flat --hosts sweep "
                        "when the tree path is unusable.")
    p.add_argument("--window-s", type=int, default=300,
                   help="Aggregation window to score (must be one the "
                        "daemons compute; see --aggregation_windows_s).")
    p.add_argument("--metrics", default="",
                   help="CSV of metric[:low|:high] overriding the default "
                        "watchlist (direction defaults to low-is-bad).")
    p.add_argument("--z-threshold", type=float, default=3.5)
    p.add_argument("--fail-on-outlier", action="store_true",
                   help="Exit 1 when any host is flagged (straggler, "
                        "host-bound, or a LINK_BOUND edge).")
    p.add_argument("--ici-min-traffic-bps", type=float,
                   default=ICI_MIN_TRAFFIC_BPS,
                   help="ICI edges (and the per-host asymmetry scalar) "
                        "below this joined bandwidth are quiet, not "
                        "degraded — excluded from edge z-scoring.")
    p.add_argument("--ici-asymmetry-pct", type=float,
                   default=ICI_ASYMMETRY_PCT,
                   help="Flag an edge LINK_BOUND (asymmetric) when its "
                        "endpoints' views of the same link differ by "
                        "more than this percentage.")
    p.add_argument("--host-bound-phase", default=HOST_BOUND_PHASE,
                   help="Phase whose host-CPU utilization the host-bound "
                        "rule inspects.")
    p.add_argument("--host-bound-cpu-min", type=float,
                   default=HOST_BOUND_CPU_MIN,
                   help="Flag when the phase's CPU util p50 is at/above "
                        "this (cores; >1 disables the rule in practice).")
    p.add_argument("--host-bound-duty-max", type=float,
                   default=HOST_BOUND_DUTY_MAX,
                   help="...and mean TPU duty-cycle p50 is at/below this "
                        "percentage.")
    p.add_argument("--json", action="store_true",
                   help="Print the machine-readable verdict instead of "
                        "the table.")
    p.add_argument("--parallelism", type=int, default=64)
    p.add_argument("--rpc-timeout-s", type=float, default=10.0)
    p.add_argument("--rpc-retries", type=int, default=3)
    return p


def parse_metrics(spec: str) -> dict | None:
    if not spec:
        return None
    out = {}
    for item in spec.split(","):
        if not item:
            continue
        name, _, direction = item.partition(":")
        if direction not in ("", "low", "high"):
            raise SystemExit(f"bad --metrics direction in {item!r} "
                             "(want low or high)")
        out[name] = direction or "low"
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    hosts = resolve_hosts(args)
    metrics = parse_metrics(args.metrics)
    verdict = None
    if args.root:
        verdict, reason = tree_sweep_ex(
            args.root, window_s=args.window_s,
            z_threshold=args.z_threshold, timeout_s=args.rpc_timeout_s,
            metrics=metrics)
        if verdict is None and not hosts:
            print(f"tree sweep via {args.root} failed ({reason}) and "
                  "no --hosts to fall back to", file=sys.stderr)
            return 2
        if verdict is None:
            print(f"tree sweep via {args.root} unusable: {reason}; "
                  "falling back to flat sweep", file=sys.stderr)
    if verdict is None:
        verdict = sweep(
            hosts, window_s=args.window_s, metrics=metrics,
            z_threshold=args.z_threshold, parallelism=args.parallelism,
            timeout_s=args.rpc_timeout_s, retries=args.rpc_retries,
            host_bound_phase=args.host_bound_phase,
            host_bound_cpu_min=args.host_bound_cpu_min,
            host_bound_duty_max=args.host_bound_duty_max,
            ici_min_traffic_bps=args.ici_min_traffic_bps,
            ici_asymmetry_pct=args.ici_asymmetry_pct)
    print(json.dumps(verdict, indent=2) if args.json else render(verdict))
    if (not verdict["hosts"]
            or len(verdict["unreachable"]) == len(verdict["hosts"])):
        return 2
    if args.fail_on_outlier and (
        verdict["outliers"] or verdict["host_bound_hosts"]
        or verdict.get("link_bound")
    ):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
