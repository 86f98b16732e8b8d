"""faultline — deterministic, seedable fault injection for the control
plane.

The daemon's value proposition is staying on while the pod misbehaves:
datagrams drop, RPCs stall, daemons get OOM-killed mid-gang-trace. Those
failures are rare and unreproducible in CI, so the chaos tests inject
them here instead of monkeypatching socket internals — the SAME hooks
the production code ships with (FabricClient wraps every datagram
through `plan_tx`/`drop_rx`; DynoClient consults the `rpc` scope before
each connection), gated to no-ops unless `DYNOLOG_TPU_FAULTS` is set.

Env grammar (comma-separated `key=value` entries):

    DYNOLOG_TPU_FAULTS="fabric.drop=0.2,rpc.delay_ms=50,seed=7"

    seed=<int>               RNG seed shared by every scope (default 0);
                             a fixed seed makes the injected fault
                             SEQUENCE reproducible per scope.
    <scope>.<action>=<val>   scopes in use: `fabric` (UNIX-dgram fabric,
                             client side) and `rpc` (TCP JSON-RPC
                             client). Actions:
        drop=<p>       probability an OUTBOUND message is dropped on
                       the simulated wire. `fabric` scope: the sender
                       still observes success (datagram loss is
                       invisible to it). `rpc` scope: the exchange
                       fails with ConnectionError (stream loss is
                       visible) — what DynoClient's retry absorbs.
        drop_rx=<p>    probability an INBOUND message is dropped after
                       the socket read. NOTE: an rx-dropped 'conf' loses
                       an exactly-once config handoff by design — the
                       fabric has no ack/redelivery; see
                       docs/Resilience.md for why tx faults are the
                       safe-by-protocol set.
        dup=<p>        probability an outbound message is sent twice
        truncate=<p>   probability an outbound payload is cut in half
                       (the receiver sees a runt / bad-JSON datagram)
        delay_ms=<f>   fixed sleep before every outbound op
        error=<p>      probability the guarded operation raises (native:
                       a collector tick throws / a sink send attempt
                       fails and is retried)
        crash=<p>      probability the guarded operation dies hard
                       (native: InjectedCrash kills the supervised
                       worker thread — the watchdog must respawn it)
        stall_ms=<f>   sleep INSIDE the guarded operation — what a hung
                       libtpu read looks like to the native watchdog
        bad_device=<f> chip index whose runtime-poll series vanishes
                       (native partial degradation; exercises
                       TpuMonitor's per-chip quarantine)

The native daemon parses the same grammar (native/src/common/Faultline.h)
with daemon-side scopes: `libtpu` (runtime poll), `collector_<name>`
(any supervised collector tick), `sink_http` / `sink_relay` (network
sink senders) — scope names never contain dots, since the first dot
splits scope from action. Because a daemon's env is frozen at exec,
`DYNOLOG_TPU_FAULTS_FILE` may name a file whose contents (same grammar)
OVERRIDE the env and are re-read on mtime change — chaos tests clear a
fault in a running daemon by truncating the file.

Injected faults are counted per scope/action; `FabricClient.stats()`
merges them under a `fault_` prefix, so they ride the shim's telemetry
push into the `dyno_self_*` family (docs/Metrics.md) — chaos is visible
in the same Prometheus counters operators already watch.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time

log = logging.getLogger("dynolog_tpu_torch.faultline")

ENV_VAR = "DYNOLOG_TPU_FAULTS"

# wrong_mac/expired act on the auth-signing path (scope "auth"): corrupt
# the HMAC proof / age the challenge or timestamp past its window. Must
# stay in lockstep with kProbActions in native/src/common/Faultline.cpp.
_PROB_ACTIONS = (
    "drop", "drop_rx", "dup", "truncate", "error", "crash",
    "wrong_mac", "expired")
# degrade_link/degrade_factor/link_stalls act on the per-link ICI series
# (scope "ici_link"): degrade_link names a global ring EDGE index, and
# every host touching that edge scales the matching link's tx/rx rates
# by degrade_factor (e.g. 0.6 = a 40% bandwidth deficit) and reports
# link_stalls stalls/s on it. Same scope drives the native daemon's
# polled per-link rates (TpuMonitor) and minifleet's injected series
# (minifleet.ring_link_series), so edge localization is chaos-testable
# end to end from one spec. Must stay in lockstep with kValueActions.
_VALUE_ACTIONS = (
    "delay_ms", "stall_ms", "bad_device",
    "degrade_link", "degrade_factor", "link_stalls")


def parse_spec(spec: str) -> tuple[dict[str, dict[str, float]], int]:
    """`"fabric.drop=0.2,seed=7"` -> ({"fabric": {"drop": 0.2}}, 7).

    Raises ValueError on anything malformed: a typo'd fault spec must
    fail the chaos run loudly, not silently inject nothing.
    """
    scopes: dict[str, dict[str, float]] = {}
    seed = 0
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        key, sep, value = entry.partition("=")
        if not sep:
            raise ValueError(f"faultline: entry {entry!r} is not key=value")
        if key == "seed":
            seed = int(value)
            continue
        scope, dot, action = key.partition(".")
        if not dot or not scope or not action:
            raise ValueError(
                f"faultline: key {key!r} is not <scope>.<action>")
        if action in _PROB_ACTIONS:
            p = float(value)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"faultline: {key}={value} is not a probability")
        elif action in _VALUE_ACTIONS:
            p = float(value)
            if p < 0:
                raise ValueError(f"faultline: {key}={value} is negative")
        else:
            raise ValueError(f"faultline: unknown action {action!r} "
                             f"(known: {_PROB_ACTIONS + _VALUE_ACTIONS})")
        scopes.setdefault(scope, {})[action] = p
    return scopes, seed


class ScopedFaults:
    """Fault decisions for one scope, from a per-scope seeded RNG.

    Thread-safe: one lock guards the RNG and the counters (the decision
    sites already pay socket-I/O costs, one lock bump is noise). The
    RNG is seeded from (seed, scope) with a string — CPython seeds
    strings content-deterministically — so two scopes never share a
    decision stream and runs with the same seed replay the same
    per-scope sequence.
    """

    def __init__(self, scope: str, actions: dict[str, float], seed: int):
        self.scope = scope
        self._actions = dict(actions)
        self._rng = random.Random(f"{seed}:{scope}")
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def _hit(self, action: str) -> bool:
        p = self._actions.get(action, 0.0)
        if p <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < p
            if hit:
                self._counts[action] = self._counts.get(action, 0) + 1
        return hit

    def maybe_delay(self) -> None:
        delay_ms = self._actions.get("delay_ms", 0.0)
        if delay_ms > 0:
            with self._lock:
                self._counts["delay"] = self._counts.get("delay", 0) + 1
            time.sleep(delay_ms / 1e3)

    def plan_tx(self, payload: bytes) -> list[bytes]:
        """The datagrams/frames that actually reach the wire for one
        outbound payload: [] when dropped, [payload, payload] when
        duplicated, a half-length runt when truncated. Applies the
        configured delay first. Decision order is fixed (delay, drop,
        truncate, dup) so a seed replays identically."""
        self.maybe_delay()
        if self._hit("drop"):
            return []
        if self._hit("truncate"):
            payload = payload[: max(1, len(payload) // 2)]
        if self._hit("dup"):
            return [payload, payload]
        return [payload]

    def drop_rx(self) -> bool:
        """True when an inbound message should be dropped post-read."""
        return self._hit("drop_rx")

    def drop(self) -> bool:
        """One drop decision for stream transports (the rpc scope):
        unlike a datagram, a dropped TCP exchange IS visible to the
        caller — DynoClient turns a hit into a ConnectionError, which is
        exactly what its retry policy is there to absorb."""
        return self._hit("drop")

    def wrong_mac(self) -> bool:
        """True when an outbound auth proof should be corrupted, so the
        peer's HMAC verify fails deterministically (scope "auth")."""
        return self._hit("wrong_mac")

    def expired(self) -> bool:
        """True when an outbound auth proof should be aged out: a blank
        challenge / stale timestamp that misses the peer's freshness
        window (scope "auth")."""
        return self._hit("expired")

    def value(self, action: str, fallback: float = 0.0) -> float:
        """The configured magnitude for a value action (delay_ms,
        degrade_link, degrade_factor, link_stalls, ...), or `fallback`
        when the spec doesn't set it. Mirrors the native
        ScopedFaults::value — the ici_link scope reads degrade_link
        with fallback -1 ("no edge degraded") and degrade_factor with
        fallback 1.0 ("full rate")."""
        return self._actions.get(action, fallback)

    def counters(self) -> dict[str, int]:
        """{action: times injected} — merged into transport stats under
        a `fault_` prefix so chaos runs are visible in dyno_self_*."""
        with self._lock:
            return dict(self._counts)


# One injector per process, parsed lazily from the env so every client
# in a process shares counters and the deterministic decision streams.
_lock = threading.Lock()
_injector: dict[str, ScopedFaults] | None = None
_spec_seen: str | None = None


def for_scope(name: str) -> ScopedFaults | None:
    """The process-wide ScopedFaults for `name`, or None when no faults
    are configured for it (the common case — callers cache the result
    and skip all fault logic on None)."""
    global _injector, _spec_seen
    spec = os.environ.get(ENV_VAR, "")
    with _lock:
        if _injector is None or spec != _spec_seen:
            scopes, seed = parse_spec(spec) if spec else ({}, 0)
            _injector = {
                scope: ScopedFaults(scope, actions, seed)
                for scope, actions in scopes.items()
            }
            _spec_seen = spec
            if _injector:
                log.warning("faultline active: %s", spec)
        return _injector.get(name)


def reset() -> None:
    """Forget the parsed env (tests re-point DYNOLOG_TPU_FAULTS and need
    fresh, re-seeded decision streams)."""
    global _injector, _spec_seen
    with _lock:
        _injector = None
        _spec_seen = None
