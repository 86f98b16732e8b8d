"""TCP JSON-RPC client for dynolog_tpu_daemon (the port's copy of
``dynolog_tpu/utils/rpc.py``: every verb, the subscription session and
the async fleet fan-out, sending the reference's request bytes).

Wire protocol (identical to the reference daemon/CLI so tooling ports 1:1;
reference: dynolog/src/rpc/SimpleJsonServer.cpp:124-189,
cli/src/commands/utils.rs:12-35): native-endian int32 length prefix followed
by UTF-8 JSON, one request per connection.
"""

from __future__ import annotations

import dataclasses
import errno as errno_mod
import hashlib
import hmac as hmac_mod
import json
import os
import random
import selectors
import socket
import struct
import time

from . import faultline

DEFAULT_PORT = 1778

# Mirror of rpc/Verbs.h isWriteLaneVerb: the verbs an auth-enabled daemon
# (--fleet_token_file) refuses without an HMAC proof. Must stay in
# lockstep with the native classifier.
_WRITE_VERBS = frozenset({
    "setOnDemandTraceRequest", "setKinetOnDemandRequest", "fleetTrace",
    "relayRegister", "relayReport", "putHistory", "tpumonPause",
    "tpumonResume", "dcgmProfPause", "dcgmProfResume", "exportRetro",
    # Not writes, but sharing the write lane's auth posture: subscribe
    # registers long-lived server state (counted against tenant quota at
    # registration), emitEvent injects journal entries (test-gated).
    "subscribe", "emitEvent",
})


def sign_request(request: dict, tenant: str, token: str,
                 challenge: str) -> None:
    """Attaches the challenge-mode HMAC proof for request["fn"] in place
    (wire format: rpc/FleetAuth.h — mac = HMAC-SHA256(token,
    "ch|<fn>|<challenge>") hex). Module-level so tests can forge proofs
    without a client instance."""
    fn = request["fn"]
    mac = hmac_mod.new(
        token.encode("utf-8"), f"ch|{fn}|{challenge}".encode("utf-8"),
        hashlib.sha256).hexdigest()
    request["auth"] = {"tenant": tenant, "challenge": challenge, "mac": mac}


def sign_request_ts(request: dict, tenant: str, token: str,
                    node: str, ts_ms: int) -> None:
    """Attaches the timestamp-mode HMAC proof in place (mac =
    HMAC-SHA256(token, "ts|<fn>|<ts_ms>|<node>") hex). One RPC instead
    of challenge+RPC; the daemon enforces a ±freshness window and
    strictly-increasing ts_ms per (tenant, node), so callers must hand
    in a monotonic ts_ms."""
    fn = request["fn"]
    mac = hmac_mod.new(
        token.encode("utf-8"),
        f"ts|{fn}|{ts_ms}|{node}".encode("utf-8"),
        hashlib.sha256).hexdigest()
    request["auth"] = {
        "tenant": tenant, "ts_ms": ts_ms, "node": node, "mac": mac}

# Mirror of the daemon's frame cap: a confused/hostile peer claiming
# gigabytes must not make the client allocate them.
MAX_FRAME = 1 << 24


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("@i", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int,
                deadline: float | None = None) -> bytes:
    """Receives exactly n bytes. The socket timeout alone is reset by
    every received byte, so a trickling peer could hold the caller (a
    fleet fan-out worker) far past it; `deadline` (time.monotonic())
    bounds the TOTAL."""
    buf = b""
    saved_timeout = sock.gettimeout()
    try:
        while len(buf) < n:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("frame read exceeded total deadline")
                sock.settimeout(remaining)
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed mid-frame")
            buf += chunk
    finally:
        # The shrinking per-chunk timeouts are an implementation detail
        # of THIS read; a caller reusing the socket must see its own
        # configured timeout, not whatever sliver was left here.
        sock.settimeout(saved_timeout)
    return buf


def _recv_frame(sock: socket.socket) -> bytes:
    # Deadlines derive from the socket's configured timeout (None =
    # wait forever, test hooks). The payload gets a FRESH size-scaled
    # deadline once its length is known — mirroring the daemon's
    # frameDeadline (SimpleJsonServer.cpp): a large reply that was slow
    # to compute must not inherit a nearly-spent header window, while a
    # trickling peer stays bounded by base + ~1 ms/KB.
    timeout = sock.gettimeout()

    def _deadline(nbytes: int) -> float | None:
        if timeout is None:
            return None
        return time.monotonic() + timeout + nbytes / (1024 * 1000)

    (length,) = struct.unpack("@i", _recv_exact(sock, 4, _deadline(0)))
    if length < 0 or length > MAX_FRAME:
        raise ValueError(f"bad frame length {length}")
    return _recv_exact(sock, length, _deadline(length))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries for one RPC call (one-call-per-connection wire
    protocol makes every attempt independent, so retrying is safe for
    reads and idempotent for the daemon's set-verbs — re-staging the
    same pending config is a no-op or an explicit 'busy' reply).

    attempts:    total tries including the first (1 = no retry).
    backoff_s:   sleep before retry k is backoff_s * multiplier**(k-1),
                 jittered by ±(jitter * 100)% so a fleet fan-out's
                 retries don't re-converge on a recovering daemon.
    deadline_s:  total wall-clock budget across attempts and sleeps;
                 None = bounded only by attempts * timeout.
    """

    attempts: int = 3
    backoff_s: float = 0.25
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: float | None = None

    def sleep_before(self, attempt: int) -> float:
        # attempt is 1-based: the sleep preceding the (attempt+1)-th try.
        base = self.backoff_s * (self.multiplier ** (attempt - 1))
        return base * random.uniform(1 - self.jitter, 1 + self.jitter)


# What a retry may swallow: connection-level failures and torn/garbled
# frames (ValueError = bad length prefix). Anything else — bad JSON in a
# complete frame aside, which json raises as ValueError too — is a
# programming error and propagates immediately.
_RETRYABLE = (OSError, ConnectionError, TimeoutError, ValueError)


class DynoClient:
    """One RPC call per connection, like the dyno CLI."""

    def __init__(self, host: str = "localhost", port: int = DEFAULT_PORT,
                 timeout: float = 10.0, retry: RetryPolicy | None = None,
                 client_id: str | None = None,
                 token: str | None = None, tenant: str | None = None,
                 sign_reads: bool = False):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retry = retry or RetryPolicy(attempts=1)
        # Stamped into every request so the daemon's per-client admission
        # control (--rpc_client_rate) buckets by logical caller instead of
        # peer address — many tools behind one NAT'd host stay distinct,
        # and one tool across many connections stays one bucket.
        self.client_id = client_id
        # Multi-tenant identity (--fleet_token_file on the daemon): with
        # both set, write verbs fetch a single-use challenge and carry an
        # HMAC proof. Unset = open-fleet behavior, byte-identical wire
        # traffic. An auth-enabled daemon answers an unsigned write with
        # a structured {"error": "auth_required"} — never a silent hang.
        self.token = token
        self.tenant = tenant
        # Reads MAY carry a proof (writes MUST): sign_reads attaches a
        # one-RPC timestamp-mode proof to read verbs so the daemon can
        # attribute them to this tenant's quota bucket and per-tenant
        # served/shed counters instead of the anonymous pool.
        self.sign_reads = sign_reads
        self._last_ts = 0
        # Attempts consumed by the most recent call() — fleet fan-out
        # reads this into its per-host outcome records.
        self.last_attempts = 0
        self._faults = faultline.for_scope("rpc")
        self._auth_faults = faultline.for_scope("auth")

    def _call_once(self, request: dict) -> dict:
        if self._faults is not None:
            self._faults.maybe_delay()
            if self._faults.drop():
                # Simulated blackhole: the connection never happens.
                raise ConnectionError("faultline: rpc connection dropped")
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ) as sock:
            _send_frame(sock, json.dumps(request).encode("utf-8"))
            return json.loads(_recv_frame(sock).decode("utf-8"))

    def _attach_auth(self, request: dict) -> None:
        """Signs a write-verb request for an auth-enabled daemon: fetch
        a single-use challenge, attach the HMAC proof. Must run per
        ATTEMPT, not per call — the daemon burns the nonce whether the
        verify succeeds or fails, so a retried request needs a fresh one.
        No token/tenant configured, or an open/old daemon answering the
        challenge probe: the request goes out unsigned (the open-fleet
        wire shape, byte-identical to pre-auth clients)."""
        request.pop("auth", None)
        if self.token is None or self.tenant is None:
            return
        if request["fn"] not in _WRITE_VERBS:
            if not self.sign_reads or request["fn"] == "authChallenge":
                return
            # Timestamp mode for reads: no challenge round-trip, just a
            # strictly-increasing ts per (tenant, node). max() keeps the
            # sequence monotonic even when attempts land within 1 ms.
            self._last_ts = max(int(time.time() * 1000), self._last_ts + 1)
            node = self.client_id or f"py-{os.getpid()}"
            ts_ms = self._last_ts
            if self._auth_faults is not None and self._auth_faults.expired():
                ts_ms -= 10 * 60 * 1000  # aged past the freshness window
            sign_request_ts(request, self.tenant, self.token, node, ts_ms)
            if (self._auth_faults is not None
                    and self._auth_faults.wrong_mac()):
                mac = request["auth"]["mac"]
                request["auth"]["mac"] = (
                    ("1" if mac[0] == "0" else "0") + mac[1:])
            return
        try:
            probe = self._call_once({"fn": "authChallenge"})
        except _RETRYABLE:
            return  # unsigned; the write itself surfaces the real error
        if not probe.get("auth_enabled") or "challenge" not in probe:
            return
        challenge = probe["challenge"]
        if self._auth_faults is not None:
            self._auth_faults.maybe_delay()
            if self._auth_faults.expired():
                # A nonce the daemon never issued == one that expired.
                challenge = "0" * len(challenge)
        sign_request(request, self.tenant, self.token, challenge)
        if self._auth_faults is not None and self._auth_faults.wrong_mac():
            mac = request["auth"]["mac"]
            request["auth"]["mac"] = (
                ("1" if mac[0] == "0" else "0") + mac[1:])

    def call(self, fn: str, **kwargs) -> dict:
        request = {"fn": fn, **kwargs}
        if self.client_id is not None and "client_id" not in request:
            request["client_id"] = self.client_id
        policy = self.retry
        deadline = (time.monotonic() + policy.deadline_s
                    if policy.deadline_s is not None else None)
        attempt = 0
        while True:
            attempt += 1
            self.last_attempts = attempt
            try:
                self._attach_auth(request)
                return self._call_once(request)
            except _RETRYABLE:
                if attempt >= policy.attempts:
                    raise
                wait = policy.sleep_before(attempt)
                if deadline is not None and (
                        time.monotonic() + wait >= deadline):
                    raise  # out of budget: surface the real error
                time.sleep(wait)

    # Convenience wrappers mirroring the CLI verbs.
    def status(self) -> dict:
        return self.call("getStatus")

    def auth_challenge(self) -> dict:
        """Probes the daemon's auth posture: `auth_enabled` plus a
        single-use challenge nonce when auth is on. `_attach_auth` uses
        the raw verb internally (a probe must not recurse into signing);
        this wrapper is the public surface for tooling that wants to
        know before it writes."""
        return self.call("authChallenge")

    def batch(self, requests: list[dict]) -> dict:
        """Several read verbs over ONE connection: the daemon dispatches
        each `{"fn": ..., ...}` sub-request in order and returns
        `{"status": "ok", "count": n, "replies": [...]}` with replies
        aligned to the input. Write/actuation verbs are refused per-slot
        (they ride the serialized write lane, one connection each), and
        the whole batch costs a single admission token — the intended
        shape for scrapers that used to dial N times per sweep."""
        return self.call("batch", requests=list(requests))

    def version(self) -> str:
        return self.call("getVersion")["version"]

    def set_trace_config(
        self,
        job_id: str,
        config: dict | str,
        pids: list[int] | None = None,
        process_limit: int = 3,
    ) -> dict:
        if isinstance(config, dict):
            config = json.dumps(config)
        return self.call(
            "setOnDemandTraceRequest",
            config=config,
            job_id=str(job_id),
            pids=pids or [],
            process_limit=process_limit,
        )

    def tpu_status(self) -> dict:
        return self.call("getTpuStatus")

    def trace_registry(self) -> dict:
        return self.call("getTraceRegistry")

    def get_history(self, window_s: int = 300,
                    key: str | None = None,
                    since_ms: int | None = None,
                    until_ms: int | None = None,
                    tier: str | int | None = None) -> dict:
        """Windowed stats for every in-memory metric series; with `key`,
        the raw (ts_ms, value) samples for that one series too.

        Range mode: `since_ms` (epoch ms; optional `until_ms`) replaces
        the relative window and reaches through the durable tier, so
        pre-restart history resolves. `tier` ("raw", 60, 300) selects one
        durable-storage tier verbatim — requires `key` and a daemon with
        --storage_dir."""
        if since_ms is not None:
            req = {"since_ms": int(since_ms)}
            if until_ms is not None:
                req["until_ms"] = int(until_ms)
        else:
            req = {"window_s": window_s}
        if key is not None:
            req["key"] = key
        if tier is not None:
            req["tier"] = str(tier)
        return self.call("getHistory", **req)

    def get_hot_processes(self, n: int = 10, stacks: int = 0,
                          branches: int = 0) -> dict:
        """`dyno top` data: hottest pids from the profiling sampler,
        optionally with top callchains and LBR call edges."""
        req: dict = {"n": n}
        if stacks:
            req["stacks"] = stacks
        if branches:
            req["branches"] = branches
        return self.call("getHotProcesses", **req)

    def get_phases(self, n: int = 20) -> dict:
        """Per-process nested-phase wall-time attribution from client
        `with client.phase(...)` annotations."""
        return self.call("getPhases", n=n)

    def get_metric_catalog(self) -> dict:
        """Every metric key the daemon can emit, with type/unit/help."""
        return self.call("getMetricCatalog")

    def get_aggregates(self, windows_s: list[int] | None = None,
                       key_prefix: str | None = None,
                       include_sketches: bool = False) -> dict:
        """Windowed in-daemon summaries (count/mean/min/max/p50/p95/p99/
        slope_per_s) for every history series, per requested window
        (daemon defaults when omitted). The fleetstatus sweep's verb.
        include_sketches adds a `sketches` block — per window, each
        series' serialized quantile sketch — so the caller can merge
        true distributions across hosts instead of averaging scalars."""
        req: dict = {}
        if windows_s:
            req["windows_s"] = list(windows_s)
        if key_prefix:
            req["key_prefix"] = key_prefix
        if include_sketches:
            req["include_sketches"] = True
        return self.call("getAggregates", **req)

    def get_events(self, since_seq: int = 0, limit: int = 256,
                   tenant: str | None = None) -> dict:
        """Cursor read of the daemon's event journal: events with
        seq >= since_seq (0 = oldest retained), oldest first, plus
        `next_seq` to feed back for a gapless, duplicate-free resume and
        `dropped` (events evicted by ring wrap before they could be
        served). The `dyno events` / fleet eventlog verb.

        `tenant` narrows the batch to that tenant's events plus
        untenanted infrastructure ones. On an auth-enabled daemon a
        non-admin caller is force-scoped to its own tenant regardless;
        asking for someone else's is a structured error."""
        req: dict = {"since_seq": since_seq, "limit": limit}
        if tenant is not None:
            req["tenant"] = tenant
        return self.call("getEvents", **req)

    def get_captures(self) -> dict:
        """Recent watch-triggered auto-captures (CaptureOrchestrator
        ledger): per firing, the rule, metric value, local trigger
        outcome, and each ring neighbor's staging result. The `dyno
        captures` verb; errors on daemons without a :trace action rule."""
        return self.call("getCaptures")

    def put_history(self, key: str,
                    samples: list[tuple[int, float]]) -> dict:
        """Test-only: inject a known (ts_ms, value) series into the
        daemon's history frame. Requires the daemon to run with
        --enable_history_injection; production daemons refuse it."""
        return self.call(
            "putHistory", key=key,
            samples=[[int(ts), float(v)] for ts, v in samples])

    def tpu_pause(self, duration_s: int = 300) -> dict:
        """Pause chip telemetry while an external profiler owns the
        performance counters; auto-resumes after duration_s."""
        return self.call("tpumonPause", duration_s=duration_s)

    def tpu_resume(self) -> dict:
        return self.call("tpumonResume")

    def self_telemetry(self) -> dict:
        """The daemon observing itself: per-collector tick costs
        (TickStats) merged with control-plane counters (RPC frames, IPC
        pokes/manifests, trace deliveries and GC drops — SelfStats)."""
        return self.call("getSelfTelemetry")

    def list_trace_artifacts(self) -> dict:
        """Committed streamed-upload artifacts (path/bytes/job/pid per
        entry) — the ledger `unitrace --report` pulls from when it has
        no shared filesystem with the daemon."""
        return self.call("listTraceArtifacts")

    def get_trace_artifact(self, path: str, offset: int = 0,
                           limit: int = 1 << 20) -> dict:
        """One chunk of a committed trace artifact, base64 in `data`,
        with `total_bytes` and `eof` for the pull loop."""
        return self.call("getTraceArtifact", path=path,
                         offset=int(offset), limit=int(limit))

    def export_retro(self, dest_dir: str) -> dict:
        """Snapshot the flight-recorder ring into
        <dest_dir>/retro_<host>-<pid>/ (windows + retro_manifest.json).
        The orchestrator fires this automatically on every watch-
        triggered capture; the manual verb exists for `dyno` tooling
        and tests. Errors on daemons without --retro_window_ms."""
        return self.call("exportRetro", dest_dir=dest_dir)

    def fleet_status(self, window_s: int | None = None,
                     z_threshold: float | None = None) -> dict:
        """Subtree-wide straggler verdict from a relay-tree node: the
        fleetstatus sweep shape, reduced in-tree over every relay report
        below this daemon (O(depth), not O(N))."""
        req: dict = {}
        if window_s is not None:
            req["window_s"] = int(window_s)
        if z_threshold is not None:
            req["z_threshold"] = float(z_threshold)
        return self.call("getFleetStatus", **req)

    def fleet_aggregates(self) -> dict:
        """Per-host watchlist scalars + per-metric fleet summaries over
        the relay subtree."""
        return self.call("getFleetAggregates")

    def fleet_trace(self, config: str, job_id: str,
                    pids: list[int] | None = None,
                    process_limit: int = 3) -> dict:
        """Gang-trace the whole subtree below this daemon: the config is
        applied locally and forwarded down every fresh tree edge in
        parallel, so one RPC to the root arms the entire fleet. Returns
        per-host records shaped like the flat trigger results plus
        `triggered`/`total` and the answering node's `root` hint."""
        return self.call("fleetTrace", config=config, job_id=str(job_id),
                         pids=list(pids or []),
                         process_limit=int(process_limit))

    def list_fleet_artifacts(self) -> dict:
        """Union of listTraceArtifacts over the whole subtree, every
        entry tagged with its owning `node`."""
        return self.call("listFleetArtifacts")

    def get_fleet_artifact(self, node: str, path: str, offset: int = 0,
                           limit: int = 1 << 20) -> dict:
        """One chunk of `node`'s committed artifact, proxied through the
        tree edge that owns it — the puller only dials this daemon."""
        return self.call("getFleetArtifact", node=node, path=path,
                         offset=int(offset), limit=int(limit))

    def relay_register(self, node: str, epoch: int) -> dict:
        """Registers `node` as a relay-tree child of this daemon. The
        daemon-to-daemon registration verb (FleetTreeNode sends it
        upward itself); exposed for tests impersonating a child."""
        return self.call("relayRegister", node=node, epoch=int(epoch))

    def relay_report(self, node: str, epoch: int, hosts: list[dict],
                     stale: list[dict] | None = None) -> dict:
        """One subtree report from `node`: pre-reduced host records plus
        staleness the child saw below itself. Daemon-to-daemon like
        relayRegister; a mismatched epoch gets `need_register`."""
        req: dict = {"node": node, "epoch": int(epoch), "hosts": hosts}
        if stale is not None:
            req["stale"] = stale
        return self.call("relayReport", **req)

    def emit_event(self, detail: str, type: str = "injected",
                   source: str = "inject", severity: str = "info",
                   metric: str | None = None, value: float = 0.0,
                   tenant: str | None = None) -> dict:
        """Test-only journal injection (the subscription plane's
        controllable event source): requires a daemon running with
        --enable_history_injection, like put_history."""
        req: dict = {"detail": detail, "type": type, "source": source,
                     "severity": severity}
        if metric is not None:
            req["metric"] = metric
            req["value"] = float(value)
        if tenant is not None:
            req["tenant"] = tenant
        return self.call("emitEvent", **req)

    def subscribe(self, events: bool = True, aggregates: bool = False,
                  event_types: list[str] | None = None,
                  min_severity: str | None = None,
                  metrics: list[str] | None = None,
                  window_s: int | None = None,
                  scope: str | None = None,
                  tenant: str | None = None,
                  since_seq: int | None = None,
                  cursors: dict[str, int] | None = None) -> "Subscription":
        """Opens a live push session (docs/Subscriptions.md): registers
        the filter over one long-lived connection and returns a
        Subscription whose recv()/follow() yield delta/gap/caught_up/
        aggregates frames — the replacement for getEvents polling.
        Raises SubscribeUnsupported against daemons that predate the
        verb so callers can fall back to polling."""
        req: dict = {"events": bool(events), "aggregates": bool(aggregates)}
        if event_types:
            req["event_types"] = list(event_types)
        if min_severity:
            req["min_severity"] = min_severity
        if metrics:
            req["metrics"] = list(metrics)
        if window_s is not None:
            req["window_s"] = int(window_s)
        if scope is not None:
            req["scope"] = scope
        if tenant is not None:
            req["tenant"] = tenant
        if since_seq is not None:
            req["since_seq"] = int(since_seq)
        sub = Subscription(self, req, connect=False)
        if cursors:
            sub.cursors.update({n: int(s) for n, s in cursors.items()})
        sub.open()
        return sub


class SubscribeUnsupported(RuntimeError):
    """The daemon answered `subscribe` with "unknown fn": it predates
    the subscription plane. Callers fall back to getEvents polling —
    the version-skew contract in docs/Subscriptions.md."""


class Subscription:
    """One live push session over the socket the handshake rode in on.

    recv() returns raw push frames while keeping per-node resume
    cursors current (delta -> next_seq, gap -> to_seq+1, caught_up ->
    max). follow() wraps recv() in the reconnect + structured
    resubscribe loop: on any transport failure it redials, re-offering
    the learned cursors so the daemon replays only unseen events. A
    changed ack instance_epoch means the daemon restarted — with a
    durable tier (`storage` true) the cursors still resolve and the
    resume is silent; without one the ring restarted at seq 0, so the
    cursors are reset and a synthetic {"push": "restart"} frame is
    yielded for consumers that need to know (dyno tail prints a
    notice; the eventlog sweep re-baselines its durable cursors).
    """

    def __init__(self, client: DynoClient, filter_req: dict,
                 connect: bool = True):
        self._client = client
        self._filter = dict(filter_req)
        self._sock: socket.socket | None = None
        self._closed = False
        self.ack: dict = {}
        self.node = ""        # answering node id, from the ack
        self.epoch = 0        # ack instance_epoch of the live session
        self.storage = False  # daemon has a non-degraded durable tier
        self.cursors: dict[str, int] = {}  # node -> next_seq resume point
        self.caught_up: set[str] = set()   # nodes seen at the live edge
        self.restarted = False  # last open() crossed a storage-less
        # daemon restart and reset the cursors
        if connect:
            self.open()

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def fileno(self) -> int:
        if self._sock is None:
            raise ConnectionError("subscription is not connected")
        return self._sock.fileno()

    def open(self) -> dict:
        """(Re)connects and performs the subscribe handshake. Learned
        per-node cursors ride the request (and supersede any original
        since_seq) so a resumed session replays only what this client
        has not acknowledged. Returns the ack."""
        self._close_socket()
        self.restarted = False
        # Two passes at most: the second handles the storage-less
        # restart, where the offered cursors reference a dead instance.
        for _ in range(2):
            request = {"fn": "subscribe", **self._filter}
            if self._client.client_id is not None:
                request.setdefault("client_id", self._client.client_id)
            if self.cursors:
                request["cursors"] = {
                    n: int(s) for n, s in self.cursors.items()}
                request.pop("since_seq", None)
            self._client._attach_auth(request)
            sock = socket.create_connection(
                (self._client.host, self._client.port),
                timeout=self._client.timeout)
            try:
                _send_frame(sock, json.dumps(request).encode("utf-8"))
                ack = json.loads(_recv_frame(sock).decode("utf-8"))
            except BaseException:
                sock.close()
                raise
            status = ack.get("status")
            if status != "ok":
                sock.close()
                err = str(ack.get("error", "subscribe failed"))
                if err.startswith("unknown fn"):
                    raise SubscribeUnsupported(err)
                if status == "busy":
                    # Subscriber limit: retryable, follow()'s backoff
                    # (or the caller's) owns the pacing.
                    raise ConnectionError(f"daemon busy: {err}")
                raise RuntimeError(f"subscribe failed: {err}")
            prev_epoch = self.epoch
            self.ack = ack
            self.node = str(ack.get("node", ""))
            self.epoch = int(ack.get("instance_epoch", 0))
            self.storage = bool(ack.get("storage", False))
            if (prev_epoch and self.epoch != prev_epoch
                    and not self.storage and self.cursors):
                # Memory-only daemon restarted: its ring restarted at
                # seq 0 and cannot replay toward our old cursors (the
                # daemon clamps them to its live edge, which would
                # silently skip the new instance's backlog). Resubscribe
                # from the new instance's first event instead.
                sock.close()
                self.cursors.clear()
                self.caught_up.clear()
                self._filter["since_seq"] = 0
                self.restarted = True
                continue
            self._sock = sock
            return ack
        raise ConnectionError("subscribe handshake did not converge")

    def recv(self, timeout: float | None = None) -> dict:
        """Blocks for the next push frame (timeout in seconds; None =
        the client's default). Raises TimeoutError/ConnectionError on a
        dead or silent stream — follow() turns those into reconnects."""
        if self._sock is None:
            raise ConnectionError("subscription is not connected")
        self._sock.settimeout(
            timeout if timeout is not None else self._client.timeout)
        frame = json.loads(_recv_frame(self._sock).decode("utf-8"))
        push = frame.get("push", "")
        node = str(frame.get("node", ""))
        if push == "delta":
            self.cursors[node] = int(frame.get("next_seq", 0))
        elif push == "gap":
            self.cursors[node] = int(frame.get("to_seq", 0)) + 1
        elif push == "caught_up":
            self.cursors[node] = max(
                self.cursors.get(node, 0), int(frame.get("next_seq", 0)))
            self.caught_up.add(node)
        return frame

    def follow(self, idle_timeout: float = 30.0):
        """Yields push frames forever (pings swallowed — they only
        prove liveness), reconnecting with structured resubscribe on
        any transport failure. idle_timeout bounds how long a silent
        stream is trusted; the daemon pings every ~2s, so well before
        this fires the connection is genuinely dead."""
        backoff = 0.2
        while not self._closed:
            if self._sock is None:
                try:
                    self.open()
                except SubscribeUnsupported:
                    raise
                except _RETRYABLE:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 2.0)
                    continue
                backoff = 0.2
                if self.restarted:
                    yield {"push": "restart", "node": self.node,
                           "epoch": self.epoch}
            try:
                frame = self.recv(timeout=idle_timeout)
            except _RETRYABLE:
                self._close_socket()
                continue
            if frame.get("push") == "ping":
                continue
            yield frame

    def _close_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._closed = True
        self._close_socket()

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Async fan-out: one selector-driven event loop replaces the per-tool
# thread pools the fleet CLIs used to spin up. Each in-flight call is a
# small state machine walking the same wire protocol as DynoClient
# (connect -> framed send -> 4-byte length -> size-deadlined payload),
# with the same RetryPolicy semantics — retries are re-queued on a timer
# instead of sleeping a worker thread.

_ST_CONNECT, _ST_SEND, _ST_RECV_LEN, _ST_RECV_BODY = range(4)


class _FanOutCall:
    """State for one (host, port, request) in the fan_out loop."""

    __slots__ = (
        "index", "host", "port", "payload", "policy", "attempt",
        "call_deadline", "state", "sock", "sendbuf", "recvbuf", "want",
        "phase_deadline", "started", "error", "result", "body_len",
    )

    def __init__(self, index: int, host: str, port: int, request: dict,
                 policy: RetryPolicy):
        self.index = index
        self.host = host
        self.port = port
        body = json.dumps(request).encode("utf-8")
        self.payload = struct.pack("@i", len(body)) + body
        self.policy = policy
        self.attempt = 0
        self.call_deadline = (
            time.monotonic() + policy.deadline_s
            if policy.deadline_s is not None else None)
        self.state = _ST_CONNECT
        self.sock: socket.socket | None = None
        self.sendbuf = memoryview(b"")
        self.recvbuf = b""
        self.want = 0
        self.phase_deadline: float | None = None
        self.started = time.monotonic()
        self.error: Exception | None = None
        self.result: dict | None = None
        self.body_len = 0


def fan_out(calls, *, timeout: float = 10.0,
            retry: RetryPolicy | None = None,
            parallelism: int = 64) -> list[dict]:
    """Issues every (host, port, request) concurrently on one thread.

    Returns one record per call, in input order:
      {"ok": True,  "response": dict, "attempts": n, "elapsed_s": t}
      {"ok": False, "error": "Type: msg", "exception": Exception,
       "attempts": n, "elapsed_s": t}

    Deadline discipline mirrors the sync client: connect/send/header
    phases each get `timeout`; the payload gets a fresh size-scaled
    deadline (timeout + bytes/(1024*1000)) once its length is known, so
    a trickling peer cannot hold a sweep open. At most `parallelism`
    sockets are in flight; the rest queue. Retries follow `retry`
    (default: none) with the backoff sleep served by the loop's timer,
    not a blocked thread.
    """
    policy = retry or RetryPolicy(attempts=1)
    records: list[dict | None] = [None] * len(calls)
    if not calls:
        return []
    faults = faultline.for_scope("rpc")
    sel = selectors.DefaultSelector()
    pending = [
        _FanOutCall(i, host, int(port), request, policy)
        for i, (host, port, request) in enumerate(calls)
    ]
    pending.reverse()  # pop() from the tail keeps input order
    active: dict[socket.socket, _FanOutCall] = {}
    restarts: list[tuple[float, _FanOutCall]] = []
    done = 0
    # Slow-start admission for very large sweeps. Opening the full
    # parallelism window of connects in one burst is fine at fleet
    # sizes up to a few hundred, but a >512-host flat-fallback sweep
    # can land hundreds of simultaneous SYNs on daemons that are also
    # serving their own relay children, overflowing listen backlogs.
    # Start with a modest connect burst and double it every loop pass
    # until the full window is in play; smaller sweeps are unaffected.
    burst = min(parallelism, 32) if len(calls) > 512 else parallelism

    def finish(call: _FanOutCall) -> None:
        nonlocal done
        elapsed = time.monotonic() - call.started
        if call.result is not None:
            records[call.index] = {
                "ok": True, "response": call.result,
                "attempts": call.attempt, "elapsed_s": round(elapsed, 3)}
        else:
            err = call.error or ConnectionError("fan_out: no attempt ran")
            records[call.index] = {
                "ok": False,
                "error": f"{type(err).__name__}: {err}",
                "exception": err,
                "attempts": call.attempt, "elapsed_s": round(elapsed, 3)}
        done += 1

    def teardown(call: _FanOutCall) -> None:
        if call.sock is not None:
            try:
                sel.unregister(call.sock)
            except (KeyError, ValueError):
                pass
            active.pop(call.sock, None)
            try:
                call.sock.close()
            except OSError:
                pass
            call.sock = None

    def fail_attempt(call: _FanOutCall, exc: Exception) -> None:
        teardown(call)
        call.error = exc
        if not isinstance(exc, _RETRYABLE) or call.attempt >= policy.attempts:
            finish(call)
            return
        wait = policy.sleep_before(call.attempt)
        now = time.monotonic()
        if call.call_deadline is not None and now + wait >= call.call_deadline:
            finish(call)  # out of budget: surface the real error
            return
        restarts.append((now + wait, call))

    def start_attempt(call: _FanOutCall) -> None:
        call.attempt += 1
        if call.attempt == 1:
            # elapsed_s measures from the first REAL attempt: time spent
            # queued behind the parallelism cap is the caller's batching
            # choice, not this call's latency. Retries still accumulate
            # (the deadline budget spans attempts).
            call.started = time.monotonic()
        if faults is not None:
            # Parity with DynoClient._call_once: the chaos fixture's
            # delay is a test-time pause, so blocking the loop is the
            # intended behavior.
            faults.maybe_delay()
            if faults.drop():
                fail_attempt(call, ConnectionError(
                    "faultline: rpc connection dropped"))
                return
        try:
            infos = socket.getaddrinfo(
                call.host, call.port, type=socket.SOCK_STREAM)
            family, stype, proto, _, addr = infos[0]
            sock = socket.socket(family, stype, proto)
        except OSError as e:
            fail_attempt(call, e)
            return
        sock.setblocking(False)
        call.sock = sock
        call.sendbuf = memoryview(call.payload)
        call.recvbuf = b""
        call.result = None
        call.phase_deadline = time.monotonic() + timeout
        err = sock.connect_ex(addr)
        if err in (0, errno_mod.EINPROGRESS, errno_mod.EWOULDBLOCK):
            call.state = _ST_SEND if err == 0 else _ST_CONNECT
            active[sock] = call
            sel.register(sock, selectors.EVENT_WRITE, call)
        else:
            fail_attempt(call, OSError(err, os.strerror(err)))

    def advance(call: _FanOutCall, events: int) -> None:
        sock = call.sock
        assert sock is not None
        try:
            if call.state == _ST_CONNECT:
                err = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                if err != 0:
                    raise OSError(err, os.strerror(err))
                call.state = _ST_SEND
            if call.state == _ST_SEND:
                while call.sendbuf:
                    try:
                        n = sock.send(call.sendbuf)
                    except BlockingIOError:
                        return
                    call.sendbuf = call.sendbuf[n:]
                call.state = _ST_RECV_LEN
                call.want = 4
                call.recvbuf = b""
                call.phase_deadline = time.monotonic() + timeout
                sel.modify(sock, selectors.EVENT_READ, call)
                return
            # Read states: drain what the kernel has, then reassess.
            while len(call.recvbuf) < call.want:
                try:
                    chunk = sock.recv(call.want - len(call.recvbuf))
                except BlockingIOError:
                    return
                if not chunk:
                    raise ConnectionError("connection closed mid-frame")
                call.recvbuf += chunk
            if call.state == _ST_RECV_LEN:
                (length,) = struct.unpack("@i", call.recvbuf)
                if length < 0 or length > MAX_FRAME:
                    raise ValueError(f"bad frame length {length}")
                call.state = _ST_RECV_BODY
                call.body_len = length
                call.want = length
                call.recvbuf = b""
                # Fresh size-scaled deadline, mirroring _recv_frame.
                call.phase_deadline = (
                    time.monotonic() + timeout + length / (1024 * 1000))
                advance(call, events)  # body bytes may already be queued
                return
            # _ST_RECV_BODY complete.
            call.result = json.loads(call.recvbuf.decode("utf-8"))
            teardown(call)
            finish(call)
        except _RETRYABLE as e:
            fail_attempt(call, e)

    while done < len(records):
        now = time.monotonic()
        due = [c for when, c in restarts if when <= now]
        restarts = [(w, c) for w, c in restarts if w > now]
        pending.extend(reversed(due))
        admit = min(burst, parallelism - len(active))
        while pending and admit > 0:
            start_attempt(pending.pop())
            admit -= 1
        if burst < parallelism:
            burst = min(parallelism, burst * 2)
        if done >= len(records):
            break
        now = time.monotonic()
        wake: list[float] = [w for w, _ in restarts]
        wake.extend(
            c.phase_deadline for c in active.values()
            if c.phase_deadline is not None)
        if not active and not restarts and not pending:
            break  # defensive: nothing can make progress
        wait = max(0.0, min(wake) - now) if wake else 0.1
        for key, events in sel.select(min(wait, 0.5) if wake else 0.1):
            advance(key.data, events)
        now = time.monotonic()
        for call in list(active.values()):
            if call.phase_deadline is not None and now >= call.phase_deadline:
                fail_attempt(call, TimeoutError(
                    "frame read exceeded total deadline"
                    if call.state in (_ST_RECV_LEN, _ST_RECV_BODY)
                    else "connect/send exceeded deadline"))
    sel.close()
    return [r if r is not None else {
        "ok": False, "error": "InternalError: call never completed",
        "exception": RuntimeError("call never completed"),
        "attempts": 0, "elapsed_s": 0.0,
    } for r in records]


class AsyncDynoClient(DynoClient):
    """Drop-in DynoClient whose call() rides the fan_out event loop —
    one code path for single calls and fleet sweeps, so the verb
    wrappers above are exercised by exactly the wire engine the fleet
    tools use."""

    def call(self, fn: str, **kwargs) -> dict:
        request = {"fn": fn, **kwargs}
        if self.client_id is not None and "client_id" not in request:
            request["client_id"] = self.client_id
        needs_auth = (self.token is not None and self.tenant is not None
                      and fn in _WRITE_VERBS)
        if not needs_auth:
            record = fan_out(
                [(self.host, self.port, request)],
                timeout=self.timeout, retry=self.retry)[0]
            self.last_attempts = record["attempts"]
            if not record["ok"]:
                raise record["exception"]
            return record["response"]
        # Signed writes: the daemon burns the challenge nonce whether the
        # verify succeeds or fails, so a fan_out-internal retry would
        # replay a dead proof. Re-sign per attempt out here instead; each
        # fan_out run is a single attempt. The challenge probe rides a
        # plain blocking connection — one tiny pre-flight RPC.
        policy = self.retry
        deadline = (time.monotonic() + policy.deadline_s
                    if policy.deadline_s is not None else None)
        attempt = 0
        while True:
            attempt += 1
            self.last_attempts = attempt
            self._attach_auth(request)
            record = fan_out(
                [(self.host, self.port, request)],
                timeout=self.timeout, retry=RetryPolicy(attempts=1))[0]
            if record["ok"]:
                return record["response"]
            exc = record["exception"]
            if not isinstance(exc, _RETRYABLE) or attempt >= policy.attempts:
                raise exc
            wait = policy.sleep_before(attempt)
            if deadline is not None and time.monotonic() + wait >= deadline:
                raise exc  # out of budget: surface the real error
            time.sleep(wait)
