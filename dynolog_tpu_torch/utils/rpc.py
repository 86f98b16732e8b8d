"""TCP JSON-RPC client for dynolog_tpu_daemon (the port's copy).

Only the single-call ``DynoClient`` with the verbs the trace path uses;
the subscription engine and the async fleet fan-out are not carried yet.

Wire protocol (identical to the reference daemon/CLI so tooling ports 1:1;
reference: dynolog/src/rpc/SimpleJsonServer.cpp:124-189,
cli/src/commands/utils.rs:12-35): native-endian int32 length prefix followed
by UTF-8 JSON, one request per connection.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac as hmac_mod
import json
import os
import random
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
