"""The port's async RPC engine sends the reference's bytes.

`fan_out`, `AsyncDynoClient` (every `DynoClient` verb) and the
`Subscription` session run against stub daemons that record each
request's raw frame and answer in the daemon's framing; the port and
the JAX package's `dynolog_tpu/utils/rpc.py` must put identical bytes
on the wire and come back with identical records and session state.
One case runs `fan_out` against two real daemons, one of them dead.
"""

import json
import shutil
import socket
import sys
import tempfile
import threading
import time

import pytest

from dynolog_tpu.utils import rpc as ref_rpc
from dynolog_tpu_torch.fleet import minifleet
from dynolog_tpu_torch.utils import rpc as port_rpc

MODS = (("ref", ref_rpc), ("port", port_rpc))


def _frame(obj) -> bytes:
    body = json.dumps(obj).encode()
    return len(body).to_bytes(4, sys.byteorder) + body


class StubDaemon:
    """One-thread TCP server in the daemon's framing. Each connection:
    read one request frame, record its raw bytes, send the frames
    ``reply(request, n)`` returns (n counts connections from 0), close.
    A reply of None sends nothing and holds the connection until close."""

    def __init__(self, reply):
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self.raw: list[bytes] = []
        self._reply = reply
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _read(self, conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    def _serve(self):
        # accept() polls: closing the socket from another thread does
        # not wake a blocked accept on Linux.
        self._srv.settimeout(0.05)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(5)
                try:
                    hdr = self._read(conn, 4)
                    body = self._read(
                        conn, int.from_bytes(hdr, sys.byteorder))
                except (OSError, ConnectionError):
                    continue
                self.raw.append(hdr + body)
                frames = self._reply(json.loads(body), len(self.raw) - 1)
                if frames is None:
                    self._stop.wait(10)
                    continue
                try:
                    for f in frames:
                        conn.sendall(f if isinstance(f, bytes)
                                     else _frame(f))
                except OSError:
                    pass  # the client hung up mid-replay (a resubscribe)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self._srv.close()
        assert not self._thread.is_alive()


@pytest.fixture
def stubs():
    made = []

    def make(reply):
        s = StubDaemon(reply)
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()


def _strip(records):
    """fan_out records without the wall-clock and exception objects."""
    return [{k: v for k, v in r.items()
             if k not in ("elapsed_s", "exception")} for r in records]


def test_fan_out_sends_reference_bytes(stubs):
    requests = [
        {"fn": "setOnDemandTraceRequest", "config": json.dumps(
            {"type": "xplane", "log_dir": "/t", "duration_ms": 500}),
         "job_id": "42", "pids": [], "process_limit": 3},
        {"fn": "batch", "client_id": "fleetstatus", "requests": [
            {"fn": "getAggregates", "windows_s": [300],
             "include_sketches": True}, {"fn": "getStatus"}]},
        {"fn": "getEvents", "since_seq": 7, "limit": 256,
         "note": "ü ✓"},
    ]
    raw, out = {}, {}
    for name, mod in MODS:
        servers = [stubs(lambda req, n: [{"echo": req["fn"], "n": n}])
                   for _ in requests]
        out[name] = _strip(mod.fan_out(
            [("127.0.0.1", s.port, r) for s, r in zip(servers, requests)],
            timeout=5))
        raw[name] = [s.raw for s in servers]
    assert raw["port"] == raw["ref"]
    assert [len(r) for r in raw["port"]] == [1, 1, 1]
    assert out["port"] == out["ref"]
    assert [r["response"]["echo"] for r in out["port"]] == [
        "setOnDemandTraceRequest", "batch", "getEvents"]


def test_fan_out_failure_records_match_reference(stubs):
    """Refused, silent and garbled peers fail with the reference's
    records, retries included; a slow-start sweep over many calls keeps
    input order."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    out = {}
    for name, mod in MODS:
        silent = stubs(lambda req, n: None)
        garbled = stubs(lambda req, n: [(1 << 30).to_bytes(4, sys.byteorder)])
        ok = stubs(lambda req, n: [{"n": n}])
        calls = [("127.0.0.1", dead_port, {"fn": "getStatus"}),
                 ("127.0.0.1", silent.port, {"fn": "getStatus"}),
                 ("127.0.0.1", garbled.port, {"fn": "getStatus"})]
        calls += [("127.0.0.1", ok.port, {"fn": "getStatus", "i": i})
                  for i in range(3)]
        recs = mod.fan_out(calls, timeout=0.3, retry=mod.RetryPolicy(
            attempts=2, backoff_s=0.01), parallelism=2)
        out[name] = (_strip(recs), len(ok.raw), len(garbled.raw))
    assert out["port"] == out["ref"]
    recs = out["port"][0]
    assert [r["ok"] for r in recs] == [False] * 3 + [True] * 3
    assert recs[0]["error"].startswith("ConnectionRefusedError")
    assert recs[1]["error"] == (
        "TimeoutError: frame read exceeded total deadline")
    assert recs[2]["error"].startswith("ValueError: bad frame length")
    assert [r["attempts"] for r in recs] == [2, 2, 2, 1, 1, 1]


_VERBS = [
    ("status", (), {}),
    ("auth_challenge", (), {}),
    ("batch", ([{"fn": "getStatus"}, {"fn": "getPhases", "n": 3}],), {}),
    ("version", (), {}),
    ("set_trace_config", ("42", {"type": "xplane", "log_dir": "/t"}),
     {"pids": [7], "process_limit": 2}),
    ("tpu_status", (), {}),
    ("trace_registry", (), {}),
    ("get_history", (60,), {"key": "hbm_util_pct.dev0"}),
    ("get_history", (), {"since_ms": 10, "until_ms": 20, "key": "k",
                         "tier": 60}),
    ("get_hot_processes", (5,), {"stacks": 2, "branches": 1}),
    ("get_phases", (7,), {}),
    ("get_metric_catalog", (), {}),
    ("get_aggregates", ([60, 300], "tensorcore", True), {}),
    ("get_events", (5, 10), {"tenant": "t"}),
    ("get_captures", (), {}),
    ("put_history", ("k", [(1, 2), (3, 4.5)]), {}),
    ("tpu_pause", (30,), {}),
    ("tpu_resume", (), {}),
    ("self_telemetry", (), {}),
    ("list_trace_artifacts", (), {}),
    ("get_trace_artifact", ("/t/h_1/streamed.pt.trace.json", 5, 100), {}),
    ("export_retro", ("/d",), {}),
    ("fleet_status", (60, 2.5), {}),
    ("fleet_aggregates", (), {}),
    ("fleet_trace", ('{"type": "xplane"}', "j", [1], 2), {}),
    ("list_fleet_artifacts", (), {}),
    ("get_fleet_artifact", ("n:1", "/p", 1, 2), {}),
    ("relay_register", ("n:1", 3), {}),
    ("relay_report", ("n:1", 3, [{"host": "a"}]), {"stale": [{"host": "b"}]}),
    ("emit_event", ("detail",), {"metric": "m", "value": 1.5,
                                 "tenant": "t"}),
]


@pytest.mark.parametrize("verb,args,kwargs", _VERBS,
                         ids=[f"{v[0]}{i}" for i, v in enumerate(_VERBS)])
def test_every_verb_sends_reference_bytes(stubs, verb, args, kwargs):
    """Each DynoClient verb, sync and through the fan_out engine, puts
    the reference's request on the wire and returns its reply."""
    reply = {"status": "ok", "version": "x"}
    raw = {}
    for name, mod in MODS:
        for cls in ("DynoClient", "AsyncDynoClient"):
            stub = stubs(lambda req, n: [reply])
            client = getattr(mod, cls)(port=stub.port, timeout=5,
                                       client_id="tool")
            got = getattr(client, verb)(*args, **kwargs)
            assert got == ("x" if verb == "version" else reply)
            raw[name, cls] = stub.raw
    assert len(raw["ref", "DynoClient"]) == 1
    assert {tuple(v) for v in raw.values()} == {
        tuple(raw["ref", "DynoClient"])}


def test_every_reference_verb_is_ported():
    public = {n for n in dir(ref_rpc.DynoClient) if not n.startswith("_")}
    assert public <= set(dir(port_rpc.DynoClient))
    assert public - {"call", "subscribe"} <= {v[0] for v in _VERBS}


def test_signed_calls_send_reference_bytes(stubs, monkeypatch):
    """Challenge-signed writes and timestamp-signed reads: the probe
    and the proof match the reference."""
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.5)

    def reply(req, n):
        if req["fn"] == "authChallenge":
            return [{"auth_enabled": True, "challenge": f"nonce{n}"}]
        return [{"status": "ok"}]

    raw = {}
    for name, mod in MODS:
        stub = stubs(reply)
        auth = dict(port=stub.port, timeout=5, token="secret",
                    tenant="team", sign_reads=True, client_id="tool")
        # Writes re-sign per attempt outside the fan_out engine; reads
        # carry a timestamp proof on the blocking client.
        mod.AsyncDynoClient(**auth).set_trace_config("42", {"type": "xplane"})
        reader = mod.DynoClient(**auth)
        reader.status()
        reader.status()  # strictly increasing ts within one ms
        raw[name] = stub.raw
    assert raw["port"] == raw["ref"]
    fns = [json.loads(r[4:])["fn"] for r in raw["port"]]
    assert fns == ["authChallenge", "setOnDemandTraceRequest",
                   "getStatus", "getStatus"]
    auth = [json.loads(r[4:]).get("auth", {}) for r in raw["port"]]
    assert auth[1]["challenge"] == "nonce0"
    assert auth[3]["ts_ms"] == auth[2]["ts_ms"] + 1


def _sub_reply(epochs, storage=False):
    """A subscribe endpoint: each connection acks with the next epoch
    from ``epochs``, then replays a delta, a gap, a ping and caught_up."""
    def reply(req, n):
        ack = {"status": "ok", "node": "a:1", "instance_epoch": epochs[n],
               "storage": storage}
        return [ack,
                {"push": "delta", "node": "a:1", "next_seq": 10 + n,
                 "events": [{"seq": 9 + n}]},
                {"push": "gap", "node": "b:1", "to_seq": 20},
                {"push": "ping"},
                {"push": "caught_up", "node": "a:1", "next_seq": 12 + n}]
    return reply


def _session_state(sub):
    return {"ack": sub.ack, "node": sub.node, "epoch": sub.epoch,
            "storage": sub.storage, "cursors": dict(sub.cursors),
            "caught_up": sorted(sub.caught_up),
            "restarted": sub.restarted}


def test_subscription_session_matches_reference(stubs):
    """Handshake bytes, cursor bookkeeping, the reconnect that offers
    cursors, and the storage-less restart that resets them."""
    out = {}
    for name, mod in MODS:
        stub = stubs(_sub_reply([5, 5, 6, 6]))
        client = mod.DynoClient(port=stub.port, timeout=5, client_id="t")
        sub = client.subscribe(
            events=True, aggregates=True, event_types=["watch_fired"],
            min_severity="warning", metrics=["hbm_util_pct"], window_s=60,
            scope="fleet", tenant="team", since_seq=3,
            cursors={"c:1": 4})
        frames = [sub.recv(timeout=5) for _ in range(4)]
        first = _session_state(sub)
        sub.open()  # same epoch: a plain resume from the cursors
        resumed = _session_state(sub)
        sub.open()  # epoch 5 -> 6 with no storage: cursors reset
        restarted = _session_state(sub)
        sub.close()
        out[name] = (stub.raw, frames, first, resumed, restarted)
    assert out["port"] == out["ref"]
    raw, frames, first, resumed, restarted = out["port"]
    req = [json.loads(r[4:]) for r in raw]
    assert req[0]["cursors"] == {"c:1": 4} and "since_seq" not in req[0]
    assert first["cursors"] == {"c:1": 4, "a:1": 12, "b:1": 21}
    assert resumed["restarted"] is False
    assert restarted["restarted"] is True and req[3]["since_seq"] == 0
    assert "cursors" not in req[3]


def test_subscription_follow_reconnects_like_reference(stubs):
    out = {}
    for name, mod in MODS:
        stub = stubs(_sub_reply([7, 7, 7], storage=True))
        sub = mod.Subscription(
            mod.DynoClient(port=stub.port, timeout=5),
            {"fn": "ignored", "events": True}, connect=False)
        got = []
        for frame in sub.follow(idle_timeout=2.0):
            got.append(frame)
            if len(got) == 6:  # three frames a session, pings swallowed
                break
        sub.close()
        out[name] = (stub.raw, got, _session_state(sub))
    assert out["port"] == out["ref"]
    assert [f["push"] for f in out["port"][1]] == [
        "delta", "gap", "caught_up"] * 2


def test_subscribe_unsupported_raises_port_error(stubs):
    stub = stubs(lambda req, n: [{"status": "error",
                                  "error": "unknown fn: subscribe"}])
    with pytest.raises(port_rpc.SubscribeUnsupported):
        port_rpc.DynoClient(port=stub.port, timeout=5).subscribe()
    busy = stubs(lambda req, n: [{"status": "busy", "error": "limit"}])
    with pytest.raises(ConnectionError, match="daemon busy"):
        port_rpc.DynoClient(port=busy.port, timeout=5).subscribe()


def test_fan_out_two_real_daemons_one_dead(daemon_bin, fixture_root,
                                           monkeypatch):
    # A short socket dir: AF_UNIX paths stay under 108 bytes.
    sock_dir = tempfile.mkdtemp(prefix="dtfan")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", sock_dir)
    daemons = minifleet.spawn_daemons(
        daemon_bin, 2, "dtfan",
        daemon_args=("--procfs_root", str(fixture_root)))
    try:
        minifleet.kill_daemon(daemons, 1)
        calls = [("localhost", port, {"fn": "batch", "requests": [
            {"fn": "getStatus"}, {"fn": "getVersion"}]})
            for _, port in daemons]
        recs = port_rpc.fan_out(calls, timeout=3, retry=port_rpc.RetryPolicy(
            attempts=2, backoff_s=0.05))
        assert recs[0]["ok"] and recs[0]["attempts"] == 1
        replies = recs[0]["response"]["replies"]
        assert "registered_processes" in replies[0]
        assert replies[1]["version"]
        assert not recs[1]["ok"] and recs[1]["attempts"] == 2
        assert "ConnectionRefusedError" in recs[1]["error"]
        live = port_rpc.AsyncDynoClient(port=daemons[0][1], timeout=3)
        assert live.version() == replies[1]["version"]
        with pytest.raises(ConnectionRefusedError):
            port_rpc.AsyncDynoClient(port=daemons[1][1], timeout=3).status()
    finally:
        minifleet.teardown(daemons, [])
        shutil.rmtree(sock_dir, ignore_errors=True)


def test_signed_writes_and_sweep_against_an_auth_daemon(
        daemon_bin, fixture_root, tmp_path, monkeypatch):
    """A daemon with a token file (minifleet's token helpers) refuses
    the port's unsigned write, lands its signed one, and the port's
    fleetstatus sweep scores the injected series."""
    from dynolog_tpu_torch.fleet import fleetstatus

    sock_dir = tempfile.mkdtemp(prefix="dtauth")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", sock_dir)
    tokens = minifleet.write_token_file(
        tmp_path / "fleet.tokens",
        [("fleetsecret", "fleet", "admin"), ("alpha-token", "alpha")])
    daemons = minifleet.spawn_daemons(
        daemon_bin, 1, "dtauth",
        daemon_args=("--procfs_root", str(fixture_root),
                     "--enable_history_injection",
                     *minifleet.auth_args(tokens)))
    try:
        port = daemons[0][1]
        now_ms = int(time.time() * 1000)
        samples = [(now_ms - (30 - k) * 1000, 50.0 + k % 3)
                   for k in range(30)]
        key = "tensorcore_duty_cycle_pct.dev0"
        refused = port_rpc.AsyncDynoClient(port=port).put_history(
            key, samples)
        assert refused["error"] == "auth_required"
        signed = port_rpc.AsyncDynoClient(
            port=port, token="alpha-token", tenant="alpha")
        assert signed.put_history(key, samples).get("added"), "not landed"
        verdict = fleetstatus.sweep([f"localhost:{port}"], window_s=60)
        assert verdict["unreachable"] == []
        duty = verdict["metrics"]["tensorcore_duty_cycle_pct"]
        assert duty["values"] == {f"localhost:{port}": 51.0}
        assert verdict["quantile_sources"] == {
            f"localhost:{port}": "sketch"}
    finally:
        minifleet.teardown(daemons, [])
        shutil.rmtree(sock_dir, ignore_errors=True)
