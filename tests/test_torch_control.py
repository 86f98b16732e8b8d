"""The port's client shim's self-telemetry and control-loop internals,
held to the reference shim given the same input:

  * the dyno_self_* family in the metric push, the spans in the trace
    manifest and the fabric's transport counters (tests/test_spans.py);
  * a 'conf' that arrives outside a poll reply, while the poll loop
    sleeps, is delivered with its base config
    (tests/test_fabric.py:test_shim_wait_loop_recovers_stray_conf);
  * a client's metric push overrides the daemon's presence record
    (tests/test_tpu_discovery.py:test_client_push_overrides_presence_record);
  * record_op_stats' cleaning and the manifest's op_stats and
    phase_spans;
  * the restart epoch bookkeeping and the jittered poll backoff.
"""

import json
import os
import random
import shutil
import socket
import subprocess
import threading
import time

import pytest

from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from torch_control_util import (
    FakeClock,
    QUIET_FLAGS,
    Sent,
    shims,
    short_sock_dir,
    stop_daemon,
    stub_capture,
    wait_for,
)


@pytest.fixture
def sock_dir(monkeypatch):
    d = short_sock_dir(monkeypatch)
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def clients(sock_dir):
    """One unstarted client of each shim, by name."""
    made = {name: cls(job_id="spans") for name, cls in shims()}
    yield made
    for c in made.values():
        c._fabric.close()


def _self_family(rec):
    return {k: v for k, v in rec.items() if k.startswith("dyno_self_")}


def test_push_metrics_carries_dyno_self_family(clients):
    """Span aggregates and the fabric's transport counters ride every
    pushed device record as dyno_self_*, with the reference's keys and
    values; the push itself is recorded for the next one."""
    family = {}
    for name, c in clients.items():
        c.spans.record("poll", 1.0, 1.1, ok=True)
        sent = Sent(c)
        c._push_metrics()
        (tmet,) = sent.datagrams
        body = json.loads(tmet[4:])
        assert tmet[:4] == b"tmet" and body["devices"], name
        recs = [_self_family(r) for r in body["devices"]]
        assert all(r == recs[0] for r in recs), name
        family[name] = recs[0]
        assert "telemetry_push" in [s["name"] for s in c.spans.snapshot()]
    fam = family["torch"]
    assert fam["dyno_self_poll_ms_last"] == 100.0
    assert fam["dyno_self_poll_count"] == 1.0
    assert "dyno_self_fabric_send_total" in fam
    assert "dyno_self_fabric_send_failures" in fam
    assert fam == family["jax"]


def test_trace_manifest_carries_spans(clients, tmp_path):
    """deliver/capture spans derive from trace_timing at manifest time,
    manifest_send is recorded, and a full span ring still fits a
    datagram: the same body as the reference's."""
    bodies = {}
    for name, c in clients.items():
        c.trace_timing = {"config_received": 100.0, "trace_start": 100.2,
                          "trace_stop": 100.7}
        c._last_trace_dir = str(tmp_path)
        sent = Sent(c)
        c._send_trace_manifest()
        assert "manifest_send" in [s["name"] for s in c.spans.snapshot()]
        for i in range(1000):
            c.spans.record("fill", float(i), float(i), ok=True)
        c._send_trace_manifest()
        bodies[name] = [json.loads(d[4:]) for d in sent.of_type("tdir")]
    first, full = bodies["torch"]
    by_name = {s["name"]: s for s in first["spans"]}
    assert by_name["deliver"]["t_start"] == 100.0
    assert by_name["deliver"]["dur_ms"] == pytest.approx(200.0)
    assert by_name["capture"]["dur_ms"] == pytest.approx(500.0)
    assert first["trace_timing"]["trace_stop"] == 100.7
    assert len(full["spans"]) <= 64
    assert len(b"tdir" + json.dumps(full).encode()) < 65536

    def comparable(body):
        # Span stamps of the manifest_send spans are wall clock.
        return {**body, "spans": [
            {k: v for k, v in s.items() if s["name"] == "fill"
             or k not in ("t_start", "t_end", "dur_ms")}
            for s in body["spans"]]}

    assert [comparable(b) for b in bodies["torch"]] == \
        [comparable(b) for b in bodies["jax"]]


def test_fabric_transport_counters(sock_dir):
    """A peer that never replies: a request counts a timeout, sends to a
    bound peer count as sent; the same counters as the reference's
    FabricClient."""
    from dynolog_tpu.client.fabric import FabricClient as RefFabric
    from dynolog_tpu_torch.client.fabric import FabricClient

    peer = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    peer.bind(os.path.join(sock_dir, "mutedaemon"))
    stats = {}
    try:
        for name, cls in (("torch", FabricClient), ("jax", RefFabric)):
            c = cls(daemon_socket="mutedaemon")
            try:
                assert c.send("tmet", {"job_id": "1", "pid": 1}) is True
                assert c.request("poll", {"job_id": "1", "pid": 1},
                                 timeout_s=0.05) is None
                stats[name] = c.stats()
            finally:
                c.close()
    finally:
        peer.close()
    st = stats["torch"]
    assert st["fabric_send_total"] == 2  # the send and the request's
    assert st["fabric_send_failures"] == 0
    assert st["fabric_requests_total"] == 1
    assert st["fabric_request_timeouts"] == 1
    assert st == stats["jax"]


class _PollAnswerer:
    """The daemon side of the fabric, on its own thread: answers every
    poll with a 'conf' that holds no config and the current base config,
    as the daemon does, and remembers the client's address."""

    def __init__(self, sock_dir, name):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.sock.bind(os.path.join(sock_dir, name))
        self.sock.settimeout(0.1)
        self.addr = None
        self.polls = 0
        self.base = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except OSError:
                continue
            if data[:4] == b"poll":
                self.sock.sendto(b"conf" + json.dumps(
                    {"config": "", "base_config": self.base}).encode(), addr)
                self.addr = addr
                self.polls += 1

    def send_stray(self, config, base):
        """A one-shot config outside any poll reply, with the base config
        that later poll replies carry too."""
        self.base = base
        self.sock.sendto(b"conf" + json.dumps(
            {"config": config, "base_config": base}).encode(), self.addr)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close()


def test_shim_wait_loop_recovers_stray_conf(sock_dir):
    """A one-shot 'conf' handed to the client while its poll loop sleeps
    out a 5 s interval (the late-reply / poke-window shape) is
    delivered, with the base config riding the same datagram applied
    first: the same merged config from both shims."""
    got = {}
    for name, cls in shims():
        peer = _PollAnswerer(sock_dir, f"peer_{name}")
        c = cls(job_id="stray", daemon_socket=f"peer_{name}",
                poll_interval_s=5.0, metrics_interval_s=3600)
        got[name] = stub_capture(c)
        try:
            c.start()
            wait_for(lambda: peer.polls >= 1, 5, "the first poll")
            time.sleep(0.2)  # inside the 5 s wait
            peer.send_stray(json.dumps({"duration_ms": 10}),
                            json.dumps({"log_dir": sock_dir}))
            wait_for(lambda: c.trace_timing.get("config_received"), 5,
                     f"{name}: the stray conf delivered")
            assert c._base_config == {"log_dir": sock_dir}
            assert c.trace_timing["delivery"] == "poll"
        finally:
            c.stop()
            peer.close()
    assert got["torch"] == got["jax"] == [
        {"duration_ms": 10, "log_dir": sock_dir}]


def test_client_push_overrides_presence_record(daemon_bin, fixture_root,
                                               sock_dir):
    """A device covered by a client's push reports the pushed metrics,
    not presence: a raw 'tmet' through the port's fabric, then the torch
    and the JAX shims' own pushes, each lands on device 0 under its job
    with no device_present, carrying the same dyno_self_* keys."""
    from dynolog_tpu_torch.client.fabric import FabricClient

    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0", "--procfs_root", str(fixture_root),
         *QUIET_FLAGS, "--tpu_monitor_interval_s", "0.3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seen = {}
    try:
        m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
        assert m, buf

        def await_record(job, key):
            deadline = time.time() + 10
            while time.time() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                rec = json.loads(line)["data"]
                if rec.get("device") == 0 and rec.get("job_id") == job \
                        and key in rec:
                    return rec
            pytest.fail(f"no pushed record of job {job} with {key}")

        fc = FabricClient()
        try:
            fc.send("tmet", {"job_id": "7", "pid": 1234, "devices": [
                {"device": 0, "hbm_util_pct": 42.0}]})
        finally:
            fc.close()
        seen["raw"] = await_record("7", "hbm_util_pct")
        for name, cls in shims():
            c = cls(job_id=f"push_{name}")
            try:
                c._push_metrics()
            finally:
                c._fabric.close()
            seen[name] = await_record(f"push_{name}",
                                      "dyno_self_fabric_send_total")
    finally:
        stop_daemon(proc)
    for name, rec in seen.items():
        assert "device_present" not in rec, (name, rec)
    assert set(_self_family(seen["torch"])) == set(_self_family(seen["jax"]))


_OP_CASES = {
    "full": [{"name": "matmul", "count": 3, "total_ms": 12.5,
              "cpu_ms": 1.25, "collective": False},
             {"name": "all_reduce", "total_ms": 4, "collective": 1}],
    "dropped": [{"name": "no_total"}, {"total_ms": 1.0}, "not a dict",
                None, {"name": 7, "total_ms": "2.5", "count": "4"}],
    "empty": [],
    "none": None,
}


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_record_op_stats_matches_reference(clients, case, sock_dir,
                                          monkeypatch):
    """record_op_stats cleans its input exactly as the reference does,
    and the manifest carries it as op_stats beside phase_spans."""
    import dynolog_tpu.client.shim as jax_shim
    import dynolog_tpu_torch.client.shim as torch_shim

    out = {}
    for name, c in clients.items():
        mod = torch_shim if name == "torch" else jax_shim
        monkeypatch.setattr(mod, "time", FakeClock())
        with c.phase("step"):
            pass
        c.record_op_stats(_OP_CASES[case])
        c._last_trace_dir = sock_dir
        sent = Sent(c)
        c._send_trace_manifest()
        (tdir,) = sent.of_type("tdir")
        body = json.loads(tdir[4:])
        out[name] = (c._op_stats, body["op_stats"], body["phase_spans"])
    assert out["torch"] == out["jax"]
    op_stats, manifest_ops, phase_spans = out["torch"]
    assert manifest_ops == op_stats
    assert [s["name"] for s in phase_spans] == ["step"]
    if case == "full":
        assert op_stats == [
            {"name": "matmul", "count": 3, "total_ms": 12.5,
             "cpu_ms": 1.25, "collective": False},
            {"name": "all_reduce", "count": 1, "total_ms": 4.0,
             "collective": True}]
    elif case == "dropped":
        assert op_stats == [{"name": "7", "count": 4, "total_ms": 2.5}]
    else:
        assert op_stats == []


def test_record_op_stats_rejects_what_the_reference_rejects(clients):
    """A total_ms that is not a number raises in both shims, and leaves
    the previous list in place."""
    errors = {}
    for name, c in clients.items():
        c.record_op_stats([{"name": "kept", "total_ms": 1.0}])
        with pytest.raises(ValueError) as e:
            c.record_op_stats([{"name": "x", "total_ms": "slow"}])
        errors[name] = (str(e.value), c._op_stats)
    assert errors["torch"] == errors["jax"]
    assert errors["torch"][1] == [{"name": "kept", "count": 1,
                                   "total_ms": 1.0}]


def test_epoch_and_backoff_match_reference(clients):
    """The restart detector and the poll backoff: the same epochs give
    the same verdicts and counters, and the same failure counts and
    seed give the same jittered waits, capped at backoff_cap_s."""
    epochs = [None, "bad", 11, 11, 12, 12, 11]
    out = {}
    for name, c in clients.items():
        c.poll_interval_s, c.backoff_cap_s = 0.2, 1.0
        verdicts = [c._note_epoch(e) for e in epochs]
        random.seed(5)
        waits = []
        for k in range(9):
            c._consec_failures = k
            waits.append(c._next_wait_s())
        out[name] = (verdicts, not c._registered, waits,
                     c.spans.counters())
    verdicts, unregistered, waits, counters = out["torch"]
    assert verdicts == [False, False, False, False, True, False, True]
    assert unregistered
    assert waits[:3] == [0.2] * 3
    assert all(0.1 <= w <= 1.5 for w in waits[3:]), waits
    assert counters["daemon_restarts_detected"] == 2
    assert counters["reconnect_backoffs"] == 6
    assert out["torch"] == out["jax"]
