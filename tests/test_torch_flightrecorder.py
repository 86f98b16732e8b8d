"""The port's flight recorder: the torch shim's rolling window ring,
streamed into the daemon's retro ring and exported when a watch rule
fires.

The four cases of tests/test_flightrecorder.py, played by the port's
minifleet and shim against the same daemon binary:

  * one injected anomaly on a 4-host fleet -> one merged report with
    the pre-trigger ring (metadata.retro coverage >= one window) beside
    the forward gang capture;
  * the ring holds at most --retro_ring_windows windows, evicting the
    oldest;
  * persisted windows survive a SIGKILLed daemon (restart_daemon);
  * a stream that lost its tail resumes without re-sending the prefix.

Then what only the port has or must show again:

  * a real torch.profiler ring on the CPU under a training loop that
    calls step(): windows land in the daemon's ring, a forward capture
    pauses them, and an exported window decodes as a Chrome trace;
  * the retro upload's tbeg and chunk datagrams equal the reference
    FabricClient's for the same window;
  * the arm/park/disable rules, the join in stop(), and windows skipped
    (not failed) while a user's own profiler runs.

Tolerances are exact, apart from wall-clock waits, each with a deadline.
"""

import base64
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
import zlib

import pytest
import torch

from dynolog_tpu.client.fabric import FabricClient as RefFabric
from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.client.fabric import FabricClient
from dynolog_tpu_torch.fleet import eventlog, minifleet, trace_report
from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from dynolog_tpu_torch.utils.rpc import DynoClient

pytestmark = pytest.mark.flightrecorder

DUTY = "tensorcore_duty_cycle_pct"
WINDOW_MS = 150


@pytest.fixture
def sock_dir(monkeypatch):
    """The fabric's socket dir, fresh per test and short: AF_UNIX paths
    stay under 108 bytes, which pytest's per-test dirs under xdist
    exceed once a client's endpoint name is appended."""
    d = tempfile.mkdtemp(prefix="dtr")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", d)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _wait(cond, timeout_s=60.0, desc="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {desc}")


def _events_of_type(port, etype):
    got = eventlog.fetch_all_events(DynoClient(port=port))
    return [e for e in got["events"] if e["type"] == etype]


def _counters(port):
    return DynoClient(port=port).self_telemetry()["counters"]


def _flightrecorder(port):
    return DynoClient(port=port).status().get("flightrecorder") or {}


def _retro_args(store, window_ms=WINDOW_MS, ring=4):
    return ("--storage_dir", str(store),
            "--retro_window_ms", str(window_ms),
            "--retro_ring_windows", str(ring))


def test_flightrecorder_fleet_e2e(daemon_bin, tmp_path, sock_dir):
    """One injected anomaly on a 4-host fleet -> ONE merged report with
    the onset (pre-trigger retro rings, >= WINDOW_MS coverage) and the
    aftermath (forward gang capture), nobody calling a single RPC. The
    fake CPU hosts push no duty cycle, so only the injection feeds the
    rule."""
    log_dir = tmp_path / "traces"
    rule_text = f"{DUTY}<20:60s:trace(400)"
    neighbors, n_clients = [], []
    flagged, f_clients = [], []
    try:
        for i in range(3):
            d, c = minifleet.spawn(
                daemon_bin, 1, f"frnb{i}",
                daemon_args=_retro_args(tmp_path / f"store_nb{i}"),
                job_id="fleet", poll_interval_s=0.1, write_fake_trace=True)
            neighbors += d
            n_clients += c
        peers = ",".join(f"localhost:{p}" for _, p in neighbors)
        flagged, f_clients = minifleet.spawn(
            daemon_bin, 1, "frfl",
            daemon_args=(
                "--enable_history_injection",
                "--watch", f"{DUTY}<20:60:trace(400)",
                "--watch_interval_s", "0.3",
                "--watch_z_threshold", "0",
                "--capture_peers", peers,
                "--capture_neighbors", "2",
                "--capture_cooldown_s", "300",
                "--capture_log_dir", str(log_dir),
                "--capture_job_id", "fleet",
                "--capture_start_delay_ms", "100",
                *_retro_args(tmp_path / "store_fl")),
            job_id="fleet", poll_interval_s=0.1, write_fake_trace=True)
        assert minifleet.wait_registered(neighbors + flagged, timeout_s=60)
        port = flagged[0][1]

        for _, p in flagged + neighbors:
            _wait(lambda p=p: _flightrecorder(p).get(
                "coverage_ms", 0) >= WINDOW_MS,
                desc=f"retro ring primed on :{p}")

        now_ms = int(time.time() * 1000)
        resp = DynoClient(port=port).put_history(
            f"{DUTY}.dev0",
            [(now_ms - (30 - k) * 1000, 5.0) for k in range(30)])
        assert resp.get("added") == 30, resp

        _wait(lambda: _events_of_type(port, "autocapture_complete"),
              desc="capture staging completing")
        done = _events_of_type(port, "autocapture_complete")[0]
        assert "retro ring exported" in done["detail"], done

        assert minifleet.wait_captures(f_clients + n_clients[:2], timeout_s=60)
        assert n_clients[2].captures_completed == 0

        _wait(lambda: len(
            trace_report.collect_retro(str(log_dir))) >= 3,
            desc="3 retro export manifests")
        ev = _events_of_type(port, "retro_exported")
        assert ev and ev[0]["source"] == "flightrecorder", ev
        counters = _counters(port)
        assert counters.get("retro_exports", 0) >= 1, counters
        assert counters.get("retro_windows", 0) >= 1, counters

        caps = DynoClient(port=port).get_captures()["captures"]
        assert caps[0]["retro_exported"] is True, caps
        assert caps[0]["retro_windows"] >= 1, caps
        assert caps[0]["retro_coverage_ms"] >= WINDOW_MS, caps
        assert caps[0]["retro_peers"] == 2, caps

        _wait(lambda: len(
            trace_report.collect_manifests(str(log_dir))) >= 3,
            desc="3 forward capture manifests")
        with open(trace_report.write_report(str(log_dir))) as f:
            report = json.load(f)
        md = report["metadata"]
        assert md["hosts"] == 3  # forward: flagged + 2 neighbors
        assert md["retro"]["hosts"] >= 3
        assert md["retro"]["windows"] >= 1
        assert md["retro"]["coverage_ms"] >= WINDOW_MS
        names = [e.get("name", "") for e in report["traceEvents"]]
        assert any(n.startswith("retro window") for n in names)
        assert any(n == f"autocapture trigger: {rule_text}"
                   for n in names)
        retro_tracks = [e for e in report["traceEvents"]
                        if e.get("ph") == "M"
                        and str(e["args"].get("name", ""))
                        .startswith("retro:")]
        assert len(retro_tracks) >= 3
        fired = _events_of_type(port, "autocapture_fired")[0]
        own = [m for m in trace_report.collect_retro(str(log_dir))
               if any(w.get("job_id") == "fleet"
                      for w in m.get("windows", []))]
        assert own, "no retro manifest with ring windows"
        for m in own:
            for w in m["windows"]:
                assert w["t0_ms"] < fired["ts_ms"] + 60_000  # sane epoch

        assert f_clients[0].spans.counters().get(
            "retro_windows_captured", 0) >= 1
    finally:
        minifleet.teardown(neighbors + flagged, n_clients + f_clients)


def test_retro_ring_evicts_oldest_at_cap(daemon_bin, tmp_path, sock_dir):
    """Past --retro_ring_windows windows the store holds the cap, evicts
    oldest-first (a contiguous newest suffix survives), unlinks the
    evicted files and counts every eviction."""
    store = tmp_path / "store"
    daemons, clients = minifleet.spawn(
        daemon_bin, 1, "frev",
        daemon_args=_retro_args(store, window_ms=60, ring=3),
        poll_interval_s=0.1)
    try:
        assert minifleet.wait_registered(daemons, timeout_s=60)
        port = daemons[0][1]
        _wait(lambda: _counters(port).get("retro_windows", 0) >= 7,
              desc="ring overflowing (7+ windows streamed)")
        fr = _flightrecorder(port)
        assert fr["mode"] == "ok"
        assert fr["windows"] <= 3, fr
        assert fr["evictions_total"] >= 4, fr
        assert fr["windows_total"] >= 7, fr
        # cap+1 momentarily tolerated: a just-renamed window races its
        # own eviction pass.
        files = sorted((store / "retro").glob("win-*.xpb"))
        assert 1 <= len(files) <= 4, files
        seqs = sorted(int(f.name.split("-")[1]) for f in files)
        assert seqs[-1] - seqs[0] == len(seqs) - 1, seqs  # contiguous
        assert seqs[0] >= 4, seqs  # seqs 0..3 were evicted oldest-first
        assert _counters(port).get("retro_evictions", 0) >= 4
    finally:
        minifleet.teardown(daemons, clients)


def test_retro_windows_survive_kill9(daemon_bin, tmp_path, sock_dir):
    """SIGKILL the daemon mid-ring: the fresh instance rescans the
    window files before its RPC socket opens, reports them in getStatus
    and journals retro_recovered."""
    store = tmp_path / "store"
    args = _retro_args(store)
    daemons, clients = minifleet.spawn(
        daemon_bin, 1, "frkill", daemon_args=args, poll_interval_s=0.1)
    try:
        assert minifleet.wait_registered(daemons, timeout_s=60)
        port = daemons[0][1]
        _wait(lambda: _flightrecorder(port).get("windows", 0) >= 2,
              desc="ring holding 2+ windows")
        assert len(list((store / "retro").glob("win-*.xpb"))) >= 2

        minifleet.kill_daemon(daemons, 0)
        minifleet.restart_daemon(daemons, 0, daemon_bin, "frkill",
                                 daemon_args=args, preserve_storage=True)
        new_port = daemons[0][1]
        fr = _flightrecorder(new_port)
        assert fr["mode"] == "ok", fr
        assert fr["windows"] >= 2, fr  # visible on the FIRST answer
        recovered = _events_of_type(new_port, "retro_recovered")
        assert recovered and "window" in recovered[0]["detail"], recovered
    finally:
        minifleet.teardown(daemons, clients)


def _start_daemon(daemon_bin, *args):
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0",
         "--kernel_monitor_interval_s", "3600",
         "--tpu_monitor_interval_s", "3600",
         "--enable_perf_monitor=false", *args],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
    if not m:
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError(f"daemon gave no port: {buf!r}")
    return proc, int(m.group(1))


def _stop_daemon(proc):
    proc.kill()
    proc.wait(timeout=10)


def test_stream_resume_after_lost_tail(daemon_bin, tmp_path, sock_dir):
    """tbeg + 2 of 3 chunks, then the sender stalls. The resume
    handshake (tbeg{resume:1} -> tack{next_seq}) continues from chunk 2;
    the artifact commits byte-identical, the daemon counts the skipped
    prefix and receives no chunk twice."""
    proc, port = _start_daemon(daemon_bin)
    fc = FabricClient()
    try:
        rpc = DynoClient(port=port)
        dest = tmp_path / "tracedir"
        dest.mkdir()
        data = os.urandom(90_000)  # 3 chunks at 32 KiB
        chunk_bytes = 32768
        chunks = [data[i:i + chunk_bytes]
                  for i in range(0, len(data), chunk_bytes)]
        begin = {
            "job_id": "resumejob", "pid": os.getpid(),
            "stream_id": "feedface00000001",
            "file": "streamed.pt.trace.json",
            "total_bytes": len(data), "chunk_count": len(chunks),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
        }

        def send_chunk(seq):
            assert fc.send("tchk", {
                "job_id": "resumejob", "pid": os.getpid(),
                "stream_id": begin["stream_id"], "seq": seq,
                "crc32": zlib.crc32(chunks[seq]) & 0xFFFFFFFF,
                "data": base64.b64encode(chunks[seq]).decode("ascii"),
            })

        fd = os.open(str(dest), os.O_RDONLY | os.O_DIRECTORY)
        try:
            assert fc.send_with_fd("tbeg", begin, fd)
            send_chunk(0)
            send_chunk(1)
            tack = fc.request("tbeg", dict(begin, resume=1),
                              timeout_s=5.0, reply_type="tack", fd=fd)
        finally:
            os.close(fd)
        assert tack is not None, "no tack reply to the resume tbeg"
        assert tack["stream_id"] == begin["stream_id"]
        assert tack["next_seq"] == 2, tack
        send_chunk(2)
        tcom = fc.request(
            "tend", {"job_id": "resumejob", "pid": os.getpid(),
                     "stream_id": begin["stream_id"],
                     "chunk_count": len(chunks), "crc32": begin["crc32"]},
            timeout_s=5.0, reply_type="tcom")
        assert tcom is not None and tcom.get("ok"), tcom
        assert (dest / "streamed.pt.trace.json").read_bytes() == data

        counters = rpc.self_telemetry()["counters"]
        assert counters.get("trace_chunks_resumed", 0) == 2, counters
        assert counters.get("trace_chunks_rx", 0) == 3, counters
        assert counters.get("trace_streams_committed", 0) == 1, counters
        resumed = [e for e in rpc.get_events(limit=64)["events"]
                   if e["type"] == "trace_upload_resumed"]
        assert resumed, "resume was not journaled"

        # A resume nobody remembers: the daemon acks 0.
        fresh = dict(begin, stream_id="feedface00000002", resume=1,
                     file="streamed2.pt.trace.json")
        fd = os.open(str(dest), os.O_RDONLY | os.O_DIRECTORY)
        try:
            tack = fc.request("tbeg", fresh, timeout_s=5.0,
                              reply_type="tack", fd=fd)
        finally:
            os.close(fd)
        assert tack is not None and tack["next_seq"] == 0, tack
    finally:
        fc.close()
        _stop_daemon(proc)


class _Trainer:
    """A tiny model trained on its own thread, calling step() each
    iteration, as a training job would."""

    def __init__(self, client):
        gen = torch.Generator().manual_seed(0)
        self.model = torch.nn.Sequential(
            torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 8))
        for p in self.model.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=0.01)
        self.x = torch.randn(16, 32, generator=gen)
        self.y = torch.randn(16, 8, generator=gen)
        self.client = client
        self.steps = 0
        self.tid = None
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        self.tid = threading.get_native_id()
        try:
            while not self._stop.is_set():
                self.opt.zero_grad()
                loss = ((self.model(self.x) - self.y) ** 2).mean()
                loss.backward()
                self.opt.step()
                self.client.step()
                self.steps += 1
                time.sleep(0.002)
        except Exception as e:
            self.error = e

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()
        assert self.error is None, self.error


def test_real_profiler_ring_on_cpu(daemon_bin, tmp_path, sock_dir):
    """The real shim and torch.profiler on the CPU: windows run in
    step() on the training thread and land in the daemon's ring, a
    forward capture pauses them and still gets the profiler, the
    exported ring decodes as Chrome traces holding the training
    thread's ops, and stop() from another thread ends the running
    window through step() and joins the recorder's thread."""
    proc, port = _start_daemon(
        daemon_bin, "--trace_stream_max_mb", "256",
        *_retro_args(tmp_path / "store", window_ms=WINDOW_MS))
    client = DynologClient(job_id="frcpu", poll_interval_s=0.1,
                           metrics_interval_s=60.0)
    trainer = None
    try:
        client.start()
        trainer = _Trainer(client).start()
        rpc = DynoClient(port=port)
        _wait(lambda: _flightrecorder(port).get("windows", 0) >= 2,
              desc="2 real windows in the daemon's ring")

        log_dir = tmp_path / "fwd"
        rpc.set_trace_config(job_id="frcpu", config={
            "type": "xplane", "log_dir": str(log_dir), "duration_ms": 300})
        _wait(lambda: client.captures_completed == 1,
              desc="forward capture")
        counters = client.spans.counters()
        assert counters.get("retro_windows_skipped", 0) > 0, counters
        assert counters.get("retro_disabled", 0) == 0, counters
        assert counters.get("retro_windows_captured", 0) >= 2, counters
        assert counters.get("retro_upload_failures", 0) == 0, counters
        # The ring goes on after the capture.
        after = counters["retro_windows_captured"]
        _wait(lambda: client.spans.counters()[
            "retro_windows_captured"] > after, desc="ring resuming")

        out = tmp_path / "exported"
        res = rpc.export_retro(str(out))
        assert res.get("windows", 0) >= 1, res
        manifests = trace_report.collect_retro(str(out))
        assert manifests and manifests[0]["windows"], manifests
        ops_on_trainer = 0
        for m in manifests:
            for w in m["windows"]:
                path = os.path.join(m["_dir"], w["file"])
                with open(path, "rb") as f:
                    assert f.read(2) == b"\x1f\x8b"  # gzipped
                trace = trace_report.read_retro_window(path)
                assert isinstance(trace.get("traceEvents"), list)
                ops_on_trainer += sum(
                    1 for e in trace["traceEvents"]
                    if str(e.get("name", "")).startswith("aten::")
                    and e.get("tid") == trainer.tid)
        # The windows ran in step(), on the training thread.
        assert ops_on_trainer > 0

        # stop() from another thread: the trainer's next step() ends the
        # running window, and stop() joins the recorder's thread.
        retro_thread = client._retro_thread
        assert retro_thread is not None and retro_thread.is_alive()
        client.stop()
        assert not retro_thread.is_alive()
        assert client._retro_prof is None and client._retro_idle.is_set()
        assert client._retro_scratch is None
        trainer.stop()
        trainer = None
    finally:
        client.stop()
        if trainer is not None:
            trainer.stop()
        _stop_daemon(proc)


def test_retro_upload_wire_is_byte_identical(monkeypatch, sock_dir):
    """The tbeg/tchk/tend datagrams of one retro window equal the
    reference FabricClient's for the same window."""
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    data = bytes(range(256)) * 300  # 76800 bytes -> 3 chunks
    sent = {}
    for name, cls in (("ref", RefFabric), ("port", FabricClient)):
        fab = cls("no_daemon_here")
        log = sent[name] = []

        def record(payload, ancillary, log=log):
            log.append((payload, ancillary))
            return True

        fab._sendmsg = record
        try:
            assert fab.upload_retro("42", 1234, 7, 1_760_000_000_000,
                                    1_760_000_000_150, data,
                                    timeout_s=0.05) is None
        finally:
            fab.close()
    assert [p[:4] for p, _ in sent["port"]] == [
        b"tbeg", b"tchk", b"tchk", b"tchk", b"tend", b"tbeg"]
    assert sent["port"] == sent["ref"]
    begin = json.loads(sent["port"][0][0][4:])
    assert begin["retro"] == 1 and begin["seq"] == 7
    assert sent["port"][0][1] == []  # no directory fd on a retro window


class _ScriptedWindows(DynologClient):
    """The shim with its window capture scripted: each call pops the
    next result (None = a failed window) and records that it ran."""

    def __init__(self, results, **kw):
        super().__init__(**kw)
        self.results = list(results)
        self.calls = 0

    def _retro_capture_window(self, window_ms):
        self.calls += 1
        time.sleep(window_ms / 1000.0)
        if self.results:
            return self.results.pop(0)
        return b"{}", 1, 2


def test_retro_arms_parks_and_disables(sock_dir):
    """A retro block arms the loop and starts its thread once; a reply
    without it parks the loop; three failed windows in a row disable
    it, counted once; stop() joins the thread."""
    client = _ScriptedWindows([None, None, None],
                              daemon_socket="no_daemon_here")
    try:
        client._apply_retro_config({"window_ms": 20, "ring_windows": 2})
        thread = client._retro_thread
        assert thread is not None and thread.is_alive()
        assert client._retro_cfg == {"window_ms": 20, "ring_windows": 2}
        _wait(lambda: client._retro_disabled, desc="recorder disabled")
        assert client.calls == 3
        assert client.spans.counters().get("retro_disabled") == 1
        assert client.spans.counters().get("retro_windows_captured",
                                           0) == 0
        client._apply_retro_config({"window_ms": 20})
        assert client._retro_thread is thread  # started once
        time.sleep(0.1)
        assert client.calls == 3  # disabled stays disabled
        client._apply_retro_config(None)
        assert client._retro_cfg is None
    finally:
        client.stop()
    assert not thread.is_alive()


def test_retro_parks_and_pauses_for_forward_capture(sock_dir):
    """Parked, the loop captures nothing; armed, a failure between
    successes resets the run of failures; while a forward capture is
    pending it skips windows and counts them."""
    client = _ScriptedWindows([None, (b"{}", 1, 2), None, None],
                              daemon_socket="no_daemon_here")
    try:
        client._apply_retro_config({"window_ms": 20})
        client._apply_retro_config({})  # no window_ms: park
        parked_at = client.calls
        time.sleep(0.3)
        assert client.calls <= parked_at + 1  # a window in flight ends
        client._apply_retro_config({"window_ms": 20})
        _wait(lambda: client.spans.counters().get(
            "retro_windows_captured", 0) >= 2, desc="windows")
        assert not client._retro_disabled
        with client._capture_lock:
            client._capturing = True

        def skipped():
            return client.spans.counters().get("retro_windows_skipped", 0)

        s0 = skipped()
        _wait(lambda: skipped() > s0, desc="a skipped window")
        calls = client.calls  # the loop has seen the pending capture
        _wait(lambda: skipped() >= s0 + 3, desc="skipped windows")
        assert client.calls == calls
        with client._capture_lock:
            client._capturing = False
        _wait(lambda: client.calls > calls, desc="ring resuming")
    finally:
        client.stop()


def test_retro_skips_while_a_user_profiler_runs(sock_dir):
    """A user's own torch.profiler session holds the one profiler of the
    process: the loop skips windows (counted) instead of failing them,
    so it is not disabled, and resumes when the user's session ends."""
    from torch.profiler import ProfilerActivity, profile

    client = _ScriptedWindows([], daemon_socket="no_daemon_here")
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        client._apply_retro_config({"window_ms": 20})
        _wait(lambda: client.spans.counters().get(
            "retro_windows_skipped", 0) >= 3, desc="skipped windows")
        assert client.calls == 0
        assert not client._retro_disabled
        prof.stop()
        prof = None
        _wait(lambda: client.calls > 0, desc="ring resuming")
    finally:
        if prof is not None:
            prof.stop()
        client.stop()


def test_retro_skips_while_the_workload_does_not_step(monkeypatch,
                                                      sock_dir):
    """Windows start in step(): a workload that does not step gets no
    window and no failure, only skips, and stop() still joins."""
    from dynolog_tpu_torch.client import shim

    monkeypatch.setattr(shim, "_STEP_WAIT_S", 0.05)
    client = DynologClient(daemon_socket="no_daemon_here")
    try:
        client._apply_retro_config({"window_ms": 20})
        _wait(lambda: client.spans.counters().get(
            "retro_windows_skipped", 0) >= 3, desc="skipped windows")
        counters = client.spans.counters()
        assert counters.get("retro_windows_captured", 0) == 0, counters
        assert not client._retro_disabled
        assert client._retro_prof is None
        thread = client._retro_thread
    finally:
        client.stop()
    assert not thread.is_alive()
