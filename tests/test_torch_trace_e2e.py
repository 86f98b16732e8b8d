"""End-to-end on-demand trace flow with the port's client shim — the
flagship path (SURVEY.md §3.3) on CPU torch:

    dyno gputrace --> daemon RPC --> client poll/push
    --> torch.profiler on the training thread --> .pt.trace.json on disk

The six cases of tests/test_trace_e2e.py against the real daemon and
`dyno`, plus the profiler-threading hazard (a capture must record the
training thread's ops), a user's own profiler (the capture fails soft),
and the port's selftest.
"""

import glob
import json
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from dynolog_tpu_torch.utils.rpc import DynoClient

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _wait_for(predicate, timeout_s=15.0, interval_s=0.05, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval_s)
    pytest.fail(f"timed out waiting for {what}")


@pytest.fixture
def trace_daemon(daemon_bin, fixture_root, monkeypatch):
    """Daemon with the IPC fabric on filesystem sockets in a fresh temp
    dir (test isolation: abstract names are host-global). Not under
    tmp_path: a socket path must stay below AF_UNIX's 108 bytes, and
    pytest's per-test dirs under xdist come close to that."""
    sock_dir = tempfile.mkdtemp(prefix="dtt")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", sock_dir)
    proc = subprocess.Popen(
        [
            str(daemon_bin),
            "--port", "0",
            "--procfs_root", str(fixture_root),
            "--kernel_monitor_interval_s", "3600",
            "--tpu_monitor_interval_s", "3600",
        ],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        text=True,
    )
    m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
    assert m, f"no RPC port; stderr: {buf!r}"
    port = int(m.group(1))
    assert "ipc: serving" in buf, buf
    yield proc, port
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
    shutil.rmtree(sock_dir, ignore_errors=True)


@pytest.fixture
def client(trace_daemon):
    from dynolog_tpu_torch.client import DynologClient
    c = DynologClient(
        job_id="42", poll_interval_s=0.1, metrics_interval_s=0.3)
    c.start()
    yield c
    c.stop()


def _registered(port):
    rpc = DynoClient(port=port)
    _wait_for(
        lambda: rpc.status()["registered_processes"] == 1,
        what="client registration")
    return rpc


class _Trainer:
    """A training thread: torch matmuls, then client.step(), until
    stopped. Keeps its native thread id (the trace's tid) and any error."""

    def __init__(self, client, profile_first_s=0.0):
        self.client = client
        self.tid = None
        self.error = None
        self.steps = 0
        self._profile_first_s = profile_first_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _loop(self, until=None):
        x = torch.randn(64, 64)
        while not self._stop.is_set():
            if until is not None and time.monotonic() >= until:
                return
            x = torch.tanh(x @ x)
            self.client.step()
            self.steps += 1
            time.sleep(0.005)

    def _run(self):
        self.tid = threading.get_native_id()
        try:
            if self._profile_first_s:
                # The user's own profiler, around the first stretch of
                # the loop.
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    self._loop(until=time.monotonic() + self._profile_first_s)
            self._loop()
        except BaseException as e:
            self.error = e

    def __enter__(self):
        self._thread.start()
        _wait_for(lambda: self.steps > 0, what="first training step")
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()
        assert self.error is None, repr(self.error)


def _traces(log_dir):
    return [p for p in glob.glob(str(log_dir / "**" / "*.pt.trace.json"),
                                 recursive=True)
            if not p.endswith("streamed.pt.trace.json")]


def test_register_and_poll_keepalive(trace_daemon, client):
    _, port = trace_daemon
    rpc = _registered(port)
    reg = rpc.call("getTraceRegistry")["jobs"]
    assert "42" in reg
    assert reg["42"][0]["pid"] == client.pid
    meta = reg["42"][0]["metadata"]
    assert meta["device_count"] >= 1
    assert meta["platform"] == "cpu"


def test_metrics_push_reaches_tpu_status(trace_daemon, client):
    _, port = trace_daemon
    rpc = DynoClient(port=port)
    _wait_for(
        lambda: len(rpc.tpu_status()["devices"]) >= 1,
        what="pushed device metrics")
    devices = rpc.tpu_status()["devices"]
    assert devices[0]["job_id"] == "42"
    assert devices[0]["metrics"]["platform"] == "cpu"


def test_duration_trace_end_to_end(trace_daemon, client, cli_bin, tmp_path):
    _, port = trace_daemon
    _registered(port)
    log_dir = tmp_path / "traces"
    out = subprocess.run(
        [
            str(cli_bin), "--port", str(port), "gputrace",
            "--job_id", "42",
            "--duration_ms", "400",
            "--log_dir", str(log_dir),
        ],
        capture_output=True, text=True, timeout=30,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Triggered 1 process(es)" in out.stdout

    # No step() hook here: the capture thread runs the profiler itself.
    x = torch.ones((128, 128))
    end = time.monotonic() + 2.0
    while time.monotonic() < end:
        x = (x @ x) / 128.0

    _wait_for(
        lambda: client.captures_completed == 1, what="capture completion")
    traces = _traces(log_dir)
    assert len(traces) == 1, f"no torch.profiler output under {log_dir}"
    assert json.load(open(traces[0]))["traceEvents"]

    def find_manifests():
        return glob.glob(
            str(log_dir / "**" / "dynolog_manifest.json"), recursive=True)

    _wait_for(lambda: bool(find_manifests()), what="capture manifest")
    manifest = json.loads(open(find_manifests()[0]).read())
    assert manifest["pid"] == client.pid
    assert manifest["written_by"] == "dynolog_tpu_daemon"
    assert manifest["trace_timing"]["trace_stop"] > 0


def test_iteration_trace_via_step_hook(trace_daemon, client, tmp_path):
    _, port = trace_daemon
    rpc = _registered(port)
    with _Trainer(client):
        log_dir = tmp_path / "traces_iter"
        resp = rpc.set_trace_config(
            job_id="42",
            config=json.dumps({
                "type": "xplane",
                "log_dir": str(log_dir),
                "duration_ms": 500,
                "iterations": 5,
                "iteration_roundup": 10,
            }))
        assert len(resp["activityProfilersTriggered"]) == 1
        _wait_for(
            lambda: client.captures_completed == 1,
            what="iteration capture completion")
        assert _traces(log_dir), f"no torch.profiler output under {log_dir}"


def test_config_delivery_latency_bounded(trace_daemon, tmp_path):
    """RPC accepted -> config delivered must be far BELOW the poll
    interval (push/poke fast path), asserted at a 5 s poll."""
    from dynolog_tpu_torch.client import DynologClient
    _, port = trace_daemon
    poll_s = 5.0
    c = DynologClient(
        job_id="lat", poll_interval_s=poll_s, metrics_interval_s=5.0)
    c.start()
    try:
        rpc = _registered(port)
        t_rpc = time.time()
        resp = rpc.set_trace_config(
            job_id="lat",
            config=json.dumps({
                "type": "xplane",
                "log_dir": str(tmp_path / "lat"),
                "duration_ms": 100,
            }))
        assert len(resp["activityProfilersTriggered"]) == 1
        _wait_for(
            lambda: "config_received" in c.trace_timing,
            what="config delivery")
        delivery_s = c.trace_timing["config_received"] - t_rpc
        assert delivery_s <= 0.5, (
            f"config delivery took {delivery_s:.2f}s at a {poll_s:.0f}s "
            "poll interval — the push/poke fast path is not working")
        _wait_for(
            lambda: c.captures_completed == 1, what="capture completion")
        assert c.trace_timing["trace_start"] >= c.trace_timing[
            "config_received"]
        assert c.trace_timing["trace_stop"] > c.trace_timing["trace_start"]
    finally:
        c.stop()


def test_busy_client_rejects_second_config(trace_daemon, client, tmp_path):
    _, port = trace_daemon
    rpc = _registered(port)
    cfg = json.dumps({
        "type": "xplane",
        "log_dir": str(tmp_path / "t1"),
        "duration_ms": 1500,
    })
    assert len(rpc.set_trace_config(job_id="42", config=cfg)[
        "activityProfilersTriggered"]) == 1
    _wait_for(lambda: client._capturing, what="capture start")
    rpc.set_trace_config(job_id="42", config=cfg)
    _wait_for(
        lambda: client.captures_completed == 1,
        what="first capture completion")
    time.sleep(0.5)
    assert client.captures_completed == 1


def test_duration_trace_records_training_thread_ops(
        trace_daemon, client, cli_bin, tmp_path):
    """Kineto records CPU ops only on the thread that started the
    profiler: a duration capture of a stepping workload must start on the
    training thread, so its trace holds that thread's aten::mm."""
    _, port = trace_daemon
    _registered(port)
    log_dir = tmp_path / "traces_thread"
    with _Trainer(client) as trainer:
        out = subprocess.run(
            [str(cli_bin), "--port", str(port), "gputrace", "--job_id", "42",
             "--duration_ms", "300", "--log_dir", str(log_dir)],
            capture_output=True, text=True, timeout=30)
        assert out.returncode == 0, out.stdout + out.stderr
        _wait_for(lambda: client.captures_completed == 1,
                  what="capture completion")
    (trace,) = _traces(log_dir)
    events = json.load(open(trace))["traceEvents"]
    mm_tids = {e.get("tid") for e in events if e.get("name") == "aten::mm"}
    assert trainer.tid in mm_tids, (trainer.tid, mm_tids)
    timing = client.trace_timing
    assert timing["trace_stop"] - timing["trace_start"] >= 0.3


def test_user_profiler_makes_capture_fail_soft(trace_daemon, client,
                                               tmp_path):
    """One profiler session per process: while the user's own
    torch.profiler runs, the capture is dropped with a warning, the
    training loop never sees an exception, and the next capture works."""
    _, port = trace_daemon
    rpc = _registered(port)
    with _Trainer(client, profile_first_s=3.0):
        cfg = {"type": "xplane", "log_dir": str(tmp_path / "busy"),
               "duration_ms": 200}
        rpc.set_trace_config(job_id="42", config=cfg)
        # The shim stamps config_received as it arms the capture; the
        # armed state itself can last less than one poll of this loop.
        _wait_for(lambda: "config_received" in client.trace_timing,
                  what="capture armed")
        _wait_for(lambda: not client._capturing, what="capture dropped")
        assert client.captures_completed == 0
        assert not _traces(tmp_path / "busy")
        time.sleep(3.0)  # the user's profiler has closed
        cfg["log_dir"] = str(tmp_path / "after")
        rpc.set_trace_config(job_id="42", config=cfg)
        _wait_for(lambda: client.captures_completed == 1,
                  what="capture after the user's profiler")
    assert _traces(tmp_path / "after")


def test_start_imports_what_a_profiler_start_imports(monkeypatch):
    """A profiler's first start imports torch._inductor, as the
    workload's first optimizer does: started on the capture thread
    while the training thread built its optimizer, the two imports
    deadlocked and raised ImportError in the training thread. start()
    imports it on the caller's thread before its own thread exists."""
    import builtins

    from dynolog_tpu_torch.client import DynologClient

    seen = []
    real_import = builtins.__import__

    def recording_import(name, *args, **kwargs):
        seen.append((name, threading.current_thread().name,
                     threading.active_count()))
        return real_import(name, *args, **kwargs)

    threads_before = threading.active_count()
    client = DynologClient(job_id="x", daemon_socket="no_daemon_here")
    monkeypatch.setattr(builtins, "__import__", recording_import)
    try:
        client.start()
    finally:
        monkeypatch.undo()
        client.stop()
    caller = threading.current_thread().name
    assert ("torch._inductor", caller, threads_before) in seen, seen


def test_selftest_passes(daemon_bin):
    out = subprocess.run(
        [sys.executable, "-m", "dynolog_tpu_torch.client.selftest",
         "--device", "cpu", "--daemon", str(daemon_bin)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: torch.profiler trace written" in out.stdout
