"""The lifetime of the port's profiler sessions: each on-demand capture's
and each ring window's torch.profiler session ends when it retires, as
the reference's ``state.reset()`` ends its own
(dynolog_tpu/client/shim.py:652-653, 944-945), not at the cyclic
collector's next full pass.

A ``torch.profiler.profile`` keeps bound methods of itself, so a session
the shim merely drops sits in a reference cycle with Kineto's results.
Every case here runs with the collector disabled (restored in
``finally``) and ``gc.collect`` replaced by a counter that collects
nothing: a session that dies here died without a collection, and the
shim is seen never to ask for one. Sessions are watched through weakrefs
taken as ``torch.profiler.profile.start`` runs, and counted by type
(``torch.profiler.profile`` and the ``torch.autograd.profiler.profile``
holding the results) in one ``gc.get_objects()`` scan. Every wait has a
deadline of a few seconds.
"""

import gc
import glob
import logging
import os
import sys
import threading
import time
import weakref

import pytest
import torch

from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.utils.rpc import DynoClient
from torch_control_util import daemon, short_sock_dir, wait_for

SESSION_TYPES = (torch.profiler.profile, torch.autograd.profiler.profile)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def live_sessions():
    """Profiler session objects alive in this process (a scan of the
    collector's tracked objects collects nothing). ``type()``, not
    ``isinstance``, which would read every object's ``__class__``."""
    return sum(1 for o in gc.get_objects() if type(o) in SESSION_TYPES)


@pytest.fixture
def no_collector(monkeypatch):
    """The collector off for the test, after one real pass clears what
    earlier tests left; ``gc.collect`` counts its callers and collects
    nothing. Yields the list of calling threads' names."""
    gc.collect()
    calls = []
    monkeypatch.setattr(
        gc, "collect",
        lambda *a, **k: calls.append(threading.current_thread().name) or 0)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield calls
    finally:
        if was_enabled:
            gc.enable()


@pytest.fixture
def sessions(monkeypatch):
    """(weakref, name of the starting function) of every
    torch.profiler.profile started in the test."""
    refs = []
    real_start = torch.profiler.profile.start

    def start(self):
        real_start(self)
        refs.append((weakref.ref(self), sys._getframe(1).f_code.co_name))

    monkeypatch.setattr(torch.profiler.profile, "start", start)
    return refs


def alive(refs, started_by=None):
    return [r for r, by in refs
            if r() is not None and started_by in (None, by)]


class _Trainer:
    """A training thread: torch matmuls, then client.step(), until
    stopped."""

    def __init__(self, client, step_s=0.003):
        self.client, self._step_s = client, step_s
        self.steps = 0
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            x = torch.randn(48, 48)
            while not self._stop.is_set():
                x = torch.tanh(x @ x)
                self.client.step()
                self.steps += 1
                time.sleep(self._step_s)
        except Exception as e:
            self.error = e

    def start(self):
        self._thread.start()
        wait_for(lambda: self.steps > 0, 10, "first training step")
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()
        assert self.error is None, repr(self.error)


def _exported_and_streamed(trace_dir):
    exported = [p for p in glob.glob(os.path.join(trace_dir, "*.json"))
                if p.endswith(".pt.trace.json")
                and not os.path.basename(p).startswith("streamed.")]
    assert len(exported) == 1, exported
    streamed = os.path.join(trace_dir, "streamed.pt.trace.json")
    with open(exported[0], "rb") as a, open(streamed, "rb") as b:
        return a.read(), b.read()


@pytest.mark.parametrize("stepping", [True, False],
                         ids=["in_step", "capture_thread"])
def test_capture_sessions_die_when_each_capture_retires(
        daemon_bin, monkeypatch, tmp_path, no_collector, sessions, stepping):
    """Three back-to-back captures, started and stopped in step() on a
    training thread, or by the capture thread of a job that never calls
    step(): once each capture's manifest landed, its session is dead,
    no session object is left, and the streamed copy equals the export
    byte for byte."""
    baseline = live_sessions()
    with daemon(daemon_bin, monkeypatch) as d:
        client = DynologClient(job_id="lifetime", poll_interval_s=0.1,
                               metrics_interval_s=3600)
        trainer = None
        try:
            client.start()
            if stepping:
                trainer = _Trainer(client).start()
            rpc = DynoClient(port=d["port"])
            wait_for(lambda: rpc.status()["registered_processes"] == 1, 10,
                     "registration")
            for k in range(1, 4):
                log_dir = tmp_path / f"capture_{k}"
                rpc.set_trace_config("lifetime", {
                    "type": "xplane", "duration_ms": 100,
                    "log_dir": str(log_dir)})
                manifest = []
                wait_for(lambda: manifest.extend(glob.glob(str(
                    log_dir / "*" / "dynolog_manifest.json"))) or manifest,
                    15, f"capture {k}'s manifest")
                assert client.captures_completed == k
                assert len(sessions) == k
                assert not alive(sessions), f"capture {k}: session alive"
                assert live_sessions() == baseline
                exported, streamed = _exported_and_streamed(
                    os.path.dirname(manifest[0]))
                assert exported and exported == streamed
        finally:
            if trainer is not None:
                trainer.stop()
            client.stop()
    assert no_collector == []


def test_stop_during_a_capture_ends_its_session(
        daemon_bin, monkeypatch, tmp_path, no_collector, sessions):
    """stop() on a thread that cannot stop the running capture (not the
    one that started it): the training thread's next step() closes it
    early, and its session ends rather than waiting parked for an
    export that no thread would run."""
    with daemon(daemon_bin, monkeypatch) as d:
        client = DynologClient(job_id="lifetime", poll_interval_s=0.1,
                               metrics_interval_s=3600)
        trainer = None
        try:
            client.start()
            trainer = _Trainer(client).start()
            rpc = DynoClient(port=d["port"])
            wait_for(lambda: rpc.status()["registered_processes"] == 1, 10,
                     "registration")
            rpc.set_trace_config("lifetime", {
                "type": "xplane", "duration_ms": 60000,
                "log_dir": str(tmp_path)})
            wait_for(lambda: client._trace_active, 10, "the capture running")
            client.stop()
            wait_for(lambda: sessions and not alive(sessions), 10,
                     "the capture's session to end")
            assert client._stopped_prof is None
        finally:
            if trainer is not None:
                trainer.stop()
            client.stop()
    assert no_collector == []


def _failing_session():
    """A started CPU session whose stop() stops it and then raises."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    real_stop = prof.stop

    def stop():
        real_stop()
        raise RuntimeError("stop failed")

    prof.stop = stop
    return prof


def _stopped_session():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    torch.tanh(torch.randn(8, 8))
    prof.stop()
    return prof


@pytest.mark.parametrize("path", ["capture_stop_raises", "ring_stop_raises",
                                  "ring_window_left_queued"])
def test_a_session_no_export_reads_is_ended(
        monkeypatch, no_collector, sessions, path):
    """A session that will never be exported ends where the shim gives
    it up: a capture's or a ring window's stop that raises, and a window
    stopped after the recorder's last wait, still queued when its
    thread exits."""
    short_sock_dir(monkeypatch)
    # A captured log record of the failure would keep its traceback's
    # frames, and the session in their locals, alive.
    monkeypatch.setattr(logging.getLogger("dynolog_tpu_torch.client"),
                        "propagate", False)
    client = DynologClient(job_id="lifetime")
    try:
        with client._capture_lock:
            if path == "capture_stop_raises":
                client._prof = _failing_session()
                client._prof_thread = threading.get_ident()
                client._stop_trace()
                assert client._stopped_prof is None
            elif path == "ring_stop_raises":
                client._retro_prof = _failing_session()
                client._retro_owner = threading.current_thread()
                client._stop_retro_window()
                assert client._retro_stopped.get_nowait() is None
        if path == "ring_window_left_queued":
            client._retro_stopped.put_nowait((_stopped_session(), 1, 2))
            client._stop.set()
            client._retro_loop()
            assert client._retro_stopped.empty()
        assert len(sessions) == 1
        assert not alive(sessions)
        assert not torch.autograd.profiler._is_profiler_enabled
    finally:
        client.stop()
    assert no_collector == []


def test_ring_window_sessions_die_once_uploaded(
        daemon_bin, monkeypatch, tmp_path, no_collector, sessions):
    """A real ring on the CPU: while windows roll, and across a forward
    capture that ends the window in flight and skips the next ones, at
    most one window's session is alive at a time (the running one, or
    the stopped one being exported); once stop() has ended the last
    window, none is."""
    baseline = live_sessions()
    with daemon(daemon_bin, monkeypatch, "--storage_dir",
                str(tmp_path / "store"), "--retro_window_ms", "150",
                "--retro_ring_windows", "4") as d:
        client = DynologClient(job_id="lifetime_ring", poll_interval_s=0.1,
                               metrics_interval_s=3600)
        trainer = None
        peak = {"windows": 0, "all": 0}

        def sampled(cond):
            def check():
                peak["windows"] = max(peak["windows"],
                                      len(alive(sessions, "_step_retro")))
                peak["all"] = max(peak["all"], len(alive(sessions)))
                return cond()
            return check

        def uploaded():
            return client.spans.counters().get("retro_windows_captured", 0)

        try:
            client.start()
            trainer = _Trainer(client).start()
            wait_for(sampled(lambda: uploaded() >= 3), 20, "3 ring windows",
                     interval_s=0.01)
            rpc = DynoClient(port=d["port"])
            rpc.set_trace_config("lifetime_ring", {
                "type": "xplane", "duration_ms": 200,
                "log_dir": str(tmp_path / "fwd")})
            wait_for(sampled(lambda: client.captures_completed == 1), 15,
                     "the forward capture", interval_s=0.01)
            n = uploaded()
            wait_for(sampled(lambda: uploaded() >= n + 2), 20,
                     "the ring resuming", interval_s=0.01)
            counters = client.spans.counters()
            assert counters.get("retro_windows_skipped", 0) > 0, counters
            assert counters.get("retro_upload_failures", 0) == 0, counters
            client.stop()  # the trainer's next step() ends the window
        finally:
            if trainer is not None:
                trainer.stop()
            client.stop()
    assert len(alive(sessions, "_start_trace")) == 0
    assert len(sessions) >= 6  # 5 windows and the forward capture
    # A window stopped for the forward capture is exported while the
    # capture runs: two sessions then, one of them a window.
    assert peak["windows"] <= 1 and peak["all"] <= 2, peak
    assert not alive(sessions)
    assert live_sessions() == baseline
    assert no_collector == []
