"""Rendezvous through the port's client shim, held to the reference on
the same scenarios (tests/test_rendezvous.py):

  * the daemon's base config (--trace_base_config) refreshes, follows
    edits and keeps the last good file over a torn write, in both
    shims' state;
  * the shims merge the base under the operator's config;
  * the trace-dir fd manifest written by the daemon through the fd the
    shim hands over;
  * a live client re-registers unprompted after the daemon is SIGKILLed
    and restarted on the same socket, and still receives a config;
  * the registration metadata, and `profiler_server_port`, where the
    port differs from the reference by design (ROADMAP Queue C).
"""

import json
import logging
import os
import threading
import time

import torch

from dynolog_tpu_torch.client.fabric import FabricClient
from dynolog_tpu_torch.utils.rpc import DynoClient
from torch_control_util import (
    Sent,
    daemon,
    shims,
    short_sock_dir,
    spawn_daemon,
    wait_for,
)


def test_base_config_refresh_and_delivery(daemon_bin, monkeypatch,
                                          tmp_path):
    """The daemon re-reads the base file every GC cycle: absent, written,
    edited, then torn. A bare poll sees each state, and both shims'
    base configs follow it equally, keeping the last good one."""
    base_path = tmp_path / "trace_base.json"
    with daemon(daemon_bin, monkeypatch,
                f"--trace_base_config={base_path}",
                "--trace_gc_interval_s", "0.2"):
        fc = FabricClient()
        clients = {name: cls(job_id=f"base_{name}", poll_interval_s=0.1,
                             metrics_interval_s=3600)
                   for name, cls in shims()}
        try:
            for c in clients.values():
                c.start()
            me = {"job_id": "basejob", "pid": os.getpid()}
            resp = fc.request("poll", me, timeout_s=2)
            assert resp is not None and "base_config" not in resp

            def both_see(want):
                return all(c._base_config == want for c in clients.values())

            for text, want in (
                    ('{"python_tracer": true}', {"python_tracer": True}),
                    ('{"python_tracer": false, "duration_ms": 7}',
                     {"python_tracer": False, "duration_ms": 7})):
                base_path.write_text(text)
                wait_for(lambda: (fc.request("poll", me, timeout_s=2) or {})
                         .get("base_config") == text, 5, f"base {text}")
                wait_for(lambda: both_see(want), 5, f"shims see {want}")

            base_path.write_text('{"torn write')
            time.sleep(0.6)  # three GC cycles
            resp = fc.request("poll", me, timeout_s=2)
            assert json.loads(resp["base_config"])["duration_ms"] == 7
            assert both_see({"python_tracer": False, "duration_ms": 7})
        finally:
            for c in clients.values():
                c.stop()
            fc.close()


class _Inline:
    """threading.Thread stand-in that runs its target at start()."""

    def __init__(self, target=None, args=(), **kw):
        self._t, self._a = target, args

    def start(self):
        self._t(*self._a)


def test_shim_merges_base_under_operator_config(monkeypatch):
    """Base keys are defaults and the operator's config wins, in both
    shims alike."""
    short_sock_dir(monkeypatch)
    monkeypatch.setattr(threading, "Thread", _Inline)
    merged = {}
    for name, cls in shims():
        c = cls(job_id="m")
        try:
            captured = merged[name] = {}
            c._capture = captured.update
            c._base_config = {"duration_ms": 99, "python_tracer": True}
            c._on_config('{"type": "xplane", "duration_ms": 5}')
        finally:
            c._fabric.close()
    assert merged["torch"] == merged["jax"] == {
        "duration_ms": 5, "python_tracer": True, "type": "xplane"}


def test_trace_dir_fd_manifest(daemon_bin, monkeypatch, tmp_path):
    """Each shim's _send_trace_manifest hands the daemon an fd of its
    trace dir over SCM_RIGHTS, and the daemon writes
    dynolog_manifest.json through it: the same keys from both shims. A
    'tdir' without an fd is rejected and the daemon keeps serving."""
    manifests = {}
    with daemon(daemon_bin, monkeypatch) as d:
        for name, cls in shims():
            c = cls(job_id="42")
            out = tmp_path / name
            out.mkdir()
            try:
                c._last_trace_dir = str(out)
                c.captures_completed = 1
                c.trace_timing = {"config_received": 100.0,
                                  "trace_start": 100.2, "trace_stop": 100.7}
                c._send_trace_manifest()
            finally:
                c._fabric.close()
            path = out / "dynolog_manifest.json"
            wait_for(path.exists, 10, f"{name} manifest")
            manifests[name] = json.loads(path.read_text())
        fc = FabricClient()
        try:
            fc.send("tdir", {"job_id": "42", "pid": os.getpid()})
            time.sleep(0.3)
        finally:
            fc.close()
        assert d["proc"].poll() is None
    m = manifests["torch"]
    assert sorted(m) == sorted(manifests["jax"])
    assert m["job_id"] == "42" and m["pid"] == os.getpid()
    assert m["written_by"] == "dynolog_tpu_daemon"
    assert m["written_at_ms"] > 0
    assert m["trace_timing"] == manifests["jax"]["trace_timing"]
    assert {"deliver", "capture"} <= {s["name"] for s in m["spans"]}


def _fake_capture(cls):
    class FakeCapture(cls):
        """The capture's start and stop stubbed: this scenario is about
        the rendezvous, not the profiler."""

        def _start_trace(self, cfg):
            self.trace_timing["trace_start"] = time.time()

        def _stop_trace(self):
            self.trace_timing["trace_stop"] = time.time()
            self.captures_completed += 1

    return FakeCapture


def test_daemon_restart_rendezvous_survives(daemon_bin, monkeypatch):
    """SIGKILL the daemon and start a fresh one on the same socket: a live
    client of each shim re-registers unprompted, counts the restart, and
    still receives a config."""
    with daemon(daemon_bin, monkeypatch) as d:
        clients = {name: _fake_capture(cls)(
            job_id=f"rs_{name}", poll_interval_s=0.2, backoff_cap_s=0.5,
            metrics_interval_s=3600) for name, cls in shims()}
        try:
            for c in clients.values():
                c.start()

            def registered(n):
                return DynoClient(port=d["port"]).status()[
                    "registered_processes"] == n

            wait_for(lambda: registered(2), 10, "registration")
            d["proc"].kill()  # no cleanup: the next daemon reclaims
            d["proc"].wait(timeout=5)
            t_kill = time.monotonic()
            d["proc"], d["port"] = spawn_daemon(daemon_bin)
            wait_for(lambda: registered(2), 15, "re-registration")
            reregistered_s = time.monotonic() - t_kill
            rpc = DynoClient(port=d["port"])
            for c in clients.values():
                resp = rpc.set_trace_config(
                    job_id=c.job_id,
                    config='{"type": "xplane", "duration_ms": 50}')
                assert len(resp["activityProfilersTriggered"]) == 1
            wait_for(lambda: all(c.captures_completed == 1
                                 for c in clients.values()), 10, "captures")
        finally:
            for c in clients.values():
                c.stop()
    assert reregistered_s < 15
    for name, c in clients.items():
        counters = c.spans.counters()
        assert counters.get("daemon_restarts_detected", 0) >= 1, \
            (name, counters)
        assert counters.get("reregistrations", 0) >= 1, (name, counters)


def _registration(cls, monkeypatch):
    short_sock_dir(monkeypatch)
    c = cls(job_id="reg")
    sent = Sent(c)
    try:
        c._register()
    finally:
        c._fabric.close()
    (ctxt,) = sent.of_type("ctxt")
    return json.loads(ctxt[4:])


def test_registration_metadata_differs_only_in_device_keys(monkeypatch):
    """By design the port sends torch's view of the devices: 1 and "cpu"
    without CUDA in use, torch.cuda.device_count() and "gpu" with it,
    where the reference sends jax.local_device_count() and the first
    device's platform. Every other byte of the 'ctxt' body is the
    reference's."""
    import dynolog_tpu_torch.client.shim as torch_shim
    import jax

    body = {name: _registration(cls, monkeypatch) for name, cls in shims()}
    meta = body["torch"]["metadata"]
    assert (meta["device_count"], meta["platform"]) == (1, "cpu")
    ref = body["jax"]["metadata"]
    assert (ref["device_count"], ref["platform"]) == (
        jax.local_device_count(), jax.local_devices()[0].platform)
    for b in body.values():
        for key in ("device_count", "platform"):
            del b["metadata"][key]
    assert body["torch"] == body["jax"]

    monkeypatch.setattr(torch_shim, "_cuda_in_use", lambda: True)
    meta = _registration(shims()[0][1], monkeypatch)["metadata"]
    assert (meta["device_count"], meta["platform"]) == (
        torch.cuda.device_count(), "gpu")


def test_profiler_server_port_is_logged_not_advertised(
        daemon_bin, monkeypatch, caplog):
    """torch.profiler has no server: where the reference starts
    jax.profiler's and advertises `profiler_port`, the port logs a
    warning and registers without the key."""
    from dynolog_tpu_torch.client import DynologClient

    with daemon(daemon_bin, monkeypatch) as d:
        c = DynologClient(job_id="pport", profiler_server_port=9012,
                          metrics_interval_s=3600)
        with caplog.at_level(logging.WARNING,
                             logger="dynolog_tpu_torch.client"):
            c.start()
        try:
            rpc = DynoClient(port=d["port"])
            procs = wait_for(lambda: rpc.trace_registry().get(
                "jobs", {}).get("pport"), 10, "registration")
        finally:
            c.stop()
    assert "profiler_port" not in procs[0]["metadata"], procs
    assert any("profiler_server_port=9012 ignored" in r.getMessage()
               for r in caplog.records), caplog.records
