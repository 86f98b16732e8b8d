"""Helpers shared by the control-plane tests of the port's client shim
(tests/test_torch_{phases,actuation,rendezvous,control}.py).

Every scenario there runs on the shared C++ daemon, first with the
port's ``dynolog_tpu_torch.client.DynologClient`` and, where the outcome
is a value, with the reference ``dynolog_tpu.client.DynologClient`` on
the same scenario, so the port is held to what the reference does.

Socket directories come from ``tempfile.mkdtemp(prefix="dt")``, not
pytest's ``tmp_path``: under xdist a per-test path plus a socket name
can pass AF_UNIX's 108-byte limit.
"""

import contextlib
import shutil
import signal
import subprocess
import tempfile
import time

import pytest

from dynolog_tpu_torch.utils.procutil import wait_for_stderr

# The daemon's collectors idle: these tests drive the IPC fabric only.
QUIET_FLAGS = (
    "--kernel_monitor_interval_s", "3600",
    "--tpu_monitor_interval_s", "3600",
    "--enable_perf_monitor=false",
    "--tpu_runtime_metrics_addr=",
)


def shims():
    """(name, DynologClient class) of the port and of the reference."""
    from dynolog_tpu.client import DynologClient as JaxClient
    from dynolog_tpu_torch.client import DynologClient as TorchClient
    return (("torch", TorchClient), ("jax", JaxClient))


def short_sock_dir(monkeypatch):
    """A fresh socket directory, named in $DYNOLOG_TPU_SOCKET_DIR for this
    test only. The caller removes it (see ``daemon``)."""
    sock_dir = tempfile.mkdtemp(prefix="dt")
    monkeypatch.setenv("DYNOLOG_TPU_SOCKET_DIR", sock_dir)
    return sock_dir


def spawn_daemon(daemon_bin, *flags):
    """A daemon on --port 0 with its fabric in $DYNOLOG_TPU_SOCKET_DIR.
    Returns (proc, port); stop it with ``stop_daemon``."""
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0", *QUIET_FLAGS, *flags],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
    if not m or "ipc: serving" not in buf:
        stop_daemon(proc)
        pytest.fail(f"daemon did not start: {buf!r}")
    return proc, int(m.group(1))


def stop_daemon(proc, sig=signal.SIGTERM):
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)


@contextlib.contextmanager
def daemon(daemon_bin, monkeypatch, *flags):
    """A daemon in a fresh short socket dir; yields a dict holding
    ``proc`` and ``port``, which a test that restarts the daemon updates
    so teardown stops the live one."""
    sock_dir = short_sock_dir(monkeypatch)
    d = {}
    try:
        d["proc"], d["port"] = spawn_daemon(daemon_bin, *flags)
        yield d
    finally:
        if "proc" in d:
            stop_daemon(d["proc"])
        shutil.rmtree(sock_dir, ignore_errors=True)


def wait_for(predicate, timeout_s=10.0, what="condition", interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval_s)
    pytest.fail(f"timed out after {timeout_s:.0f}s waiting for {what}")


def stub_capture(client):
    """Replaces the client's capture with a recorder: delivery tests
    measure config delivery, not the profiler. ``_on_config`` still
    stamps ``config_received``/``delivery`` and takes the busy slot
    before the stub runs, as for the real capture thread."""
    got = []

    def fake_capture(cfg):
        got.append(cfg)
        with client._capture_lock:
            client._capturing = False

    client._capture = fake_capture
    return got


class Sent:
    """Records what a client's fabric sends instead of sending it, as
    the encoded datagram bytes the daemon would read."""

    def __init__(self, client):
        self.datagrams = []
        self._encode = client._fabric._encode
        client._fabric.send = self._send
        client._fabric.send_with_fd = lambda t, b, fd: self._send(t, b)

    def _send(self, msg_type, body):
        self.datagrams.append(self._encode(msg_type, body))
        return True

    def of_type(self, tag):
        return [d for d in self.datagrams if d[:4] == tag.encode()]


class FakeClock:
    """Stands in for a shim module's ``time``: ``time()`` steps by 0.25 s
    a call from a fixed epoch, so two shims that read the clock in the
    same order stamp the same values."""

    def __init__(self, start=1_700_000_000.0, step=0.25):
        self._t = start
        self._step = step

    def time(self):
        self._t += self._step
        return self._t

    def monotonic(self):
        return time.monotonic()

    def perf_counter(self):
        return time.perf_counter()

    def sleep(self, seconds):
        time.sleep(seconds)
