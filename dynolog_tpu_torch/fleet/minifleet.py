"""Mini-fleet harness: N local daemons + N registered fake-capture
clients playing N pod hosts on one machine.

The port's copy of ``dynolog_tpu/fleet/minifleet.py`` — spawn, wait,
teardown and token files — with the fake clients built on the torch
shim. The relay-tree, seeded-topology, ICI-ring and restart helpers
stay with the JAX package until the port's tests need them. Shared by ``tests/test_torch_fleet.py``
and the RPC fan-out tests, so they cannot drift apart in spawn flags,
registration protocol, or timing keys.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time

from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from dynolog_tpu_torch.utils.rpc import DynoClient


class FakeCaptureClient(DynologClient):
    """The real torch shim with the profiler cut out: it keeps the
    shim's config delivery, synchronized start and trace_timing, and
    skips torch.profiler (one profiler session per process, and all
    fleet "hosts" share this process; the real capture boundary is
    covered by test_torch_trace_e2e). No fake host calls step(), so
    every capture takes the shim's capture-thread path, whose
    ``_finish_trace`` has no stopped profile to export: the fake counts
    the capture and sends the manifest in ``_stop_trace`` instead.
    ``write_fake_trace=True`` drops a placeholder ``.pt.trace.json``
    where the real capture would export one."""

    def __init__(self, *args, write_fake_trace: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self._write_fake_trace = write_fake_trace

    def _trace_dir(self, cfg):
        # All fake "hosts" share one real hostname + pid, so the shim's
        # <host>_<pid> layout would collapse every capture (and its
        # daemon-written manifest) into ONE directory. Suffix the unique
        # fabric endpoint so each fake host keeps its own dir, as
        # distinct hosts would.
        return (super()._trace_dir(cfg)
                + "_" + self._fabric.endpoint_name[-8:])

    def _start_trace(self, cfg):
        self.trace_timing["trace_start"] = time.time()
        # Create the output dir and remember it exactly like the real
        # shim: the manifest grant (_send_trace_manifest) opens it to
        # hand the daemon an fd, so the daemon-written manifest — and
        # the spans inside it — exist for fleet tests and
        # `trace_report` even though the capture is fake.
        out = self._trace_dir(cfg)
        os.makedirs(out, exist_ok=True)
        self._last_trace_dir = out
        self.trace_timing["start_returned"] = time.time()
        if self._write_fake_trace:
            with open(os.path.join(
                    out, f"fake_{self._fabric.endpoint_name}.pt.trace.json"),
                    "w") as f:
                f.write('{"traceEvents": []}')

    def _stop_trace(self):
        self.trace_timing["stop_begin"] = time.time()
        self.trace_timing["trace_stop"] = time.time()
        self.captures_completed += 1
        self._send_trace_manifest()


def _spawn_daemon(daemon_bin, socket_name, daemon_args=()):
    """One daemon on an ephemeral RPC port with slow collector
    cadences; returns (Popen, port) once the daemon has printed its
    bound port. Raises on a daemon that exits or never prints one."""
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0",
         "--kernel_monitor_interval_s", "3600",
         "--tpu_monitor_interval_s", "3600",
         "--enable_perf_monitor=false",
         "--ipc_socket_name", socket_name,
         *daemon_args],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
    if not m:
        try:
            proc.kill()
        except OSError:
            pass
        raise RuntimeError(f"daemon on {socket_name} gave no port: {buf!r}")
    return proc, int(m.group(1))


def write_token_file(path, entries):
    """Writes a ``--fleet_token_file`` for an authenticated minifleet:
    ``entries`` are ``(token, tenant)`` or ``(token, tenant, tier)``
    tuples, one line each. Returns ``str(path)`` ready for
    ``daemon_args``. Convention: put the fleet fabric identity first and
    at admin tier (``("fleetsecret", "fleet", "admin")``) — the daemons
    sign their own tree traffic as the FIRST tenant unless
    --fleet_auth_identity says otherwise, and down-tree fleetTrace
    forwarding needs the admin gang-capture gate."""
    text = "\n".join(":".join(str(x) for x in e) for e in entries) + "\n"
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return str(path)


def auth_args(token_file):
    """The ``daemon_args`` fragment that turns the multi-tenant control
    plane on for every spawn helper in this module."""
    return ("--fleet_token_file", str(token_file))


def spawn_daemons(daemon_bin, n, socket_prefix, daemon_args=()):
    """Daemons only, no clients — fleetstatus tests/bench inject history
    via putHistory instead of registering capture shims. Returns
    [(Popen, port)]; tear down with ``teardown(daemons, [])``."""
    daemons = []
    try:
        for i in range(n):
            daemons.append(
                _spawn_daemon(daemon_bin, f"{socket_prefix}{i}",
                              daemon_args))
    except Exception:
        teardown(daemons, [])
        raise
    return daemons


def spawn(daemon_bin, n, socket_prefix, daemon_args=(), job_id="fleet",
          poll_interval_s=0.5, write_fake_trace=False):
    """Spawns n daemons (RPC port 0, slow collector cadences) and one
    registered FakeCaptureClient per daemon. Returns (daemons, clients)
    where daemons is [(Popen, port)]. On any failure the partial fleet
    is torn down before the exception propagates — callers still wrap
    the whole usage in try/finally teardown()."""
    daemons, clients = [], []
    try:
        for i in range(n):
            daemons.append(
                _spawn_daemon(daemon_bin, f"{socket_prefix}{i}",
                              daemon_args))
            c = FakeCaptureClient(
                job_id=job_id, daemon_socket=f"{socket_prefix}{i}",
                poll_interval_s=poll_interval_s,
                write_fake_trace=write_fake_trace)
            c.start()
            clients.append(c)
    except Exception:
        teardown(daemons, clients)
        raise
    return daemons, clients


def wait_registered(daemons, timeout_s=15.0):
    """Waits until every daemon reports exactly one registered process.
    A daemon that is down mid-poll (connection refused — kill chaos
    windows hit this constantly) counts as "not ready yet", not an
    error: the answer at the deadline is False, same as any other
    not-ready state."""
    def _ready(port):
        try:
            return (DynoClient(port=port).status()
                    ["registered_processes"] == 1)
        except (OSError, ConnectionError, TimeoutError, ValueError):
            return False

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(_ready(p) for _, p in daemons):
            return True
        time.sleep(0.1)
    return False


def wait_captures(clients, count=1, timeout_s=20.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(c.captures_completed == count for c in clients):
            return True
        time.sleep(0.1)
    return False


def kill_daemon(daemons, i):
    """Chaos helper: hard-kill daemon i (SIGKILL — a host dying, not a
    clean shutdown). Idempotent; teardown tolerates the corpse."""
    proc, _ = daemons[i]
    try:
        proc.kill()
    except OSError:
        pass
    proc.wait()


def capture_windows(clients):
    """[(trace_start, trace_stop)] for clients that completed a capture."""
    return [
        (c.trace_timing["trace_start"], c.trace_timing["trace_stop"])
        for c in clients
        if "trace_start" in c.trace_timing and
        "trace_stop" in c.trace_timing
    ]


def windows_intersect(windows) -> bool:
    """True when every capture window shares a common instant — the
    latest start strictly precedes the earliest stop. This is actual
    mutual overlap, not a spread bound: a spread smaller than some
    tolerance proves nothing when the capture duration is shorter than
    the tolerance."""
    if not windows:
        return False
    return max(w[0] for w in windows) < min(w[1] for w in windows)


def teardown(daemons, clients):
    for c in clients:
        try:
            c.stop()
        except Exception:
            pass
    for proc, _ in daemons:
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            pass  # already dead (chaos tests kill daemons mid-run)
    for proc, _ in daemons:
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
