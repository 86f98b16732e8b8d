"""Mini-fleet harness: N local daemons + N registered fake-capture
clients playing N pod hosts on one machine.

The port's copy of ``dynolog_tpu/fleet/minifleet.py``, with the fake
clients built on the torch shim. Shared by the port's fleet, fan-out and
flight-recorder tests, so they cannot drift apart in spawn flags,
registration protocol, or timing keys.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import time

from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.utils import faultline
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
    where the real capture would export one, and its flight-recorder
    windows are fake payloads over real wall-clock spans."""

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

    def _retro_capture_window(self, window_ms):
        # Flight-recorder window without torch.profiler: real wall-clock
        # span (the merged report's pre-trigger timeline uses these
        # stamps), fake bytes. Payload is unique per window so
        # ring-eviction and dedupe tests can tell windows apart.
        t0_ms = int(time.time() * 1000)
        time.sleep(max(window_ms, 1) / 1000.0)
        t1_ms = int(time.time() * 1000)
        data = (f"retro-{self._fabric.endpoint_name}-{self._retro_seq}"
                .encode() * 64)
        return data, t0_ms, t1_ms


def _spawn_daemon(daemon_bin, socket_name, daemon_args=(), port=0,
                  env=None):
    """One daemon with slow collector cadences; returns (Popen, port)
    once the daemon has printed its bound port. Raises on a daemon that
    exits or never prints one. ``port`` defaults to 0 (ephemeral);
    seeded topologies pass a pre-reserved fixed port so the node's
    identity matches its seed-list entry. ``env`` overlays os.environ —
    chaos tests arm faultline scopes per daemon through it."""
    run_env = None
    if env:
        run_env = dict(os.environ)
        run_env.update(env)
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", str(port),
         "--kernel_monitor_interval_s", "3600",
         "--tpu_monitor_interval_s", "3600",
         "--enable_perf_monitor=false",
         "--ipc_socket_name", socket_name,
         *daemon_args],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=run_env)
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


def free_ports(n):
    """n distinct currently-free TCP ports. All sockets are held open
    until every port is picked, then released together — the usual
    bind-0 trick, raceable in principle but reliable for test spawns
    that bind the ports right back."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def seed_rank(s: str) -> int:
    """FNV-1a 64 over the id string — the exact rendezvous hash the
    daemon uses (native twin: fleettree/FleetTree.cpp fleetHash64), so
    tests and bench can predict which seed is root and which seed a
    node parents to without asking the daemons."""
    h = 14695981039346656037
    for b in s.encode():
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def expected_root(seeds):
    """The seed every node converges on as root: highest seed_rank
    (hash ties break toward the lexicographically smaller id, matching
    the native candidate order)."""
    return sorted(seeds, key=lambda s: (-seed_rank(s), s))[0]


def spawn_seeded(daemon_bin, socket_prefix, seeds=3, leaves=0,
                 daemon_args=(), host=None, env=None):
    """A self-forming topology: no --parent hand-wiring anywhere. Picks
    ``seeds`` free ports up front, builds the ``--fleet_seeds`` CSV from
    them, then spawns the seed daemons on those FIXED ports and
    ``leaves`` more daemons on ephemeral ports — every one with only the
    seed list. The tree shape (which seed is root, who parents where) is
    entirely the daemons' rendezvous choice.

    ``host`` defaults to this machine's hostname, which must resolve
    locally (single-machine harness) so the daemons both recognize the
    seed entries as themselves and can dial each other. Returns
    (daemons, seed_list) where daemons is [(Popen, port)] seeds-first
    in seed-list order."""
    if host is None:
        host = socket.gethostname()
    ports = free_ports(seeds)
    seed_list = [f"{host}:{p}" for p in ports]
    csv = ",".join(seed_list)
    daemons = []
    try:
        for i, p in enumerate(ports):
            daemons.append(_spawn_daemon(
                daemon_bin, f"{socket_prefix}seed{i}",
                (*daemon_args, "--fleet_seeds", csv), port=p, env=env))
        for i in range(leaves):
            daemons.append(_spawn_daemon(
                daemon_bin, f"{socket_prefix}leaf{i}",
                (*daemon_args, "--fleet_seeds", csv), env=env))
    except Exception:
        teardown(daemons, [])
        raise
    return daemons, seed_list


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


def ici_ring_args(n, index):
    """The ``daemon_args`` fragment that topologizes daemon ``index`` of
    an n-host ring (link 0 toward the previous neighbor, link 1 toward
    the next; see native/src/common/IciTopology.h for the edge naming
    convention fleetstatus scores against)."""
    return ("--ici_topology", f"ring:{n}", "--ici_ring_index", str(index))


def ring_link_series(n, base_bps=1_000_000.0, *, points=8,
                     interval_s=5.0, end_ms=None, jitter_pct=2.0):
    """Per-host per-link ICI history for an n-host ring, ready for
    ``DynoClient.put_history``: returns a list of n dicts (one per ring
    index) mapping ``ici_link<k>_{tx,rx,stalls}...`` keys to
    ``[(ts_ms, value), ...]`` samples.

    Both endpoints of ring edge e (host e's link 1 and host e+1's
    link 0) see the SAME edge rate — base_bps shaped by a deterministic
    per-edge jitter within ±jitter_pct% (seed_rank-derived, so healthy
    edges differ enough that the fleet MAD never degenerates to zero
    and the robust-z fallback can't saturate; see fleetstatus module
    docstring).

    Honors the ``ici_link`` faultline scope in lockstep with the native
    TpuMonitor poll path: ``ici_link.degrade_link=<edge>`` scales that
    edge's tx/rx on BOTH endpoints by ``ici_link.degrade_factor`` and
    adds ``ici_link.link_stalls`` stalls/s — so a topology test degrades
    one link with the same DYNOLOG_TPU_FAULTS spec a live daemon would.
    """
    if end_ms is None:
        end_ms = int(time.time() * 1000)
    faults = faultline.for_scope("ici_link")
    degrade_edge = int(faults.value("degrade_link", -1)) if faults else -1
    factor = faults.value("degrade_factor", 1.0) if faults else 1.0
    stalls = faults.value("link_stalls", 0.0) if faults else 0.0

    def edge_rate(e):
        # Deterministic per-edge shaping in [-jitter_pct, +jitter_pct]%.
        frac = (seed_rank(f"edge{e}") % 10_000) / 10_000.0
        rate = base_bps * (1.0 + (2.0 * frac - 1.0) * jitter_pct / 100.0)
        return rate * factor if e == degrade_edge else rate

    stamps = [end_ms - (points - 1 - i) * int(interval_s * 1000)
              for i in range(points)]
    out = []
    for i in range(n):
        series = {}
        # link 0 carries edge (i-1)%n, link 1 carries edge i.
        for link, edge in ((0, (i - 1) % n), (1, i)):
            rate = edge_rate(edge)
            s = stalls if edge == degrade_edge else 0.0
            for kind, val in (("tx_bytes_per_s", rate),
                              ("rx_bytes_per_s", rate),
                              ("stalls_per_s", s)):
                series[f"ici_link{link}_{kind}.dev0"] = [
                    (ts, val) for ts in stamps]
        out.append(series)
    return out


def inject_ring_links(daemons, series):
    """putHistory every host's ring_link_series into its daemon (which
    must run with --enable_history_injection). daemons[i] pairs with
    series[i] — ring index i is daemons[i] by convention."""
    for (_, port), host_series in zip(daemons, series):
        client = DynoClient(port=port)
        for key, samples in host_series.items():
            client.put_history(key, samples)


def spawn_tree(daemon_bin, socket_prefix, leaves=2, daemon_args=(),
               relays=1):
    """A 2-level relay tree on one machine: one root, `relays` mid-tier
    relay daemon(s) registered to it via --parent, and `leaves` leaf
    daemons per relay registered to their relay. Returns [(Popen, port)]
    root-first, then relays, then leaves (teardown with
    ``teardown(daemons, [])``). Extra ``daemon_args`` apply to every
    node; fleettree tests pass fast --fleet_report_interval_s /
    --fleet_stale_after_s here."""
    daemons = []
    try:
        daemons.append(
            _spawn_daemon(daemon_bin, f"{socket_prefix}root", daemon_args))
        root_port = daemons[0][1]
        relay_ports = []
        for r in range(relays):
            daemons.append(_spawn_daemon(
                daemon_bin, f"{socket_prefix}relay{r}",
                (*daemon_args, "--parent", f"localhost:{root_port}")))
            relay_ports.append(daemons[-1][1])
        for r, relay_port in enumerate(relay_ports):
            for i in range(leaves):
                daemons.append(_spawn_daemon(
                    daemon_bin, f"{socket_prefix}r{r}leaf{i}",
                    (*daemon_args, "--parent", f"localhost:{relay_port}")))
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


def _storage_dir_from_args(daemon_args):
    """The --storage_dir value in a daemon arg list (either
    ``--storage_dir <d>`` or ``--storage_dir=<d>``), or None."""
    args = list(daemon_args)
    for j, a in enumerate(args):
        if a == "--storage_dir" and j + 1 < len(args):
            return args[j + 1]
        if a.startswith("--storage_dir="):
            return a.split("=", 1)[1]
    return None


def restart_daemon(daemons, i, daemon_bin, socket_prefix, daemon_args=(),
                   preserve_storage=True):
    """Chaos helper: the supervisor half of a kill/restart cycle — kills
    daemon i if still up, then brings up a FRESH daemon process on the
    same fabric socket (new instance epoch, empty registry, new RPC
    port). daemons[i] is replaced in place; returns the new (proc, port).
    The already-running client on that socket is deliberately untouched:
    the point of the exercise is watching it detect the epoch change and
    re-register on its own.

    ``preserve_storage`` (default on) keeps the daemon's --storage_dir
    across the restart — the real host-reboot scenario, where the
    durable tier recovers events/history. Pass False to model a host
    re-imaged from scratch: the storage dir is wiped before the new
    instance starts."""
    proc, _ = daemons[i]
    if proc.poll() is None:
        kill_daemon(daemons, i)
    if not preserve_storage:
        storage_dir = _storage_dir_from_args(daemon_args)
        if storage_dir:
            shutil.rmtree(storage_dir, ignore_errors=True)
    daemons[i] = _spawn_daemon(daemon_bin, f"{socket_prefix}{i}",
                               daemon_args)
    return daemons[i]


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
