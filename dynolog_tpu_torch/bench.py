"""The port's headline benchmark: the monitoring stack's step-time
overhead and its on-demand trace latency, with the client-side phases of
the reference's ``bench.py``, on the torch shim and the flagship train
step, then bench.py's fleet and recovery phases on the port's fleet code.

    python -m dynolog_tpu_torch.bench                  # one CUDA card
    python -m dynolog_tpu_torch.bench --quick          # fewest rounds
    python -m dynolog_tpu_torch.bench --device cpu --quick --tiny
    python -m dynolog_tpu_torch.bench --only fleet_selfheal

``--quick`` runs every phase in its fewest rounds and trials, the
fan-out at 8 hosts only, the self-heal and the multi-tenant storm at 4
seeds + 20 leaves, 100 subscribers and 8 x 32 simulated hosts;
``--tiny`` (for the CPU) a 2-layer flagship, one burner, every fleet
and daemon-side phase at 4 daemons or fewer and one trial, and the
sketch at a tenth of its samples. ``--only PHASE`` (repeatable) runs
just those phases of the second list below, without the card's.

Phases, each a key of ``detail`` in the one JSON line printed last:

  overhead             ms/step of the flagship step with no client
                       against a client that polls every 0.5 s, pushes
                       metrics every 1 s and sees step() on every
                       iteration, in rotating windows of ~2 s, against
                       a daemon whose collectors tick every 1 s; the
                       collectors' tick cost and the daemon's RSS
  trace_latency        5 on-demand captures of 300 ms (after two warm
                       ones) while the card trains, with the shipped
                       client (push and stream on, 1.0 s poll): RPC
                       accepted -> first artifact byte, split into the
                       shim's trace_timing stamps
  trace_latency_poll_fallback
                       the same with push and stream off
  phase_attribution    the daemon's kernel-collector cadence with ~20
                       phase annotations a second against none, and the
                       cpu_util getPhases reads back for a busy-spin
                       and a sleeping phase
  loaded_host          one sha256 burner per CPU, alone and beside the
                       daemon and a torch-shim client (B L B L B)
  flight_recorder      kernel-collector cadence with the retro ring on
                       against off, watch rule firing -> retro_manifest
                       .json, and ms/step of the flagship under the
                       full client with the ring on against off

The fleet, recovery and daemon-side phases leave the card idle and run
in bench.py's order, each with its own daemons, on the port's minifleet
(fake torch shim captures), fleetstatus, eventlog, sketch, faultline and
RPC client:

  fleet                {hosts: ...}: unitrace fan-out RPC to 8 and 64
                       daemons and the spread of the synchronized starts
  restart_recovery     SIGKILL + restart of a daemon -> the running shim
                       re-registered, 4 hosts x 3 trials
  fleet_health         a fleetstatus sweep of 4 daemons, one straggler
  fleet_tree           one getFleetStatus to a 64-host relay tree's root
                       against the flat sweep
  fleet_selfheal       a fleet of 16 seeds + 240 leaves: sweeps, gang
                       trigger, re-parenting after seed kills, root
                       promotion
  event_journal        emit cost per event, drain of a full 1024 ring
  degraded_mode        kernel-collector cadence with the tpu collector
                       stalled and the HTTP sink dead, against healthy
  autocapture          watch rule firing -> first fake trace on 3 hosts
  durability           kernel cadence with the WAL and flusher on against
                       no storage; kill -9 of a 1 MB store filled past
                       its budget -> the restarted daemon answering
  sketch_quantiles     QuantileSketch's worst relative error on three
                       workloads of 200,000 samples, buckets and wire
                       bytes at 1 M, depth-3 tree merges a second
  read_swarm           waves of 200 concurrent getAggregates readers for
                       6 s: read p50/p99, cadence under the swarm
  multitenant          kernel cadence with HMAC auth under signed load;
                       a polite tenant's read p99 alone and beside a 10x
                       abuser; an authenticated 256-daemon re-parent storm
  link_localization    a 16-host ICI ring with one edge at 60 %: the edge
                       flagged alone, link against host-only sweeps
  subscription         500 subscribers at a 13-daemon tree's root: leaf
                       event -> every socket, steady RPC rate
  fleet_scale          1,024 simulated hosts over 8 interiors: root sweep,
                       batched fan-in bytes, reconvergence after an
                       interior's kill

It sets no target: a phase that fails ends the run with a non-zero exit
code and the phase's name on stderr, and no JSON line. ``detail``
also holds ``phase_s`` (each phase's wall time) and ``host_state``
(open descriptors, threads and live daemons before each daemon-side
phase). ``--device cuda``
(the default) raises where CUDA is absent. The window machinery here is
shared with ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import glob
import io
import json
import logging
import math
import os
import pathlib
import random
import resource
import selectors
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import torch

from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.fleet import eventlog, fleetstatus, minifleet, unitrace
from dynolog_tpu_torch.fleet.sketch import RELATIVE_ERROR_BOUND, QuantileSketch
from dynolog_tpu_torch.models.train import make_train_step, run_annotated_loop
from dynolog_tpu_torch.models.transformer import (
    ModelConfig,
    load_jax_params,
    resolve_device,
)
from dynolog_tpu_torch.utils import faultline
from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from dynolog_tpu_torch.utils.rpc import DynoClient, RetryPolicy, fan_out

REPO = pathlib.Path(__file__).resolve().parent.parent

# bench.py:make_step's flagship configuration (~34.1 M parameters).
FLAGSHIP = ModelConfig(vocab_size=8192, d_model=512, n_layers=8, n_heads=8,
                       d_ff=1408, max_seq_len=512,
                       compute_dtype=torch.bfloat16, remat=True)
BATCH, SEQ = 8, 512
# --tiny, for runs on the CPU: 2 layers, d_model 64, float32.
TINY = ModelConfig.tiny(compute_dtype=torch.float32)
TINY_BATCH, TINY_SEQ = 2, 64
JOB = "bench"
WINDOW_MS = 300  # bench.py's capture window for the latency phase
RETRO_WINDOW_MS = 500
# The shim's trace_timing stamps of one capture, as intervals.
BREAKDOWN = {
    "rpc_to_config": ("rpc", "config_received"),
    "config_to_start": ("config_received", "trace_start"),
    "start_call": ("trace_start", "start_returned"),
    "start_to_stop": ("trace_start", "trace_stop"),
    "stop_call": ("stop_begin", "trace_stop"),
    "stop_to_artifact": ("trace_stop", "export_done"),
    "stop_to_stream_commit": ("trace_stop", "stream_commit"),
}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Rounds, trials and windows of every phase."""
    overhead_rounds: int = 8
    window_ms: float = 2000.0      # target length of a timed window
    min_steps: int = 20            # the fewest steps in a timed window
    trace_warm: int = 2
    trace_trials: int = 5
    phase_window_s: float = 4.0
    burners: int = 0               # 0: one per CPU
    burn_s: float = 8.0            # a burner's calibrated loop
    loaded_order: str = "blblb"
    fr_window_s: float = 4.0
    fr_firings: int = 3
    ring_rounds: int = 4
    # The fleet and recovery phases: bench.py's defaults.
    fleet_hosts: tuple[int, ...] = (8, 64)
    restart_hosts: int = 4
    restart_trials: int = 3
    fstat_hosts: int = 4
    tree_hosts: int = 64
    tree_relays: int = 7
    tree_trials: int = 15
    heal_seeds: int = 16
    heal_leaves: int = 240
    heal_kill_trials: int = 3
    heal_sweep_trials: int = 7
    heal_trigger_trials: int = 3
    journal_capacity: int = 1024
    degraded_window_s: float = 5.0
    autocapture_rules: int = 5
    durability_window_s: float = 4.0
    sketch_samples: int = 200_000
    sketch_big_samples: int = 1_000_000
    swarm_readers: int = 200
    swarm_waves: int = 5
    swarm_min_wall_s: float = 6.0
    mt_seeds: int = 16
    mt_leaves: int = 240
    mt_kill_trials: int = 2
    mt_polite_reads: int = 200
    link_hosts: int = 16
    link_edge: int = 5
    link_trials: int = 15
    link_min_wall_s: float = 3.0
    sub_subscribers: int = 500
    sub_rounds: int = 5
    sub_leaves: int = 3
    sub_relays: int = 3
    scale_interiors: int = 8
    scale_children: int = 32
    scale_hosts_per_child: int = 32
    scale_sweeps: int = 20
    scale_byte_window_s: float = 10.0


FULL = Sizes()
# Every phase, each key with a number, in the fewest rounds.
QUICK = Sizes(overhead_rounds=2, window_ms=500.0, min_steps=5,
              trace_warm=1, trace_trials=1, phase_window_s=1.0, burn_s=1.0,
              loaded_order="blb", fr_window_s=1.0, fr_firings=1,
              ring_rounds=1, fleet_hosts=(8,), restart_trials=1,
              tree_trials=3, heal_seeds=4, heal_leaves=20,
              heal_kill_trials=1, heal_sweep_trials=3,
              heal_trigger_trials=1, degraded_window_s=1.0,
              autocapture_rules=2, durability_window_s=1.0,
              swarm_readers=50, swarm_min_wall_s=2.0, mt_seeds=4,
              mt_leaves=20, mt_kill_trials=1, mt_polite_reads=50,
              link_trials=3, sub_subscribers=100, sub_rounds=2,
              scale_interiors=4, scale_children=8, scale_sweeps=5,
              scale_byte_window_s=5.0)
# --tiny's fleet and daemon-side phases: at most 4 daemons each (a
# restart adds one), a single trial, the sketch at a tenth of its
# samples.
TINY_FLEET = dict(fleet_hosts=(4,), restart_hosts=2, restart_trials=1,
                  fstat_hosts=4, tree_hosts=4, tree_relays=1, tree_trials=1,
                  heal_seeds=3, heal_leaves=1, heal_kill_trials=1,
                  heal_sweep_trials=1, heal_trigger_trials=1,
                  degraded_window_s=1.0, autocapture_rules=1,
                  durability_window_s=1.0, sketch_samples=20_000,
                  sketch_big_samples=100_000, swarm_readers=20,
                  swarm_waves=1, swarm_min_wall_s=0.5, mt_seeds=3,
                  mt_leaves=1, mt_kill_trials=1, mt_polite_reads=10,
                  link_hosts=4, link_edge=1, link_trials=1,
                  link_min_wall_s=0.5, sub_subscribers=8, sub_rounds=1,
                  sub_leaves=2, sub_relays=1, scale_interiors=3,
                  scale_children=3, scale_hosts_per_child=4,
                  scale_sweeps=1, scale_byte_window_s=1.0)


class BenchError(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise BenchError(what)


def wait_for(predicate, timeout_s, what, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval_s)
    # Where every thread is when a phase stalls: the shim's work runs on
    # the training, poll and capture threads.
    faulthandler.dump_traceback(all_threads=True)
    raise BenchError(f"timed out after {timeout_s:.0f}s waiting for {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def build_native() -> tuple[pathlib.Path, pathlib.Path, float]:
    """scripts/build.sh from the checkout: (daemon, dyno, seconds)."""
    t0 = time.monotonic()
    out = subprocess.run([str(REPO / "scripts" / "build.sh")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise BenchError(f"native build failed:\n{out.stdout[-2000:]}\n"
                         f"{out.stderr[-4000:]}")
    for sub in ("build", "build-manual"):
        d = REPO / "native" / sub
        if (d / "dynolog_tpu_daemon").exists() and (d / "dyno").exists():
            return (d / "dynolog_tpu_daemon", d / "dyno",
                    time.monotonic() - t0)
    raise BenchError("build produced no dynolog_tpu_daemon/dyno")


def start_daemon(daemon_bin, *flags, env=None):
    """The daemon on --port 0 with fabric sockets in
    $DYNOLOG_TPU_SOCKET_DIR and its collectors idle (later flags win),
    in ``env`` (default: this process's environment). Returns
    (proc, port); stop it with stop_daemon."""
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0",
         "--kernel_monitor_interval_s", "3600",
         "--tpu_monitor_interval_s", "3600", *flags],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env)
    m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
    if m is None:
        stop_daemon(proc)
        raise BenchError(f"daemon did not start: {buf[-2000:]}")
    return proc, int(m.group(1))


def stop_daemon(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _drained(started):
    """A started daemon's (proc, port) with its log drained: a collector
    that ticks logs every tick, and a full pipe would block the daemon."""
    proc, port = started
    threading.Thread(target=proc.stderr.read, daemon=True).start()
    return proc, port


def trigger_gputrace(dyno_bin, port, job, log_dir, duration_ms=500):
    out = subprocess.run(
        [str(dyno_bin), "--port", str(port), "gputrace",
         "--job_id", job, "--duration_ms", str(duration_ms),
         "--log_dir", log_dir],
        capture_output=True, text=True, timeout=30)
    check(out.returncode == 0 and "Triggered 1" in out.stdout,
          f"dyno gputrace: {out.stdout} {out.stderr}")


class TrainingThread:
    """Runs the annotated flagship loop with the client's step() hook
    until stopped; remembers its native thread id, every loss and every
    step's wall time."""

    def __init__(self, step_fn, make_batch, client):
        self.losses: list[float] = []
        self.step_ms: list[float] = []
        self.error: Exception | None = None
        self.tid: int | None = None
        self._stop = threading.Event()
        self._args = (step_fn, make_batch, client)
        self._thread = threading.Thread(target=self._run, name="train",
                                        daemon=True)

    def _run(self):
        self.tid = threading.get_native_id()
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                self.losses.append(run_annotated_loop(
                    self._args[0], self._args[1], 1, client=self._args[2]))
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # reported on the main thread
            self.error = e

    def start(self):
        self._thread.start()
        wait_for(lambda: self.losses or self.error, 120, "first train step")
        return self

    def halt(self):
        self._stop.set()
        self._thread.join(timeout=60)

    def stop(self):
        self.halt()
        check(not self._thread.is_alive(), "training thread did not stop")
        self.alive_check()

    def alive_check(self):
        if self.error is not None:
            raise BenchError(f"training thread failed: {self.error!r}")


class StepOnly:
    """The client with its step() hook but without phase annotations:
    splits the overhead of the per-step phase datagrams (and the
    daemon's per-phase CPU sampling they switch on) from the rest."""

    def __init__(self, client):
        self.step = client.step

    def phase(self, name):
        return contextlib.nullcontext()


def run_capture(client, trainer, trigger, log_dir, timeout_s=120):
    before = client.captures_completed
    t_rpc = time.time()
    trigger()
    try:
        wait_for(lambda: client.captures_completed > before or trainer.error,
                 timeout_s, f"capture into {log_dir}")
    except BenchError as e:
        raise BenchError(f"{e}; trace_timing={client.trace_timing} "
                         f"train steps={len(trainer.losses)}") from None
    trainer.alive_check()
    return t_rpc, dict(client.trace_timing)


def make_sync(device):
    """What ends a timed window on ``device``: the card's queue drained."""
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def timed_window(step_fn, make_batch, client, steps, sync):
    """ms/step of ``steps`` annotated steps; the loop reads every loss
    back, as the reference loop blocks on it."""
    sync()
    t0 = time.perf_counter()
    run_annotated_loop(step_fn, make_batch, steps, client=client)
    sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def window_steps(step_fn, make_batch, sync, target_ms=2000.0,
                 min_steps=20):
    """Steps in a window of ~``target_ms``, from a 10-step probe."""
    probe = timed_window(step_fn, make_batch, None, 10, sync)
    return max(min_steps, int(target_ms / probe))


def rotated(names, i):
    """Round i's order: sides rotate so drift spreads over all of them."""
    k = i % len(names)
    return names[k:] + names[:k]


def measure_windows(step_fn, make_batch, sides, rounds, sync,
                    target_ms=2000.0, min_steps=20):
    """ms/step of each side in ``rounds`` rotating rounds of equal
    windows. ``sides`` maps a name to None (no client) or to a function
    that returns (a started client, the hook the loop calls); each
    window gets a fresh client, stopped after it. Returns ({side:
    [ms/step per round]}, steps per window)."""
    steps = window_steps(step_fn, make_batch, sync, target_ms, min_steps)
    ms = {name: [] for name in sides}
    for i in range(rounds):
        for name in rotated(list(sides), i):
            if sides[name] is None:
                ms[name].append(timed_window(step_fn, make_batch, None,
                                             steps, sync))
                continue
            client, hook = sides[name]()
            try:
                timed_window(step_fn, make_batch, hook, 3, sync)  # settles
                ms[name].append(timed_window(step_fn, make_batch, hook,
                                             steps, sync))
            finally:
                client.stop()
    return ms, steps


def retro_uploads(client):
    return [sp for sp in client.spans.snapshot()
            if sp["name"] == "retro_upload"]


def measure_ring(step_fn, make_batch, job, ring_socket, rounds, sync,
                 target_ms=2000.0, min_steps=20):
    """Median ms/step of the full client against the default daemon
    (ring off) and against the daemon on ``ring_socket`` (ring on), in
    rotating windows, each with a fresh client. Returns {"ms": {side:
    [...]}, "steps": steps per window, "uploads": the ring-on clients'
    retro_upload spans, "extra_ms": training time the ring cost per
    window it took, one entry a round}."""
    steps = window_steps(step_fn, make_batch, sync, target_ms, min_steps)
    ms = {"ring_off": [], "ring_on": []}
    uploads, extra_ms = [], []
    for i in range(rounds):
        for side in rotated(["ring_off", "ring_on"], i):
            client = DynologClient(
                job_id=f"{job}_overhead", metrics_interval_s=1.0,
                daemon_socket=ring_socket if side == "ring_on" else None)
            client.start()
            try:
                timed_window(step_fn, make_batch, client, 3, sync)
                # Windows start in step(): train until the first landed.
                deadline = time.monotonic() + 60
                while side == "ring_on" and not retro_uploads(client):
                    check(time.monotonic() < deadline,
                          "retro: no window uploaded within 60 s")
                    timed_window(step_fn, make_batch, client, 1, sync)
                n0 = len(retro_uploads(client))
                ms[side].append(timed_window(step_fn, make_batch, client,
                                             steps, sync))
                taken = len(retro_uploads(client)) - n0
            finally:
                client.stop()
            if side == "ring_on":
                uploads.extend(retro_uploads(client))
                check(client.spans.counters().get("retro_disabled", 0) == 0,
                      "retro: the flight recorder disabled itself")
                on_windows = taken
        # Training time the ring cost this round, per window it took.
        if on_windows:
            extra_ms.append((ms["ring_on"][-1] - ms["ring_off"][-1])
                            * steps / on_windows)
    return {"ms": ms, "steps": steps, "uploads": uploads,
            "extra_ms": extra_ms}


def _p95(xs):
    """95th percentile. Below 20 samples the honest tail estimate is the
    worst observation (interpolating 5 trials would report a value no
    trial ever exceeded-adjacent to); with more data, interpolate."""
    s = sorted(xs)
    if len(s) < 20:
        return s[-1]
    idx = 0.95 * (len(s) - 1)
    lo = int(idx)
    frac = idx - lo
    return s[lo] * (1 - frac) + s[lo + 1] * frac


def _stats(xs):
    return {"median": round(statistics.median(xs), 1),
            "p95": round(_p95(xs), 1)}


def _pct(a, b):
    return 100 * (a - b) / b


def _ms_list(xs):
    return [round(x, 3) for x in xs]


def trace_breakdown(t_rpc, timing, t_artifact=None, window_ms=WINDOW_MS):
    """One capture's latency in ms: each BREAKDOWN interval whose stamps
    the shim recorded (no stream, no stop_to_stream_commit), and with
    ``t_artifact`` (the first artifact byte seen on disk) e2e from the
    RPC and nonwindow, e2e less the capture window."""
    t = {"rpc": t_rpc, **timing}
    out = {name: (t[b] - t[a]) * 1e3 for name, (a, b) in BREAKDOWN.items()
           if a in t and b in t}
    if t_artifact is not None:
        out["e2e"] = (t_artifact - t_rpc) * 1e3
        out["nonwindow"] = out["e2e"] - window_ms
    return out


def make_step(cfg: ModelConfig = FLAGSHIP, device="cuda", batch=BATCH,
              seq=SEQ, seed=0, params=None):
    """bench.py:make_step on the port: the flagship train step (AdamW)
    built by ``make_train_step`` with weights from ``seed`` (or the JAX
    package's parameter tree ``params``, carried over by
    ``load_jax_params``), and one batch of tokens from a seeded
    generator. Returns (step_fn, make_batch) for run_annotated_loop."""
    device = resolve_device(device)
    model, _, step_fn = make_train_step(
        cfg, device=device, generator=torch.Generator().manual_seed(seed))
    if params is not None:
        load_jax_params(model, params)
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, seq),
        generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return step_fn, lambda i: tokens


def measure_overhead(step_fn, make_batch, daemon_proc, port, sizes, sync):
    """bench.py's overhead phase in rotating windows: no client against
    a client that polls every 0.5 s, pushes metrics every 1 s and sees
    step() on every iteration (no phase annotations, as bench.py's
    hook); then the collectors' tick cost and the daemon's RSS."""
    def on():
        client = DynologClient(job_id=f"{JOB}_overhead", poll_interval_s=0.5,
                               metrics_interval_s=1.0).start()
        return client, StepOnly(client)

    ms, steps = measure_windows(step_fn, make_batch, {"off": None, "on": on},
                                sizes.overhead_rounds, sync, sizes.window_ms,
                                sizes.min_steps)
    collectors = DynoClient(port=port).status().get("collectors", {})
    rss_mb = None
    with open(f"/proc/{daemon_proc.pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss_mb = int(line.split()[1]) / 1024
    off, on_ = statistics.median(ms["off"]), statistics.median(ms["on"])
    return {"off_ms": _ms_list(ms["off"]), "on_ms": _ms_list(ms["on"]),
            "off_median_ms": off, "on_median_ms": on_,
            "overhead_pct": _pct(on_, off), "steps_per_window": steps,
            "rounds": sizes.overhead_rounds,
            "slower_than_off_in": sum(a > b for a, b in zip(ms["on"],
                                                            ms["off"])),
            "poll_interval_s": 0.5, "metrics_interval_s": 1.0,
            "collector_interval_s": 1.0,
            "collector_tick_ms": {k: v.get("avg_ms")
                                  for k, v in collectors.items()},
            "daemon_rss_mb": rss_mb}


def _first_artifact(log_dir):
    """The time the first non-empty exported trace is seen under
    ``log_dir``, or None."""
    for p in glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                       recursive=True):
        if not os.path.basename(p).startswith("streamed.") and \
                os.path.getsize(p) > 0:
            return time.time()
    return None


def measure_trace_latency(rpc, client, trainer, dyno_bin, port, log_root,
                          label, sizes):
    """bench.py:measure_trace_latency on the torch shim while the
    training thread steps: ``sizes.trace_warm`` untimed captures through
    `dyno gputrace` (the first in a process pays the profiler's start-up),
    then ``sizes.trace_trials`` triggered by set_trace_config in-process
    as bench.py does, each watched on disk every 5 ms for its first
    artifact byte."""
    trials = []
    for i in range(sizes.trace_warm + sizes.trace_trials):
        wait_for(lambda: not client._capturing, 30,
                 "the previous capture to retire")
        log_dir = os.path.join(log_root, f"{label}_{i}")
        if i < sizes.trace_warm:
            run_capture(client, trainer, lambda: trigger_gputrace(
                dyno_bin, port, JOB, log_dir, WINDOW_MS), log_dir)
            continue
        before = client.captures_completed
        t_rpc = time.time()
        resp = rpc.set_trace_config(job_id=JOB, config={
            "type": "xplane", "log_dir": log_dir, "duration_ms": WINDOW_MS})
        check(resp.get("activityProfilersTriggered"),
              f"{label}: trace trigger failed: {resp}")
        t_artifact = wait_for(lambda: _first_artifact(log_dir)
                              or trainer.error, 60,
                              f"{label} trial {i}: an artifact", 0.005)
        trainer.alive_check()
        wait_for(lambda: client.captures_completed > before
                 or trainer.error, 60, f"{label} trial {i}: the capture")
        trainer.alive_check()
        trials.append((t_rpc, dict(client.trace_timing), t_artifact))
    rows = [trace_breakdown(t_rpc, t, t_art) for t_rpc, t, t_art in trials]
    names = [n for n in rows[0] if all(n in r for r in rows)]
    return {"trials": len(rows), "warm": sizes.trace_warm,
            "window_ms": WINDOW_MS,
            "poll_interval_s": client.poll_interval_s,
            "push": client.enable_push, "stream": client.enable_stream,
            "deliveries": [t.get("delivery") for _, t, _ in trials],
            "e2e_ms": _stats([r["e2e"] for r in rows]),
            "nonwindow_ms": _stats([r["nonwindow"] for r in rows]),
            "phases_ms": {n: _stats([r[n] for r in rows]) for n in names
                          if n not in ("e2e", "nonwindow")}}


def measure_phase_attribution(daemon_bin, window_s):
    """bench.py:measure_phase_attribution with a torch-shim client: the
    kernel collector's cadence (0.1 s) with ~20 phase annotations a
    second against a phase-free run, and the cpu_util getPhases reads
    back for a busy-spin ``input`` and a sleeping ``step`` phase."""
    interval_s, sample_s = 0.1, 0.05

    def run(annotated):
        name = f"benchph_{'on' if annotated else 'off'}"
        proc, port = _drained(start_daemon(
            daemon_bin, "--ipc_socket_name", name,
            "--kernel_monitor_interval_s", str(interval_s),
            "--enable_perf_monitor=false",
            "--phase_cpu_interval_s", str(sample_s)))
        shim = None
        try:
            rpc = DynoClient(port=port)
            shim = DynologClient(job_id="benchph", poll_interval_s=1.0,
                                 daemon_socket=name).start()

            def ticks():
                return (rpc.status().get("collectors", {})
                        .get("kernel", {}).get("ticks", 0))

            wait_for(lambda: ticks() >= 2, 20, "two kernel ticks")
            t0, n0, annotations = time.monotonic(), ticks(), 0
            while time.monotonic() < t0 + window_s:
                if annotated:
                    # 0.1 s per phase: long enough that the 0.05 s
                    # sampling edges don't dominate the split.
                    with shim.phase("input"):
                        spin_until = time.monotonic() + 0.1
                        x = 0
                        while time.monotonic() < spin_until:
                            x += sum(range(100))
                    with shim.phase("step"):
                        time.sleep(0.1)
                    annotations += 2
                else:
                    time.sleep(0.05)
            elapsed = time.monotonic() - t0
            out = {"kernel_ticks_per_s": (ticks() - n0) / elapsed}
            if annotated:
                time.sleep(0.3)  # final datagrams + collector tick
                mine = next((p for p in rpc.get_phases()["processes"]
                             if p["pid"] == shim.pid), {})
                leaves = {tuple(p["stack"])[-1]: p
                          for p in mine.get("phases", [])}
                out["annotations_per_s"] = annotations / elapsed
                out["spin_cpu_util"] = leaves.get("input", {}).get(
                    "cpu_util")
                out["sleep_cpu_util"] = leaves.get("step", {}).get(
                    "cpu_util", 0.0)
            return out
        finally:
            if shim is not None:
                shim.stop()
            stop_daemon(proc)

    quiet = run(annotated=False)
    annotated = run(annotated=True)
    return {"window_s": window_s, "collector_interval_s": interval_s,
            "phase_cpu_interval_s": sample_s, "quiet": quiet,
            "annotated": annotated,
            "cadence_ratio": annotated["kernel_ticks_per_s"]
            / max(1e-9, quiet["kernel_ticks_per_s"])}


_BURNER = ("import hashlib,sys,time\n"
           "t0 = time.perf_counter()\n"
           "b = b'x' * 64\n"
           "for _ in range(int(sys.argv[1])):\n"
           "    b = hashlib.sha256(b).digest()\n"
           "print(time.perf_counter() - t0)\n")


def _cpu_seconds(pid):
    """utime+stime of a process (all threads), in seconds."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(") ", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def measure_loaded_overhead(daemon_bin, sizes):
    """bench.py:measure_loaded_overhead with a torch-shim client: a
    fixed sha256 quantum (calibrated to ``sizes.burn_s``) in each of
    ``sizes.burners`` processes (0: one per CPU this process may run
    on), alone (B) and beside a daemon at 1 s cadences with a client
    polling every 0.5 s (L), in ``sizes.loaded_order``. Under saturation every CPU-second the stack
    spends is taken from the burners, so the accounting number is exact
    where the wall delta is noisy."""
    n = sizes.burners or len(os.sched_getaffinity(0))

    def burn(iters):
        """(slowest burner's loop s, the burners' summed loop s)."""
        procs = [subprocess.Popen([sys.executable, "-c", _BURNER, str(iters)],
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(n)]
        times = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=120)
                check(p.returncode == 0, "burner subprocess failed")
                times.append(float(out.strip()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return max(times), sum(times)

    cal_iters = max(int(2_000_000 * sizes.burn_s / 8.0), 10_000)
    burn(cal_iters)  # warm caches and the frequency governor
    cal_s, _ = burn(cal_iters)
    iters = max(int(cal_iters * sizes.burn_s / cal_s), 1)

    def loaded():
        proc, _ = _drained(start_daemon(
            daemon_bin, "--ipc_socket_name", "benchload",
            "--kernel_monitor_interval_s", "1",
            "--tpu_monitor_interval_s", "1"))
        try:
            client = DynologClient(job_id="loadbench", poll_interval_s=0.5,
                                   metrics_interval_s=1.0,
                                   daemon_socket="benchload").start()
            try:
                cpu0 = _cpu_seconds(proc.pid) + _cpu_seconds(os.getpid())
                wall, burner_cpu = burn(iters)
                cpu1 = _cpu_seconds(proc.pid) + _cpu_seconds(os.getpid())
                return wall, burner_cpu, cpu1 - cpu0
            finally:
                client.stop()
        finally:
            stop_daemon(proc)

    base, runs = [], []
    for kind in sizes.loaded_order:
        if kind == "b":
            base.append(burn(iters)[0])
        else:
            runs.append(loaded())
    b, l = statistics.median(base), statistics.median(r[0] for r in runs)
    return {"cpus_saturated": n, "target_s": sizes.burn_s, "quantum_s": b,
            "base_s": base, "loaded_s": [r[0] for r in runs],
            "overhead_pct": _pct(l, b),
            "overhead_cpu_accounting_pct": statistics.median(
                100 * c / cpu for _, cpu, c in runs),
            "stack_cpu_s": [r[2] for r in runs],
            "burner_cpu_s": [r[1] for r in runs]}


def measure_flight_recorder(daemon_bin, tmp, sizes):
    """bench.py:measure_flight_recorder on the port's minifleet: the
    kernel collector's cadence (0.1 s) with a ring of 150 ms windows
    streaming against the ring off, and watch rule firing ->
    retro_manifest.json."""
    interval_s = 0.1
    retro_args = ("--retro_window_ms", "150", "--retro_ring_windows", "4")

    def retro_windows(rpc):
        return rpc.self_telemetry()["counters"].get("retro_windows", 0)

    def cadence(ring_on):
        side = "on" if ring_on else "off"
        args = ["--kernel_monitor_interval_s", str(interval_s),
                "--storage_dir", os.path.join(tmp, f"fr_store_{side}")]
        if ring_on:
            args += retro_args
        daemons, clients = minifleet.spawn(
            daemon_bin, 1, f"benchfr{side}", daemon_args=tuple(args),
            poll_interval_s=0.2)
        try:
            check(minifleet.wait_registered(daemons, timeout_s=30),
                  "flight-recorder client never registered")
            rpc = DynoClient(port=daemons[0][1])
            if ring_on:  # steady state: the ring streams before the window
                wait_for(lambda: retro_windows(rpc) >= 2, 20,
                         "the retro ring streaming")

            def ticks():
                return (rpc.status().get("collectors", {})
                        .get("kernel", {}).get("ticks", 0))

            wait_for(lambda: ticks() >= 2, 20, "two kernel ticks")
            t0, n0 = time.monotonic(), ticks()
            time.sleep(sizes.fr_window_s)
            return (ticks() - n0) / (time.monotonic() - t0), \
                rpc.status().get("flightrecorder")
        finally:
            minifleet.teardown(daemons, clients)

    off_rate, _ = cadence(ring_on=False)
    on_rate, recorder = cadence(ring_on=True)

    log_dir = os.path.join(tmp, "fr_autocap")
    watch = ",".join(f"bench_fr_metric{i}<20:60:trace(300)"
                     for i in range(sizes.fr_firings))
    daemons, clients = minifleet.spawn(
        daemon_bin, 1, "benchfrtrig",
        daemon_args=("--enable_history_injection", "--watch", watch,
                     "--watch_interval_s", "0.2", "--watch_z_threshold", "0",
                     "--capture_cooldown_s", "0",
                     "--capture_log_dir", log_dir,
                     "--capture_job_id", "fleet",
                     "--capture_start_delay_ms", "100",
                     "--storage_dir", os.path.join(tmp, "fr_store_trig"),
                     *retro_args),
        poll_interval_s=0.1, write_fake_trace=True)
    try:
        check(minifleet.wait_registered(daemons, timeout_s=30),
              "flagged fleet never registered")
        rpc = DynoClient(port=daemons[0][1])
        wait_for(lambda: retro_windows(rpc) >= 2, 20,
                 "the retro ring primed before the triggers")

        def manifests():
            return {p: os.path.getmtime(p) for p in glob.glob(
                os.path.join(log_dir, "retro_*", "retro_manifest.json"))}

        latencies_ms = []
        for i in range(sizes.fr_firings):
            # The export rewrites one retro_<host>-<pid>/ dir: a new
            # artifact is a manifest whose mtime advanced.
            seen = manifests()
            now_ms = int(time.time() * 1000)
            rpc.put_history(f"bench_fr_metric{i}.dev0",
                            [(now_ms - (30 - k) * 1000, 5.0)
                             for k in range(30)])

            def fired():
                ev = [e for e in eventlog.fetch_all_events(rpc)["events"]
                      if e["type"] == "autocapture_fired"]
                return ev[i] if len(ev) == i + 1 else None

            event = wait_for(fired, 15, f"rule {i} firing")
            fresh = wait_for(lambda: [m for p, m in manifests().items()
                                      if m > seen.get(p, 0.0)], 15,
                             f"rule {i}'s retro export", 0.02)
            latencies_ms.append(min(fresh) * 1000 - event["ts_ms"])
            check(minifleet.wait_captures(clients, count=i + 1,
                                          timeout_s=15),
                  f"capture {i} never completed")
        counters = rpc.self_telemetry()["counters"]
    finally:
        minifleet.teardown(daemons, clients)

    return {"window_s": sizes.fr_window_s,
            "collector_interval_s": interval_s,
            "retro_window_ms": 150, "retro_ring_windows": 4,
            "kernel_ticks_per_s": {"ring_off": off_rate, "ring_on": on_rate},
            "cadence_ratio": on_rate / max(1e-9, off_rate),
            "flightrecorder_status": recorder,
            "firings": sizes.fr_firings,
            "trigger_to_retro_ms": _stats(latencies_ms),
            "retro_counters": {k: counters.get(k, 0) for k in (
                "retro_windows", "retro_bytes", "retro_evictions",
                "retro_exports")}}


def measure_ring_cost(daemon_bin, tmp, step_fn, make_batch, sync, sizes):
    """ms/step of the flagship under the full client with a real
    torch.profiler ring of 500 ms windows (a daemon of its own) against
    the same client without one (the default daemon): measure_ring."""
    proc, _ = _drained(start_daemon(
        daemon_bin, "--ipc_socket_name", "benchring",
        "--storage_dir", os.path.join(tmp, "ring_store"),
        "--retro_window_ms", str(RETRO_WINDOW_MS),
        "--retro_ring_windows", "4", "--trace_stream_max_mb", "1024"))
    try:
        ring = measure_ring(step_fn, make_batch, JOB, "benchring",
                            sizes.ring_rounds, sync, sizes.window_ms,
                            sizes.min_steps)
    finally:
        stop_daemon(proc)
    ok = [u for u in ring["uploads"] if u.get("ok")]
    check(ok, "flight_recorder: no ring window uploaded")
    off, on = (statistics.median(ring["ms"][s])
               for s in ("ring_off", "ring_on"))
    return {"window_ms": RETRO_WINDOW_MS,
            "ring_off_ms": _ms_list(ring["ms"]["ring_off"]),
            "ring_on_ms": _ms_list(ring["ms"]["ring_on"]),
            "ring_off_median_ms": off, "ring_on_median_ms": on,
            "vs_ring_off_pct": _pct(on, off),
            "steps_per_window": ring["steps"], "rounds": sizes.ring_rounds,
            "cost_per_window_ms": _ms_list(ring["extra_ms"]),
            "windows_uploaded": len(ok),
            "stop_ms_median": statistics.median(u["stop_ms"] for u in ok),
            "export_ms_median": statistics.median(
                u["export_ms"] for u in ok)}


def measure_fleet_fanout(daemon_bin, tmp, n_hosts=8):
    """bench.py:measure_fleet_fanout on the port's minifleet: unitrace's
    fan-out RPC to ``n_hosts`` local daemons, each with a registered
    FakeCaptureClient (the torch shim without torch.profiler: one
    profiler session per process, and every "host" shares this one), and
    the spread of the synchronized capture starts. The numbers isolate
    the control plane: RPC fan-out, config delivery, start alignment."""
    delay_s = 2
    daemons, clients = minifleet.spawn(daemon_bin, n_hosts, "dynbench")
    try:
        check(minifleet.wait_registered(daemons, timeout_s=60),
              "fleet clients never registered")
        duration_ms = 1000
        args = unitrace.build_parser().parse_args([
            "--hosts", ",".join(f"localhost:{p}" for _, p in daemons),
            "--job-id", "fleet",
            "--log-dir", os.path.join(tmp, f"fleet{n_hosts}"),
            "--duration-ms", str(duration_ms),
            "--start-time-delay-s", str(delay_s),
        ])
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            out = unitrace.run(args)
        fanout_ms = (time.time() - t0) * 1e3
        check(out["ok"] == n_hosts, f"fleet trigger failed: {out['results']}")
        start_s = out["start_time_ms"] / 1000.0
        check(minifleet.wait_captures(clients, timeout_s=delay_s + 25),
              "fleet captures did not complete")
        starts = [c.trace_timing["trace_start"] for c in clients]
        windows = minifleet.capture_windows(clients)
        # How long all n windows were open at once (> 0: a shared instant).
        common_open_ms = (min(w[1] for w in windows) -
                          max(w[0] for w in windows)) * 1e3
        return {
            "hosts": n_hosts,
            "fanout_rpc_ms": round(fanout_ms, 1),
            "sync_spread_ms": round((max(starts) - min(starts)) * 1e3, 1),
            "max_sync_error_ms": round(
                max(abs(t - start_s) for t in starts) * 1e3, 1),
            "start_delay_s": delay_s,
            "capture_window_ms": duration_ms,
            "common_open_ms": round(common_open_ms, 1),
            "windows_intersect": common_open_ms > 0,
        }
    finally:
        minifleet.teardown(daemons, clients)


def measure_restart_recovery(daemon_bin, tmp, n_hosts=4, trials=3):
    """bench.py:measure_restart_recovery on the port's minifleet: SIGKILL
    one daemon, start a fresh one on the same socket (new epoch, empty
    registry) and time until the running torch shim re-registers on its
    own, over ``trials`` cycles with rotating victims; the shims'
    recovery counters summed fleet-wide."""
    daemons, clients = minifleet.spawn(
        daemon_bin, n_hosts, "dynchaos", poll_interval_s=0.5)
    try:
        check(minifleet.wait_registered(daemons, timeout_s=30),
              "fleet clients never registered")
        recover_s = []
        for trial in range(trials):
            t0 = time.time()
            minifleet.restart_daemon(daemons, trial % n_hosts, daemon_bin,
                                     "dynchaos")
            check(minifleet.wait_registered(daemons, timeout_s=30),
                  f"client never re-registered after restart {trial}")
            recover_s.append(time.time() - t0)
        keys = ("daemon_restarts_detected", "reregistrations",
                "reconnects", "reconnect_backoffs")
        totals = {k: 0 for k in keys}
        for c in clients:
            counters = c.spans.counters()
            for k in keys:
                totals[k] += counters.get(k, 0)
        return {
            "hosts": n_hosts,
            "trials": trials,
            "recovery_ms": _stats([s * 1e3 for s in recover_s]),
            "client_counters": totals,
        }
    finally:
        minifleet.teardown(daemons, clients)


def _inject_duty_cycle(port, base, rng, now_ms, points, devs=1):
    """putHistory ``points`` 1 s samples of tensorcore_duty_cycle_pct
    around ``base`` (jitter +-0.3 from ``rng``) for each of ``devs``
    devices, as bench.py's fleet health phases do."""
    rpc = DynoClient(port=port)
    for dev in range(devs):
        rpc.put_history(
            f"tensorcore_duty_cycle_pct.dev{dev}",
            [(now_ms - (points - k) * 1000, base + rng.uniform(-0.3, 0.3))
             for k in range(points)])


def measure_fleetstatus(daemon_bin, tmp, n_hosts=4, straggler=2):
    """bench.py:measure_fleetstatus: ``n_hosts`` daemons with injected
    history, host ``straggler``'s duty cycle ~30 % low, then the time of
    one fleetstatus sweep and whether it flagged that host alone."""
    rng = random.Random(42)
    daemons = minifleet.spawn_daemons(
        daemon_bin, n_hosts, "dynfstat",
        daemon_args=("--enable_history_injection",))
    try:
        now_ms = int(time.time() * 1000)
        for i, (_, port) in enumerate(daemons):
            base = 70.0 * (0.7 if i == straggler else 1.0) \
                + rng.uniform(-0.5, 0.5)
            _inject_duty_cycle(port, base, rng, now_ms, 60, devs=2)
        hosts = [f"localhost:{p}" for _, p in daemons]
        t0 = time.time()
        verdict = fleetstatus.sweep(hosts, window_s=300)
        sweep_ms = (time.time() - t0) * 1e3
        flagged = {o["host"] for o in verdict["outliers"]}
        return {
            "hosts": n_hosts,
            "sweep_ms": round(sweep_ms, 1),
            "straggler_detected": flagged == {hosts[straggler]},
            "outliers": [
                {"host": o["host"], "metric": o["metric"], "z": o["z"]}
                for o in verdict["outliers"]],
        }
    finally:
        minifleet.teardown(daemons, [])


def _port_of(host):
    """The port of a ``host:port`` id: tree ids carry the hostname, flat
    ones localhost."""
    return host.rsplit(":", 1)[1]


def measure_fleet_tree(daemon_bin, tmp, n_hosts=64, relays=7, trials=15):
    """bench.py:measure_fleet_tree: the same daemons swept two ways, one
    getFleetStatus to the root of a 2-level relay tree against the flat
    fan-out (getAggregates + getStatus per host), each scoring one
    injected straggler leaf."""
    leaves = (n_hosts - 1 - relays) // relays
    rng = random.Random(42)
    daemons = minifleet.spawn_tree(
        daemon_bin, "dyntree", leaves=leaves, relays=relays,
        daemon_args=("--enable_history_injection",
                     "--fleet_report_interval_s", "1",
                     "--fleet_stale_after_s", "15"))
    try:
        ports = [p for _, p in daemons]
        root = f"localhost:{ports[0]}"
        straggler = len(ports) - 1  # a leaf: two hops from the root
        now_ms = int(time.time() * 1000)
        for i, port in enumerate(ports):
            base = 70.0 * (0.7 if i == straggler else 1.0) \
                + rng.uniform(-0.5, 0.5)
            _inject_duty_cycle(port, base, rng, now_ms, 30)
        # Every host's record rides a report up both hops before timing.
        deadline = time.time() + 90
        while time.time() < deadline:
            v = fleetstatus.tree_sweep(root, window_s=300, timeout_s=5.0)
            scored = (v or {}).get("metrics", {}).get(
                "tensorcore_duty_cycle_pct", {}).get("values", {})
            if len(scored) == len(ports):
                break
            time.sleep(0.5)
        else:
            raise BenchError(f"relay tree never converged to {len(ports)} "
                             f"hosts (last saw {len(scored)})")

        tree_ms, flat_ms = [], []
        tree_v = flat_v = None
        for _ in range(trials):
            t0 = time.time()
            tree_v = fleetstatus.tree_sweep(root, window_s=300,
                                            timeout_s=5.0)
            tree_ms.append((time.time() - t0) * 1e3)
        hosts = [f"localhost:{p}" for p in ports]
        for _ in range(trials):
            t0 = time.time()
            flat_v = fleetstatus.sweep(hosts, window_s=300)
            flat_ms.append((time.time() - t0) * 1e3)
        tree_flagged = {_port_of(o["host"]) for o in tree_v["outliers"]}
        flat_flagged = {_port_of(o["host"]) for o in flat_v["outliers"]}
        return {
            "hosts": len(ports), "relays": relays,
            "leaves_per_relay": leaves, "trials": trials,
            "tree_sweep_ms": _stats(tree_ms),
            "flat_sweep_ms": _stats(flat_ms),
            "tree_rpcs_per_sweep": 1,
            "flat_rpcs_per_sweep": 2 * len(ports),
            "straggler_parity": tree_flagged == flat_flagged
            == {_port_of(hosts[straggler])},
        }
    finally:
        minifleet.teardown(daemons, [])


def _tree_status(port):
    """The ``fleettree`` block of a daemon's getStatus ({} if it does
    not answer)."""
    try:
        return DynoClient(port=port, timeout=3.0).status().get(
            "fleettree") or {}
    except Exception:
        return {}


def _wait_fresh(via_port, want, timeout_s):
    """Seconds until a tree sweep through ``via_port`` has every port in
    ``want`` fresh, or None on timeout."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        v = fleetstatus.tree_sweep(
            f"localhost:{via_port}", window_s=300, timeout_s=5.0)
        if v is not None:
            fresh = ({_port_of(h) for h in v["hosts"]}
                     - {_port_of(u["host"]) for u in v["unreachable"]})
            if want <= fresh:
                return time.time() - t0
        time.sleep(0.25)
    return None


def _log_unfresh(via_port, want, seed_ports, dead_ports):
    """Logs the hosts of ``want`` that a tree sweep through ``via_port``
    does not have fresh: each one's role, whether the sweep lists it as
    unreachable, and the parent its own getStatus names."""
    v = fleetstatus.tree_sweep(f"localhost:{via_port}", window_s=300,
                               timeout_s=5.0)
    if v is None:
        logging.warning("fleet_selfheal: no tree sweep through %s", via_port)
        return
    unreachable = {_port_of(u["host"]) for u in v["unreachable"]}
    missing = sorted(want - ({_port_of(h) for h in v["hosts"]}
                             - unreachable))
    rows = []
    for p in missing:
        parent = _tree_status(int(p)).get("parent") or {}
        rows.append(f"{p} {'seed' if int(p) in seed_ports else 'leaf'} "
                    f"{'unreachable' if p in unreachable else 'unlisted'} "
                    f"parent={parent.get('port')} "
                    f"registered={parent.get('registered')}")
    root_port = int(_port_of(v.get("root") or ":0"))
    children = {_port_of(c["node"])
                for c in _tree_status(root_port).get("children", [])}
    try:
        counters = DynoClient(port=root_port, timeout=3.0).self_telemetry()[
            "counters"]
    except Exception:  # a root that does not answer is itself the finding
        counters = {}
    logging.warning(
        "fleet_selfheal: %d of %d live hosts not fresh through %s after "
        "the promotion (root %s: %d children, missing ones among them %s, "
        "relay counters %s; killed %s): %s", len(missing), len(want),
        via_port, v.get("root"), len(children),
        sorted(children & set(missing)),
        {k: counters.get(k) for k in ("relay_reports_rx", "relay_sheds",
                                      "relay_splits")},
        sorted(dead_ports), "; ".join(rows))


def _kill_interior_seeds(daemons, seeds, root_port, rng, trials,
                         dead_ports):
    """Re-parent convergence, as bench.py's self-heal and multi-tenant
    storms measure it: each trial SIGKILLs one live seed with children
    (never the root ``root_port``; no restarts) and times each orphan's
    re-registration with another parent. Adds the killed ports to
    ``dead_ports``; returns (re-parent seconds, one per orphan that made
    it, the count of orphans still unparented after 30 s)."""
    ports = [p for _, p in daemons]
    reparent_s = []
    lost = 0
    for _ in range(trials):
        victims = [(i, p) for i, p in enumerate(ports[:seeds])
                   if p not in dead_ports and str(p) != root_port
                   and _tree_status(p).get("children")]
        if not victims:
            break
        idx, victim = rng.choice(victims)
        orphans = [int(_port_of(c["node"]))
                   for c in _tree_status(victim)["children"]]
        minifleet.kill_daemon(daemons, idx)
        dead_ports.add(victim)
        t0 = time.time()
        pending = set(orphans)
        while pending and time.time() - t0 < 30.0:
            for p in sorted(pending):
                parent = _tree_status(p).get("parent") or {}
                if parent.get("registered") and parent.get("port") != victim:
                    reparent_s.append(time.time() - t0)
                    pending.discard(p)
            time.sleep(0.05)
        lost += len(pending)
    return reparent_s, lost


def measure_fleet_selfheal(daemon_bin, tmp, seeds=16, leaves=240,
                           kill_trials=3, sweep_trials=7,
                           trigger_trials=3):
    """bench.py:measure_fleet_selfheal: ``seeds`` + ``leaves`` daemons
    that form their tree from one --fleet_seeds list, then

    - sweep cost: tree_sweep through the root against the flat sweep;
    - gang-trigger delivery: one fleetTrace to the root against the flat
      setOnDemandTraceRequest fan-out (nothing is registered, so this
      times delivery alone);
    - re-parent convergence: SIGKILL an interior seed with children,
      one per trial, and time each orphan's re-registration elsewhere
      (None where no seed but the root has a child);
    - root promotion: SIGKILL the root and time until the next
      rendezvous winner answers as root through a surviving seed, then
      until a sweep sees every live host fresh (each None where it did
      not happen within the phase's deadline).

    Unlike bench.py, it drains every daemon's log: the phase holds up to
    256 daemons for over a minute, and a full pipe would block one."""
    daemons, seed_list = minifleet.spawn_seeded(
        daemon_bin, "dynheal", seeds=seeds, leaves=leaves,
        daemon_args=("--fleet_report_interval_s", "1",
                     "--fleet_stale_after_s", "2"))
    for d in daemons:
        _drained(d)
    rng = random.Random(1234)
    try:
        ports = [p for _, p in daemons]
        dead_ports: set = set()

        def wait_fresh(via_port, timeout_s):
            return _wait_fresh(
                via_port, {str(p) for p in ports if p not in dead_ports},
                timeout_s)

        current_root = minifleet.expected_root(seed_list)
        check(wait_fresh(int(_port_of(current_root)), 180.0) is not None,
              f"seeded fleet never converged to {len(ports)} hosts")

        tree_ms, flat_ms = [], []
        for _ in range(sweep_trials):
            t0 = time.time()
            v = fleetstatus.tree_sweep(
                f"localhost:{_port_of(current_root)}", window_s=300,
                timeout_s=10.0)
            tree_ms.append((time.time() - t0) * 1e3)
        check(v is not None, "tree sweep through the root failed")
        hosts = [f"localhost:{p}" for p in ports]
        for _ in range(sweep_trials):
            t0 = time.time()
            fleetstatus.sweep(hosts, window_s=300)
            flat_ms.append((time.time() - t0) * 1e3)

        config = "ACTIVITIES_DURATION_MSECS=50"
        tree_trig_ms, flat_trig_ms = [], []
        root_client = DynoClient(port=int(_port_of(current_root)),
                                 timeout=60.0)
        for t in range(trigger_trials):
            t0 = time.time()
            resp = root_client.fleet_trace(config, f"healtree{t}")
            tree_trig_ms.append((time.time() - t0) * 1e3)
            check(resp.get("total", 0) == len(ports),
                  f"fleetTrace reached {resp.get('total')} of "
                  f"{len(ports)} hosts")
        for t in range(trigger_trials):
            req = {"fn": "setOnDemandTraceRequest", "config": config,
                   "job_id": f"healflat{t}", "pids": [],
                   "process_limit": 3}
            t0 = time.time()
            fan_out([("localhost", p, req) for p in ports], timeout=30.0)
            flat_trig_ms.append((time.time() - t0) * 1e3)

        reparent_s, lost_children = _kill_interior_seeds(
            daemons, seeds, _port_of(current_root), rng, kill_trials,
            dead_ports)

        # Root promotion: kill the root; the next rendezvous winner must
        # answer as root through a surviving seed's address.
        live_seeds = [s for s in seed_list
                      if int(_port_of(s)) not in dead_ports]
        old_root = minifleet.expected_root(live_seeds)
        new_root = minifleet.expected_root(
            [s for s in live_seeds if s != old_root])
        idx = next(i for i, p in enumerate(ports)
                   if str(p) == _port_of(old_root))
        minifleet.kill_daemon(daemons, idx)
        dead_ports.add(ports[idx])
        via = next(int(_port_of(s)) for s in live_seeds if s != old_root)
        t0 = time.time()
        promoted_s = None
        while time.time() - t0 < 30.0:
            v = fleetstatus.tree_sweep(
                f"localhost:{via}", window_s=300, timeout_s=5.0)
            if v is not None and \
                    _port_of(v.get("root", "")) == _port_of(new_root):
                promoted_s = time.time() - t0
                break
            time.sleep(0.25)
        settled_s = wait_fresh(via, 60.0)
        if settled_s is None:
            _log_unfresh(via, {str(p) for p in ports if p not in dead_ports},
                         set(ports[:seeds]), dead_ports)

        return {
            "hosts": len(ports), "seeds": seeds,
            "kill_trials": kill_trials,
            "reparented_children": len(reparent_s),
            "lost_children": lost_children,
            "reparent_s": _stats(reparent_s) if reparent_s else None,
            "root_promotion_s":
                round(promoted_s, 3) if promoted_s else None,
            "post_promotion_full_sweep_s":
                round(settled_s, 3) if settled_s else None,
            "tree_sweep_ms": _stats(tree_ms),
            "flat_sweep_ms": _stats(flat_ms),
            "gang_trigger_tree_ms": _stats(tree_trig_ms),
            "gang_trigger_flat_ms": _stats(flat_trig_ms),
        }
    finally:
        minifleet.teardown(daemons, [])


def measure_event_journal(daemon_bin, tmp, capacity=1024):
    """bench.py:measure_event_journal: the emit path's cost per event
    (each setOnDemandTraceRequest journals one trace_config_staged, so
    the figure holds a whole RPC round trip) and the getEvents drain of
    a journal overfilled past ``capacity``, cursor batches included."""
    daemons = minifleet.spawn_daemons(
        daemon_bin, 1, "dynevt",
        daemon_args=("--event_journal_capacity", str(capacity)))
    try:
        client = DynoClient(port=daemons[0][1])
        n = capacity + 64  # overfilled: the drain meets a wrapped ring
        t0 = time.time()
        for i in range(n):
            client.set_trace_config(f"benchjob{i}", {"duration_ms": 1})
        emit_ms = (time.time() - t0) * 1e3 / n
        t0 = time.time()
        got = eventlog.fetch_all_events(client, limit=512)
        drain_ms = (time.time() - t0) * 1e3
        journal = client.get_events(limit=1)["journal"]
        return {
            "ring_capacity": capacity,
            "staged_events": n,
            "emit_rpc_ms_per_event": round(emit_ms, 3),
            "drain_ms_at_capacity": round(drain_ms, 1),
            "events_drained": len(got["events"]),
            "evicted_total": journal["dropped"],
        }
    finally:
        minifleet.teardown(daemons, [])


def measure_degraded_mode(daemon_bin, tmp, window_s=5.0):
    """bench.py:measure_degraded_mode: the kernel collector's cadence and
    getStatus latency over ``window_s`` in a healthy daemon and in one
    whose tpu collector is stalled for good (the daemon reads the
    faultline spec from DYNOLOG_TPU_FAULTS_FILE) and whose HTTP sink
    points at a dead endpoint, once the stalled collector is
    quarantined; with the supervision and sink counters."""
    interval_s = 0.1

    def run_phase(faulted):
        env = dict(os.environ)
        extra = []
        if faulted:
            faults = os.path.join(tmp, "bench_faults")
            with open(faults, "w") as f:
                f.write("collector_tpu.stall_ms=600000\n")
            env["DYNOLOG_TPU_FAULTS_FILE"] = faults
            extra = ["--http_sink_endpoint", "127.0.0.1:9/ingest",
                     "--sink_queue_capacity", "8"]
        proc, port = _drained(start_daemon(
            daemon_bin,
            "--kernel_monitor_interval_s", str(interval_s),
            "--tpu_monitor_interval_s", str(interval_s),
            "--enable_perf_monitor=false",
            "--collector_deadline_ms", "300",
            "--collector_quarantine_after", "2",
            "--collector_probe_interval_ms", "300",
            "--ipc_socket_name", "benchdegraded",
            *extra, env=env))
        try:
            client = DynoClient(port=port)

            deadline = time.time() + 20
            while _kernel_ticks(client) < 2 and time.time() < deadline:
                time.sleep(0.1)
            if faulted:
                # Steady state (quarantine), not the transition.
                while time.time() < deadline:
                    h = client.status().get("collector_health", {})
                    if h.get("tpu", {}).get("state") == "quarantined":
                        break
                    time.sleep(0.1)
            t0 = time.monotonic()
            n0 = _kernel_ticks(client)
            rpc_ms = []
            t_end = t0 + window_s
            while time.monotonic() < t_end:
                r0 = time.perf_counter()
                status = client.status()
                rpc_ms.append((time.perf_counter() - r0) * 1e3)
                time.sleep(0.05)
            n1 = _kernel_ticks(client)
            elapsed = time.monotonic() - t0
            out = {
                "kernel_ticks_per_s": round((n1 - n0) / elapsed, 3),
                "rpc_getstatus_ms": _stats(rpc_ms),
            }
            if faulted:
                out["tpu_state"] = (status.get("collector_health", {})
                                    .get("tpu", {}).get("state"))
                out["sink_http"] = status.get("sinks", {}).get("http")
                counters = client.call("getSelfTelemetry")["counters"]
                out["supervision_counters"] = {
                    k: counters.get(k, 0)
                    for k in ("collector_restarts",
                              "collector_deadline_misses",
                              "collector_quarantines")}
            return out
        finally:
            stop_daemon(proc)

    healthy = run_phase(faulted=False)
    degraded = run_phase(faulted=True)
    return {
        "window_s": window_s,
        "collector_interval_s": interval_s,
        "nominal_ticks_per_s": 1.0 / interval_s,
        "healthy": healthy,
        "degraded": degraded,
        "cadence_ratio": round(
            degraded["kernel_ticks_per_s"]
            / max(1e-9, healthy["kernel_ticks_per_s"]), 3),
    }


def measure_autocapture(daemon_bin, tmp, rules=5):
    """bench.py:measure_autocapture on the port's minifleet: a flagged
    daemon and two ring neighbours, each with a FakeCaptureClient that
    writes ``fake_<endpoint>.pt.trace.json``; ``rules`` watch rules
    fired one at a time by injected history, each timed from its
    autocapture_fired stamp to the first artifact any host wrote."""
    log_dir = os.path.join(tmp, "autocap_bench")
    watch = ",".join(
        f"bench_ac_metric{i}<20:60:trace(300)" for i in range(rules))
    neighbors, n_clients = minifleet.spawn(
        daemon_bin, 2, "acbnb", poll_interval_s=0.1, write_fake_trace=True)
    flagged, f_clients = [], []
    try:
        peers = ",".join(f"localhost:{p}" for _, p in neighbors)
        flagged, f_clients = minifleet.spawn(
            daemon_bin, 1, "acbfl",
            daemon_args=("--enable_history_injection",
                         "--watch", watch,
                         "--watch_interval_s", "0.2",
                         "--watch_z_threshold", "0",
                         "--capture_peers", peers,
                         "--capture_neighbors", "2",
                         "--capture_cooldown_s", "0",
                         "--capture_log_dir", log_dir,
                         "--capture_job_id", "fleet",
                         "--capture_start_delay_ms", "100"),
            poll_interval_s=0.1, write_fake_trace=True)
        check(minifleet.wait_registered(neighbors + flagged, timeout_s=30),
              "autocapture fleet never registered")
        port = flagged[0][1]
        client = DynoClient(port=port)

        def fired_events():
            got = eventlog.fetch_all_events(DynoClient(port=port))
            return [e for e in got["events"]
                    if e["type"] == "autocapture_fired"]

        def traces():
            return set(glob.glob(
                os.path.join(log_dir, "**", "*.pt.trace.json"),
                recursive=True))

        latencies_ms = []
        for i in range(rules):
            # A repeat capture rewrites each host's fake trace in place:
            # a new artifact is a path whose mtime passed the snapshot.
            seen = {p: os.path.getmtime(p) for p in traces()}
            now_ms = int(time.time() * 1000)
            client.put_history(
                f"bench_ac_metric{i}.dev0",
                [(now_ms - (30 - k) * 1000, 5.0) for k in range(30)])
            deadline = time.time() + 15
            fired = None
            while time.time() < deadline:
                ev = fired_events()
                if len(ev) == i + 1:
                    fired = ev[i]
                    break
                time.sleep(0.05)
            check(fired is not None, f"rule {i} never fired")
            fresh = []
            while time.time() < deadline and not fresh:
                fresh = [os.path.getmtime(p) for p in traces()
                         if os.path.getmtime(p) > seen.get(p, 0.0)]
                if not fresh:
                    time.sleep(0.02)
            check(fresh, f"rule {i} fired but no artifact")
            latencies_ms.append(min(fresh) * 1000 - fired["ts_ms"])
            # Every host closes this window before the next rule fires:
            # a client mid-capture drops incoming configs.
            check(minifleet.wait_captures(f_clients + n_clients, count=i + 1,
                                          timeout_s=15),
                  f"capture {i} never completed")
        return {
            "hosts": 3,
            "firings": rules,
            "first_artifact_ms": _stats(latencies_ms),
            "capture_start_delay_ms": 100,
        }
    finally:
        minifleet.teardown(neighbors + flagged, n_clients + f_clients)


def _kernel_ticks(client):
    """The kernel collector's tick count from a daemon's getStatus."""
    return (client.status().get("collectors", {})
            .get("kernel", {}).get("ticks", 0))


def _wait_ticks(client, n, timeout_s=20.0):
    """Returns once the kernel collector has ticked ``n`` times, or after
    ``timeout_s``."""
    deadline = time.time() + timeout_s
    while _kernel_ticks(client) < n and time.time() < deadline:
        time.sleep(0.05)


def _aligned_ticks(client):
    """(ticks, monotonic time) sampled at a tick transition: a rate
    between two transitions carries no partial-tick quantization (the
    collector paces on absolute deadlines, so at 10 Hz a 2-3 s window
    would otherwise be +-5 % from rounding alone)."""
    last = _kernel_ticks(client)
    deadline = time.time() + 5
    while time.time() < deadline:
        n = _kernel_ticks(client)
        if n != last:
            return n, time.monotonic()
        time.sleep(0.005)
    return _kernel_ticks(client), time.monotonic()


def _tick_rate(client, seconds):
    """Kernel-collector ticks per second over ``seconds``, between two
    tick transitions."""
    n0, t0 = _aligned_ticks(client)
    time.sleep(seconds)
    n1, t1 = _aligned_ticks(client)
    return (n1 - n0) / (t1 - t0)


def _rank(xs, p, ndigits=3):
    """bench.py's nearest-rank percentile: the sorted sample at
    int(p * (n - 1)), rounded."""
    s = sorted(xs)
    return round(s[min(len(s) - 1, int(p * (len(s) - 1)))], ndigits)


def measure_durability(daemon_bin, tmp, window_s=4.0):
    """bench.py:measure_durability: the kernel collector's cadence with
    the write-through WAL and the flusher persisting to disk against a
    storage-less daemon, each over ``window_s``; then a 1 MB store filled
    past its budget (evictions running), SIGKILLed and restarted on the
    same dir, with the wall time until the recovered daemon answers RPC
    (segment scan, torn-tail truncation and journal re-seed all run
    before the RPC socket opens). Unlike bench.py, every daemon's log is
    drained."""
    interval_s = 0.1
    store = os.path.join(tmp, "bench_store")
    small_store = ["--storage_dir", store,
                   "--storage_budget_mb", "1",
                   "--storage_segment_kb", "4",
                   "--storage_flush_interval_s", "0.1"]

    def spawn(extra):
        return start_daemon(
            daemon_bin, "--kernel_monitor_interval_s", str(interval_s),
            "--enable_tpu_monitor=false", "--enable_perf_monitor=false",
            "--ipc_socket_name", "benchdur", *extra)

    def kernel_ticks_per_s(with_storage):
        shutil.rmtree(store, ignore_errors=True)
        extra = (["--storage_dir", store,
                  "--storage_flush_interval_s", "0.2"]
                 if with_storage else [])
        proc, port = _drained(spawn(extra))
        try:
            client = DynoClient(port=port)
            _wait_ticks(client, 2)
            t0 = time.monotonic()
            n0 = _kernel_ticks(client)
            time.sleep(window_s)
            n1 = _kernel_ticks(client)
            return round((n1 - n0) / (time.monotonic() - t0), 3)
        finally:
            stop_daemon(proc)

    no_storage = kernel_ticks_per_s(with_storage=False)
    with_flusher = kernel_ticks_per_s(with_storage=True)

    # Fill a 1 MB store past its budget, so that recovery scans a full,
    # evicting segment set: the worst case.
    shutil.rmtree(store, ignore_errors=True)
    proc, port = _drained(spawn(small_store))
    try:
        client = DynoClient(port=port)
        pad = "x" * 512
        i = 0
        deadline = time.time() + 30
        while time.time() < deadline:
            for _ in range(200):
                client.set_trace_config(f"durbench{i}-{pad}",
                                        {"duration_ms": 1})
                i += 1
            if client.status()["storage"]["evictions_total"] > 0:
                break
        at_kill = client.status()["storage"]
    except BaseException:
        stop_daemon(proc)
        raise
    # Nothing between the kill and the respawn: the respawn's wait for
    # the RPC port line is the recovery time.
    proc.kill()
    proc.wait()
    t0 = time.monotonic()
    started = spawn(small_store)
    recovery_ms = round((time.monotonic() - t0) * 1e3, 1)
    proc, port = _drained(started)
    try:
        recovered = DynoClient(port=port).status()["storage"]
    finally:
        stop_daemon(proc)
    return {
        "window_s": window_s,
        "collector_interval_s": interval_s,
        "kernel_ticks_per_s": {"no_storage": no_storage,
                               "with_flusher": with_flusher},
        "cadence_ratio": round(with_flusher / max(1e-9, no_storage), 3),
        "store_at_kill": {"bytes": at_kill["bytes"],
                          "segments": at_kill["segments"],
                          "evictions_total": at_kill["evictions_total"],
                          "events_staged": i},
        "recovery_ms": recovery_ms,
        "recovered": {"frames": recovered["recovered_frames"],
                      "torn_frames": recovered["torn_frames"],
                      "bytes": recovered["bytes"],
                      "segments": recovered["segments"]},
    }


def measure_sketch_quantiles(samples=200_000, big_samples=1_000_000,
                             leaf_samples=2000):
    """bench.py:measure_sketch_quantiles on the port's QuantileSketch:
    the worst relative error against exact quantiles on three workload
    shapes of ``samples`` each, buckets and wire bytes at
    ``big_samples`` against the exact history's, and the throughput of
    a depth-3 tree merge (64 leaves of ``leaf_samples`` -> 16 -> 4 -> 1).
    Pure Python and seeded: at bench.py's sizes every key but the three
    timings equals bench.py's."""
    def exact_q(sorted_vals, q):
        rank = q * (len(sorted_vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(sorted_vals) - 1)
        return sorted_vals[lo] + (rank - lo) * (
            sorted_vals[hi] - sorted_vals[lo])

    rng = random.Random(14)
    n = samples
    workloads = {
        "uniform": [rng.uniform(1.0, 100.0) for _ in range(n)],
        "lognormal": [rng.lognormvariate(0.0, 1.5) for _ in range(n)],
        "bimodal": [rng.gauss(10.0, 0.5) if rng.random() < 0.7
                    else rng.gauss(90.0, 2.0) for _ in range(n)],
    }
    worst_err = 0.0
    per_workload = {}
    for name, vals in workloads.items():
        sk = QuantileSketch()
        for v in vals:
            sk.add(abs(v) + 1e-9)  # lognormal/gauss tails stay positive
        s = sorted(abs(v) + 1e-9 for v in vals)
        errs = {}
        for q in (0.5, 0.95, 0.99):
            exact = exact_q(s, q)
            err = abs(sk.quantile(q) - exact) / abs(exact)
            errs[f"p{int(q * 100)}"] = round(err, 5)
            worst_err = max(worst_err, err)
        per_workload[name] = errs

    # Memory: the sketch is O(buckets); the exact baseline is the sample
    # list itself, on the same JSON wire the fleet sweeps speak.
    big = QuantileSketch()
    million = [rng.lognormvariate(2.0, 1.0) for _ in range(big_samples)]
    t0 = time.monotonic()
    for v in million:
        big.add(v)
    add_s = time.monotonic() - t0
    bucket_count = len(big.pos) + len(big.neg)
    sketch_bytes = len(json.dumps(big.to_json()))
    exact_bytes = len(json.dumps(million))

    leaves = []
    for i in range(64):
        leaf = QuantileSketch()
        for _ in range(leaf_samples):
            leaf.add(rng.uniform(1.0 + i * 0.1, 100.0))
        leaves.append(leaf.to_json())

    def reduce_level(payloads, fan_in):
        out = []
        merges = 0
        for i in range(0, len(payloads), fan_in):
            acc = QuantileSketch()
            for wire in payloads[i:i + fan_in]:
                got = QuantileSketch.from_json(wire)
                check(got is not None and acc.merge(got),
                      "sketch_quantiles: a leaf sketch did not merge")
                merges += 1
            out.append(acc.to_json())
        return out, merges

    merges_total = 0
    passes = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.5:
        level = leaves
        for fan_in in (4, 4, 4):  # 64 -> 16 -> 4 -> 1
            level, m = reduce_level(level, fan_in)
            merges_total += m
        root = QuantileSketch.from_json(level[0])
        check(root is not None and root.count == 64 * leaf_samples,
              "sketch_quantiles: the root's count is not the leaves' sum")
        passes += 1
    merge_window_s = time.monotonic() - t0

    return {
        "documented_error_bound": RELATIVE_ERROR_BOUND,
        "worst_relative_error": round(worst_err, 5),
        "relative_error_by_workload": per_workload,
        "samples_per_workload": n,
        "bucket_count_at_1m_samples": bucket_count,
        "sketch_wire_bytes_at_1m": sketch_bytes,
        "exact_history_wire_bytes_at_1m": exact_bytes,
        "wire_bytes_ratio": round(sketch_bytes / exact_bytes, 6),
        "add_us_per_sample": round(add_s / len(million) * 1e6, 3),
        "tree_merges_per_s": round(merges_total / merge_window_s, 1),
        "tree_merge_passes": passes,
        "tree_shape": "64 leaves -> 16 -> 4 -> 1 (depth 3)",
    }


def measure_read_swarm(daemon_bin, tmp, readers=200, waves=5,
                       min_wall_s=6.0):
    """bench.py:measure_read_swarm: waves of ``readers`` concurrent
    getAggregates calls (8 sockets in flight) against one daemon that
    samples at 10 Hz, for at least ``waves`` waves and ``min_wall_s`` of
    pressure: per-request p50/p99 (socket creation to parsed reply), the
    kernel collector's cadence under the swarm against idle, and the
    server's cache and queue accounting. Unlike bench.py, the daemon's
    log is drained."""
    interval_s = 0.1
    proc, port = _drained(start_daemon(
        daemon_bin, "--kernel_monitor_interval_s", str(interval_s),
        "--enable_tpu_monitor=false", "--enable_perf_monitor=false",
        "--enable_history_injection",
        "--rpc_client_rate", "0",  # measuring the pool, not admission
        "--rpc_queue_max", "512",
        "--ipc_socket_name", "benchswarm"))
    try:
        client = DynoClient(port=port)
        now = int(time.time() * 1000)
        client.put_history(
            "bench_swarm_metric",
            [(now - 5000 + i * 10, float(i)) for i in range(100)])
        _wait_ticks(client, 3)
        idle_rate = _tick_rate(client, 2.5)

        req = {"fn": "getAggregates", "windows_s": [60]}
        latencies_ms = []
        errors = 0
        waves_run = 0
        n0, t0 = _aligned_ticks(client)
        while waves_run < waves or time.monotonic() - t0 < min_wall_s:
            for rec in fan_out([("127.0.0.1", port, req)] * readers,
                               timeout=10.0, parallelism=8):
                if rec["ok"] and "windows" in rec["response"]:
                    latencies_ms.append(rec["elapsed_s"] * 1e3)
                else:
                    errors += 1
            waves_run += 1
        n1, t1 = _aligned_ticks(client)
        swarm_s = t1 - t0
        swarm_rate = (n1 - n0) / swarm_s
        rpc = client.status()["rpc"]
        check(latencies_ms, f"read_swarm: no read answered ({errors} "
                            f"errors)")
        return {
            "readers": readers,
            "waves": waves_run,
            "requests": readers * waves_run,
            "errors": errors,
            "swarm_wall_s": round(swarm_s, 2),
            "requests_per_s": round(len(latencies_ms) / max(1e-9, swarm_s),
                                    1),
            "read_p50_ms": _rank(latencies_ms, 0.50),
            "read_p99_ms": _rank(latencies_ms, 0.99),
            "served_ms": rpc.get("served_ms", {}),
            "read_threads": rpc.get("read_threads"),
            "kernel_ticks_per_s": {"idle": round(idle_rate, 3),
                                   "under_swarm": round(swarm_rate, 3)},
            "cadence_ratio": round(swarm_rate / max(1e-9, idle_rate), 3),
            "cache": rpc.get("cache", {}),
            "queued_total": rpc.get("queued_total"),
            "rejected_total": rpc.get("rejected_total"),
        }
    finally:
        stop_daemon(proc)


# The abusive tenant of measure_multitenant, in a process of its own (in
# this one it would share the interpreter lock with the polite client's
# timing loop): signed getAggregates paced at ``rate`` a second, niced so
# that on a small host the two client processes do not contend for one
# core. It imports the port's RPC client from the repo root.
_ABUSER = (
    "import os, sys, time\n"
    "sys.path.insert(0, {repo!r})\n"
    "os.nice(10)\n"
    "from dynolog_tpu_torch.utils.rpc import DynoClient\n"
    "c = DynoClient(port={port}, token='bench-abuser',\n"
    "               tenant='abuser', sign_reads=True,\n"
    "               client_id='bench-abuser')\n"
    "next_t = time.monotonic()\n"
    "while True:\n"
    "    next_t += 1.0 / {rate}\n"
    "    c.call('getAggregates', windows_s=[60])\n"
    "    delay = next_t - time.monotonic()\n"
    "    if delay > 0:\n"
    "        time.sleep(delay)\n")


def abuser_script(port, rate):
    """The abusive tenant's ``python -c`` program against ``port``."""
    return _ABUSER.format(repo=str(REPO), port=port, rate=rate)


def measure_multitenant(daemon_bin, tmp, seeds=16, leaves=240,
                        kill_trials=2, polite_reads=200):
    """bench.py:measure_multitenant:

    - the auth tax: kernel cadence at 10 Hz with the authenticated
      control plane on and a steady signed read+write load, against an
      open daemon idle;
    - abuse isolation: a polite tenant's signed-read p99 over
      ``polite_reads`` reads 80 ms apart, alone and then while an
      abusive tenant (a process of its own) calls at 10x the per-tenant
      rate of 20/s;
    - the authenticated re-parent storm: ``seeds`` + ``leaves`` daemons
      sharing a token file, interior seeds SIGKILLed one a trial, each
      orphan's re-registration crossing the challenge handshake.

    Unlike bench.py, every daemon's log is drained."""
    token_path = os.path.join(tmp, "bench_fleet.tokens")
    minifleet.write_token_file(token_path, [
        ("benchfleet", "fleet", "admin"),
        ("bench-polite", "polite"),
        ("bench-abuser", "abuser"),
    ])

    def spawn_one(name, *extra):
        return _drained(start_daemon(
            daemon_bin, "--kernel_monitor_interval_s", "0.1",
            "--enable_tpu_monitor=false", "--enable_perf_monitor=false",
            "--enable_history_injection", "--rpc_client_rate", "0",
            "--ipc_socket_name", name, *extra))

    def tick_rate(port):
        client = DynoClient(port=port)
        _wait_ticks(client, 3)
        return _tick_rate(client, 2.5)

    # Cadence with auth on, under signed traffic, against open and idle.
    proc, port = spawn_one("benchmtopen")
    try:
        open_rate = tick_rate(port)
    finally:
        stop_daemon(proc)

    proc, port = spawn_one("benchmtauth", "--fleet_token_file", token_path,
                           "--tenant_rate", "1000", "--tenant_burst", "1000")
    try:
        writer = DynoClient(port=port, token="benchfleet",
                            tenant="fleet", client_id="bench-writer")
        reader = DynoClient(port=port, token="benchfleet",
                            tenant="fleet", sign_reads=True,
                            client_id="bench-reader")
        stop_flag = threading.Event()

        def signed_load():
            now = int(time.time() * 1000)
            i = 0
            while not stop_flag.is_set():
                writer.put_history("bench_mt_metric", [(now + i, float(i))])
                reader.call("getAggregates", windows_s=[60])
                i += 1

        t = threading.Thread(target=signed_load, daemon=True)
        t.start()
        try:
            auth_rate = tick_rate(port)
        finally:
            stop_flag.set()
            t.join(timeout=10.0)
        auth_stats = DynoClient(port=port).status()["rpc"]
    finally:
        stop_daemon(proc)

    # Abuse isolation. A budget of 20/s holds the polite cadence (~12/s
    # with service time); 10x of it is quota abuse, mostly O(1) sheds,
    # not a test of the host's scheduler.
    tenant_rate = 20
    proc, port = spawn_one("benchmtabuse", "--fleet_token_file", token_path,
                           "--tenant_rate", str(tenant_rate),
                           "--tenant_burst", str(tenant_rate))
    try:
        def polite_p99(spacing_s=0.08):
            c = DynoClient(port=port, token="bench-polite",
                           tenant="polite", sign_reads=True,
                           client_id="bench-polite")
            lat = []
            for _ in range(polite_reads):
                t0 = time.monotonic()
                r = c.call("getAggregates", windows_s=[60])
                check(r.get("error") != "quota_exceeded",
                      "multitenant: the polite tenant was shed (quota "
                      "isolation broken)")
                lat.append((time.monotonic() - t0) * 1e3)
                time.sleep(spacing_s)
            lat.sort()
            return lat[min(len(lat) - 1, int(0.99 * (len(lat) - 1)))]

        alone_p99 = polite_p99()
        abuser = subprocess.Popen(
            [sys.executable, "-c", abuser_script(port, 10 * tenant_rate)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(2.0)  # the abuser spends its burst; steady shedding
        try:
            under_abuse_p99 = polite_p99()
        finally:
            abuser.kill()
            abuser.wait(timeout=10.0)
        tenant_counts = DynoClient(port=port).status()["rpc"].get(
            "tenants", {})
        abuse_counts = tenant_counts.get("abuser", {})
    finally:
        stop_daemon(proc)

    # The authenticated re-parent storm.
    daemons, seed_list = minifleet.spawn_seeded(
        daemon_bin, "benchmtstorm", seeds=seeds, leaves=leaves,
        daemon_args=("--fleet_report_interval_s", "1",
                     "--fleet_stale_after_s", "2",
                     "--fleet_token_file", token_path))
    for d in daemons:
        _drained(d)
    rng = random.Random(4321)
    try:
        ports = [p for _, p in daemons]
        dead_ports: set = set()
        root = minifleet.expected_root(seed_list)
        bootstrap_s = _wait_fresh(int(_port_of(root)),
                                  {str(p) for p in ports}, 180.0)
        check(bootstrap_s is not None,
              f"multitenant: the authenticated seeded fleet never "
              f"converged to {len(ports)} hosts")
        reparent_s, lost_children = _kill_interior_seeds(
            daemons, seeds, _port_of(root), rng, kill_trials, dead_ports)
        # Every re-registration crossed the handshake: no survivor saw a
        # rejected relay verb (counted on the parent's side).
        storm_auth_rejects = 0
        for p in ports:
            if p in dead_ports:
                continue
            try:
                storm_auth_rejects += DynoClient(
                    port=p, timeout=3.0).status()["rpc"].get(
                        "auth_rejected_total", 0)
            except Exception:
                pass
    finally:
        minifleet.teardown(daemons, [])

    return {
        "kernel_ticks_per_s": {"open_idle": round(open_rate, 3),
                               "auth_under_load": round(auth_rate, 3)},
        "cadence_ratio": round(auth_rate / max(1e-9, open_rate), 3),
        "auth_ok_total": auth_stats.get("auth_ok_total"),
        "polite_read_p99_ms": {
            "alone": round(alone_p99, 3),
            "under_10x_abuser": round(under_abuse_p99, 3)},
        "polite_p99_shift_pct": round(
            (under_abuse_p99 - alone_p99) / max(1e-9, alone_p99) * 100, 1),
        "abuser": {"served": abuse_counts.get("served", 0),
                   "shed": abuse_counts.get("shed", 0)},
        "tenant_counts": tenant_counts,
        "storm_hosts": len(ports),
        "storm_bootstrap_s": round(bootstrap_s, 1),
        "storm_kill_trials": kill_trials,
        "storm_reparented_children": len(reparent_s),
        "storm_lost_children": lost_children,
        "storm_reparent_s": _stats(reparent_s) if reparent_s else None,
        "storm_auth_rejected_total": storm_auth_rejects,
    }


def measure_link_localization(daemon_bin, tmp, n_hosts=16,
                              degraded_edge=5, trials=15, min_wall_s=3.0):
    """bench.py:measure_link_localization: an ``n_hosts`` ICI ring with
    edge ``degraded_edge`` at 60 % through the ``ici_link`` faultline
    scope and healthy host metrics everywhere; the sweep must flag that
    edge alone LINK_BOUND and no host. Its cost: at least ``trials``
    sweeps and ``min_wall_s`` of edge-scoring sweeps against host-only
    sweeps of daemons spawned without --ici_topology, and host 0's
    kernel cadence (10 Hz) idle against under the sweeps. Unlike
    bench.py, every daemon's log is drained."""
    interval_s = 0.1

    def run_fleet(topologized):
        rng = random.Random(7)
        daemons = []
        try:
            for i in range(n_hosts):
                extra = (minifleet.ici_ring_args(n_hosts, i)
                         if topologized else ())
                # Host 0 is the cadence probe: its kernel collector at
                # 10 Hz (the last flag wins over the helper's 3600 s).
                daemons.extend(_drained(d) for d in minifleet.spawn_daemons(
                    daemon_bin, 1,
                    f"benchlh{'t' if topologized else 'h'}{i}",
                    daemon_args=(
                        "--enable_history_injection",
                        *(("--kernel_monitor_interval_s",
                           str(interval_s)) if i == 0 else ()),
                        *extra)))
            now_ms = int(time.time() * 1000)
            for _, port in daemons:
                base = 70.0 + rng.uniform(-0.5, 0.5)
                DynoClient(port=port).put_history(
                    "tensorcore_duty_cycle_pct.dev0",
                    [(now_ms - (30 - k) * 1000,
                      base + rng.uniform(-0.3, 0.3)) for k in range(30)])
            if topologized:
                # Armed in this process only (the daemons are up):
                # ring_link_series honours the spec the daemon's own
                # poll path does.
                prev = os.environ.get(faultline.ENV_VAR)
                os.environ[faultline.ENV_VAR] = (
                    f"ici_link.degrade_link={degraded_edge},"
                    "ici_link.degrade_factor=0.6")
                faultline.reset()
                try:
                    minifleet.inject_ring_links(
                        daemons, minifleet.ring_link_series(n_hosts))
                finally:
                    if prev is None:
                        os.environ.pop(faultline.ENV_VAR, None)
                    else:
                        os.environ[faultline.ENV_VAR] = prev
                    faultline.reset()

            hosts = [f"localhost:{p}" for _, p in daemons]
            probe = DynoClient(port=daemons[0][1])
            _wait_ticks(probe, 3)
            idle_rate = _tick_rate(probe, 2.0)

            sweeps_ms = []
            verdict = None
            n0, t0 = _aligned_ticks(probe)
            while len(sweeps_ms) < trials or \
                    time.monotonic() - t0 < min_wall_s:
                s0 = time.time()
                verdict = fleetstatus.sweep(hosts, window_s=300)
                sweeps_ms.append((time.time() - s0) * 1e3)
            n1, t1 = _aligned_ticks(probe)
            return hosts, sweeps_ms, verdict, idle_rate, (n1 - n0) / (t1 - t0)
        finally:
            minifleet.teardown(daemons, [])

    _, host_ms, host_verdict, _, _ = run_fleet(topologized=False)
    hosts, link_ms, verdict, idle_rate, sweep_rate = run_fleet(
        topologized=True)

    expected_edge = (f"{hosts[degraded_edge]}<->"
                     f"{hosts[(degraded_edge + 1) % n_hosts]}:link1")
    bound = verdict.get("link_bound", [])
    exact = (len(bound) == 1 and bound[0]["edge"] == expected_edge
             and bound[0]["reason"] == "low_bandwidth")
    return {
        "hosts": n_hosts,
        "sweeps": len(link_ms),
        "degraded_edge": expected_edge,
        "link_bound": bound,
        "exact_edge": exact,
        "deficit_pct": bound[0]["deficit_pct"] if bound else None,
        # Every host was injected healthy: an outlier is a false positive.
        "false_positive_hosts": len(verdict.get("outliers", [])),
        "link_scoring": verdict.get("link_scoring", {}),
        "host_only_link_scoring":
            host_verdict.get("link_scoring", {}).get("status"),
        "host_only_sweep_ms": {"median": _rank(host_ms, 0.5, 1),
                               "p95": _rank(host_ms, 0.95, 1)},
        "link_sweep_ms": {"median": _rank(link_ms, 0.5, 1),
                          "p95": _rank(link_ms, 0.95, 1)},
        "kernel_ticks_per_s": {"idle": round(idle_rate, 3),
                               "under_sweep": round(sweep_rate, 3)},
        "cadence_ratio": round(sweep_rate / max(1e-9, idle_rate), 3),
    }


@contextlib.contextmanager
def _nofile_at_least(n):
    """RLIMIT_NOFILE's soft limit raised to ``n`` (at most the hard
    limit) while the block runs, and restored after it. Yields the soft
    limit in force."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = n if hard == resource.RLIM_INFINITY else min(n, hard)
    raised = False
    if soft != resource.RLIM_INFINITY and soft < want:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
            raised = True
        except (ValueError, OSError):
            pass
    try:
        yield resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    finally:
        if raised:
            resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


def _read_frame(sock):
    """One frame (a native-endian int32 length, then the body) from a
    blocking socket."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            check(chunk, "subscription: the daemon closed a session")
            buf += chunk
        return buf
    (ln,) = struct.unpack("@i", exact(4))
    return exact(ln)


def measure_subscription(daemon_bin, tmp, subscribers=500, probe_rounds=5,
                         leaves=3, relays=3):
    """bench.py:measure_subscription: ``subscribers`` fleet-scoped
    ``subscribe`` sessions at the root of a depth-3 tree (1 root,
    ``relays`` relays, ``leaves`` leaves each), one event emitted at
    every leaf a round with its send stamp as the detail: delivery
    latency to every subscriber's socket (two relay hops and the 20 ms
    push cadence), the root's kernel cadence under all the sessions
    against idle, and the steady-state RPC rate against 1 Hz polling.

    Unlike bench.py, it raises RLIMIT_NOFILE only as far as the sessions
    need (a socket here and one in the root, which inherits the limit)
    and restores it after, and drains every daemon's log (they tick at
    10 Hz)."""
    need = 2 * subscribers + 1024
    with _nofile_at_least(need) as soft:
        if soft < need:
            subscribers = min(subscribers, max(64, soft // 3))
        return _subscription(daemon_bin, tmp, subscribers, probe_rounds,
                             leaves, relays)


def _subscription(daemon_bin, tmp, subscribers, probe_rounds, leaves,
                  relays):
    daemons = minifleet.spawn_tree(
        daemon_bin, os.path.join(tmp, "subbench"), leaves=leaves,
        relays=relays,
        daemon_args=("--enable_history_injection",
                     "--fleet_report_interval_s", "1",
                     "--sub_push_interval_ms", "20",
                     "--sub_max_sessions", str(subscribers * 2),
                     "--rpc_client_rate", "0",
                     "--kernel_monitor_interval_s", "0.1"))
    for d in daemons:
        _drained(d)
    socks = []
    sel = selectors.DefaultSelector()
    try:
        root_port = daemons[0][1]
        client = DynoClient(port=root_port, timeout=10.0)
        leaf_clients = [DynoClient(port=p, timeout=10.0)
                        for _, p in daemons[1 + relays:]]

        # The tree has formed once the root sees every daemon.
        deadline = time.time() + 30
        while time.time() < deadline:
            if len(client.fleet_aggregates().get("hosts", {})) >= \
                    len(daemons):
                break
            time.sleep(0.3)
        idle_rate = _tick_rate(client, 2.5)

        # Register the swarm with blocking handshakes (the ack ends
        # each), then read them all non-blocking in one loop.
        reg_t0 = time.monotonic()
        for i in range(subscribers):
            s = socket.create_connection(("127.0.0.1", root_port),
                                         timeout=10.0)
            socks.append(s)
            body = json.dumps(
                {"fn": "subscribe", "events": True, "scope": "fleet",
                 "client_id": f"bench-sub-{i}"}).encode()
            s.sendall(struct.pack("@i", len(body)) + body)
            ack = _read_frame(s)
            check(json.loads(ack).get("status") == "ok",
                  f"subscription: subscriber {i}: {ack!r}")
            s.setblocking(False)
            sel.register(s, selectors.EVENT_READ, bytearray())
        register_s = time.monotonic() - reg_t0

        probe_latencies_ms = []

        def drain(duration_s):
            """Reads every subscriber's socket for ``duration_s``; each
            probe event's arrival less its send stamp is a sample."""
            end = time.monotonic() + duration_s
            while time.monotonic() < end:
                for key, _ in sel.select(timeout=0.05):
                    buf = key.data
                    try:
                        chunk = key.fileobj.recv(1 << 16)
                    except BlockingIOError:
                        continue
                    if not chunk:
                        sel.unregister(key.fileobj)
                        continue
                    buf.extend(chunk)
                    now_ms = time.time() * 1000.0
                    while len(buf) >= 4:
                        (ln,) = struct.unpack("@i", bytes(buf[:4]))
                        if len(buf) < 4 + ln:
                            break
                        frame = json.loads(bytes(buf[4:4 + ln]))
                        del buf[:4 + ln]
                        if frame.get("push") != "delta":
                            continue
                        for e in frame.get("events", []):
                            if e.get("type") == "bench_probe":
                                probe_latencies_ms.append(
                                    now_ms - float(e["detail"]))

        drain(1.0)  # settle: the registrations' caught_up/ping frames
        n0, t0 = _aligned_ticks(client)
        for _ in range(probe_rounds):
            for lc in leaf_clients:
                lc.emit_event(str(time.time() * 1000.0), type="bench_probe")
            drain(0.3)
        drain(1.0)  # the last round's frames land everywhere
        n1, t1 = _aligned_ticks(client)
        load_rate = (n1 - n0) / (t1 - t0)

        # Steady state: sessions open, nobody emitting. Polling would be
        # every subscriber calling getEvents once a second.
        served0 = client.status()["rpc"]["served_total"]
        drain(5.0)
        served1 = client.status()["rpc"]["served_total"]
        # Both bookend getStatus calls are ours; subtract them.
        steady_rpc_per_min = max(0, served1 - served0 - 1) * 12

        expected = probe_rounds * len(leaf_clients) * len(socks)
        lat = probe_latencies_ms
        sub_block = client.status().get("subscriptions", {})
        return {
            "subscribers": len(socks),
            "tree": {"depth": 3, "daemons": len(daemons)},
            "register_s": round(register_s, 3),
            "probe_events": probe_rounds * len(leaf_clients),
            "deliveries": len(lat),
            "deliveries_expected": expected,
            "delivery_ratio": round(len(lat) / max(1, expected), 4),
            "delta_p50_ms": _rank(lat, 0.50) if lat else None,
            "delta_p95_ms": _rank(lat, 0.95) if lat else float("inf"),
            "kernel_ticks_per_s": {"idle": round(idle_rate, 3),
                                   "under_load": round(load_rate, 3)},
            "cadence_ratio": round(load_rate / max(1e-9, idle_rate), 3),
            "steady_rpc_per_min": steady_rpc_per_min,
            "polling_equiv_rpc_per_min": subscribers * 60,
            "root_active_sessions": sub_block.get("active"),
            "root_feeds": len(sub_block.get("feeds", [])),
        }
    finally:
        sel.close()
        for s in socks:
            s.close()
        minifleet.teardown(daemons, [])


def _sim_record(c, h, val, now_ms):
    return {"node": f"simh-{c:02d}-{h:02d}:1", "ts_ms": now_ms,
            "epoch": 1, "health": {}, "sketches": {},
            "scalars": {"tensorcore_duty_cycle_pct": round(40.0 + val, 3),
                        "hbm_util_pct": round(20.0 + val / 2, 3)}}


class _SimChild:
    """One simulated relay child of measure_fleet_scale, speaking the
    daemon's batched-delta relay wire: relayRegister, one full frame,
    then a delta frame a step with ~5 % of its synthetic host records
    changed. One attempt per RPC (no retries), so that a killed parent
    shows at once and the next step re-registers with a survivor.
    ``sent`` counts the request bytes of every child."""

    def __init__(self, idx, hosts, parents, dead_ports, now_ms, sent):
        self.node = f"simc-{idx:02d}:1"
        self.idx = idx
        self.epoch = 1
        self.seq = 0
        self.parents, self.dead_ports, self.sent = parents, dead_ports, sent
        self.parent = parents[idx % len(parents)]
        self.registered = False
        self.pending_full = True
        self.tick = 0
        self.records = [_sim_record(idx, h, (idx * 7 + h) % 30, now_ms)
                        for h in range(hosts)]

    def rpc(self, req):
        self.sent.add(len(json.dumps(req)))
        c = DynoClient(port=self.parent, timeout=3.0,
                       retry=RetryPolicy(attempts=1))
        return c.call(req["fn"], **{k: v for k, v in req.items()
                                    if k != "fn"})

    def step(self):
        if not self.registered:
            live = [p for p in self.parents if p not in self.dead_ports]
            self.parent = live[self.idx % len(live)]
            ack = self.rpc({"fn": "relayRegister", "node": self.node,
                            "epoch": self.epoch})
            check(ack.get("status") == "ok", f"fleet_scale: register: {ack}")
            self.registered = True
            self.pending_full = True
        self.tick += 1
        ts = int(time.time() * 1000)
        n = len(self.records)
        changed = []
        for j in range(max(1, n // 16)):  # ~5 % churn an interval
            r = self.records[(self.tick * 3 + j) % n]
            r["ts_ms"] = ts
            r["scalars"]["tensorcore_duty_cycle_pct"] = round(
                40.0 + (self.tick + j) % 30, 3)
            changed.append(r)
        if self.pending_full:
            for r in self.records:
                r["ts_ms"] = ts  # a fresh stamp: dedupe prefers this copy
            mode, hosts = "full", list(self.records)
        else:
            mode, hosts = "delta", [
                {"node": r["node"], "d": True, "ts_ms": r["ts_ms"],
                 "scalars": r["scalars"]} for r in changed]
        self.seq += 1
        ack = self.rpc({"fn": "relayReport", "node": self.node,
                        "epoch": self.epoch, "seq": self.seq, "ts_ms": ts,
                        "fidelity": "full", "mode": mode, "hosts": hosts,
                        "stale": []})
        if ack.get("need_register"):
            self.registered = False
        elif ack.get("status") == "ok":
            self.pending_full = bool(ack.get("need_full")
                                     or ack.get("overloaded"))


class _ByteCount:
    """A byte total that several threads add to."""

    def __init__(self):
        self.total = 0
        self._lock = threading.Lock()

    def add(self, n):
        with self._lock:
            self.total += n

    def read(self):
        with self._lock:
            return self.total


def measure_fleet_scale(daemon_bin, tmp, interiors=8, sim_children=32,
                        hosts_per_child=32, sweeps=20, byte_window_s=10.0):
    """bench.py:measure_fleet_scale: a root and ``interiors`` interior
    daemons, with ``sim_children`` simulated relay children (each of
    ``hosts_per_child`` synthetic host records, spread over the
    interiors) reporting once a second, so that the root reduces
    ``sim_children * hosts_per_child`` hosts besides the real daemons.
    It times ``sweeps`` root getFleetStatus calls; counts the fan-in
    bytes over ``byte_window_s`` (the children's uplinks and the
    interiors' relay_report_bytes) against every record shipped as its
    own frame over both edges; SIGKILLs the first interior and times
    until it is named stale and every simulated host is fresh through a
    survivor (None past 40 s); and reads the root's kernel cadence
    (10 Hz) idle against under all of it. Unlike bench.py, every
    daemon's log is drained."""
    daemons = minifleet.spawn_tree(
        daemon_bin, os.path.join(tmp, "scalebench"), leaves=0,
        relays=interiors,
        daemon_args=("--fleet_report_interval_s", "1",
                     "--fleet_stale_after_s", "5",
                     "--fleet_window_s", "300",
                     "--rpc_client_rate", "0",
                     "--kernel_monitor_interval_s", "0.1"))
    for d in daemons:
        _drained(d)
    root_port = daemons[0][1]
    interior_ports = [p for _, p in daemons[1:]]
    client = DynoClient(port=root_port, timeout=10.0)
    stop = threading.Event()
    pump_thread = None
    try:
        now_ms = int(time.time() * 1000)
        dead_ports = set()
        sent = _ByteCount()
        sim = [_SimChild(i, hosts_per_child, interior_ports, dead_ports,
                         now_ms, sent) for i in range(sim_children)]

        def pump():
            while not stop.is_set():
                t0 = time.monotonic()
                for ch in sim:
                    if stop.is_set():
                        return
                    try:
                        ch.step()
                    except Exception:
                        # A dead or overwhelmed parent: re-register with
                        # a surviving interior on the next pass.
                        ch.registered = False
                stop.wait(max(0.05, 1.0 - (time.monotonic() - t0)))

        def fresh_and_stale():
            v = client.fleet_status()
            stale_nodes = {e["node"] for e in v.get("stale", [])}
            return set(v.get("hosts", [])) - stale_nodes, stale_nodes

        def uplink_bytes():
            return sum(DynoClient(port=p, timeout=3.0).self_telemetry()
                       ["counters"].get("relay_report_bytes", 0)
                       for p in interior_ports if p not in dead_ports)

        # The real tree formed (root and interiors fresh), then the idle
        # cadence before the simulated tier reports.
        deadline = time.time() + 30
        while time.time() < deadline:
            fresh, _ = fresh_and_stale()
            if len(fresh) >= len(daemons):
                break
            time.sleep(0.3)
        idle_rate = _tick_rate(client, 2.5)

        pump_thread = threading.Thread(target=pump, daemon=True)
        pump_thread.start()
        sim_names = {r["node"] for ch in sim for r in ch.records}
        deadline = time.time() + 60
        while time.time() < deadline:
            fresh, _ = fresh_and_stale()
            if sim_names <= fresh:
                break
            time.sleep(0.5)
        else:
            raise BenchError(
                f"fleet_scale: only {len(fresh & sim_names)}/"
                f"{len(sim_names)} simulated hosts converged")

        # Sweep latency, fan-in bytes and cadence under load.
        cn0, ct0 = _aligned_ticks(client)
        sweep_ms = []
        for _ in range(sweeps):
            s0 = time.monotonic()
            v = client.fleet_status()
            sweep_ms.append((time.monotonic() - s0) * 1000.0)
            check(v.get("status") == "ok", f"fleet_scale: sweep failed: {v}")
        harness0, interiors0 = sent.read(), uplink_bytes()
        time.sleep(byte_window_s)
        harness1, interiors1 = sent.read(), uplink_bytes()
        cn1, ct1 = _aligned_ticks(client)
        load_rate = (cn1 - cn0) / (ct1 - ct0)

        actual_bytes = (harness1 - harness0) + (interiors1 - interiors0)
        # Unbatched: every synthetic record as its own full frame each
        # interval, over both edges (child -> interior -> root); the real
        # daemons' own records are left out, so this undercounts.
        per_record = [len(json.dumps(
            {"fn": "relayReport", "node": "simc-00:1", "epoch": 1,
             "seq": 1, "ts_ms": now_ms, "fidelity": "full",
             "mode": "full", "hosts": [r], "stale": []}))
            for ch in sim for r in ch.records]
        unbatched_bytes = 2 * sum(per_record) * byte_window_s

        # SIGKILL the first interior (daemons[0] is the root).
        kill_idx = 1
        dead_port = daemons[kill_idx][1]
        minifleet.kill_daemon(daemons, kill_idx)
        dead_ports.add(dead_port)
        kill_t = time.monotonic()
        converge_s = None
        deadline = time.time() + 40
        while time.time() < deadline:
            fresh, stale_nodes = fresh_and_stale()
            # Converged: the dead relay has aged out as stale, and every
            # simulated host is fresh through a surviving interior.
            if (any(n.endswith(f":{dead_port}") for n in stale_nodes)
                    and sim_names <= fresh):
                converge_s = time.monotonic() - kill_t
                break
            time.sleep(0.25)
        fresh, _ = fresh_and_stale()

        root_counters = (DynoClient(port=root_port, timeout=3.0)
                         .self_telemetry()["counters"])
        # The uplink counters live on the senders: a surviving interior.
        interior_counters = DynoClient(
            port=next(p for p in interior_ports if p not in dead_ports),
            timeout=3.0).self_telemetry()["counters"]
        return {
            "simulated_hosts": sim_children * hosts_per_child,
            "sim_children": sim_children,
            "interiors": interiors,
            "records_at_root": len(fresh),
            "sweep_ms": {"median": round(sorted(sweep_ms)[
                             len(sweep_ms) // 2], 3),
                         "p95": _rank(sweep_ms, 0.95)},
            "fanin": {
                "window_s": byte_window_s,
                "harness_uplink_bytes": harness1 - harness0,
                "interior_uplink_bytes": interiors1 - interiors0,
                "actual_bytes": actual_bytes,
                "unbatched_baseline_bytes": int(unbatched_bytes),
                "reduction_x": round(unbatched_bytes / max(1, actual_bytes),
                                     2),
            },
            "killed_interior_port": dead_port,
            "converge_after_kill_s": (round(converge_s, 3)
                                      if converge_s is not None else None),
            "lost_children": len(sim_names - fresh),
            "kernel_ticks_per_s": {"idle": round(idle_rate, 3),
                                   "under_load": round(load_rate, 3)},
            "cadence_ratio": round(load_rate / max(1e-9, idle_rate), 3),
            "root_relay_counters": {
                k: root_counters.get(k, 0)
                for k in ("relay_reports_rx", "relay_sheds",
                          "relay_splits")},
            "interior_uplink_counters": {
                k: interior_counters.get(k, 0)
                for k in ("relay_batched_frames", "relay_delta_records",
                          "relay_report_bytes")},
        }
    finally:
        stop.set()
        if pump_thread is not None:
            pump_thread.join(timeout=5.0)
        minifleet.teardown(daemons, [])


# The numbers every run reports, by phase: main() fails a run that
# leaves one out. The fallback client streams nothing, so it has no
# stop_to_stream_commit.
_LATENCY = ("e2e_ms", "nonwindow_ms",
            *(f"phases_ms.{n}" for n in BREAKDOWN))
REQUIRED = {
    "overhead": ("off_ms", "on_ms", "off_median_ms", "on_median_ms",
                 "overhead_pct", "daemon_rss_mb"),
    "trace_latency": _LATENCY,
    "trace_latency_poll_fallback": tuple(
        k for k in _LATENCY if not k.endswith("stop_to_stream_commit")),
    "phase_attribution": ("cadence_ratio", "quiet.kernel_ticks_per_s",
                          "annotated.kernel_ticks_per_s",
                          "annotated.annotations_per_s",
                          "annotated.spin_cpu_util",
                          "annotated.sleep_cpu_util"),
    "loaded_host": ("base_s", "loaded_s", "overhead_pct",
                    "overhead_cpu_accounting_pct"),
    "flight_recorder": ("cadence_ratio", "kernel_ticks_per_s.ring_off",
                        "kernel_ticks_per_s.ring_on", "trigger_to_retro_ms",
                        "ring.ring_off_ms", "ring.ring_on_ms",
                        "ring.ring_off_median_ms", "ring.ring_on_median_ms",
                        "ring.vs_ring_off_pct"),
    # "*": every host count the run swept.
    "fleet": ("*.fanout_rpc_ms", "*.sync_spread_ms", "*.max_sync_error_ms",
              "*.common_open_ms"),
    "restart_recovery": ("recovery_ms",),
    "fleet_health": ("sweep_ms",),
    "fleet_tree": ("tree_sweep_ms", "flat_sweep_ms"),
    # Not reparent_s, root_promotion_s, post_promotion_full_sweep_s:
    # outcomes, None where the fleet did not converge in time.
    "fleet_selfheal": ("tree_sweep_ms", "flat_sweep_ms",
                       "gang_trigger_tree_ms", "gang_trigger_flat_ms"),
    "event_journal": ("emit_rpc_ms_per_event", "drain_ms_at_capacity"),
    "degraded_mode": ("cadence_ratio", "healthy.kernel_ticks_per_s",
                      "healthy.rpc_getstatus_ms",
                      "degraded.kernel_ticks_per_s",
                      "degraded.rpc_getstatus_ms"),
    "autocapture": ("first_artifact_ms",),
    "durability": ("kernel_ticks_per_s.no_storage",
                   "kernel_ticks_per_s.with_flusher", "cadence_ratio",
                   "recovery_ms"),
    "sketch_quantiles": ("worst_relative_error", "wire_bytes_ratio",
                         "add_us_per_sample", "tree_merges_per_s"),
    "read_swarm": ("read_p50_ms", "read_p99_ms", "requests_per_s",
                   "kernel_ticks_per_s.idle",
                   "kernel_ticks_per_s.under_swarm", "cadence_ratio"),
    # Not storm_reparent_s: None where no seed but the root had a child.
    "multitenant": ("kernel_ticks_per_s.open_idle",
                    "kernel_ticks_per_s.auth_under_load", "cadence_ratio",
                    "polite_read_p99_ms.alone",
                    "polite_read_p99_ms.under_10x_abuser",
                    "polite_p99_shift_pct", "storm_bootstrap_s"),
    "link_localization": ("host_only_sweep_ms", "link_sweep_ms",
                          "kernel_ticks_per_s.idle",
                          "kernel_ticks_per_s.under_sweep",
                          "cadence_ratio"),
    # Not delta_p50_ms: None where no probe was delivered.
    "subscription": ("register_s", "delta_p95_ms",
                     "kernel_ticks_per_s.idle",
                     "kernel_ticks_per_s.under_load", "cadence_ratio"),
    # Not converge_after_kill_s: None where it did not converge in 40 s.
    "fleet_scale": ("sweep_ms", "fanin.reduction_x",
                    "kernel_ticks_per_s.idle",
                    "kernel_ticks_per_s.under_load", "cadence_ratio"),
}


def _is_number(x):
    if isinstance(x, dict):  # a {median, p95} pair
        return set(x) == {"median", "p95"} and all(map(_is_number,
                                                       x.values()))
    if isinstance(x, list):
        return bool(x) and all(map(_is_number, x))
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x))


def _values_at(x, parts):
    """The values under the dotted path ``parts`` of ``x``; a ``*`` part
    stands for every value of a dict (none: [None])."""
    if not parts:
        return [x]
    if not isinstance(x, dict):
        return [None]
    if parts[0] == "*":
        return [v for sub in x.values() for v in _values_at(sub, parts[1:])
                ] or [None]
    return _values_at(x.get(parts[0]), parts[1:])


def missing_numbers(detail, phases=None) -> list[str]:
    """The REQUIRED keys of ``detail`` (of ``phases`` only, if given)
    that hold no number."""
    return [f"{phase}.{key}" for phase, keys in REQUIRED.items()
            if phases is None or phase in phases
            for key in keys
            if not all(map(_is_number,
                           _values_at(detail.get(phase), key.split("."))))]


@contextlib.contextmanager
def _phase(name, seconds):
    """Adds the phase's wall time to ``seconds``; names a failing phase
    on stderr, and the exception ends the run."""
    t0 = time.monotonic()
    try:
        yield
    except BaseException:
        print(f"bench: phase {name} failed", file=sys.stderr, flush=True)
        raise
    finally:
        seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t0


# bench.py's fleet, recovery and daemon-side phases, each a key of
# ``detail``, in the order the port's bench runs them (bench.py's own,
# from ``fleet`` on).
DAEMON_PHASES = ("fleet", "restart_recovery", "fleet_health", "fleet_tree",
                 "fleet_selfheal", "event_journal", "degraded_mode",
                 "autocapture", "durability", "sketch_quantiles",
                 "read_swarm", "multitenant", "link_localization",
                 "subscription", "fleet_scale")


def _daemon_phase(name, daemon_bin, tmp, s):
    """Runs daemon-side phase ``name`` (not ``fleet``: main runs it once
    per host count) at sizes ``s``; returns its ``detail`` value."""
    if name == "sketch_quantiles":
        return measure_sketch_quantiles(samples=s.sketch_samples,
                                        big_samples=s.sketch_big_samples)
    measure, kw = {
        "restart_recovery": (measure_restart_recovery,
                             {"n_hosts": s.restart_hosts,
                              "trials": s.restart_trials}),
        "fleet_health": (measure_fleetstatus, {"n_hosts": s.fstat_hosts}),
        "fleet_tree": (measure_fleet_tree,
                       {"n_hosts": s.tree_hosts, "relays": s.tree_relays,
                        "trials": s.tree_trials}),
        "fleet_selfheal": (measure_fleet_selfheal,
                           {"seeds": s.heal_seeds, "leaves": s.heal_leaves,
                            "kill_trials": s.heal_kill_trials,
                            "sweep_trials": s.heal_sweep_trials,
                            "trigger_trials": s.heal_trigger_trials}),
        "event_journal": (measure_event_journal,
                          {"capacity": s.journal_capacity}),
        "degraded_mode": (measure_degraded_mode,
                          {"window_s": s.degraded_window_s}),
        "autocapture": (measure_autocapture, {"rules": s.autocapture_rules}),
        "durability": (measure_durability,
                       {"window_s": s.durability_window_s}),
        "read_swarm": (measure_read_swarm,
                       {"readers": s.swarm_readers, "waves": s.swarm_waves,
                        "min_wall_s": s.swarm_min_wall_s}),
        "multitenant": (measure_multitenant,
                        {"seeds": s.mt_seeds, "leaves": s.mt_leaves,
                         "kill_trials": s.mt_kill_trials,
                         "polite_reads": s.mt_polite_reads}),
        "link_localization": (measure_link_localization,
                              {"n_hosts": s.link_hosts,
                               "degraded_edge": s.link_edge,
                               "trials": s.link_trials,
                               "min_wall_s": s.link_min_wall_s}),
        "subscription": (measure_subscription,
                         {"subscribers": s.sub_subscribers,
                          "probe_rounds": s.sub_rounds,
                          "leaves": s.sub_leaves, "relays": s.sub_relays}),
        "fleet_scale": (measure_fleet_scale,
                        {"interiors": s.scale_interiors,
                         "sim_children": s.scale_children,
                         "hosts_per_child": s.scale_hosts_per_child,
                         "sweeps": s.scale_sweeps,
                         "byte_window_s": s.scale_byte_window_s}),
    }[name]
    return measure(daemon_bin, tmp, **kw)


def _host_state(daemon_bin):
    """What an earlier phase could leave behind: this process's open
    descriptors and threads, its RLIMIT_NOFILE, and the processes of
    ``daemon_bin`` alive on the host."""
    exe = os.path.realpath(daemon_bin)
    live = 0
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                live += os.readlink(f"/proc/{pid}/exe") == exe
            except OSError:  # gone, or not ours to read
                pass
    return {"open_fds": len(os.listdir("/proc/self/fd")),
            "threads": threading.active_count(),
            "nofile_soft": resource.getrlimit(resource.RLIMIT_NOFILE)[0],
            "live_daemons": live}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dynolog_tpu_torch.bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--daemon-bin", type=pathlib.Path,
                   help="a built dynolog_tpu_daemon (with --dyno-bin: "
                        "no build)")
    p.add_argument("--dyno-bin", type=pathlib.Path, help="a built dyno")
    p.add_argument("--quick", action="store_true",
                   help="every phase, in the fewest rounds, trials and "
                        "windows that give each key a number")
    p.add_argument("--tiny", action="store_true",
                   help="for the CPU: a 2-layer, d_model-64 flagship, "
                        "one burner of at most 0.5 s, every fleet phase "
                        "at 4 daemons or fewer and one trial")
    p.add_argument("--only", metavar="PHASE", action="append",
                   choices=DAEMON_PHASES,
                   help="run only this daemon-side phase (repeatable), "
                        "without the card's phases")
    args = p.parse_args(argv)
    if (args.daemon_bin is None) != (args.dyno_bin is None):
        p.error("--daemon-bin and --dyno-bin go together")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    loadavg_start = list(os.getloadavg())
    sizes = QUICK if args.quick else FULL
    cfg, batch, seq = FLAGSHIP, BATCH, SEQ
    if args.tiny:
        sizes = dataclasses.replace(sizes, burners=1,
                                    burn_s=min(sizes.burn_s, 0.25),
                                    **TINY_FLEET)
        cfg, batch, seq = TINY, TINY_BATCH, TINY_SEQ
    if device.type == "cuda":
        platform = (f"gpu:{torch.cuda.get_device_name(0)}"
                    f"x{torch.cuda.device_count()}")
        card = card_line()
    else:
        platform, card = "cpu", None

    phase_s = {}
    if args.daemon_bin is None:
        with _phase("build", phase_s):
            daemon_bin, dyno_bin, _ = build_native()
    else:
        daemon_bin, dyno_bin = args.daemon_bin, args.dyno_bin
    tmp = tempfile.mkdtemp(prefix="dtpu_bench_")
    os.environ["DYNOLOG_TPU_SOCKET_DIR"] = tmp
    detail = {}
    state = {"start": _host_state(daemon_bin)}
    if args.only is None:
        first_loss = card_phases(detail, phase_s, daemon_bin, dyno_bin, tmp,
                                 device, cfg, batch, seq, sizes)
    daemon_phases = [n for n in DAEMON_PHASES
                     if args.only is None or n in args.only]
    for name in daemon_phases:
        state[name] = _host_state(daemon_bin)
        if name == "fleet":
            detail["fleet"] = {}
            for n in sizes.fleet_hosts:
                with _phase(f"fleet_{n}", phase_s):
                    detail["fleet"][str(n)] = measure_fleet_fanout(
                        daemon_bin, tmp, n_hosts=n)
            continue
        with _phase(name, phase_s):
            detail[name] = _daemon_phase(name, daemon_bin, tmp, sizes)

    missing = missing_numbers(detail, None if args.only is None
                              else daemon_phases)
    check(not missing, f"bench: no number for {missing}")
    detail.update({
        "platform": platform, "card": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "quick": args.quick, "tiny": args.tiny,
        "host_loadavg": {"start": loadavg_start,
                         "end": list(os.getloadavg())},
        "host_state": state,
        "phase_s": phase_s,
    })
    if args.only is None:
        detail["model"] = {
            **{f.name: str(getattr(cfg, f.name))
               if f.name == "compute_dtype" else getattr(cfg, f.name)
               for f in dataclasses.fields(cfg)},
            "batch": batch, "seq": seq, "first_loss": first_loss}
    print(json.dumps({"metric": "telemetry_overhead_pct",
                      "value": detail.get("overhead", {}).get(
                          "overhead_pct"),
                      "unit": "%", "detail": detail}), flush=True)
    return 0


def card_phases(detail, phase_s, daemon_bin, dyno_bin, tmp, device, cfg,
                batch, seq, sizes):
    """The phases on the card (overhead, trace latency twice, the ring's
    ms/step) against one daemon, then the client-side phases that start
    their own (phase attribution, loaded host, flight recorder), into
    ``detail``. Returns the flagship's first loss."""
    sync = make_sync(device)
    with _phase("make_step", phase_s):
        step_fn, make_batch = make_step(cfg, device, batch, seq)
        first_loss = run_annotated_loop(step_fn, make_batch, 3)
        sync()
    daemon, port = _drained(start_daemon(
        daemon_bin, "--kernel_monitor_interval_s", "1",
        "--tpu_monitor_interval_s", "1", "--trace_stream_max_mb", "1024"))
    try:
        with _phase("overhead", phase_s):
            detail["overhead"] = measure_overhead(
                step_fn, make_batch, daemon, port, sizes, sync)
        rpc = DynoClient(port=port)
        for key, kw in (("trace_latency", {}),
                        ("trace_latency_poll_fallback",
                         {"enable_push": False, "enable_stream": False})):
            with _phase(key, phase_s):
                client = DynologClient(job_id=JOB, poll_interval_s=1.0,
                                       metrics_interval_s=1.0, **kw).start()
                trainer = None
                try:
                    trainer = TrainingThread(step_fn, make_batch,
                                             StepOnly(client)).start()
                    detail[key] = measure_trace_latency(
                        rpc, client, trainer, dyno_bin, port,
                        os.path.join(tmp, "traces"), key, sizes)
                    trainer.stop()
                finally:
                    # The client first: a capture still running ends at
                    # the training thread's next step().
                    client.stop()
                    if trainer is not None:
                        trainer.halt()
        with _phase("flight_recorder", phase_s):
            ring = measure_ring_cost(daemon_bin, tmp, step_fn, make_batch,
                                     sync, sizes)
    finally:
        stop_daemon(daemon)
    # The daemon-side phases run with no other daemon up, as bench.py's.
    with _phase("phase_attribution", phase_s):
        detail["phase_attribution"] = measure_phase_attribution(
            daemon_bin, sizes.phase_window_s)
    with _phase("loaded_host", phase_s):
        detail["loaded_host"] = measure_loaded_overhead(daemon_bin, sizes)
    with _phase("flight_recorder", phase_s):
        detail["flight_recorder"] = {
            **measure_flight_recorder(daemon_bin, tmp, sizes), "ring": ring}
    return first_loss


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(threadName)s %(message)s")
    sys.exit(main())
