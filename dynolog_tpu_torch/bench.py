"""The port's headline benchmark: the monitoring stack's step-time
overhead and its on-demand trace latency, with the client-side phases of
the reference's ``bench.py``, on the torch shim and the flagship train
step, then bench.py's fleet and recovery phases on the port's fleet code.

    python -m dynolog_tpu_torch.bench                  # one CUDA card
    python -m dynolog_tpu_torch.bench --quick          # fewest rounds
    python -m dynolog_tpu_torch.bench --device cpu --quick --tiny

``--quick`` runs every phase in its fewest rounds and trials, the
fan-out at 8 hosts only and the self-heal at 4 seeds + 20 leaves;
``--tiny`` (for the CPU) a 2-layer flagship, one burner, and every
fleet phase at 4 daemons or fewer and one trial.

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

The fleet and recovery phases leave the card idle and run in bench.py's
order, each with its own daemons, on the port's minifleet (fake torch
shim captures), fleetstatus, eventlog and RPC client:

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

It sets no target: a phase that fails ends the run with a non-zero exit
code and the phase's name on stderr, and no JSON line. ``--device cuda``
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
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.fleet import eventlog, fleetstatus, minifleet, unitrace
from dynolog_tpu_torch.models.train import make_train_step, run_annotated_loop
from dynolog_tpu_torch.models.transformer import (
    ModelConfig,
    load_jax_params,
    resolve_device,
)
from dynolog_tpu_torch.utils.procutil import wait_for_stderr
from dynolog_tpu_torch.utils.rpc import DynoClient, fan_out

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


FULL = Sizes()
# Every phase, each key with a number, in the fewest rounds.
QUICK = Sizes(overhead_rounds=2, window_ms=500.0, min_steps=5,
              trace_warm=1, trace_trials=1, phase_window_s=1.0, burn_s=1.0,
              loaded_order="blb", fr_window_s=1.0, fr_firings=1,
              ring_rounds=1, fleet_hosts=(8,), restart_trials=1,
              tree_trials=3, heal_seeds=4, heal_leaves=20,
              heal_kill_trials=1, heal_sweep_trials=3,
              heal_trigger_trials=1, degraded_window_s=1.0,
              autocapture_rules=2)
# --tiny's fleet phases: at most 4 daemons each (a restart adds one),
# a single trial.
TINY_FLEET = dict(fleet_hosts=(4,), restart_hosts=2, restart_trials=1,
                  fstat_hosts=4, tree_hosts=4, tree_relays=1, tree_trials=1,
                  heal_seeds=3, heal_leaves=1, heal_kill_trials=1,
                  heal_sweep_trials=1, heal_trigger_trials=1,
                  degraded_window_s=1.0, autocapture_rules=1)


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

        def tree_status(port):
            try:
                return DynoClient(port=port, timeout=3.0).status().get(
                    "fleettree") or {}
            except Exception:
                return {}

        def wait_fresh(via_port, timeout_s):
            """Seconds until a sweep through via_port has every live port
            fresh, or None on timeout."""
            want = {str(p) for p in ports if p not in dead_ports}
            t0 = time.time()
            while time.time() - t0 < timeout_s:
                v = fleetstatus.tree_sweep(
                    f"localhost:{via_port}", window_s=300, timeout_s=5.0)
                if v is not None:
                    fresh = ({_port_of(h) for h in v["hosts"]}
                             - {_port_of(u["host"])
                                for u in v["unreachable"]})
                    if want <= fresh:
                        return time.time() - t0
                time.sleep(0.25)
            return None

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

        # Re-parent convergence: one interior seed killed per trial, no
        # restarts; every orphan's re-registration elsewhere is a sample.
        reparent_s = []
        lost_children = 0
        for _ in range(kill_trials):
            root_port = _port_of(current_root)
            victims = [
                (i, p) for i, p in enumerate(ports[:seeds])
                if p not in dead_ports and str(p) != root_port
                and tree_status(p).get("children")]
            if not victims:
                break
            idx, victim = rng.choice(victims)
            orphans = [int(_port_of(c["node"]))
                       for c in tree_status(victim)["children"]]
            minifleet.kill_daemon(daemons, idx)
            dead_ports.add(victim)
            t0 = time.time()
            pending = set(orphans)
            while pending and time.time() - t0 < 30.0:
                for p in sorted(pending):
                    parent = tree_status(p).get("parent") or {}
                    if parent.get("registered") and \
                            parent.get("port") != victim:
                        reparent_s.append(time.time() - t0)
                        pending.discard(p)
                time.sleep(0.05)
            lost_children += len(pending)

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

            def kernel_ticks():
                return (client.status().get("collectors", {})
                        .get("kernel", {}).get("ticks", 0))

            deadline = time.time() + 20
            while kernel_ticks() < 2 and time.time() < deadline:
                time.sleep(0.1)
            if faulted:
                # Steady state (quarantine), not the transition.
                while time.time() < deadline:
                    h = client.status().get("collector_health", {})
                    if h.get("tpu", {}).get("state") == "quarantined":
                        break
                    time.sleep(0.1)
            t0 = time.monotonic()
            n0 = kernel_ticks()
            rpc_ms = []
            t_end = t0 + window_s
            while time.monotonic() < t_end:
                r0 = time.perf_counter()
                status = client.status()
                rpc_ms.append((time.perf_counter() - r0) * 1e3)
                time.sleep(0.05)
            n1 = kernel_ticks()
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


def missing_numbers(detail) -> list[str]:
    """The REQUIRED keys of ``detail`` that hold no number."""
    return [f"{phase}.{key}" for phase, keys in REQUIRED.items()
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
    sync = make_sync(device)

    with _phase("make_step", phase_s):
        step_fn, make_batch = make_step(cfg, device, batch, seq)
        first_loss = run_annotated_loop(step_fn, make_batch, 3)
        sync()
    detail = {}
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
    # The fleet and recovery phases, in bench.py's order.
    detail["fleet"] = {}
    for n in sizes.fleet_hosts:
        with _phase(f"fleet_{n}", phase_s):
            detail["fleet"][str(n)] = measure_fleet_fanout(daemon_bin, tmp,
                                                           n_hosts=n)
    for key, measure, kw in (
            ("restart_recovery", measure_restart_recovery,
             {"n_hosts": sizes.restart_hosts,
              "trials": sizes.restart_trials}),
            ("fleet_health", measure_fleetstatus,
             {"n_hosts": sizes.fstat_hosts}),
            ("fleet_tree", measure_fleet_tree,
             {"n_hosts": sizes.tree_hosts, "relays": sizes.tree_relays,
              "trials": sizes.tree_trials}),
            ("fleet_selfheal", measure_fleet_selfheal,
             {"seeds": sizes.heal_seeds, "leaves": sizes.heal_leaves,
              "kill_trials": sizes.heal_kill_trials,
              "sweep_trials": sizes.heal_sweep_trials,
              "trigger_trials": sizes.heal_trigger_trials}),
            ("event_journal", measure_event_journal,
             {"capacity": sizes.journal_capacity}),
            ("degraded_mode", measure_degraded_mode,
             {"window_s": sizes.degraded_window_s}),
            ("autocapture", measure_autocapture,
             {"rules": sizes.autocapture_rules})):
        with _phase(key, phase_s):
            detail[key] = measure(daemon_bin, tmp, **kw)

    missing = missing_numbers(detail)
    check(not missing, f"bench: no number for {missing}")
    detail.update({
        "platform": platform, "card": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "quick": args.quick, "tiny": args.tiny,
        "model": {**{f.name: str(getattr(cfg, f.name))
                     if f.name == "compute_dtype" else getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)},
                  "batch": batch, "seq": seq, "first_loss": first_loss},
        "host_loadavg": {"start": loadavg_start,
                         "end": list(os.getloadavg())},
        "phase_s": phase_s,
    })
    print(json.dumps({"metric": "telemetry_overhead_pct",
                      "value": detail["overhead"]["overhead_pct"],
                      "unit": "%", "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(threadName)s %(message)s")
    sys.exit(main())
