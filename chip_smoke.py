#!/usr/bin/env python3
"""Drives the port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The path (SURVEY.md §3.3): `dyno gputrace` reaches the C++ daemon over
TCP JSON-RPC, the daemon hands the config to the in-process client shim
(dynolog_tpu_torch.client) over the UNIX-datagram fabric, the shim runs
torch.profiler on the training thread, and the Chrome trace plus
dynolog_manifest.json land in the trace dir — while the shim pushes
per-device telemetry and the flagship transformer train step (bench.py's
configuration, bf16, batch 8 x 512) calls step() every iteration.

Phases, one line each; any failure raises, so the script exits non-zero
without the final line:

  env        card name and power limit (nvidia-smi), torch and CUDA
  build      scripts/build.sh builds the daemon and dyno from the checkout
  daemon     started on --port 0 with fabric sockets in a temp dir
  overhead   ms/step of the flagship step with no client, with a client
             that only sees step(), with the full client (phase
             annotations, metrics every 1 s), and with the full client
             against a daemon that samples no per-phase CPU, in rotating
             windows
  register   the client registers with platform "gpu"
  telemetry  a pushed record carries the GPU and NVML keys
  gputrace   `dyno gputrace --duration_ms 500`: CUDA kernels, the training
             thread's aten:: ops, the manifest
  iteration  a 5-iteration capture armed over RPC, same checks
  latency    3 traced trials split into rpc->config, config->start,
             start->stop, stop->artifact
  parity     the tiny model in float32 (TF32 off) on the GPU against the
             same weights on the CPU, max abs <= 1e-4
  control    the shim's control plane against a daemon of its own
             (socket chip_smoke_control, a base config file of
             {"duration_ms": 300}) under the flagship step: ~3 s of
             annotated steps read back through getPhases and `dyno
             phases`; three `dyno gputrace` pushed to a client that polls
             every 5 s; a config without duration_ms that takes the
             base's 300 ms; the daemon SIGKILLed and restarted inside an
             open checkpoint phase, the client re-registering on its own
             and replaying the phase; a gputrace after the restart whose
             manifest carries op_stats, phase_spans and spans, and the
             dyno_self_* keys in the job's tpu_status record
  training   the flagship loss is finite and fell over the run
  fleet      three daemons and three worker processes (this script with
             --fleet-worker), each training the flagship step on the one
             card under the real shim as one host of a job; unitrace
             gang-traces them with --report --health-check, every host's
             .pt.trace.json is checked, and pull_artifacts brings the
             committed streams back over RPC byte for byte. The three
             workers share the card, so their steps contend for it.
  retro      the flight recorder: a daemon with a retro ring of 500 ms
             windows and a watch rule with a trace action; the flagship
             step under the real shim until the ring covers a window, an
             injected anomaly, the ring's export beside the forward
             capture, the merged report's metadata.retro and a decoded
             window's CUDA kernels; then ms/step with the ring on and off
             in rotating windows. A disabled or empty ring fails it.
  parallel   the parallel workloads over NCCL, one rank per visible card
             (NCCL refuses two ranks on one card): the flagship step with
             ring attention on mesh_shape(n), MoeConfig() on
             moe_mesh_shape(n, 8) and PipeConfig() on (n, 1), every one
             at batch 8 x 512 (one card: a (1, 1, 1) mesh, one expert
             rank and one pipeline stage). Each workload's first loss
             against the unsharded model of the same weights, ms/step,
             a falling loss; one `dyno gputrace` of rank 0's sharded
             flagship step under the client shim, with its NCCL kernels
             counted. `python3 chip_smoke.py --parallel-only` runs the
             build, the daemon and this phase alone (the four-card run).
  packaged   the installed port: scripts/make_deb.sh on the binaries
             built above, extracted with dpkg-deb -x; the packaged
             daemon, a worker run from a temp dir with only the extracted
             dist-packages on PYTHONPATH (JAX refused, the port's
             __file__ under the extracted root) training the flagship
             step under enable() and step(), and the packaged `dyno
             gputrace --duration_ms 500` against it, held to the
             gputrace checks; one line with the deb's name and bytes, the
             port files staged, the trace's kernels and its wall time.
             Without dpkg-deb, or with a build outside native/build, it
             prints `packaged: skipped (<the missing tool>)` instead.
  bench      `python -m dynolog_tpu_torch.bench --quick` in a subprocess
             against the binaries built above, within 420 s: exit code 0,
             a last line that parses, platform "gpu:...", a number under
             every key the bench requires, and every fleet outcome true
             (capture windows intersect, the straggler flagged by the
             sweep and by both tree paths, no orphan lost, the promoted
             root expected_root's and then every live host fresh; the
             bench itself fails on an auto-capture rule with no
             artifact); its headline numbers, one line each.

The port has no hand-written kernel (the JAX package has no Pallas
kernel), so the kernel table it prints is empty. The last line is the
device record `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import glob
import hashlib
import json
import logging
import math
import os
import pathlib
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from dynolog_tpu_torch.bench import BenchError as SmokeError
from dynolog_tpu_torch.bench import (
    BATCH,
    BREAKDOWN,
    FLAGSHIP,
    SEQ,
    StepOnly,
    TrainingThread,
    build_native,
    card_line,
    check,
    measure_ring as _measure_ring,
    measure_windows,
    missing_numbers,
    retro_uploads,
    run_capture,
    start_daemon,
    stop_daemon,
    trace_breakdown,
    trigger_gputrace,
    wait_for,
)
from dynolog_tpu_torch.client import DynologClient
from dynolog_tpu_torch.fleet import eventlog, trace_report, unitrace
from dynolog_tpu_torch.models import moe, pipeline
from dynolog_tpu_torch.models.train import (
    loss_fn,
    make_sharded_train_step,
    make_train_step,
    run_annotated_loop,
)
from dynolog_tpu_torch.models.transformer import ModelConfig, Transformer
from dynolog_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from dynolog_tpu_torch.utils.cpumesh import run_ranks
from dynolog_tpu_torch.utils.rpc import DynoClient

REPO = pathlib.Path(__file__).resolve().parent

JOB = "chip_smoke"
OVERHEAD_ROUNDS = 8
TRACE_MS = 500
LATENCY_TRIALS = 3
PARITY_ATOL = 1e-4
QUIET = "dynolog_tpu_no_phase_cpu"
FLEET_JOB = "chip_smoke_fleet"
FLEET_HOSTS = 3
FLEET_DELAY_S = 3
RETRO_JOB = "chip_smoke_retro"
RETRO_SOCKET = "chip_smoke_retro"
RETRO_WINDOW_MS = 500
RETRO_ROUNDS = 4
# The retro phase's watch rule reads a series that only its put_history
# writes: NVML reads this card's duty cycle at 0-38 %, so a rule on
# tensorcore_duty_cycle_pct could fire on real readings before the ring
# is primed.
RETRO_METRIC = "chip_smoke_anomaly"
CONTROL_JOB = "chip_smoke_control"
CONTROL_SOCKET = "chip_smoke_control"
CONTROL_PHASES_S = 3.0
CONTROL_PUSH_TRIALS = 3
CONTROL_POLL_S = 5.0
CONTROL_BASE_MS = 300
PARALLEL_JOB = "chip_smoke_parallel"
PARALLEL_WARMUP = 2
PARALLEL_STEPS = 8
PARALLEL_TIMEOUT_S = 300
# Sharded first loss against the unsharded model of the same weights,
# relative: tests/test_model.py's bf16 sharded-loss bound for the
# flagship, the JAX MoE/pipeline tests' 2e-2 for the others.
PARALLEL_REL = {"flagship": 5e-3, "moe": 2e-2, "pipe": 2e-2}
BENCH_TIMEOUT_S = 420
PACKAGED_JOB = "chip_smoke_packaged"
PACKAGED_DIST = "usr/lib/python3/dist-packages"

# The packaged phase's worker, run as `python -c PACKAGED_WORKER` from a
# temp dir with only the extracted dist-packages on PYTHONPATH (not this
# script: its directory would put the repo's copy first on sys.path). It
# refuses JAX, reports where the port came from, and trains the flagship
# step on cuda:0 under enable() (job id from $DYNOLOG_TPU_JOB_ID),
# calling step() every iteration, until SIGTERM.
PACKAGED_WORKER = """\
import importlib.abc, json, os, signal, sys, threading


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dynolog_tpu"):
            raise ImportError(name + " is refused here")


sys.meta_path.insert(0, _Refuse())
import dynolog_tpu_torch
import torch
from dynolog_tpu_torch.bench import BATCH, FLAGSHIP, SEQ
from dynolog_tpu_torch.client import enable
from dynolog_tpu_torch.models.train import make_train_step

stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
_, _, step_fn = make_train_step(
    FLAGSHIP, device="cuda", generator=torch.Generator().manual_seed(0))
tokens = torch.randint(0, FLAGSHIP.vocab_size, (BATCH, SEQ),
                       generator=torch.Generator().manual_seed(1)).cuda()
client = enable(poll_interval_s=0.5)
losses = []
try:
    while not stop.is_set():
        losses.append(float(step_fn(tokens)))
        client.step()
        if len(losses) == 1:
            print(json.dumps({"ready": os.getpid(),
                              "tid": threading.get_native_id(),
                              "file": dynolog_tpu_torch.__file__}),
                  flush=True)
finally:
    client.stop()
print(json.dumps({"done": os.getpid(), "steps": len(losses),
                  "first_loss": losses[0], "last_loss": losses[-1]}),
      flush=True)
"""


def measure_overhead(step_fn, make_batch, tag):
    """Median ms/step with no client ("off"), with a running client that
    only sees step() ("step_only"), with the full client ("on": step(),
    phase annotations, metrics pushed every 1 s), and with the full
    client against the daemon that samples no per-phase CPU
    ("on_no_phase_cpu"). Sides rotate through equal windows so drift
    spreads over all of them. Each window ends in
    torch.cuda.synchronize(); the loop reads every loss back, as the
    reference loop blocks on it."""
    def client_side(daemon_socket, step_only=False):
        def open_side():
            client = DynologClient(
                job_id=f"{JOB}_overhead", metrics_interval_s=1.0,
                daemon_socket=daemon_socket)
            client.start()
            return client, StepOnly(client) if step_only else client
        return open_side

    sides = {"off": None, "step_only": client_side(None, step_only=True),
             "on": client_side(None),
             "on_no_phase_cpu": client_side(QUIET)}
    ms, steps = measure_windows(step_fn, make_batch, sides, OVERHEAD_ROUNDS,
                                torch.cuda.synchronize)
    m_off = statistics.median(ms["off"])
    for side in sides:
        m = statistics.median(ms[side])
        slower = sum(a > b for a, b in zip(ms[side], ms["off"]))
        print(f"step_ms [{tag}] client_{side} median={m:.3f} "
              f"windows={[round(x, 3) for x in ms[side]]} "
              f"steps_per_window={steps} "
              f"overhead={100 * (m - m_off) / m_off:+.3f}% "
              f"slower_than_off_in={slower}/{OVERHEAD_ROUNDS}", flush=True)


def find_traces(log_dir):
    exported = [p for p in glob.glob(
        os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)
        if not os.path.basename(p).startswith("streamed.")]
    check(len(exported) == 1, f"expected one exported trace: {exported}")
    return exported[0]


def check_trace(log_dir, train_tid, label):
    """The artifact of one capture: CUDA kernels, the training thread's
    aten:: ops, the streamed copy, and the daemon's manifest."""
    path = find_traces(log_dir)
    with open(path, "rb") as f:
        raw = f.read()
    events = json.loads(raw)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    aten_train = sum(1 for e in events
                     if str(e.get("name", "")).startswith("aten::")
                     and e.get("tid") == train_tid)
    check(kernels > 0, f"{label}: no CUDA kernel events in {path}")
    check(aten_train > 0,
          f"{label}: no aten:: ops on the training thread {train_tid}")
    streamed = os.path.join(os.path.dirname(path), "streamed.pt.trace.json")
    check(os.path.exists(streamed), f"{label}: no streamed artifact")
    with open(streamed, "rb") as f:
        check(f.read() == raw, f"{label}: streamed artifact differs")
    manifest_path = os.path.join(os.path.dirname(path),
                                 "dynolog_manifest.json")
    wait_for(lambda: os.path.exists(manifest_path), 15, f"{label} manifest")
    with open(manifest_path) as f:
        manifest = json.load(f)
    check(manifest["trace_timing"]["trace_stop"] > 0,
          f"{label}: manifest lacks trace_stop")
    print(f"{label}: {os.path.basename(path)} bytes={len(raw)} "
          f"events={len(events)} kernels={kernels} "
          f"aten_on_train_thread={aten_train} streamed=identical "
          f"manifest=ok", flush=True)
    return len(raw), kernels


def parity_check(tag):
    """Tiny model, float32 with TF32 off, same weights on CPU and GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig.tiny(compute_dtype=torch.float32)
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    gpu = Transformer(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = cpu(tokens)
        out = gpu(tokens.cuda()).cpu()
    err = float((out - ref).abs().max())
    check(torch.isfinite(out).all(), "parity: non-finite GPU logits")
    check(err <= PARITY_ATOL, f"parity: max abs {err} > {PARITY_ATOL}")
    print(f"parity [{tag}] tiny fp32 logits gpu vs cpu max_abs={err:.3e} "
          f"(limit {PARITY_ATOL})", flush=True)


def _phase_stacks(rpc, pid):
    """This process's getPhases entry: ({stack: entry}, open_stack). A
    read resets the daemon's attribution window."""
    procs = [p for p in rpc.get_phases()["processes"] if p["pid"] == pid]
    if not procs:
        return {}, []
    return ({tuple(p["stack"]): p for p in procs[0]["phases"]},
            procs[0]["open_stack"])


class _StepClock:
    """The client as the training loop sees it, stamping the wall time of
    every step() call: a duration capture stops at the first step() at or
    after its deadline."""

    def __init__(self, client, stamps):
        self.phase = client.phase
        self._step = client.step
        self._stamps = stamps

    def step(self):
        self._stamps.append(time.time())
        self._step()


def control_phase(daemon_bin, dyno_bin, step_fn, make_batch, tag,
                  stop_slack_ms):
    """The client shim's control plane under the flagship step, against a
    daemon of its own (it is restarted here): phase attribution, push
    delivery against a 5 s poll, the base config, a daemon restart
    inside an open phase, and the manifest's and telemetry's
    self-reporting. ``stop_slack_ms`` is the latency phase's largest
    start_to_stop beyond its window."""
    t_phase = time.monotonic()
    base_file = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_base_"),
                             "trace_base.json")
    with open(base_file, "w") as f:
        json.dump({"duration_ms": CONTROL_BASE_MS}, f)
    trace_root = tempfile.mkdtemp(prefix="chip_smoke_control_")
    pid = os.getpid()

    def start():
        proc, port = start_daemon(
            daemon_bin, "--ipc_socket_name", CONTROL_SOCKET,
            "--trace_base_config", base_file,
            "--trace_stream_max_mb", "1024", "--enable_perf_monitor=false")
        threading.Thread(target=proc.stderr.read, daemon=True).start()
        return {"proc": proc, "port": port, "rpc": DynoClient(port=port)}

    d = start()
    client = trainer = None
    try:
        # Phases: ~3 s of annotated steps, read back.
        client = DynologClient(
            job_id=CONTROL_JOB, poll_interval_s=CONTROL_POLL_S,
            metrics_interval_s=1.0, daemon_socket=CONTROL_SOCKET).start()
        run_annotated_loop(step_fn, make_batch, 2, client=client)
        wait_for(lambda: CONTROL_JOB in d["rpc"].trace_registry().get(
            "jobs", {}), 30, "control client registration")
        _phase_stacks(d["rpc"], pid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < CONTROL_PHASES_S:
            run_annotated_loop(step_fn, make_batch, 1, client=client)
            steps += 1
        loop_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.2)  # the last datagrams land
        stacks, _ = _phase_stacks(d["rpc"], pid)
        step_wall = sum(e["wall_ms"] for k, e in stacks.items()
                        if k[0] == "step")
        check(("step", "input") in stacks,
              f"control: no step>input stack: {sorted(stacks)}")
        check(step_wall >= 0.5 * loop_ms,
              f"control: step stacks hold {step_wall:.1f} ms of a "
              f"{loop_ms:.1f} ms loop")
        run_annotated_loop(step_fn, make_batch, 2, client=client)
        out = subprocess.run(
            [str(dyno_bin), "--port", str(d["port"]), "phases"],
            capture_output=True, text=True, timeout=30)
        check(out.returncode == 0 and f"pid {pid}" in out.stdout
              and "step" in out.stdout,
              f"control: dyno phases: {out.stdout} {out.stderr}")
        print(f"control [{tag}] phases: {steps} annotated steps in "
              f"{loop_ms:.1f} ms, step stacks {step_wall:.1f} ms "
              f"({100 * step_wall / loop_ms:.1f} %); `dyno phases` lists "
              f"pid {pid}", flush=True)
        for k in sorted(stacks):
            e = stacks[k]
            print(f"control [{tag}] phases {'>'.join(k)} wall_ms="
                  f"{e['wall_ms']:.1f} cpu_ms={e.get('cpu_ms', 0):.1f}",
                  flush=True)

        # Push: three gputraces to a client that polls every 5 s.
        stamps: list[float] = []
        trainer = TrainingThread(step_fn, make_batch,
                                 _StepClock(client, stamps)).start()
        rpc_to_config = []
        for i in range(CONTROL_PUSH_TRIALS):
            log_dir = os.path.join(trace_root, f"push_{i}")
            t_rpc, t = run_capture(
                client, trainer, lambda: trigger_gputrace(
                    dyno_bin, d["port"], CONTROL_JOB, log_dir), log_dir)
            ms = (t["config_received"] - t_rpc) * 1e3
            check(t.get("delivery") == "push" and ms < CONTROL_POLL_S * 1e3,
                  f"control push_{i}: delivery {t.get('delivery')} after "
                  f"{ms:.1f} ms")
            rpc_to_config.append(round(ms, 3))
            check_trace(log_dir, trainer.tid, f"control push_{i}")
        counters = d["rpc"].self_telemetry()["counters"]
        check(counters.get("push_sent", 0) >= CONTROL_PUSH_TRIALS
              and "push_fallback" not in counters,
              f"control: daemon push counters {counters}")
        received = client.spans.counters().get("pushes_received", 0)
        check(received >= CONTROL_PUSH_TRIALS,
              f"control: the client received {received} pushes")
        print(f"control [{tag}] push rpc_to_config median_ms="
              f"{statistics.median(rpc_to_config):.3f} trials_ms="
              f"{rpc_to_config} poll_interval_ms={CONTROL_POLL_S * 1e3:.0f} "
              f"push_sent={counters['push_sent']} push_fallback=0 "
              f"pushes_received={received}", flush=True)

        # Base config: a config without duration_ms takes the base's.
        check(client._base_config == {"duration_ms": CONTROL_BASE_MS},
              f"control: the client's base config {client._base_config}")
        log_dir = os.path.join(trace_root, "base")
        _, t = run_capture(client, trainer, lambda: d["rpc"].set_trace_config(
            CONTROL_JOB, {"type": "xplane", "log_dir": log_dir}), log_dir)
        check_trace(log_dir, trainer.tid, "control base")
        deadline = t["start_returned"] + CONTROL_BASE_MS / 1e3
        # The clock stamps each step() call as it enters the shim, and
        # the call that stops the capture stamps stop_begin inside: its
        # stamp is the last one before stop_begin.
        before = [x for x in stamps
                  if t["start_returned"] < x <= t["stop_begin"]]
        check(before and t["stop_begin"] >= deadline
              and all(x < deadline for x in before[:-1]),
              f"control base: stop at {t['stop_begin'] - deadline:+.3f} s "
              f"from the {CONTROL_BASE_MS} ms deadline, step() calls "
              f"{[round(x - deadline, 3) for x in before]}")
        start_to_stop = (t["trace_stop"] - t["trace_start"]) * 1e3
        check(start_to_stop <= CONTROL_BASE_MS + stop_slack_ms,
              f"control base: start_to_stop {start_to_stop:.1f} ms > "
              f"{CONTROL_BASE_MS} + {stop_slack_ms:.1f} ms")
        window = (t["stop_begin"] - t["start_returned"]) * 1e3
        print(f"control [{tag}] base config duration_ms={CONTROL_BASE_MS}: "
              f"window {window:.1f} ms (stopped at the first step() after "
              f"its deadline, {(t['stop_begin'] - deadline) * 1e3:.1f} ms "
              f"late), start_to_stop {start_to_stop:.1f} ms against "
              f"{CONTROL_BASE_MS} + the latency phase's "
              f"{stop_slack_ms:.1f} ms", flush=True)
        trainer.stop()
        trainer = None
        client.stop()

        # Restart: SIGKILL and restart the daemon inside an open
        # checkpoint phase; the client re-registers on its own.
        client = DynologClient(
            job_id=CONTROL_JOB, poll_interval_s=0.5, backoff_cap_s=2.0,
            metrics_interval_s=1.0, daemon_socket=CONTROL_SOCKET).start()
        run_annotated_loop(step_fn, make_batch, 2, client=client)
        restart = {}

        def registered():
            jobs = d["rpc"].trace_registry().get("jobs", {})
            return any(p["pid"] == pid for p in jobs.get(CONTROL_JOB, []))

        def kill_and_restart(i):
            t_push = time.time()
            d["proc"].kill()
            d["proc"].wait(timeout=10)
            t_kill = time.monotonic()
            d.update(start())
            wait_for(lambda: client.spans.counters().get(
                "daemon_restarts_detected", 0) >= 1 and registered(), 60,
                "re-registration after the restart")
            restart["rereg_ms"] = (time.monotonic() - t_kill) * 1e3

            def replayed():
                stacks, open_stack = _phase_stacks(d["rpc"], pid)
                return open_stack[-1:] == ["checkpoint"] and (
                    stacks, open_stack)

            restart["stacks"], restart["open"] = wait_for(
                replayed, 10, "the open checkpoint phase replayed")
            restart["since_push_ms"] = (time.time() - t_push) * 1e3

        run_annotated_loop(step_fn, make_batch, 1, client=client,
                           checkpoint_every=1,
                           checkpoint_fn=kill_and_restart)
        ck = restart["stacks"][tuple(restart["open"])]
        check(ck["wall_ms"] >= 0.5 * restart["since_push_ms"],
              f"control restart: checkpoint wall_ms {ck['wall_ms']:.1f} of "
              f"{restart['since_push_ms']:.1f} ms since its push")
        counters = client.spans.counters()
        print(f"control [{tag}] restart: SIGKILL -> re-registration "
              f"{restart['rereg_ms']:.1f} ms; open_stack "
              f"{'>'.join(restart['open'])} wall_ms={ck['wall_ms']:.1f} "
              f"of {restart['since_push_ms']:.1f} ms since its push; "
              f"daemon_restarts_detected="
              f"{counters.get('daemon_restarts_detected')} reregistrations="
              f"{counters.get('reregistrations')}", flush=True)

        # Manifest: a gputrace after the restart, with op_stats from the
        # workload's own step timer.
        trainer = TrainingThread(step_fn, make_batch, client).start()
        wait_for(lambda: len(trainer.step_ms) >= 3 or trainer.error, 120,
                 "three timed steps")
        trainer.alive_check()
        timed = list(trainer.step_ms)
        client.record_op_stats([{"name": "flagship_step",
                                 "count": len(timed),
                                 "total_ms": sum(timed)}])
        log_dir = os.path.join(trace_root, "after_restart")
        run_capture(client, trainer, lambda: trigger_gputrace(
            dyno_bin, d["port"], CONTROL_JOB, log_dir), log_dir)
        check_trace(log_dir, trainer.tid, "control after restart")
        with open(os.path.join(os.path.dirname(find_traces(log_dir)),
                               "dynolog_manifest.json")) as f:
            manifest = json.load(f)
        ops = manifest.get("op_stats") or []
        phase_names = {s["name"] for s in manifest.get("phase_spans", [])}
        check(ops and ops[0]["name"] == "flagship_step"
              and ops[0]["count"] == len(timed),
              f"control manifest op_stats: {ops}")
        check("step" in phase_names and manifest.get("spans"),
              f"control manifest: phase_spans {sorted(phase_names)}, "
              f"{len(manifest.get('spans', []))} spans")

        def self_record():
            for dev in d["rpc"].tpu_status().get("devices", []):
                met = dev.get("metrics", {})
                if dev.get("job_id") == CONTROL_JOB and \
                        "dyno_self_fabric_send_total" in met:
                    return met
            return None

        met = wait_for(self_record, 30, "dyno_self_* in tpu_status")
        selfkeys = sorted(k for k in met if k.startswith("dyno_self_"))
        print(f"control [{tag}] manifest after the restart: op_stats "
              f"{ops[0]['name']} x{ops[0]['count']} "
              f"{ops[0]['total_ms']:.1f} ms, phase_spans "
              f"{len(manifest['phase_spans'])} {sorted(phase_names)}, "
              f"spans {len(manifest['spans'])}; tpu_status carries "
              f"{len(selfkeys)} dyno_self_* keys", flush=True)
        trainer.stop()
        check(all(map(math.isfinite, trainer.losses)),
              "control: non-finite flagship loss")
        trainer = None
    finally:
        if trainer is not None:
            trainer.halt()
        if client is not None:
            client.stop()
        stop_daemon(d["proc"])
    print(f"control: phase took {time.monotonic() - t_phase:.1f} s",
          flush=True)


def fleet_worker() -> int:
    """One host of the fleet phase: the flagship step on cuda:0 under the
    real shim, registered to the daemon $DYNOLOG_TPU_SOCKET names, until
    SIGTERM. Prints one JSON line when the first step is done and one
    when it stops."""
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s worker %(process)d %(message)s")
    if not torch.cuda.is_available():
        print("fleet worker: CUDA is not available", file=sys.stderr)
        return 1
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    _, _, step_fn = make_train_step(
        FLAGSHIP, device="cuda", generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(
        0, FLAGSHIP.vocab_size, (BATCH, SEQ),
        generator=torch.Generator().manual_seed(1)).cuda()
    client = DynologClient(job_id=FLEET_JOB, poll_interval_s=0.5,
                           metrics_interval_s=1.0).start()
    step_ms, losses = [], []
    try:
        while not stop.is_set():
            t0 = time.perf_counter()
            losses.append(run_annotated_loop(
                step_fn, lambda i: tokens, 1, client=client))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(losses) == 1:
                print(json.dumps({"ready": os.getpid(),
                                  "tid": threading.get_native_id()}),
                      flush=True)
    finally:
        client.stop()
    print(json.dumps({"done": os.getpid(), "steps": len(losses),
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "median_step_ms": statistics.median(step_ms)}),
          flush=True)
    return 0


class FleetWorker:
    """A worker child (this script with --fleet-worker, registered to
    the daemon ``socket_name`` names, unless ``argv`` says otherwise)
    and the JSON lines it printed."""

    def __init__(self, socket_name=None, argv=None, **popen):
        if argv is None:
            argv = [sys.executable, str(pathlib.Path(__file__).resolve()),
                    "--fleet-worker"]
            popen["env"] = {**os.environ, "DYNOLOG_TPU_SOCKET": socket_name}
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     text=True, **popen)
        self.lines: list[dict] = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("{"):
                self.lines.append(json.loads(line))

    def get(self, key):
        for line in self.lines:
            if key in line:
                return line
        if self.proc.poll() not in (None, 0):
            raise SmokeError(f"fleet worker exited {self.proc.returncode}")
        return None

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def start_fleet_daemon(daemon_bin, socket_name):
    """A fleet daemon whose pushed-telemetry tick runs every second, so
    pushed records reach the aggregates the health check scores, with
    its stderr drained (its log grows with every tick)."""
    proc, port = start_daemon(
        daemon_bin, "--ipc_socket_name", socket_name,
        "--tpu_monitor_interval_s", "1", "--trace_stream_max_mb", "256",
        "--enable_perf_monitor=false")
    threading.Thread(target=proc.stderr.read, daemon=True).start()
    return proc, port


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fleet_phase(daemon_bin, tag):
    """The fleet path: unitrace gang-traces three flagship workers, each
    under its own daemon, with the report and the health check, then
    pulls the committed streams back over RPC."""
    t_phase = time.monotonic()
    names = [f"chip_smoke_fleet{i}" for i in range(FLEET_HOSTS)]
    daemons, workers = [], []
    try:
        for name in names:
            daemons.append(start_fleet_daemon(daemon_bin, name))
        workers = [FleetWorker(name) for name in names]
        ready = wait_for(
            lambda: all(w.get("ready") for w in workers) and [
                w.get("ready") for w in workers], 180, "fleet workers")
        tid_of = {r["ready"]: r["tid"] for r in ready}
        hosts = [f"localhost:{port}" for _, port in daemons]

        def duty_samples():
            # Pushed records reach a sweep once the daemon's tick has
            # logged two of them into its history.
            for _, port in daemons:
                win = DynoClient(port=port).get_aggregates(
                    windows_s=[300], key_prefix="tensorcore_duty_cycle_pct"
                ).get("windows", {}).get("300", {})
                if not any(s.get("count", 0) >= 2 for s in win.values()):
                    return False
            return True

        deadline = time.monotonic() + 30
        while not duty_samples() and time.monotonic() < deadline:
            time.sleep(0.5)
        if not duty_samples():
            print(f"fleet [{tag}] aggregates held no "
                  "tensorcore_duty_cycle_pct with 2 samples on every "
                  "daemon after 30 s", flush=True)

        log_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
        args = unitrace.build_parser().parse_args([
            "--hosts", ",".join(hosts), "--job-id", FLEET_JOB,
            "--log-dir", log_dir, "--duration-ms", str(TRACE_MS),
            "--start-time-delay-s", str(FLEET_DELAY_S),
            "--report", "--report-wait-s", "120", "--health-check"])
        t0 = time.monotonic()
        out = unitrace.run(args)
        run_s = time.monotonic() - t0
        check(out["ok"] == FLEET_HOSTS and len(out["hosts"]) == FLEET_HOSTS,
              f"fleet: {out['ok']}/{len(out['hosts'])} hosts triggered: "
              f"{out['results']}")
        manifests = trace_report.collect_manifests(log_dir)
        check(len(manifests) == FLEET_HOSTS,
              f"fleet: {len(manifests)} manifests under {log_dir}")
        check(out.get("report_path"), "fleet: unitrace --report wrote none")
        with open(out["report_path"]) as f:
            md = json.load(f)["metadata"]
        check(md["hosts"] == FLEET_HOSTS, f"fleet report metadata: {md}")
        arts = md.get("artifacts", [])
        check(len(arts) == FLEET_HOSTS
              and all(a["path"].endswith(".pt.trace.json") for a in arts),
              f"fleet report artifacts: {arts}")
        for m in manifests:
            check(m.get("pid") in tid_of, f"fleet: manifest of pid "
                  f"{m.get('pid')}, workers {sorted(tid_of)}")
            check_trace(m["_dir"], tid_of[m["pid"]],
                        f"fleet {os.path.basename(m['_dir'])}")
        health = out.get("health") or {}
        scored = len(health.get("hosts", [])) - len(
            health.get("unreachable", []))
        check(scored == FLEET_HOSTS and not health.get("aggregates_failed"),
              f"fleet health verdict scored {scored} hosts: {health}")

        pull_dir = tempfile.mkdtemp(prefix="chip_smoke_pull_")
        t0 = time.monotonic()
        pulled = unitrace.pull_artifacts(out["hosts"], pull_dir,
                                         timeout_s=30)
        pull_s = time.monotonic() - t0
        check(pulled == FLEET_HOSTS, f"fleet: pulled {pulled} artifacts")
        pulled_bytes = 0
        for m in manifests:
            sub = os.path.basename(m["_dir"])
            got = os.path.join(pull_dir, sub, trace_report.STREAMED_ARTIFACT)
            want = os.path.join(m["_dir"], trace_report.STREAMED_ARTIFACT)
            check(os.path.isfile(got), f"fleet: no pulled {got}")
            check(_sha256(got) == _sha256(want),
                  f"fleet: pulled {got} differs from {want}")
            pulled_bytes += os.path.getsize(got)

        streamed = sum(1 for a in arts if a.get("source") == "streamed")
        print(f"fleet [{tag}] {FLEET_HOSTS}/{FLEET_HOSTS} hosts triggered, "
              f"{len(manifests)} manifests, report over {md['hosts']} "
              f"hosts in {run_s:.1f} s (3 workers share one card)",
              flush=True)
        print(f"fleet [{tag}] capture_start_skew_ms="
              f"{md.get('capture_start_skew_ms')} deliver_ms_max="
              f"{md.get('deliver_ms_max')} (start delay "
              f"{FLEET_DELAY_S} s included) streamed_artifacts={streamed}"
              f"/{len(arts)}", flush=True)
        print(f"fleet [{tag}] pull_artifacts {pulled} files "
              f"{pulled_bytes} bytes in {pull_s * 1e3:.1f} ms, sha256 "
              f"identical to the committed streams", flush=True)
        duty = (health.get("metrics", {})
                .get("tensorcore_duty_cycle_pct", {}).get("values", {}))
        if duty:
            for host in hosts:
                print(f"fleet [{tag}] health {host} "
                      f"tensorcore_duty_cycle_pct={duty.get(host)}",
                      flush=True)
        else:
            print(f"fleet [{tag}] health: the aggregates held no "
                  "tensorcore_duty_cycle_pct scalar for any host",
                  flush=True)
    finally:
        for w in workers:
            w.stop()
        for proc, _ in daemons:
            stop_daemon(proc)
    for w in workers:
        done = w.get("done")
        check(done and math.isfinite(done["last_loss"]),
              f"fleet worker {w.proc.pid} ended with {w.lines}")
        print(f"fleet [{tag}] worker {done['done']}: {done['steps']} steps, "
              f"median {done['median_step_ms']:.1f} ms/step with 3 "
              f"workers on one card, loss {done['first_loss']:.4f} -> "
              f"{done['last_loss']:.4f}", flush=True)
    print(f"fleet: phase took {time.monotonic() - t_phase:.1f} s", flush=True)


def packaged_phase(daemon_bin, tag):
    """The installed port: scripts/make_deb.sh on the binaries built
    above, extracted with dpkg-deb -x; the packaged daemon, a worker
    that imports the port from the extracted tree alone and trains the
    flagship step under enable(), and the packaged `dyno gputrace`
    against it, the artifact held to check_trace. Without dpkg-deb, or
    with a build outside native/build (where make_deb.sh takes the
    binaries from), it prints a skip line naming the missing tool."""
    t_phase = time.monotonic()
    if shutil.which("dpkg-deb") is None:
        print("packaged: skipped (dpkg-deb)", flush=True)
        return
    if daemon_bin.parent != REPO / "native" / "build":
        print("packaged: skipped (cmake/ninja: the build is in "
              f"{daemon_bin.parent.relative_to(REPO)})", flush=True)
        return
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_deb_"))
    made = subprocess.run([str(REPO / "scripts" / "make_deb.sh"),
                           str(out_dir)], capture_output=True, text=True,
                          timeout=120)
    check(made.returncode == 0,
          f"packaged: make_deb.sh exit {made.returncode}: {made.stderr}")
    debs = list(out_dir.glob("*.deb"))
    check(len(debs) == 1, f"packaged: debs {debs}")
    deb_name, deb_bytes = debs[0].name, debs[0].stat().st_size
    root = out_dir / "rootfs"
    subprocess.run(["dpkg-deb", "-x", str(debs[0]), str(root)], check=True,
                   timeout=60)
    staged = sum(1 for p in (root / PACKAGED_DIST / "dynolog_tpu_torch")
                 .rglob("*") if p.is_file())
    bin_dir = root / "usr" / "local" / "bin"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DYNOLOG_TPU_SOCKET_DIR=tempfile.mkdtemp(prefix="dtpk"),
               DYNOLOG_TPU_JOB_ID=PACKAGED_JOB,
               PYTHONPATH=str(root / PACKAGED_DIST))
    daemon, port = start_daemon(bin_dir / "dynolog_tpu_daemon",
                                "--trace_stream_max_mb", "1024", env=env)
    threading.Thread(target=daemon.stderr.read, daemon=True).start()
    worker = None
    try:
        worker = FleetWorker(
            argv=[sys.executable, "-c", PACKAGED_WORKER],
            cwd=tempfile.mkdtemp(prefix="chip_smoke_cwd_"), env=env)
        first = wait_for(lambda: worker.get("ready"), 180, "packaged worker")
        check(first["file"].startswith(str(root) + os.sep),
              f"packaged worker imported {first['file']}")
        rpc = DynoClient(port=port)
        wait_for(lambda: any(
            p["pid"] == first["ready"] for p in rpc.trace_registry()
            .get("jobs", {}).get(PACKAGED_JOB, [])), 30,
            "packaged client registration")
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_packaged_")
        t0 = time.monotonic()
        trigger_gputrace(bin_dir / "dyno", port, PACKAGED_JOB, log_dir,
                         TRACE_MS)
        wait_for(lambda: glob.glob(os.path.join(
            log_dir, "**", "dynolog_manifest.json"), recursive=True), 60,
            "packaged capture")
        trace_s = time.monotonic() - t0
        _, kernels = check_trace(log_dir, first["tid"], "packaged")
    finally:
        if worker is not None:
            worker.stop()
        stop_daemon(daemon)
        shutil.rmtree(out_dir, ignore_errors=True)
    done = wait_for(lambda: worker.get("done"), 10, "packaged worker's end")
    check(math.isfinite(done["last_loss"]),
          f"packaged worker ended with {worker.lines}")
    print(f"packaged [{tag}] {deb_name} bytes={deb_bytes} "
          f"port_files_staged={staged}; the packaged daemon, dyno and "
          f"port traced the flagship step ({done['steps']} steps under "
          f"enable()): {TRACE_MS} ms capture, kernels={kernels}, "
          f"dyno gputrace to manifest {trace_s:.2f} s; phase took "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)


def measure_ring(step_fn, make_batch, tag):
    """Median ms/step of the full client against the main daemon (ring
    off) and against the retro daemon (ring on), in rotating windows of
    ~2 s, each with a fresh client. Returns the ring-on clients'
    retro_upload spans and the training time each window cost."""
    ring = _measure_ring(step_fn, make_batch, RETRO_JOB, RETRO_SOCKET,
                         RETRO_ROUNDS, torch.cuda.synchronize)
    ms = ring["ms"]
    m_off = statistics.median(ms["ring_off"])
    for side in ms:
        m = statistics.median(ms[side])
        slower = sum(a > b for a, b in zip(ms[side], ms["ring_off"]))
        print(f"retro [{tag}] step_ms client_{side} median={m:.3f} "
              f"windows={[round(x, 3) for x in ms[side]]} "
              f"steps_per_window={ring['steps']} "
              f"vs_ring_off={100 * (m - m_off) / m_off:+.3f}% "
              f"slower_than_off_in={slower}/{RETRO_ROUNDS}", flush=True)
    return ring["uploads"], ring["extra_ms"]


def retro_phase(daemon_bin, step_fn, make_batch, tag):
    """The flight recorder on the card: one anomaly turned into a merged
    report of the ring's windows and the forward capture, with no
    operator RPC but the injection; then the ring's cost."""
    t_phase = time.monotonic()
    store = tempfile.mkdtemp(prefix="chip_smoke_retro_store_")
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_retro_")
    proc, port = start_daemon(
        daemon_bin, "--ipc_socket_name", RETRO_SOCKET,
        "--storage_dir", store,
        "--retro_window_ms", str(RETRO_WINDOW_MS),
        "--retro_ring_windows", "4",
        "--enable_history_injection",
        "--watch", f"{RETRO_METRIC}>50:60:trace(400)",
        "--watch_interval_s", "0.3", "--watch_z_threshold", "0",
        "--capture_log_dir", log_dir, "--capture_job_id", RETRO_JOB,
        "--capture_start_delay_ms", "100",
        "--trace_stream_max_mb", "1024")
    threading.Thread(target=proc.stderr.read, daemon=True).start()
    client = trainer = None
    try:
        rpc = DynoClient(port=port)
        client = DynologClient(job_id=RETRO_JOB, poll_interval_s=0.5,
                               metrics_interval_s=1.0,
                               daemon_socket=RETRO_SOCKET).start()
        trainer = TrainingThread(step_fn, make_batch, client).start()
        def coverage_ms():
            fr = rpc.status().get("flightrecorder") or {}
            return fr.get("coverage_ms", 0) >= RETRO_WINDOW_MS and \
                fr["coverage_ms"]

        primed_coverage = wait_for(coverage_ms, 60,
                                   f"the ring covering {RETRO_WINDOW_MS} ms")

        def events(etype):
            got = eventlog.fetch_all_events(rpc)["events"]
            return [e for e in got if e["type"] == etype]

        now_ms = int(time.time() * 1000)
        resp = rpc.put_history(f"{RETRO_METRIC}.dev0", [
            (now_ms - (30 - k) * 1000, 100.0) for k in range(30)])
        check(resp.get("added") == 30, f"retro: put_history {resp}")
        t_inject = time.monotonic()
        done = wait_for(lambda: events("autocapture_complete"), 60,
                        "autocapture_complete")[0]
        check("retro ring exported" in done["detail"],
              f"retro: autocapture_complete says {done['detail']!r}")
        fire_s = time.monotonic() - t_inject
        wait_for(lambda: client.captures_completed >= 1 or trainer.error,
                 120, "the triggered forward capture")
        trainer.alive_check()
        manifests = wait_for(
            lambda: trace_report.collect_manifests(log_dir), 30,
            "the forward capture's manifest")
        retro = trace_report.collect_retro(log_dir)
        check(retro, f"retro: no retro_manifest.json under {log_dir}")
        train_tid = trainer.tid
        # The client first: the training thread's next step() ends the
        # window it runs (a profiler stops only on its own thread).
        client.stop()
        trainer.stop()
        counters = client.spans.counters()
        check(counters.get("retro_disabled", 0) == 0,
              f"retro: the flight recorder disabled itself: {counters}")
        check(counters.get("retro_windows_captured", 0) > 0,
              f"retro: no window captured: {counters}")
        uploads = retro_uploads(client)
        trainer = client = None

        check_trace(manifests[0]["_dir"], train_tid, "retro forward")
        with open(trace_report.write_report(log_dir)) as f:
            md = json.load(f)["metadata"]
        check(md.get("hosts") == 1, f"retro report metadata: {md}")
        arts = md.get("artifacts", [])
        check(len(arts) == 1 and arts[0]["path"].endswith(".pt.trace.json"),
              f"retro report: no forward capture artifact: {arts}")
        r = md.get("retro") or {}
        check(r.get("windows", 0) >= 1
              and r.get("coverage_ms", 0) >= RETRO_WINDOW_MS,
              f"retro report metadata.retro: {r}")
        kernels = []
        for m in retro:
            for w in m.get("windows", []):
                check(w.get("job_id") == RETRO_JOB,
                      f"retro: exported window of another job: {w}")
                trace = trace_report.read_retro_window(
                    os.path.join(m["_dir"], w["file"]))
                kernels.append(sum(1 for e in trace["traceEvents"]
                                   if e.get("cat") == "kernel"))
        check(any(kernels), f"retro: no CUDA kernel in any exported "
              f"window: {kernels}")

        captured = counters.get("retro_windows_captured", 0)
        failed = counters.get("retro_upload_failures", 0)
        print(f"retro [{tag}] windows captured={captured} skipped="
              f"{counters.get('retro_windows_skipped', 0)} uploaded="
              f"{captured - failed} upload_failures={failed}", flush=True)
        print(f"retro [{tag}] primed coverage_ms={primed_coverage}; "
              f"anomaly -> autocapture_complete in {fire_s:.2f} s: "
              f"{done['detail']}", flush=True)
        print(f"retro [{tag}] report metadata.retro windows="
              f"{r['windows']} coverage_ms={r['coverage_ms']} gaps="
              f"{r.get('gaps')} hosts={r.get('hosts')}, forward artifact "
              f"{os.path.basename(arts[0]['path'])}; kernels per exported "
              f"window {kernels}", flush=True)

        # The ring's cost, after the report: these clients' windows land
        # in the same ring.
        more, extra_ms = measure_ring(step_fn, make_batch, tag)
        ok = [u for u in uploads + more if u.get("ok")]
        check(ok, "retro: no window uploaded")
        print(f"retro [{tag}] training-thread cost per window: median "
              f"{statistics.median(extra_ms):.1f} ms, rounds "
              f"{[round(x, 1) for x in extra_ms]}; stop call in step() "
              f"median={statistics.median(u['stop_ms'] for u in ok):.1f} "
              f"max={max(u['stop_ms'] for u in ok):.1f} ms; export on the "
              f"recorder's thread (holding the interpreter lock) median="
              f"{statistics.median(u['export_ms'] for u in ok):.1f} ms",
              flush=True)
        print(f"retro [{tag}] window bytes median="
              f"{int(statistics.median(u['json_bytes'] for u in ok))} "
              f"(JSON), {int(statistics.median(u['bytes'] for u in ok))} "
              f"gzipped, max {max(u['bytes'] for u in ok)}; gzip_ms "
              f"median={statistics.median(u['gzip_ms'] for u in ok):.1f}; "
              f"upload_ms median="
              f"{statistics.median(u['dur_ms'] for u in ok):.1f} max="
              f"{max(u['dur_ms'] for u in ok):.1f} over {len(ok)} uploads "
              f"({len(uploads) + len(more) - len(ok)} failed)", flush=True)
    finally:
        if client is not None:
            client.stop()
        if trainer is not None:
            trainer.halt()
        stop_daemon(proc)
    print(f"retro: phase took {time.monotonic() - t_phase:.1f} s", flush=True)


def _timed_steps(step, tokens, n):
    """n steps, each loss read back; (losses, ms/step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(tokens)) for _ in range(n)]
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) * 1e3 / n


def _batch(vocab_size, generator):
    return torch.randint(0, vocab_size, (BATCH, SEQ),
                         generator=generator).cuda()


def _capture_steps(step, tokens, ready_path):
    """Steps every rank until rank 0's client has completed one capture
    (or 120 s pass): rank 0 trains under the client shim, registered as
    PARALLEL_JOB, creates ``ready_path`` once its client has seen a
    step() (a config that arrives before any step() is captured on the
    client's own thread, without the training thread's ops), and
    broadcasts whether to go on after every step."""
    rank = dist.get_rank()
    client = None
    if rank == 0:
        client = DynologClient(job_id=PARALLEL_JOB, poll_interval_s=0.5,
                               metrics_interval_s=1.0).start()
    go = torch.ones(1, device="cuda")
    deadline = time.monotonic() + 120
    steps = 0
    try:
        while go.item():
            run_annotated_loop(step, lambda i: tokens, 1, client=client)
            steps += 1
            if client is not None and steps == 2:
                pathlib.Path(ready_path).touch()
            if client is not None and (client.captures_completed >= 1
                                       or time.monotonic() > deadline):
                go.zero_()
            dist.broadcast(go, src=0)
    finally:
        if client is not None:
            client.stop()
    return {"tid": threading.get_native_id(), "steps": steps,
            "captures": client.captures_completed if client else None}


def parallel_rank(ready_path) -> dict:
    """One NCCL rank of the parallel phase: the three workloads at their
    widths, batch 8 x 512, from seeded weights. Returns per workload the
    mesh, the first losses, rank 0's unsharded loss of the same weights,
    the last loss and ms/step; and the capture of the flagship step."""
    n = dist.get_world_size()
    gen = lambda seed: torch.Generator().manual_seed(seed)
    out = {}

    def run(name, mesh, step, unsharded):
        ref = None
        if dist.get_rank() == 0:
            with torch.no_grad():
                ref = float(unsharded())
            torch.cuda.empty_cache()
        first, _ = _timed_steps(step, tokens, PARALLEL_WARMUP)
        losses, ms = _timed_steps(step, tokens, PARALLEL_STEPS)
        out[name] = {"mesh": dict(zip(mesh.mesh_dim_names,
                                      mesh.mesh.shape)),
                     "first": first[0], "unsharded": ref,
                     "last": losses[-1], "ms": ms,
                     "finite": all(map(math.isfinite, first + losses))}

    tokens = _batch(FLAGSHIP.vocab_size, gen(1))
    mesh = make_mesh("cuda", mesh_shape(n))
    cfg = dataclasses.replace(FLAGSHIP, seq_axis="seq")
    _, _, step = make_sharded_train_step(cfg, mesh, "cuda", gen(0))
    run("flagship", mesh, step, lambda: loss_fn(
        Transformer(FLAGSHIP, "cuda", gen(0)), tokens))
    # The unsharded step beside it on rank 0, in windows alternating
    # with the sharded step's: plain, sharded, sharded, plain. The other
    # ranks run the sharded windows only, meeting rank 0 in them.
    windows = {"plain": [], "sharded": []}
    plain = None
    if dist.get_rank() == 0:
        _, _, plain = make_train_step(FLAGSHIP, "cuda", gen(0))
        _timed_steps(plain, tokens, PARALLEL_WARMUP)
    for side in ("plain", "sharded", "sharded", "plain"):
        if side == "sharded" or plain is not None:
            windows[side].append(_timed_steps(
                plain if side == "plain" else step, tokens,
                PARALLEL_STEPS)[1])
    out["flagship"]["windows_ms"] = windows
    del plain
    out["capture"] = _capture_steps(step, tokens, ready_path)
    del step

    moe_cfg = moe.MoeConfig()
    tokens = _batch(moe_cfg.vocab_size, gen(1))
    mesh = moe.make_moe_mesh("cuda", moe_cfg.n_experts)
    _, _, step = moe.make_moe_workload(moe_cfg, mesh, "cuda", gen(2))
    run("moe", mesh, step, lambda: moe.moe_loss(
        moe.MoeModel(moe_cfg, "cuda", gen(2)), tokens))
    del step

    # One stage per rank: PipeConfig()'s four stages on four cards, one
    # stage on one card.
    pipe_cfg = dataclasses.replace(pipeline.PipeConfig(), n_stages=n)
    tokens = _batch(pipe_cfg.vocab_size, gen(1))
    mesh = pipeline.make_pipe_mesh("cuda", n)
    _, _, step = pipeline.make_pipe_workload(pipe_cfg, mesh, "cuda", gen(3))
    run("pipe", mesh, step, lambda: pipeline.pipe_loss(
        pipeline.PipeModel(pipe_cfg, "cuda", gen(3)), tokens))
    return out


def parallel_phase(rpc, dyno_bin, port, tag):
    """The parallel workloads on NCCL ranks, one per visible card, with
    one gputrace of rank 0's sharded flagship step."""
    t_phase = time.monotonic()
    n = torch.cuda.device_count()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    ready = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ready_"),
                         "stepping")
    got = {}

    def ranks():
        try:
            got["results"] = run_ranks(n, parallel_rank, ready,
                                       backend="nccl",
                                       timeout_s=PARALLEL_TIMEOUT_S)
        except Exception as e:  # re-raised on this thread below
            got["error"] = e

    thread = threading.Thread(target=ranks, name="parallel", daemon=True)
    thread.start()
    wait_for(lambda: os.path.exists(ready) or not thread.is_alive(),
             PARALLEL_TIMEOUT_S, "rank 0 stepping under the client")
    check(PARALLEL_JOB in rpc.trace_registry().get("jobs", {})
          or not thread.is_alive(), "parallel: rank 0 is not registered")
    if thread.is_alive():
        trigger_gputrace(dyno_bin, port, PARALLEL_JOB, log_dir)
    thread.join(timeout=PARALLEL_TIMEOUT_S)
    check(not thread.is_alive(), "parallel: ranks did not finish")
    if "error" in got:
        raise SmokeError(f"parallel: {got['error']}")
    res = got["results"]
    cap = res[0]["capture"]
    check(cap["captures"] >= 1, f"parallel: no capture on rank 0: {cap}")
    check_trace(log_dir, cap["tid"], "parallel gputrace")
    with open(find_traces(log_dir), "rb") as f:
        events = json.load(f)["traceEvents"]
    nccl = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                   and "nccl" in str(e.get("name", "")).lower()})
    print(f"parallel [{tag}] gputrace of rank 0's sharded flagship step "
          f"after {cap['steps']} steps: {len(nccl)} distinct NCCL "
          f"kernels {nccl[:6]}", flush=True)
    for name in ("flagship", "moe", "pipe"):
        r0 = res[0][name]
        rel = abs(r0["first"] - r0["unsharded"]) / abs(r0["unsharded"])
        for rank, r in enumerate(res):
            w = r[name]
            check(w["finite"], f"parallel {name} rank {rank}: non-finite")
            check(w["first"] == r0["first"] and w["last"] == r0["last"],
                  f"parallel {name}: ranks disagree {w} vs {r0}")
        check(rel <= PARALLEL_REL[name],
              f"parallel {name}: first loss {r0['first']} vs unsharded "
              f"{r0['unsharded']}, relative {rel:.3e}")
        check(r0["last"] < r0["first"],
              f"parallel {name}: loss did not fall {r0}")
        print(f"parallel [{tag}] {name} {n} NCCL rank(s) mesh {r0['mesh']} "
              f"batch {BATCH}x{SEQ}: {r0['ms']:.3f} ms/step over "
              f"{PARALLEL_STEPS} steps (rank 0; after {PARALLEL_WARMUP} "
              f"warm-up), first loss {r0['first']:.5f} vs unsharded "
              f"{r0['unsharded']:.5f} (rel {rel:.2e}, limit "
              f"{PARALLEL_REL[name]}), last {r0['last']:.5f}", flush=True)
    win = res[0]["flagship"]["windows_ms"]
    print(f"parallel [{tag}] flagship ms/step windows on rank 0 "
          f"(plain, sharded, sharded, plain; {PARALLEL_STEPS} steps each): "
          f"unsharded {[round(x, 3) for x in win['plain']]} sharded "
          f"{[round(x, 3) for x in win['sharded']]}", flush=True)
    print(f"parallel: phase took {time.monotonic() - t_phase:.1f} s",
          flush=True)


def bench_phase(daemon_bin, dyno_bin, tag):
    """`python -m dynolog_tpu_torch.bench --quick` against the binaries
    built above, in its own session so that a run past its deadline
    takes its daemons and burners down with it."""
    t_phase = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynolog_tpu_torch.bench", "--quick",
         "--daemon-bin", str(daemon_bin), "--dyno-bin", str(dyno_bin)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise SmokeError(f"bench: no result within {BENCH_TIMEOUT_S} s: "
                         f"{err[-4000:]}") from None
    check(proc.returncode == 0,
          f"bench: exit {proc.returncode}: {err[-4000:]}")
    lines = out.strip().splitlines()
    check(lines, f"bench: printed nothing: {err[-4000:]}")
    record = json.loads(lines[-1])
    d = record["detail"]
    check(d["platform"].startswith("gpu:"), f"bench: platform {d['platform']}")
    check(d["card"] and not missing_numbers(d),
          f"bench: no number for {missing_numbers(d)}, card {d['card']}")
    o = d["overhead"]
    print(f"bench [{tag}] platform {d['platform']}, card {d['card']}; "
          f"overhead {record['value']:+.3f}% (client off "
          f"{o['off_median_ms']:.3f} / on {o['on_median_ms']:.3f} ms/step, "
          f"{o['rounds']} rounds of {o['steps_per_window']} steps)",
          flush=True)
    for key in ("trace_latency", "trace_latency_poll_fallback"):
        t = d[key]
        print(f"bench [{tag}] {key} e2e median={t['e2e_ms']['median']} "
              f"p95={t['e2e_ms']['p95']} nonwindow median="
              f"{t['nonwindow_ms']['median']} ms, stop_call median="
              f"{t['phases_ms']['stop_call']['median']} ms, window "
              f"{t['window_ms']} ms, {t['trials']} trial(s), deliveries "
              f"{t['deliveries']}", flush=True)
    pa, lh, fr = d["phase_attribution"], d["loaded_host"], d["flight_recorder"]
    print(f"bench [{tag}] phase_attribution cadence_ratio="
          f"{pa['cadence_ratio']:.3f} spin_cpu_util="
          f"{pa['annotated']['spin_cpu_util']} sleep_cpu_util="
          f"{pa['annotated']['sleep_cpu_util']}; loaded_host overhead="
          f"{lh['overhead_pct']:+.3f}% accounting="
          f"{lh['overhead_cpu_accounting_pct']:.3f}% over "
          f"{lh['cpus_saturated']} burners", flush=True)
    print(f"bench [{tag}] flight_recorder cadence_ratio="
          f"{fr['cadence_ratio']:.3f} trigger_to_retro median="
          f"{fr['trigger_to_retro_ms']['median']} ms; ring "
          f"{fr['ring']['ring_off_median_ms']:.3f} -> "
          f"{fr['ring']['ring_on_median_ms']:.3f} ms/step "
          f"({fr['ring']['vs_ring_off_pct']:+.3f}%)", flush=True)
    bench_fleet_lines(d, tag)
    print(f"bench: phase took {time.monotonic() - t_phase:.1f} s", flush=True)


def bench_fleet_lines(d, tag):
    """The fleet and recovery phases of one bench record: a line each
    with its headline numbers, and a check of every outcome bench.py's
    assertions gate on."""
    for n, f in d["fleet"].items():
        check(f["windows_intersect"],
              f"bench fleet {n}: capture windows do not intersect {f}")
        print(f"bench [{tag}] fleet {n} hosts: fanout_rpc "
              f"{f['fanout_rpc_ms']} ms, sync spread {f['sync_spread_ms']} "
              f"ms, max sync error {f['max_sync_error_ms']} ms, all open "
              f"{f['common_open_ms']} of {f['capture_window_ms']} ms",
              flush=True)
    rr = d["restart_recovery"]
    print(f"bench [{tag}] restart_recovery {rr['hosts']} hosts x "
          f"{rr['trials']}: recovery median {rr['recovery_ms']['median']} "
          f"p95 {rr['recovery_ms']['p95']} ms, shim counters "
          f"{rr['client_counters']}", flush=True)
    fh = d["fleet_health"]
    check(fh["straggler_detected"],
          f"bench fleet_health: straggler not flagged alone {fh}")
    print(f"bench [{tag}] fleet_health {fh['hosts']} hosts: sweep "
          f"{fh['sweep_ms']} ms, straggler detected "
          f"{fh['straggler_detected']}", flush=True)
    ft = d["fleet_tree"]
    check(ft["straggler_parity"],
          f"bench fleet_tree: tree and flat do not both flag the straggler "
          f"{ft}")
    print(f"bench [{tag}] fleet_tree {ft['hosts']} hosts ({ft['relays']} "
          f"relays): tree p95 {ft['tree_sweep_ms']['p95']} ms against flat "
          f"p95 {ft['flat_sweep_ms']['p95']} ms, straggler parity "
          f"{ft['straggler_parity']}", flush=True)
    fs = d["fleet_selfheal"]
    check(fs["lost_children"] == 0,
          f"bench fleet_selfheal: {fs['lost_children']} orphan(s) never "
          f"re-parented")
    # root_promotion_s is set only once a sweep through a surviving seed
    # names expected_root of the seeds left as root.
    check(fs["root_promotion_s"] is not None,
          "bench fleet_selfheal: expected_root's seed was never promoted")
    check(fs["post_promotion_full_sweep_s"] is not None,
          "bench fleet_selfheal: no sweep saw every live host fresh after "
          "the promotion")
    reparent = fs["reparent_s"] or {}
    print(f"bench [{tag}] fleet_selfheal {fs['hosts']} hosts "
          f"({fs['seeds']} seeds): re-parent p95 {reparent.get('p95')} s "
          f"over {fs['reparented_children']} orphan(s), root promotion "
          f"{fs['root_promotion_s'] * 1e3:.1f} ms, every live host fresh "
          f"after {fs['post_promotion_full_sweep_s']} s, tree sweep p95 "
          f"{fs['tree_sweep_ms']['p95']} ms against flat "
          f"{fs['flat_sweep_ms']['p95']} ms", flush=True)
    ej = d["event_journal"]
    print(f"bench [{tag}] event_journal capacity {ej['ring_capacity']}: "
          f"emit {ej['emit_rpc_ms_per_event']} ms/event, drain "
          f"{ej['drain_ms_at_capacity']} ms for {ej['events_drained']} "
          f"events", flush=True)
    dm = d["degraded_mode"]
    print(f"bench [{tag}] degraded_mode cadence ratio {dm['cadence_ratio']} "
          f"(healthy {dm['healthy']['kernel_ticks_per_s']} / degraded "
          f"{dm['degraded']['kernel_ticks_per_s']} ticks/s), tpu "
          f"{dm['degraded']['tpu_state']}", flush=True)
    # measure_autocapture itself fails the run on a rule that fired with
    # no artifact, so one artifact a rule needs no check here.
    ac = d["autocapture"]
    print(f"bench [{tag}] autocapture {ac['firings']} rules on "
          f"{ac['hosts']} hosts: first artifact median "
          f"{ac['first_artifact_ms']['median']} p95 "
          f"{ac['first_artifact_ms']['p95']} ms", flush=True)
    bench_daemon_lines(d, tag)


def bench_daemon_lines(d, tag):
    """bench.py's last seven phases of one bench record: a line each with
    its headline numbers, and a check of every outcome bench.py's
    assertions gate on. Its timing bars (read p99 under 50 ms, cadence
    ratios of 0.97 and more, sweep p95 under 50 ms, ...) are printed,
    not checked: the port's bench sets no targets."""
    du = d["durability"]
    check(du["store_at_kill"]["evictions_total"] > 0,
          f"bench durability: the store never evicted {du['store_at_kill']}")
    check(du["recovered"]["frames"] > 0,
          f"bench durability: no frame recovered {du['recovered']}")
    print(f"bench [{tag}] durability cadence ratio {du['cadence_ratio']} "
          f"(no storage {du['kernel_ticks_per_s']['no_storage']} / flusher "
          f"{du['kernel_ticks_per_s']['with_flusher']} ticks/s); kill -9 "
          f"of a {du['store_at_kill']['bytes']}-byte store "
          f"({du['store_at_kill']['evictions_total']} evictions) -> "
          f"answering in {du['recovery_ms']} ms, "
          f"{du['recovered']['frames']} frames recovered "
          f"({du['recovered']['torn_frames']} torn)", flush=True)
    sq = d["sketch_quantiles"]
    check(sq["worst_relative_error"] <= sq["documented_error_bound"],
          f"bench sketch_quantiles: error {sq['worst_relative_error']} over "
          f"the bound {sq['documented_error_bound']}")
    check(sq["wire_bytes_ratio"] < 0.05,
          f"bench sketch_quantiles: wire bytes ratio {sq['wire_bytes_ratio']}")
    print(f"bench [{tag}] sketch_quantiles worst error "
          f"{sq['worst_relative_error']} (bound "
          f"{sq['documented_error_bound']}), {sq['bucket_count_at_1m_samples']}"
          f" buckets, wire ratio {sq['wire_bytes_ratio']}, add "
          f"{sq['add_us_per_sample']} us/sample, "
          f"{sq['tree_merges_per_s']} merges/s", flush=True)
    rs = d["read_swarm"]
    check(rs["errors"] == 0, f"bench read_swarm: {rs['errors']} reads failed")
    print(f"bench [{tag}] read_swarm {rs['readers']} readers x "
          f"{rs['waves']} waves: p50 {rs['read_p50_ms']} p99 "
          f"{rs['read_p99_ms']} ms (bar 50), {rs['requests_per_s']} req/s, "
          f"cadence ratio {rs['cadence_ratio']} (bar 0.97), cache hit "
          f"{rs['cache'].get('hit_ratio')} (bar 0.9)", flush=True)
    mt = d["multitenant"]
    check(mt["abuser"]["shed"] > 0,
          f"bench multitenant: the abuser was never shed {mt['abuser']}")
    check(mt["storm_lost_children"] == 0,
          f"bench multitenant: {mt['storm_lost_children']} orphan(s) of the "
          f"authenticated storm never re-parented")
    check(mt["storm_auth_rejected_total"] == 0,
          f"bench multitenant: {mt['storm_auth_rejected_total']} relay "
          f"verb(s) rejected in the storm")
    storm = mt["storm_reparent_s"] or {}
    print(f"bench [{tag}] multitenant cadence ratio {mt['cadence_ratio']} "
          f"(bar 0.97); polite p99 {mt['polite_read_p99_ms']['alone']} -> "
          f"{mt['polite_read_p99_ms']['under_10x_abuser']} ms under the "
          f"abuser ({mt['polite_p99_shift_pct']:+}%, bar 20%), abuser "
          f"{mt['abuser']}; storm {mt['storm_hosts']} hosts: bootstrap "
          f"{mt['storm_bootstrap_s']} s, re-parent p95 {storm.get('p95')} s "
          f"over {mt['storm_reparented_children']} orphan(s) (bar 5)",
          flush=True)
    ll = d["link_localization"]
    check(ll["exact_edge"], f"bench link_localization: flagged "
                            f"{ll['link_bound']}, not {ll['degraded_edge']}")
    check(ll["false_positive_hosts"] == 0,
          f"bench link_localization: {ll['false_positive_hosts']} healthy "
          f"host(s) blamed")
    print(f"bench [{tag}] link_localization {ll['hosts']}-host ring: "
          f"degraded edge flagged alone, deficit {ll['deficit_pct']}%; link "
          f"sweep p95 {ll['link_sweep_ms']['p95']} ms against host-only "
          f"{ll['host_only_sweep_ms']['p95']} (bar 2x), cadence ratio "
          f"{ll['cadence_ratio']}", flush=True)
    sub = d["subscription"]
    check(sub["delivery_ratio"] >= 1.0,
          f"bench subscription: {sub['deliveries']} of "
          f"{sub['deliveries_expected']} deliveries")
    print(f"bench [{tag}] subscription {sub['subscribers']} subscribers on "
          f"{sub['tree']['daemons']} daemons: registered in "
          f"{sub['register_s']} s, delta p50 {sub['delta_p50_ms']} p95 "
          f"{sub['delta_p95_ms']} ms (bar 250), cadence ratio "
          f"{sub['cadence_ratio']}, steady {sub['steady_rpc_per_min']} "
          f"rpc/min against {sub['polling_equiv_rpc_per_min']} polling",
          flush=True)
    fs = d["fleet_scale"]
    check(fs["lost_children"] == 0,
          f"bench fleet_scale: {fs['lost_children']} simulated host(s) lost")
    check(fs["converge_after_kill_s"] is not None,
          "bench fleet_scale: no reconvergence within 40 s of the interior's "
          "kill")
    print(f"bench [{tag}] fleet_scale {fs['simulated_hosts']} simulated "
          f"hosts over {fs['interiors']} interiors: sweep p95 "
          f"{fs['sweep_ms']['p95']} ms (bar 50), fan-in "
          f"{fs['fanin']['reduction_x']}x under unbatched (bar 5), "
          f"reconverged {fs['converge_after_kill_s']} s after the kill (bar "
          f"15), cadence ratio {fs['cadence_ratio']}", flush=True)


def main() -> int:
    if sys.argv[1:] == ["--fleet-worker"]:
        return fleet_worker()
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(threadName)s %(message)s")
    # A stall anywhere still ends the run inside its time limit, and a
    # crash too, with every thread's stack on stderr.
    faulthandler.enable()
    faulthandler.dump_traceback_later(1080, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    tag = card

    daemon_bin, dyno_bin, build_s = build_native()
    print(f"build: {daemon_bin.parent.relative_to(REPO)} in {build_s:.1f}s",
          flush=True)

    os.environ["DYNOLOG_TPU_SOCKET_DIR"] = tempfile.mkdtemp(
        prefix="chip_smoke_")
    daemon, port = start_daemon(daemon_bin, "--trace_stream_max_mb", "1024")
    if sys.argv[1:] == ["--parallel-only"]:
        try:
            parallel_phase(DynoClient(port=port), dyno_bin, port, tag)
        finally:
            stop_daemon(daemon)
        return finish()
    client = trainer = None
    try:
        print(f"daemon: port {port}", flush=True)
        rpc = DynoClient(port=port)

        model, _, step_fn = make_train_step(
            FLAGSHIP, device="cuda",
            generator=torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        tokens = torch.randint(
            0, FLAGSHIP.vocab_size, (BATCH, SEQ),
            generator=torch.Generator().manual_seed(1)).cuda()

        def make_batch(i):
            return tokens

        first_loss = run_annotated_loop(step_fn, make_batch, 3)
        print(f"workload: flagship {n_params} params, batch {BATCH}x{SEQ}, "
              f"bf16, remat; first loss {first_loss:.4f}", flush=True)

        # A second daemon without per-phase CPU sampling, for the
        # overhead split.
        quiet, _ = start_daemon(daemon_bin, "--ipc_socket_name", QUIET,
                                "--phase_cpu_interval_s", "3600")
        try:
            measure_overhead(step_fn, make_batch, tag)
        finally:
            stop_daemon(quiet)

        client = DynologClient(job_id=JOB, poll_interval_s=0.5,
                               metrics_interval_s=1.0).start()
        trainer = TrainingThread(step_fn, make_batch, client).start()

        def registered():
            jobs = rpc.trace_registry().get("jobs", {})
            procs = [p for p in jobs.get(JOB, []) if p["pid"] == os.getpid()]
            return procs[0] if procs else None

        reg = wait_for(registered, 30, "client registration")
        check(reg["metadata"].get("platform") == "gpu",
              f"registration metadata: {reg['metadata']}")
        print(f"register: job {JOB} pid {reg['pid']} metadata.platform=gpu "
              f"device_count={reg['metadata'].get('device_count')}",
              flush=True)

        def gpu_record():
            for dev in rpc.tpu_status().get("devices", []):
                met = dev.get("metrics", {})
                if (dev.get("job_id") == JOB and met.get("platform") == "gpu"
                        and "tensorcore_duty_cycle_pct" in met):
                    return met
            return None

        met = wait_for(gpu_record, 30, "pushed GPU telemetry")
        check("H100" in met.get("device_kind", ""), f"device_kind: {met}")
        check(met.get("hbm_used_bytes", 0) > 0, f"hbm_used_bytes: {met}")
        check(met.get("hbm_total_bytes", 0) > 0, f"hbm_total_bytes: {met}")
        print(f"telemetry [{tag}] device={met['device']} "
              f"kind={met['device_kind']} "
              f"hbm_used_bytes={met['hbm_used_bytes']} "
              f"hbm_total_bytes={met['hbm_total_bytes']} "
              f"tensorcore_duty_cycle_pct={met['tensorcore_duty_cycle_pct']}",
              flush=True)

        trace_root = tempfile.mkdtemp(prefix="chip_smoke_traces_")
        dur_dir = os.path.join(trace_root, "gputrace")

        _, t = run_capture(
            client, trainer,
            lambda: trigger_gputrace(dyno_bin, port, JOB, dur_dir), dur_dir)
        check_trace(dur_dir, trainer.tid, "gputrace")
        to_start = (t["trace_start"] - t["config_received"]) * 1e3
        start_call = (t["start_returned"] - t["trace_start"]) * 1e3
        print(f"gputrace [{tag}] first capture in the process: "
              f"config->start {to_start:.1f} ms, profiler start call "
              f"{start_call:.1f} ms", flush=True)

        def arm(log_dir, **extra):
            return lambda: rpc.set_trace_config(job_id=JOB, config={
                "type": "xplane", "log_dir": log_dir,
                "duration_ms": TRACE_MS, **extra})

        iter_dir = os.path.join(trace_root, "iteration")
        run_capture(client, trainer,
                    arm(iter_dir, iterations=5, iteration_roundup=10),
                    iter_dir)
        check_trace(iter_dir, trainer.tid, "iteration")

        phases = {name: [] for name in BREAKDOWN}
        sizes = []
        for i in range(LATENCY_TRIALS):
            log_dir = os.path.join(trace_root, f"latency_{i}")
            t_rpc, t = run_capture(client, trainer, arm(log_dir), log_dir)
            sizes.append(
                check_trace(log_dir, trainer.tid, f"latency_{i}")[0])
            row = trace_breakdown(t_rpc, t)
            check(set(row) == set(BREAKDOWN),
                  f"latency_{i}: trace_timing lacks stamps: {t}")
            for name, ms in row.items():
                phases[name].append(ms)
        for name, xs in phases.items():
            ms = [round(x, 3) for x in xs]
            print(f"trace_latency [{tag}] {name} median_ms="
                  f"{statistics.median(ms):.3f} trials_ms={ms} "
                  f"window_ms={TRACE_MS}", flush=True)
        print(f"artifact [{tag}] pt.trace.json bytes median="
              f"{int(statistics.median(sizes))} trials={sizes}", flush=True)

        trainer.stop()
        losses = trainer.losses
        check(all(map(math.isfinite, losses)), "non-finite flagship loss")
        check(losses[-1] < first_loss,
              f"flagship loss did not fall: {first_loss} -> {losses[-1]}")
        print(f"training: {len(losses)} traced-run steps, loss "
              f"{first_loss:.4f} -> {losses[-1]:.4f}, finite", flush=True)
        trainer = None

        parity_check(tag)
        control_phase(daemon_bin, dyno_bin, step_fn, make_batch, tag,
                      max(phases["start_to_stop"]) - TRACE_MS)
        retro_phase(daemon_bin, step_fn, make_batch, tag)
        parallel_phase(rpc, dyno_bin, port, tag)
    finally:
        if trainer is not None:
            trainer.halt()
        if client is not None:
            client.stop()
        stop_daemon(daemon)

    fleet_phase(daemon_bin, tag)
    packaged_phase(daemon_bin, tag)
    bench_phase(daemon_bin, dyno_bin, tag)
    return finish()


def finish() -> int:
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
