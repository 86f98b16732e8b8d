#!/usr/bin/env python3
"""Measures what a flight-recorder window costs the training thread, for
the designs the torch shim could take, on one NVIDIA GPU with the
flagship train step (chip_smoke.py's configuration). The shim records
its windows the step_seq way; "thread" crashed (PERF.md, PR 4).

    python3 scripts/torch_retro_design.py [--rounds 4] [--round-s 4]
        [--window-ms 500] [--sides off,thread,step,step_cuda,step_seq]
        [--daemon native/build/dynolog_tpu_daemon]

Sides, in rotating rounds of --round-s seconds of training each:

  off        no profiler
  thread     (a) ProfilerActivity.CUDA only, started, stopped and
             exported on a ring thread of its own, back to back
  step       (b) CPU and CUDA activities, started and stopped between
             two steps on the training thread (as the shim's forward
             captures are), exported on a ring thread
  step_cuda  (b) with ProfilerActivity.CUDA only
  step_seq   (b) with ProfilerActivity.CUDA only, each window started
             only once the previous one is exported, so no session runs
             while another is exported

For each window it records the profiler's start and stop calls, the
export, the Chrome trace's bytes and kernel events, and, for "thread",
the longest time a probe thread waited to run Python while the ring
thread was inside stop or export (a stop or export that holds the
interpreter lock stalls the training thread for as long). The
training-thread stall per window is the start and stop calls for the
step sides and, for "thread", the extra training time of its rounds over
the same round's "off", per window. With --daemon, the last windows of
"thread" are then streamed into a retro ring, as JSON and gzipped, to
time the upload. Prints one JSON line per side, the card's name and
power limit, and a summary line last.
"""

from __future__ import annotations

import argparse
import faulthandler
import gzip
import json
import os
import pathlib
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dynolog_tpu_torch.client.fabric import FabricClient  # noqa: E402
from dynolog_tpu_torch.models.train import make_train_step  # noqa: E402
from dynolog_tpu_torch.models.transformer import ModelConfig  # noqa: E402
from dynolog_tpu_torch.utils.procutil import wait_for_stderr  # noqa: E402

FLAGSHIP = ModelConfig(vocab_size=8192, d_model=512, n_layers=8, n_heads=8,
                       d_ff=1408, max_seq_len=512,
                       compute_dtype=torch.bfloat16, remat=True)
BATCH, SEQ = 8, 512
SIDES = ("off", "thread", "step", "step_cuda", "step_seq")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


class GilProbe:
    """Sleeps 5 ms at a time on its own thread and keeps every wake-up
    that came 20 ms late or later: a thread holding the interpreter lock
    that long kept every other Python thread waiting. Runs through every
    side, so its own small share of the lock weighs on all of them."""

    def __init__(self):
        self.late: list[tuple[float, float]] = []  # (t_begin, t_end)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(0.005)
            t1 = time.perf_counter()
            if t1 - t0 > 0.025:
                self.late.append((t0, t1))

    def max_wait_ms(self, t0: float, t1: float) -> float:
        waits = [e - b for b, e in list(self.late) if b < t1 and e > t0]
        return round(max(waits, default=0.0) * 1e3, 3)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _export(prof, path) -> tuple[bytes, float]:
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    with open(path, "rb") as f:
        data = f.read()
    os.unlink(path)
    return data, (time.perf_counter() - t0) * 1e3


def _kernels(data: bytes) -> int:
    return sum(1 for e in json.loads(data)["traceEvents"]
               if e.get("cat") == "kernel")


class ThreadRing:
    """(a): back-to-back CUDA-only windows started, stopped and exported
    on this ring's own thread."""

    def __init__(self, window_s, scratch, probe):
        self.windows: list[dict] = []
        self.last_bytes: list[bytes] = []
        self._window_s, self._scratch, self._probe = window_s, scratch, probe
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        path = os.path.join(self._scratch, "thread.pt.trace.json")
        while not self._stop.is_set():
            prof = profile(activities=[ProfilerActivity.CUDA])
            t0 = time.perf_counter()
            prof.start()
            t1 = time.perf_counter()
            self._stop.wait(self._window_s)
            t2 = time.perf_counter()
            prof.stop()
            t3 = time.perf_counter()
            data, export_ms = _export(prof, path)
            t4 = time.perf_counter()
            self.windows.append({
                "start_ms": (t1 - t0) * 1e3, "stop_ms": (t3 - t2) * 1e3,
                "export_ms": export_ms, "bytes": len(data),
                "kernels": _kernels(data),
                "gil_wait_in_stop_ms": self._probe.max_wait_ms(t2, t3),
                "gil_wait_in_export_ms": self._probe.max_wait_ms(t3, t4)})
            self.last_bytes = (self.last_bytes + [data])[-3:]

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)


class StepRing:
    """(b): windows started and stopped in the training loop, between
    two steps, and exported on this ring's thread."""

    def __init__(self, window_s, scratch, activities, sequential=False):
        self.windows: list[dict] = []
        self._window_s, self._activities = window_s, activities
        self._sequential = sequential
        self._exported = threading.Event()
        self._exported.set()
        self._prof = None
        self._deadline = 0.0
        self._start_ms = 0.0
        self._todo: queue.Queue = queue.Queue()
        self._path = os.path.join(scratch, "step.pt.trace.json")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def on_step(self):
        now = time.perf_counter()
        if self._prof is not None:
            if now < self._deadline:
                return
            t0 = time.perf_counter()
            self._prof.stop()
            stop_ms = (time.perf_counter() - t0) * 1e3
            self._exported.clear()
            self._todo.put((self._prof, self._start_ms, stop_ms))
            self._prof = None
        if self._sequential and not self._exported.is_set():
            return
        self._prof = profile(activities=self._activities)
        t0 = time.perf_counter()
        self._prof.start()
        t1 = time.perf_counter()
        self._start_ms = (t1 - t0) * 1e3
        self._deadline = t1 + self._window_s

    def _run(self):
        while True:
            item = self._todo.get()
            if item is None:
                return
            prof, start_ms, stop_ms = item
            data, export_ms = _export(prof, self._path)
            self.windows.append({
                "start_ms": start_ms, "stop_ms": stop_ms,
                "export_ms": export_ms, "bytes": len(data),
                "kernels": _kernels(data)})
            self._exported.set()

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
        self._todo.put(None)
        self._thread.join(timeout=120)


def train_round(step_fn, tokens, seconds, on_step=None):
    """Trains for `seconds`; returns (steps, ms/step). Every step reads
    its loss back, as the flagship loop does."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        float(step_fn(tokens))
        steps += 1
        if on_step is not None:
            on_step()
    torch.cuda.synchronize()
    return steps, (time.perf_counter() - t0) * 1e3 / steps


def _median(xs):
    return round(statistics.median(xs), 3) if xs else None


def measure_upload(daemon_bin, windows):
    """Streams each window into a retro ring as JSON and gzipped (level
    1); returns the medians of bytes, gzip ms and upload ms."""
    store = tempfile.mkdtemp(prefix="retro_design_store_")
    sock = tempfile.mkdtemp(prefix="rd_")
    os.environ["DYNOLOG_TPU_SOCKET_DIR"] = sock
    proc = subprocess.Popen(
        [str(daemon_bin), "--port", "0", "--kernel_monitor_interval_s",
         "3600", "--tpu_monitor_interval_s", "3600",
         "--storage_dir", store, "--retro_window_ms", "500",
         "--retro_ring_windows", "64", "--trace_stream_max_mb", "1024"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    out = {"json_bytes": [], "json_upload_ms": [], "gzip_bytes": [],
           "gzip_ms": [], "gzip_upload_ms": [], "failed": 0}
    try:
        m, buf = wait_for_stderr(proc, r"rpc: listening on port (\d+)")
        if m is None:
            raise RuntimeError(f"daemon did not start: {buf[-2000:]}")
        threading.Thread(target=proc.stderr.read, daemon=True).start()
        fabric = FabricClient()
        seq = 0
        try:
            for data in windows:
                t0 = time.perf_counter()
                packed = gzip.compress(data, compresslevel=1)
                out["gzip_ms"].append((time.perf_counter() - t0) * 1e3)
                for kind, payload in (("json", data), ("gzip", packed)):
                    t0 = time.perf_counter()
                    ok = fabric.upload_retro(
                        "retro_design", os.getpid(), seq, 1, 2, payload,
                        timeout_s=60.0) is not None
                    ms = (time.perf_counter() - t0) * 1e3
                    seq += 1
                    out["failed"] += not ok
                    out[f"{kind}_bytes"].append(len(payload))
                    out[f"{kind}_upload_ms"].append(ms)
        finally:
            fabric.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(sock, ignore_errors=True)
    return {k: (v if k == "failed" else _median(v)) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--round-s", type=float, default=4.0)
    ap.add_argument("--window-ms", type=int, default=500)
    ap.add_argument("--sides", default=",".join(SIDES),
                    help="comma-separated subset of " + ",".join(SIDES))
    ap.add_argument("--daemon", default=None,
                    help="dynolog_tpu_daemon binary: time the upload too")
    args = ap.parse_args(argv)
    sides = tuple(x for x in args.sides.split(",") if x)
    if not set(sides) <= set(SIDES):
        ap.error(f"--sides: unknown side in {args.sides!r}")
    # A crash in the profiler shows every thread's Python stack.
    faulthandler.enable()
    if not torch.cuda.is_available():
        print("torch_retro_design: CUDA is not available", file=sys.stderr)
        return 1
    card = _card_line()
    print(card, flush=True)
    _, _, step_fn = make_train_step(
        FLAGSHIP, device="cuda", generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(
        0, FLAGSHIP.vocab_size, (BATCH, SEQ),
        generator=torch.Generator().manual_seed(1)).cuda()
    window_s = args.window_ms / 1000.0
    scratch = tempfile.mkdtemp(prefix="retro_design_")
    probe = GilProbe()
    results = {side: {"ms_per_step": [], "steps": [], "windows": [],
                      "extra_ms_per_window": []} for side in sides}
    last_thread_windows: list[bytes] = []
    try:
        train_round(step_fn, tokens, 2.0)
        # The first profiler start in a process sets up CUPTI (seconds);
        # pay it for both threads before the rounds.
        for acts in ([ProfilerActivity.CUDA],
                     [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            prof = profile(activities=acts)
            prof.start()
            float(step_fn(tokens))
            prof.stop()
        for r in range(args.rounds):
            k = r % len(sides)
            for side in sides[k:] + sides[:k]:
                ring = None
                if side == "thread":
                    ring = ThreadRing(window_s, scratch, probe)
                    on_step = None
                elif side != "off":
                    acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
                            if side == "step" else [ProfilerActivity.CUDA])
                    ring = StepRing(window_s, scratch, acts,
                                    sequential=side == "step_seq")
                    on_step = ring.on_step
                else:
                    on_step = None
                steps, ms = train_round(step_fn, tokens, args.round_s,
                                        on_step)
                res = results[side]
                res["ms_per_step"].append(ms)
                res["steps"].append(steps)
                if ring is not None:
                    ring.close()
                    res["windows"].extend(ring.windows)
                    res.setdefault("windows_per_round", []).append(
                        len(ring.windows))
                    if side == "thread":
                        last_thread_windows = ring.last_bytes
            # Extra training time per window against this round's "off"
            # (every side of a round runs after or before it, in turn).
            for side in sides:
                res = results[side]
                if side == "off" or "off" not in sides:
                    continue
                n_win = res["windows_per_round"][-1]
                if n_win:
                    res["extra_ms_per_window"].append(
                        (res["ms_per_step"][-1] - results["off"][
                            "ms_per_step"][-1]) * res["steps"][-1] / n_win)
    finally:
        probe.close()
        shutil.rmtree(scratch, ignore_errors=True)

    summary = {"card": card, "window_ms": args.window_ms,
               "rounds": args.rounds, "round_s": args.round_s}
    off_med = (statistics.median(results["off"]["ms_per_step"])
               if "off" in sides else None)
    for side in sides:
        res = results[side]
        wins = res["windows"]
        line = {
            "side": side,
            "ms_per_step_median": _median(res["ms_per_step"]),
            "ms_per_step_rounds": [round(x, 3) for x in res["ms_per_step"]],
            "windows": len(wins),
        }
        if off_med:
            line["vs_off_pct"] = round(100 * (statistics.median(
                res["ms_per_step"]) - off_med) / off_med, 3)
        if wins:
            for key in wins[0]:
                line[f"{key}_median"] = _median([w[key] for w in wins])
            line["stop_ms_max"] = round(max(w["stop_ms"] for w in wins), 3)
            line["extra_train_ms_per_window_median"] = _median(
                res["extra_ms_per_window"])
            line["training_thread_stall_ms_per_window"] = (
                _median([w["start_ms"] + w["stop_ms"] for w in wins])
                if side != "thread" else _median(res["extra_ms_per_window"]))
        print(json.dumps(line), flush=True)
        summary[side] = line
    if args.daemon and last_thread_windows:
        up = measure_upload(args.daemon, last_thread_windows)
        print(json.dumps({"upload_of_thread_windows": up}), flush=True)
        summary["upload"] = up
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
