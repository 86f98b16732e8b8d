#!/usr/bin/env python3
"""Where the on-demand stop call's time goes, and what the shim's
retired profiler sessions cost while they stay alive.

    python3 scripts/stop_call_probe.py cell --out DIR [--tree TREE] \
        -- --cell olmo1b_ondemand_trace --seed 0
    python3 scripts/stop_call_probe.py cpu-loop [--captures 30]

``cell`` runs ``TREE/benchmark/run.py`` (by default this checkout's)
with the arguments after ``--``, unchanged, in this process, and
records for every stop of the shim's profiler on the training thread
(``DynologClient._stop_trace``): its wall time; the shim's
``torch.profiler.profile`` sessions still alive at the stop (weakrefs
taken as each starts) and the inner ``torch.autograd.profiler.profile``
sessions holding Kineto's results; RSS before and after; the thread's
``getrusage`` deltas (minor and major faults, user and system time,
context switches); ``torch.cuda.synchronize()``'s time inside the stop;
and Kineto's disable, ``profiler_disable_call_duration_us``. It also
records every collector pass (``gc.callbacks``: it observes and
collects nothing), every ``_finish_trace`` and, where the tree's shim
has it, every ``_end_session``. Prints a ``diag:`` line per stop and
writes ``DIR/diag.json``; exits with the runner's code. To probe
another commit, unpack it (``git archive``) and pass it as ``--tree``.

``cpu-loop`` runs N CPU captures of the port's tiny train step (each a
torch.profiler session over 10 steps, exported as Chrome JSON) in two
fresh processes: one drops each session as the shim did before it ended
sessions, one ends each with the shim's ``_end_session``. The collector
stays on, as in a job. Prints one JSON line a mode: RSS growth over the
loop, the stop calls, the trace size, and the collector's full passes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import resource
import subprocess
import sys
import tempfile
import threading
import time
import weakref

REPO = pathlib.Path(__file__).resolve().parents[1]
PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE / 1e6


class Probe:
    """The records of one run, and the wrappers that take them."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.outer, self.inner = [], []  # (weakref, started by the shim)
        self.stops, self.gcs, self.finishes, self.releases = [], [], [], []
        self._gc_open = {}
        self._tl = threading.local()

    def now(self) -> float:
        return round(time.monotonic() - self.t0, 4)

    def alive(self, refs, shim=True) -> int:
        return sum(1 for w, by_shim in refs
                   if by_shim == shim and w() is not None)

    def on_gc(self, phase, info):
        tid = threading.get_native_id()
        if phase == "start":
            self._gc_open[tid] = (time.monotonic(), rss_mb())
            return
        t, rss = self._gc_open.pop(tid, (time.monotonic(), 0.0))
        self.gcs.append({
            "t": round(t - self.t0, 4),
            "ms": round((time.monotonic() - t) * 1e3, 3),
            "gen": info.get("generation"),
            "collected": info.get("collected"),
            "thread": threading.current_thread().name,
            "rss_before_mb": round(rss, 1),
            "rss_after_mb": round(rss_mb(), 1)})

    def install(self, torch, shim):
        import gc
        gc.callbacks.append(self.on_gc)
        probe = self
        real_start = torch.profiler.profile.start

        def start(prof):
            real_start(prof)
            by_shim = sys._getframe(1).f_code.co_filename.endswith("shim.py")
            probe.outer.append((weakref.ref(prof), by_shim))
            if getattr(prof, "profiler", None) is not None:
                probe.inner.append((weakref.ref(prof.profiler), by_shim))

        torch.profiler.profile.start = start
        real_sync = torch.cuda.synchronize

        def sync(*a, **k):
            t = time.perf_counter()
            out = real_sync(*a, **k)
            if getattr(probe._tl, "in_stop", False):
                probe._tl.sync_ms += (time.perf_counter() - t) * 1e3
            return out

        torch.cuda.synchronize = sync
        real_stop = shim.DynologClient._stop_trace

        def stop_trace(client):
            probe.record_stop(client, real_stop)

        shim.DynologClient._stop_trace = stop_trace
        real_finish = shim.DynologClient._finish_trace

        def finish_trace(client):
            t = time.perf_counter()
            real_finish(client)
            probe.finishes.append({
                "t": probe.now(),
                "ms": round((time.perf_counter() - t) * 1e3, 3),
                "alive_outer": probe.alive(probe.outer),
                "alive_inner": probe.alive(probe.inner),
                "rss_mb": round(rss_mb(), 1)})

        shim.DynologClient._finish_trace = finish_trace
        if hasattr(shim, "_end_session"):
            real_end = shim._end_session

            def end_session(prof):
                t = time.perf_counter()
                real_end(prof)
                probe.releases.append({
                    "t": probe.now(),
                    "thread": threading.current_thread().name,
                    "ms": round((time.perf_counter() - t) * 1e3, 3)})

            shim._end_session = end_session

    def record_stop(self, client, real_stop):
        import gc
        prof = client._prof
        before = {"alive_outer": self.alive(self.outer),
                  "alive_inner": self.alive(self.inner),
                  "alive_other_inner": self.alive(self.inner, shim=False),
                  "gc_count": gc.get_count(),
                  "gc_passes_before": len(self.gcs),
                  "gen2_before": sum(1 for g in self.gcs if g["gen"] == 2)}
        r0 = resource.getrusage(resource.RUSAGE_THREAD)
        p0 = resource.getrusage(resource.RUSAGE_SELF)
        rss0 = rss_mb()
        self._tl.in_stop, self._tl.sync_ms = True, 0.0
        t_start = self.now()
        t0 = time.perf_counter()
        try:
            real_stop(client)
        finally:
            t1 = time.perf_counter()
            self._tl.in_stop = False
        r1 = resource.getrusage(resource.RUSAGE_THREAD)
        p1 = resource.getrusage(resource.RUSAGE_SELF)
        stats = getattr(getattr(prof, "profiler", None), "_stats", None)
        disable_us = getattr(stats, "profiler_disable_call_duration_us", None)
        n_gc = before["gc_passes_before"]
        row = {
            "i": len(self.stops), "t": t_start,
            "dir": client._last_trace_dir,
            "stop_ms": round((t1 - t0) * 1e3, 3),
            "sync_ms": round(self._tl.sync_ms, 3),
            "disable_ms": None if disable_us is None else disable_us / 1e3,
            **before,
            "rss_mb": round(rss0, 1), "rss_after_mb": round(rss_mb(), 1),
            "minflt": r1.ru_minflt - r0.ru_minflt,
            "majflt": r1.ru_majflt - r0.ru_majflt,
            "proc_minflt": p1.ru_minflt - p0.ru_minflt,
            "utime_ms": round((r1.ru_utime - r0.ru_utime) * 1e3, 1),
            "stime_ms": round((r1.ru_stime - r0.ru_stime) * 1e3, 1),
            "nvcsw": r1.ru_nvcsw - r0.ru_nvcsw,
            "nivcsw": r1.ru_nivcsw - r0.ru_nivcsw,
            "gc_during": self.gcs[n_gc:],
        }
        self.stops.append(row)
        print(f"diag: stop {row['i']} {row['stop_ms']:.1f} ms sync "
              f"{row['sync_ms']:.1f} disable {row['disable_ms']} alive "
              f"{row['alive_outer']}/{row['alive_inner']} rss "
              f"{row['rss_mb']:.0f} minflt {row['minflt']} stime "
              f"{row['stime_ms']} utime {row['utime_ms']} gen2_before "
              f"{row['gen2_before']}", flush=True)

    def dump(self, path, rc, torch_version):
        with open(path, "w") as f:
            json.dump({"rc": rc, "torch": torch_version,
                       "stops": self.stops, "gcs": self.gcs,
                       "finishes": self.finishes,
                       "releases": self.releases,
                       "sessions": [[by_shim, w() is not None]
                                    for w, by_shim in self.inner]}, f)


def run_cell(tree: pathlib.Path, out: pathlib.Path, runner_args) -> int:
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", tree / "benchmark" / "run.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    import torch
    import torch.profiler  # noqa: F401
    from dynolog_tpu_torch.client import shim
    probe = Probe()
    probe.install(torch, shim)
    rc = 1
    try:
        rc = runner.main(runner_args)
    finally:
        probe.dump(out / "diag.json", rc, torch.__version__)
    return rc


def cpu_child(mode: str, captures: int) -> None:
    """One mode of cpu-loop, in a fresh process: prints one JSON line."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dynolog_tpu_torch.client.shim import _end_session
    from dynolog_tpu_torch.models.train import make_train_step
    from dynolog_tpu_torch.models.transformer import ModelConfig

    torch.set_num_threads(1)
    full = []
    gc.callbacks.append(lambda phase, info: phase == "stop"
                        and info.get("generation") == 2 and full.append(1))
    cfg = ModelConfig.tiny(compute_dtype=torch.float32)
    _, _, step = make_train_step(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    for _ in range(3):
        float(step(tokens))
    scratch = tempfile.mkdtemp(prefix="stop_call_probe_")
    path = os.path.join(scratch, "t.pt.trace.json")
    stops, sizes = [], []
    rss0 = rss_mb()
    for _ in range(captures):
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        for _ in range(10):
            float(step(tokens))
        t = time.perf_counter()
        prof.stop()
        stops.append(round((time.perf_counter() - t) * 1e3, 1))
        prof.export_chrome_trace(path)
        sizes.append(os.path.getsize(path))
        if mode == "release":
            _end_session(prof)
        del prof
    rss1 = rss_mb()
    os.unlink(path)
    os.rmdir(scratch)
    print(json.dumps({
        "mode": mode, "captures": captures, "torch": torch.__version__,
        "rss_growth_mb": round(rss1 - rss0, 1),
        "rss_start_mb": round(rss0, 1),
        "trace_mb": round(sum(sizes) / len(sizes) / 1e6, 2),
        "stop_ms_median": sorted(stops)[len(stops) // 2],
        "stop_ms": stops, "full_collector_passes": len(full)}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cell", help="a benchmark cell under the probe")
    c.add_argument("--out", type=pathlib.Path, required=True)
    c.add_argument("--tree", type=pathlib.Path, default=REPO,
                   help="the checkout whose runner and port run")
    c.add_argument("runner_args", nargs=argparse.REMAINDER)
    loop = sub.add_parser("cpu-loop", help="CPU captures, both modes")
    loop.add_argument("--captures", type=int, default=30)
    child = sub.add_parser("cpu-child", help=argparse.SUPPRESS)
    child.add_argument("--mode", choices=("drop", "release"), required=True)
    child.add_argument("--captures", type=int, required=True)
    args = p.parse_args(argv)
    if args.cmd == "cell":
        runner_args = args.runner_args
        if runner_args[:1] == ["--"]:
            runner_args = runner_args[1:]
        return run_cell(args.tree.resolve(), args.out.resolve(),
                        runner_args)
    if args.cmd == "cpu-child":
        sys.path.insert(0, str(REPO))
        cpu_child(args.mode, args.captures)
        return 0
    for mode in ("drop", "release"):
        out = subprocess.run(
            [sys.executable, __file__, "cpu-child", "--mode", mode,
             "--captures", str(args.captures)],
            capture_output=True, text=True, timeout=900, cwd=REPO)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
