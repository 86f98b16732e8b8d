"""n ranks of ``torch.distributed`` on one host (counterpart of
``dynolog_tpu/utils/cpumesh.py``).

The JAX package gets an n-device mesh on the CPU from XLA's virtual host
devices; the port gets one from n processes. ``run_cpu_mesh`` starts n
gloo ranks on the CPU (the tests and ``entry.dryrun_multichip(n,
device="cpu")``); ``run_ranks`` with ``backend="nccl"`` starts one rank
per GPU (NCCL refuses two ranks on one GPU: "Duplicate GPU detected").

The ranks are spawned (never forked: the parent may hold threads), meet
at a FileStore in a fresh temp dir (no TCP port to race for), and each
returns ``fn(*args)`` with every tensor in it turned into numpy. ``fn``
must be importable by the child: a module-level function of a module
that does not import JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def to_numpy(obj):
    """Tensors anywhere in dicts, lists and tuples -> numpy arrays."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _rank_main(rank, world, backend, store_dir, timeout_s):
    try:
        torch.set_num_threads(1)
        if backend == "gloo":
            # CPU ranks stand in for devices: they yield the host's cores
            # to everything else that runs beside them (a test suite's
            # timing-sensitive neighbours, the caller's own threads).
            os.nice(19)
        with open(os.path.join(store_dir, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
        try:
            result = to_numpy(fn(*args))
        finally:
            dist.destroy_process_group()
    except Exception:  # handed to the parent, which raises it
        _write(os.path.join(store_dir, f"rank{rank}.err"),
               traceback.format_exc().encode())
        return
    _write(os.path.join(store_dir, f"rank{rank}.pkl"), pickle.dumps(result))


def _write(path, data: bytes) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def run_ranks(n: int, fn, *args, backend: str = "gloo",
              timeout_s: float = 120.0) -> list:
    """Runs ``fn(*args)`` on ranks 0..n-1 of a new world and returns
    their results in rank order. Raises RuntimeError with every failed
    rank's traceback, and TimeoutError when a rank has not finished
    within ``timeout_s`` and none failed; every rank is gone when it
    returns."""
    if backend == "nccl" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"{n} NCCL ranks need {n} GPUs; {torch.cuda.device_count()} "
            "visible (NCCL puts no two ranks on one GPU)")
    store_dir = tempfile.mkdtemp(prefix="dtm")
    path = lambda r, ext: os.path.join(store_dir, f"rank{r}.{ext}")
    # The job goes through a file: through the spawn pipe, each start()
    # would wait for its child to import torch before the next began.
    _write(os.path.join(store_dir, "job.pkl"), pickle.dumps((fn, args)))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, backend, store_dir, timeout_s))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        # Wait for every rank, or stop at the first that failed: the
        # others would wait on it in a collective until their timeout.
        deadline = time.monotonic() + timeout_s
        failed = False
        while time.monotonic() < deadline:
            failed = any(p.exitcode not in (None, 0) for p in procs) or any(
                os.path.exists(path(r, "err")) for r in range(n))
            if failed or not any(p.is_alive() for p in procs):
                break
            time.sleep(0.05)
        results, errors = [], []
        for r, p in enumerate(procs):
            if os.path.exists(path(r, "err")):
                with open(path(r, "err")) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif os.path.exists(path(r, "pkl")):
                with open(path(r, "pkl"), "rb") as f:
                    results.append(pickle.load(f))
            else:
                errors.append(f"rank {r}: no result ("
                              + ("still running" if p.is_alive()
                                 else f"exit code {p.exitcode}") + ")")
        if errors:
            cls = RuntimeError if failed else TimeoutError
            raise cls(f"{fn.__name__} on {n} {backend} ranks failed:\n"
                      + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)


def run_cpu_mesh(n: int, fn, *args, timeout_s: float = 120.0) -> list:
    """``fn(*args)`` on n gloo ranks on the CPU, one thread each, at the
    lowest scheduling priority."""
    return run_ranks(n, fn, *args, backend="gloo", timeout_s=timeout_s)
