#!/usr/bin/env python3
"""Can NCCL put more than one rank on one GPU?

    python3 scripts/nccl_one_card_probe.py [--ranks 2,4] [--timeout-s 120]

For each rank count, starts that many processes, every one on cuda:0,
joins them into one NCCL process group (a FileStore in a temp dir), and
runs an all-reduce, a ring of batched send/recv and an all-to-all. Prints
one JSON line per rank count: whether every rank finished, and each
rank's error where one failed. Exits 0 whatever NCCL answered; 1 when
CUDA is absent.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    result = {"rank": rank, "ok": False}
    try:
        torch.cuda.set_device(0)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "nccl", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60),
            device_id=torch.device("cuda", 0))
        x = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        result["all_reduce"] = float(x[0])
        send = torch.full((1024,), float(rank), device="cuda")
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        result["ring_recv"] = float(recv[0])
        a2a_in = torch.arange(world * 4, dtype=torch.float32,
                              device="cuda") + 100 * rank
        a2a_out = torch.empty_like(a2a_in)
        dist.all_to_all_single(a2a_out, a2a_in)
        result["all_to_all"] = a2a_out.tolist()[::4]
        torch.cuda.synchronize()
        dist.destroy_process_group()
        result["ok"] = True
    except Exception as e:  # reported to the parent as data
        result["error"] = f"{type(e).__name__}: {e}"[-2000:]
        result["traceback"] = traceback.format_exc()[-2000:]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def probe(world: int, timeout_s: float) -> dict:
    tmp = tempfile.mkdtemp(prefix="nccl_probe_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank,
                         args=(r, world, os.path.join(tmp, "store"), tmp))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        ranks = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
            else:
                ranks.append({"rank": r, "ok": False,
                              "error": "no result (hung or crashed)",
                              "exitcode": procs[r].exitcode})
        return {"world": world, "device": "cuda:0 for every rank",
                "accepted": all(x["ok"] for x in ranks), "hung": hung,
                "ranks": ranks}
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="2,4")
    ap.add_argument("--timeout-s", type=float, default=120)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nccl_one_card_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "device_count": torch.cuda.device_count()}),
          flush=True)
    for world in (int(w) for w in args.ranks.split(",")):
        print(json.dumps(probe(world, args.timeout_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
