"""Entry points of the port (counterpart of ``__graft_entry__.py``).

``entry(device)`` — the single-device forward step of the flagship
workload at the reference's ``entry()`` configuration, as (fn, args).
``dryrun_multichip(n, device)`` — one full sharded train step of each
parallel workload on n ranks, at tiny shapes: the flagship transformer
on a dp x sp x tp mesh (ring attention over the seq axis), the MoE
workload on a dp x ep mesh, and the pipeline on a pp x dp mesh. With
``device="cpu"`` the ranks are gloo processes on the CPU; with CUDA they
are NCCL processes, one per GPU (NCCL puts no two ranks on one GPU), and
it raises when there are not n GPUs.

    python -m dynolog_tpu_torch.entry [--device cpu] [-n 8]
"""

from __future__ import annotations

import argparse
import math

import torch
import torch.distributed as dist

from dynolog_tpu_torch.models import moe, pipeline
from dynolog_tpu_torch.models.train import make_sharded_train_step
from dynolog_tpu_torch.models.transformer import (
    ModelConfig,
    Transformer,
    resolve_device,
)
from dynolog_tpu_torch.parallel.mesh import axis, make_mesh
from dynolog_tpu_torch.utils.cpumesh import run_ranks

ENTRY_CONFIG = ModelConfig(vocab_size=4096, d_model=256, n_layers=4,
                           n_heads=8, d_ff=704, max_seq_len=512)


def _forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return model(tokens)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args) for a single-device forward step."""
    model = Transformer(ENTRY_CONFIG, device=device,
                        generator=torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 256), dtype=torch.long,
                         device=model.embed.device)
    return _forward, (model, tokens)


def _dryrun_rank(device_type: str) -> dict:
    """One sharded step of each workload on this rank; their losses."""
    n = dist.get_world_size()
    gen = lambda seed: torch.Generator().manual_seed(seed)
    mesh = make_mesh(device_type)
    data, seq, model = (axis(mesh, a)[1] for a in ("data", "seq", "model"))
    cfg = ModelConfig.tiny(
        seq_axis="seq" if seq > 1 else None,
        # head and ff dims divisible by the model axis
        n_heads=max(4, model * 2))
    _, _, step = make_sharded_train_step(cfg, mesh, device_type, gen(0))
    tokens = torch.zeros((2 * data, 64 * seq), dtype=torch.long,
                         device=device_type)
    losses = {"flagship": float(step(tokens))}

    # Expert parallelism: the MoE workload on a (data, expert) mesh.
    moe_cfg = moe.MoeConfig.tiny()
    moe_mesh = moe.make_moe_mesh(device_type, moe_cfg.n_experts)
    _, _, moe_step = moe.make_moe_workload(moe_cfg, moe_mesh, device_type,
                                           gen(1))
    moe_tokens = torch.zeros((2 * axis(moe_mesh, "data")[1], 32),
                             dtype=torch.long, device=device_type)
    losses["moe"] = float(moe_step(moe_tokens))

    # Pipeline parallelism: the pp workload on a (pipe, data) mesh.
    n_stages = 2 if n % 2 == 0 else 1
    pipe_cfg = pipeline.PipeConfig.tiny(n_stages=n_stages, n_microbatches=2)
    pipe_mesh = pipeline.make_pipe_mesh(device_type, n_stages)
    _, _, pipe_step = pipeline.make_pipe_workload(pipe_cfg, pipe_mesh,
                                                  device_type, gen(2))
    pipe_tokens = torch.zeros((2 * axis(pipe_mesh, "data")[1], 32),
                              dtype=torch.long, device=device_type)
    losses["pipe"] = float(pipe_step(pipe_tokens))
    return losses


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout_s: float = 300.0) -> dict:
    """Runs ONE full sharded train step of each workload on n ranks and
    returns rank 0's losses; raises if a rank fails or a loss is not
    finite."""
    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    per_rank = run_ranks(n_devices, _dryrun_rank, dev.type, backend=backend,
                         timeout_s=timeout_s)
    for rank, losses in enumerate(per_rank):
        bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"rank {rank}: non-finite loss {bad}")
    return per_rank[0]


def main() -> None:
    ap = argparse.ArgumentParser(description="forward step + dryrun")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-n", type=int, default=8)
    args = ap.parse_args()
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), out.dtype)
    losses = dryrun_multichip(args.n, args.device)
    print(f"dryrun ok: {args.n} ranks, losses {losses}")


if __name__ == "__main__":
    main()
