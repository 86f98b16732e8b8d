"""Rank programs that run the parallel workloads on given weights and
tokens and hand back numpy results, for holding them to the JAX package.

Each function runs on every rank of a world that ``utils.cpumesh``
started (the ranks import this module, never a test module, which
imports JAX), builds its meshes over that world, and returns this
rank's results. Inputs are numpy arrays: the JAX package's parameter
trees and a seed's tokens. ``device`` is where the rank computes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dynolog_tpu_torch.models import moe, pipeline
from dynolog_tpu_torch.models import train
from dynolog_tpu_torch.models import transformer as tf
from dynolog_tpu_torch.parallel.collectives import all_reduce_grads
from dynolog_tpu_torch.parallel.mesh import axis, make_mesh
from dynolog_tpu_torch.parallel.ring_attention import ring_attention

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def ring_case(q, k, v, cot, sizes, device="cpu") -> dict:
    """Ring attention on the first n ranks for each n in ``sizes``, of
    the global q, k, v [B, S, H, D]; each rank takes its sequence block.
    Returns {n: {"out", "dq", "dk", "dv"}} of this rank's block, the
    gradients those of sum(out * cot)."""
    rank = dist.get_rank()
    out = {}
    for n in sizes:
        group = dist.new_group(list(range(n)))
        if rank >= n:
            continue
        s = q.shape[1] // n
        blk = lambda a: torch.from_numpy(
            np.ascontiguousarray(a[:, rank * s:(rank + 1) * s])).to(device)
        qb, kb, vb = (blk(a).requires_grad_() for a in (q, k, v))
        o = ring_attention(qb, kb, vb, group)
        (o * blk(cot)).sum().backward()
        out[n] = {"out": o, "dq": qb.grad, "dk": kb.grad, "dv": vb.grad}
    return out


def flagship_case(cfg_kw, params, tokens, shape, steps,
                  device="cpu") -> dict:
    """The flagship over a (data, seq, model) mesh of ``shape`` with the
    JAX tree ``params`` loaded: the sharded loss of ``tokens`` in fp32
    and bf16, the fp32 gradients after the data/seq sum (this rank's
    shards, by parameter name), and the losses of ``steps`` train
    steps."""
    mesh = make_mesh(device, shape)
    tok = torch.from_numpy(tokens).long().to(device)
    out = {"model_index": axis(mesh, "model")[0]}
    for name, dt in DTYPES.items():
        cfg = tf.ModelConfig.tiny(compute_dtype=dt, seq_axis="seq", **cfg_kw)
        model = tf.load_jax_params(
            tf.Transformer(cfg, device=device, mesh=mesh), params)
        loss = train.sharded_loss_fn(model, tok)
        out[f"loss_{name}"] = loss
        if name == "fp32":
            loss.backward()
            all_reduce_grads(model.parameters(), [mesh.get_group("data"),
                                                  mesh.get_group("seq")])
            out["grads"] = _grads(model)
    cfg = tf.ModelConfig.tiny(compute_dtype=torch.float32, seq_axis="seq",
                              **cfg_kw)
    model, _, step = train.make_sharded_train_step(cfg, mesh, device)
    tf.load_jax_params(model, params)
    out["steps"] = [float(step(tok)) for _ in range(steps)]
    return out


def moe_case(params, tokens, steps, device="cpu") -> dict:
    """The tiny MoE over ``make_moe_mesh``'s (data, expert) mesh: per
    dtype, this
    rank's logits of its rows of ``tokens``, its routes and the loss;
    in fp32 also the gradients (this rank's shards, after the data sum);
    then the losses of ``steps`` train steps in bf16."""
    mesh = moe.make_moe_mesh(device, moe.MoeConfig.tiny().n_experts)
    tok = torch.from_numpy(tokens).long().to(device)
    out = {"expert_index": axis(mesh, "expert")[0],
           "data_index": axis(mesh, "data")[0],
           "mesh": tuple(mesh.mesh.shape)}
    for name, dt in DTYPES.items():
        cfg = moe.MoeConfig.tiny(compute_dtype=dt)
        model = moe.load_jax_moe_params(
            moe.MoeModel(cfg, device=device, mesh=mesh), params)
        rows = moe.shard_rows(tok, mesh)
        out[f"logits_{name}"] = model(rows)
        out[f"top_{name}"] = model.routes(rows)
        loss = moe.moe_loss(model, tok)
        out[f"loss_{name}"] = loss
        if name == "fp32":
            loss.backward()
            all_reduce_grads(model.parameters(), [mesh.get_group("data")])
            out["grads"] = _grads(model)
    cfg = moe.MoeConfig.tiny()
    model, _, step = moe.make_moe_workload(cfg, mesh, device)
    moe.load_jax_moe_params(model, params)
    out["steps"] = [float(step(tok)) for _ in range(steps)]
    return out


def pipe_case(params, tokens, cfg_kw, step_cfg_kw, step_tokens, steps,
              device="cpu") -> dict:
    """The tiny pipeline of ``cfg_kw`` over ``make_pipe_mesh``: per dtype,
    this rank's logits (the rows ``pipe_rows`` names) and the loss; in
    fp32 also the gradients (this rank's shards, after the sync). Then
    the losses of ``steps`` bf16 train steps of ``step_tokens`` with
    ``step_cfg_kw``, from a seeded init."""
    mesh = pipeline.make_pipe_mesh(device, cfg_kw["n_stages"])
    tok = torch.from_numpy(tokens).long().to(device)
    out = {"stage": axis(mesh, "pipe")[0]}
    for name, dt in DTYPES.items():
        cfg = pipeline.PipeConfig.tiny(compute_dtype=dt, **cfg_kw)
        model = pipeline.load_jax_pipe_params(
            pipeline.PipeModel(cfg, device=device, mesh=mesh), params)
        out["rows"] = pipeline.pipe_rows(tok.shape[0], cfg, mesh)
        out[f"logits_{name}"] = model(tok)
        loss = pipeline.pipe_loss(model, tok)
        out[f"loss_{name}"] = loss
        if name == "fp32":
            loss.backward()
            model.sync_grads()
            out["grads"] = _grads(model)
    cfg = pipeline.PipeConfig.tiny(**step_cfg_kw)
    step_mesh = pipeline.make_pipe_mesh(device, cfg.n_stages)
    out["step_mesh"] = tuple(step_mesh.mesh.shape)
    _, _, step = pipeline.make_pipe_workload(
        cfg, step_mesh, device, torch.Generator().manual_seed(6))
    big = torch.from_numpy(step_tokens).long().to(device)
    out["steps"] = [float(step(big)) for _ in range(steps)]
    return out


def run_cases(cases) -> list:
    """Runs each (function, args) of ``cases`` in turn on this rank, so
    one world serves many cases."""
    return [fn(*args) for fn, args in cases]
