"""Mixture-of-experts observed workload: expert parallelism (ep), in
PyTorch (counterpart of ``dynolog_tpu/models/moe.py``).

The same capacity-free top-1 "switch" layer in dense-dispatch form:
fp32 routing, a one-hot route from the first-index argmax, per-expert
MLPs batched over the expert dim, and the output scaled by the router's
confidence. Over a ``("data", "expert")`` mesh a rank holds E/ep
experts; tokens are sharded over ``data`` only, so every rank of an
expert group sees the same tokens, dispatches them to its own experts,
and the combine is summed over ``expert`` (the sum GSPMD inserts for the
reference's expert-sharded combine einsum).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dynolog_tpu_torch.models.train import make_sharded_workload
from dynolog_tpu_torch.models.transformer import resolve_device
from dynolog_tpu_torch.parallel.collectives import (
    all_reduce_grads,
    copy_to_group,
    reduce_from_group,
)
from dynolog_tpu_torch.parallel.mesh import axis, make_mesh, shard

MOE_AXES = ("data", "expert")


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 4096
    d_model: int = 256
    n_experts: int = 8
    d_ff: int = 512
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, **kw) -> "MoeConfig":
        base = dict(vocab_size=256, d_model=64, n_experts=4, d_ff=128)
        base.update(kw)
        return cls(**base)


def moe_mesh_shape(n_devices: int, n_experts: int) -> tuple[int, int]:
    """(data, expert): as much expert parallelism as experts and device
    count allow, the rest data parallelism."""
    expert = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0 and n_experts % cand == 0:
            expert = cand
            break
    return (n_devices // expert, expert)


def make_moe_mesh(device_type: str, n_experts: int):
    """A (data, expert) mesh over every rank of the default group."""
    return make_mesh(device_type,
                     moe_mesh_shape(dist.get_world_size(), n_experts),
                     MOE_AXES)


# The dim of each parameter sharded over ``expert`` (None: replicated).
MOE_PARAM_SPECS = {
    "embed": None,     # [V, d] replicated (small)
    "gate": None,      # [d, E] replicated: every token scores every expert
    "w1": 0,           # [E, d, f] — the ep axis
    "w2": 0,           # [E, f, d]
    "unembed": None,   # [d, V]
}


def shard_rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global [B, S] batch (tokens are sharded
    over ``data``, replicated over ``expert``)."""
    di, dn = axis(mesh, "data")
    return shard(tokens, 0, di, dn)


class MoeModel(nn.Module):
    """tokens [B, S] -> logits [B, S, V] float32 through one switch
    layer; over a mesh, this rank's experts and rows."""

    def __init__(self, cfg: MoeConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.expert_group = None
        self.ep_index, self.ep = 0, 1
        if mesh is not None:
            self.expert_group = mesh.get_group("expert")
            self.ep_index, self.ep = axis(mesh, "expert")
        d, e, f, v = cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.vocab_size
        dt = cfg.compute_dtype
        shapes = {"embed": ((v, d), dt), "gate": ((d, e), torch.float32),
                  "w1": ((e, d, f), dt), "w2": ((e, f, d), dt),
                  "unembed": ((d, v), dt)}
        with torch.no_grad():
            for name, (shape, dtype) in shapes.items():
                # normal(0.02) at full size, in the reference's order,
                # then this rank's experts.
                full = torch.empty(shape).normal_(0.0, 0.02,
                                                  generator=generator)
                setattr(self, name, nn.Parameter(shard(
                    full, MOE_PARAM_SPECS[name], self.ep_index,
                    self.ep).to(dtype).contiguous()))
        self.to(resolve_device(device))

    def _route(self, x):
        """Top-1 routing: scores in fp32, the first-index argmax, and the
        router's confidence in it. x: [B,S,d] -> (top, weight) [B,S]."""
        scores = torch.softmax(x.float() @ self.gate, dim=-1)  # [B,S,E]
        top = scores.argmax(dim=-1)
        return top, scores.gather(-1, top[..., None])[..., 0]

    def routes(self, tokens: torch.Tensor) -> torch.Tensor:
        """The expert each token of ``tokens`` [B,S] goes to."""
        return self._route(F.embedding(tokens, self.embed))[0]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens, self.embed)  # [B,S,d]
        # Dispatch as a one-hot so every shape is static; the router's
        # confidence scales the expert output.
        top, weight = self._route(x)
        route = F.one_hot(top, cfg.n_experts).to(x.dtype)
        n_loc = cfg.n_experts // self.ep
        route = route[..., self.ep_index * n_loc:(self.ep_index + 1) * n_loc]
        xe = x
        if self.expert_group is not None:
            xe = copy_to_group(x, self.expert_group)
        expert_in = torch.einsum("bse,bsd->ebsd", route, xe)
        hidden = F.gelu(torch.einsum("ebsd,edf->ebsf", expert_in, self.w1),
                        approximate="tanh")  # jax.nn.gelu's default
        expert_out = torch.einsum("ebsf,efd->ebsd", hidden, self.w2)
        y = torch.einsum("ebsd,bse->bsd", expert_out, route)
        if self.expert_group is not None:
            y = reduce_from_group(y, self.expert_group)
        y = y * weight[..., None].to(y.dtype)
        return ((x + y) @ self.unembed).float()


def moe_loss(model: MoeModel, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of the global batch ``tokens``, the mean
    over all B*(S-1) positions on every rank."""
    rows = tokens if model.mesh is None else shard_rows(tokens, model.mesh)
    logp = torch.log_softmax(model(rows)[:, :-1], dim=-1)
    total = -logp.gather(-1, rows[:, 1:, None]).sum()
    if model.mesh is not None:
        total = reduce_from_group(total, model.mesh.get_group("data"))
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))


@torch.no_grad()
def load_jax_moe_params(model: MoeModel, params) -> MoeModel:
    """Copies the JAX package's ``init_moe_params`` tree into ``model``,
    this rank's experts of ``w1``/``w2``."""
    for name, dim in MOE_PARAM_SPECS.items():
        src = shard(np.asarray(params[name], np.float32), dim,
                    model.ep_index, model.ep)
        dst = getattr(model, name)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    return model


def make_moe_workload(cfg: MoeConfig, mesh,
                      device: str | torch.device = "cuda",
                      generator: torch.Generator | None = None,
                      lr: float = 3e-4):
    """(model, optimizer, ``step(tokens) -> loss``) over a (data,
    expert) mesh; gradients summed over ``data`` (experts differ over
    ``expert``, and the replicated parameters already hold their full
    gradient there)."""
    model = MoeModel(cfg, device=device, generator=generator, mesh=mesh)
    data = mesh.get_group("data")
    optimizer, step = make_sharded_workload(
        model, moe_loss,
        lambda: all_reduce_grads(model.parameters(), [data]), lr=lr)
    return model, optimizer, step
