"""Pipeline-parallel observed workload: pipeline parallelism (pp), in
PyTorch (counterpart of ``dynolog_tpu/models/pipeline.py``).

The same GPipe rotation over a ``("pipe", "data")`` mesh: rank s of
``pipe`` holds stage s's MLP block, and M + P - 1 ticks move the
microbatches through the stages — at tick t every stage computes its
block on what arrived, stage 0 feeding itself from the microbatch queue,
the last stage banking finished microbatch t - (P-1), and a ring shift
by one stage after every tick. The banked outputs are summed over
``pipe`` so every rank holds them, and each microbatch's batch dim is
sharded over ``data``.

Without a mesh the model holds every stage and applies them in order:
what the pipeline is supposed to compute.
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
    reduce_from_group,
    ring_shift,
)
from dynolog_tpu_torch.parallel.mesh import axis, make_mesh, shard

PIPE_AXES = ("pipe", "data")


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    vocab_size: int = 4096
    d_model: int = 256
    d_ff: int = 512
    n_stages: int = 4
    n_microbatches: int = 4
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, **kw) -> "PipeConfig":
        base = dict(vocab_size=256, d_model=64, d_ff=128, n_stages=2,
                    n_microbatches=2)
        base.update(kw)
        return cls(**base)


def make_pipe_mesh(device_type: str, n_stages: int):
    """A (pipe, data) mesh over every rank of the default group."""
    world = dist.get_world_size()
    if world % n_stages != 0:
        raise ValueError(f"{world} ranks not divisible by {n_stages} stages")
    return make_mesh(device_type, (n_stages, world // n_stages), PIPE_AXES)


# The dim of each parameter sharded over ``pipe`` (None: replicated).
PIPE_PARAM_SPECS = {
    "embed": None,     # [V, d] replicated
    "w1": 0,           # [P, d, f] — stage-stacked
    "b1": 0,           # [P, f]
    "w2": 0,           # [P, f, d]
    "ln": 0,           # [P, d]
    "unembed": None,   # [d, V]
}
# The reference's init: biases at zero, norms at one, normal(0.02) else.
_CONST_INIT = {"b1": torch.zeros, "ln": torch.ones}


def pipe_rows(batch: int, cfg: PipeConfig, mesh) -> torch.Tensor:
    """The global rows of a [batch, S] batch this rank computes, in its
    order: for each microbatch (rows m*B/M ...), this data rank's slice
    of that microbatch's rows."""
    m = cfg.n_microbatches
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    per = batch // m
    di, dn = axis(mesh, "data") if mesh is not None else (0, 1)
    if per % dn:
        raise ValueError(f"microbatch of {per} rows not divisible by "
                         f"data axis {dn}")
    b = per // dn
    return (torch.arange(m)[:, None] * per + di * b
            + torch.arange(b)[None, :]).reshape(-1)


def _stage_block(x, w1, b1, w2, ln):
    """One pipeline stage: pre-norm MLP with residual."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    h = (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * ln
    return x + F.gelu(h @ w1 + b1, approximate="tanh") @ w2


class PipeModel(nn.Module):
    """tokens: the global [B, S] batch -> float32 logits [B_r, S, V] of
    this rank's rows (``pipe_rows``; all rows without a mesh)."""

    def __init__(self, cfg: PipeConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.stage, self.n_pipe = 0, 1
        if mesh is not None:
            self.stage, self.n_pipe = axis(mesh, "pipe")
            if self.n_pipe != cfg.n_stages:
                raise ValueError(f"mesh pipe axis {self.n_pipe} != "
                                 f"{cfg.n_stages} stages")
        d, f, s, v = cfg.d_model, cfg.d_ff, cfg.n_stages, cfg.vocab_size
        shapes = {"embed": (v, d), "w1": (s, d, f), "b1": (s, f),
                  "w2": (s, f, d), "ln": (s, d), "unembed": (d, v)}
        with torch.no_grad():
            for name, shape in shapes.items():
                if name in _CONST_INIT:
                    full = _CONST_INIT[name](shape)
                else:
                    full = torch.empty(shape).normal_(0.0, 0.02,
                                                      generator=generator)
                setattr(self, name, nn.Parameter(shard(
                    full, PIPE_PARAM_SPECS[name], self.stage,
                    self.n_pipe).to(cfg.compute_dtype).contiguous()))
        self.to(resolve_device(device))

    def _stages(self, i):
        return self.w1[i], self.b1[i], self.w2[i], self.ln[i]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        rows = pipe_rows(tokens.shape[0], cfg, self.mesh).to(tokens.device)
        x = F.embedding(tokens[rows], self.embed)  # [M*b, S, d]
        if self.mesh is None:
            for i in range(cfg.n_stages):
                x = _stage_block(x, *self._stages(i))
            return (x @ self.unembed).float()
        return (self._pipe(x) @ self.unembed).float()

    def _pipe(self, x):
        m, nstages = self.cfg.n_microbatches, self.n_pipe
        micro = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        group = self.mesh.get_group("pipe")
        flag = lambda cond: torch.tensor(cond, device=x.device)
        first, last = flag(self.stage == 0), self.stage == nstages - 1
        state = torch.zeros_like(micro[0])
        banked = [torch.zeros_like(micro[0]) for _ in range(m)]
        # Selects, not branches, as in the reference: every tick's output
        # reaches the loss on every rank (with a zero gradient where it
        # is not used), so every rank runs every shift's backward and the
        # ranks' sends and receives pair up.
        for t in range(m + nstages - 1):
            # Stage 0 feeds itself from the queue (past its end the clip
            # re-feeds the last microbatch, never banked).
            feed = micro[min(t, m - 1)]
            y = _stage_block(torch.where(first, feed, state),
                             *self._stages(0))
            # The last stage banks finished microbatch t - (P-1).
            done = min(max(t - (nstages - 1), 0), m - 1)
            banked[done] = banked[done] + torch.where(
                flag(last and t >= nstages - 1), y, torch.zeros_like(y))
            state = ring_shift(y, group)
        # Only the last stage banked; share its outputs with every pipe
        # rank (backward: identity, every rank computes the same loss).
        out = reduce_from_group(torch.stack(banked), group)
        return out.reshape(x.shape)

    def sync_grads(self) -> None:
        """Sums the gradients over ``data``; the embedding's also over
        ``pipe``, since only stage 0 uses it. The stage weights differ
        over ``pipe``, and the unembedding already holds its full
        gradient on every pipe rank."""
        data, pipe = self.mesh.get_group("data"), self.mesh.get_group("pipe")
        all_reduce_grads([self.embed], [data, pipe])
        all_reduce_grads([p for n, p in self.named_parameters()
                          if n != "embed"], [data])


def pipe_loss(model: PipeModel, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of the global batch ``tokens``, the mean
    over all B*(S-1) positions on every rank."""
    rows = pipe_rows(tokens.shape[0], model.cfg, model.mesh)
    mine = tokens[rows.to(tokens.device)]
    logp = torch.log_softmax(model(tokens)[:, :-1], dim=-1)
    total = -logp.gather(-1, mine[:, 1:, None]).sum()
    if model.mesh is not None:
        total = reduce_from_group(total, model.mesh.get_group("data"))
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))


@torch.no_grad()
def load_jax_pipe_params(model: PipeModel, params) -> PipeModel:
    """Copies the JAX package's ``init_pipe_params`` tree into
    ``model``, this rank's stage of the stage-stacked weights."""
    for name, dim in PIPE_PARAM_SPECS.items():
        src = shard(np.asarray(params[name], np.float32), dim, model.stage,
                    model.n_pipe)
        dst = getattr(model, name)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    return model


def make_pipe_workload(cfg: PipeConfig, mesh,
                       device: str | torch.device = "cuda",
                       generator: torch.Generator | None = None,
                       lr: float = 3e-4):
    """(model, optimizer, ``step(tokens) -> loss``) over a (pipe, data)
    mesh."""
    model = PipeModel(cfg, device=device, generator=generator, mesh=mesh)
    optimizer, step = make_sharded_workload(model, pipe_loss,
                                            model.sync_grads, lr=lr)
    return model, optimizer, step
