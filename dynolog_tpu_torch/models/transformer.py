"""Decoder-only transformer LM — the flagship observed workload, in
PyTorch (counterpart of ``dynolog_tpu/models/transformer.py``).

The same model as the reference, op for op: float32 parameters cast to
the compute dtype inside forward (no autocast), RMSNorm with its
variance in float32, half-split rotary embeddings, SwiGLU, and per-layer
activation checkpointing (``torch.utils.checkpoint`` stands where the
reference wraps its ``lax.scan`` body in ``jax.checkpoint``). Weight
layouts are the reference's (``wq [d, h, hd]``, ``wo [h, hd, d]``, ...),
so ``load_jax_params`` carries a JAX parameter tree over exactly.

Built over a ``DeviceMesh`` of ``("data", "seq", "model")`` the model
holds one rank's shards and runs the reference's dp x sp x tp layout
with explicit collectives where GSPMD inserts them: the parameters are
sliced over ``model`` by ``PARAM_SPECS`` (heads and ff column-parallel,
``wo``/``w_down`` row-parallel with an all-reduce, embedding sharded on
d and gathered, logits sharded on vocab and gathered), the rank's
sequence block takes its global RoPE positions, and with ``seq_axis``
attention is ``ring_attention`` over the ``seq`` ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dynolog_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_dim,
    reduce_from_group,
)
from dynolog_tpu_torch.parallel.mesh import PARAM_SPECS, axis, shard
from dynolog_tpu_torch.parallel.ring_attention import (
    dense_causal_attention,
    ring_attention,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 1_408
    max_seq_len: int = 2_048
    rope_theta: float = 10_000.0
    compute_dtype: torch.dtype = torch.bfloat16
    # Use ring attention over this mesh axis; None -> dense attention.
    seq_axis: str | None = None
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    d_ff=128, max_seq_len=128)
        base.update(kw)
        return cls(**base)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point was asked for; CUDA that is absent
    raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def _rmsnorm(x, gamma, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def _rope_tables(positions, head_dim, theta, dtype):
    """cos/sin [B, S, 1, D/2] for the half-split rotation, angles in
    float32 and cast to the compute dtype, as the reference computes
    them (its docstring says "(even, odd)" pairs; the code, and so this
    port, rotates the first half against the second)."""
    d_half = head_dim // 2
    freqs = theta ** (-torch.arange(
        d_half, dtype=torch.float32, device=positions.device) / d_half)
    angles = positions[..., None].float() * freqs
    return (torch.cos(angles)[:, :, None, :].to(dtype),
            torch.sin(angles)[:, :, None, :].to(dtype))


def _rope(x, cos, sin):
    d_half = x.shape[-1] // 2
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Block(nn.Module):
    """One transformer block. x: [B, S, d]. With ``tp_group`` it holds
    1/``tp`` of the heads and of ff; with ``sp_group`` its sequence is
    this rank's block and attention runs the ring."""

    def __init__(self, cfg: ModelConfig, tp: int = 1, tp_group=None,
                 sp_group=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        h, ff = cfg.n_heads // tp, cfg.d_ff // tp
        self.compute_dtype = cfg.compute_dtype
        self.tp_group, self.sp_group = tp_group, sp_group
        self.wq = nn.Parameter(torch.empty(d, h, hd))
        self.wk = nn.Parameter(torch.empty(d, h, hd))
        self.wv = nn.Parameter(torch.empty(d, h, hd))
        self.wo = nn.Parameter(torch.empty(h, hd, d))
        self.w_gate = nn.Parameter(torch.empty(d, ff))
        self.w_up = nn.Parameter(torch.empty(d, ff))
        self.w_down = nn.Parameter(torch.empty(ff, d))
        self.ln1 = nn.Parameter(torch.ones(d))
        self.ln2 = nn.Parameter(torch.ones(d))

    def _f(self, x):
        return x if self.tp_group is None else copy_to_group(x, self.tp_group)

    def _g(self, x):
        return (x if self.tp_group is None
                else reduce_from_group(x, self.tp_group))

    def forward(self, x, cos, sin):
        dt = self.compute_dtype
        h = self._f(_rmsnorm(x, self.ln1))
        q = _rope(torch.einsum("bsd,dhk->bshk", h, self.wq.to(dt)), cos, sin)
        k = _rope(torch.einsum("bsd,dhk->bshk", h, self.wk.to(dt)), cos, sin)
        v = torch.einsum("bsd,dhk->bshk", h, self.wv.to(dt))
        if self.sp_group is not None:
            attn = ring_attention(q, k, v, self.sp_group)
        else:
            attn = dense_causal_attention(q, k, v)
        x = x + self._g(torch.einsum("bshk,hkd->bsd", attn, self.wo.to(dt)))

        h = self._f(_rmsnorm(x, self.ln2))
        gate = F.silu(torch.einsum("bsd,df->bsf", h, self.w_gate.to(dt)))
        up = torch.einsum("bsd,df->bsf", h, self.w_up.to(dt))
        return x + self._g(
            torch.einsum("bsf,fd->bsd", gate * up, self.w_down.to(dt)))


class Transformer(nn.Module):
    """tokens [B, S] int64 -> logits [B, S, vocab] in the compute dtype.

    With ``mesh`` (a DeviceMesh over ``("data", "seq", "model")``) it is
    this rank's part of the sharded model: tokens are the rank's
    [B/data, S/seq] block and the logits cover it, every vocab entry
    (gathered over ``model``). The weights are the unsharded model's
    from the same ``generator``, sliced."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.tp_group = self.sp_group = None
        self.tp_index, self.tp, self.seq_index = 0, 1, 0
        if mesh is not None:
            self.tp_group = mesh.get_group("model")
            self.tp_index, self.tp = axis(mesh, "model")
            self.seq_index, n_seq = axis(mesh, "seq")
            if cfg.seq_axis is not None:
                self.sp_group = mesh.get_group(cfg.seq_axis)
            elif n_seq > 1:
                raise ValueError("a mesh with a seq axis of "
                                 f"{n_seq} needs cfg.seq_axis")
        elif cfg.seq_axis is not None:
            raise ValueError(f"seq_axis={cfg.seq_axis!r} needs a mesh")
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty(v, d // self.tp))
        self.unembed = nn.Parameter(torch.empty(d, v // self.tp))
        self.final_norm = nn.Parameter(torch.ones(d))
        self.layers = nn.ModuleList(
            Block(cfg, self.tp, self.tp_group, self.sp_group)
            for _ in range(cfg.n_layers))
        self._init_weights(generator)
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init_weights(self, generator):
        """The reference's scheme (init_params): normal weights scaled by
        fan-in^-1/2, unit embedding, norms at one. Drawn on the CPU from
        ``generator`` at full size, in one order, and sliced, so every
        mesh gets the unsharded model's weights; torch and JAX draw
        different numbers from one seed, so parity tests load JAX's
        weights with load_jax_params."""
        cfg = self.cfg
        d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff

        def draw(name, param, shape, scale):
            full = torch.empty(shape).normal_(0.0, scale, generator=generator)
            param.copy_(shard(full, PARAM_SPECS[name], self.tp_index,
                              self.tp))

        draw("embed", self.embed, (cfg.vocab_size, d), 1.0)
        draw("unembed", self.unembed, (d, cfg.vocab_size), d ** -0.5)
        for layer in self.layers:
            for name, shape, scale in (
                    ("wq", (d, h, hd), d ** -0.5),
                    ("wk", (d, h, hd), d ** -0.5),
                    ("wv", (d, h, hd), d ** -0.5),
                    ("wo", (h, hd, d), (h * hd) ** -0.5),
                    ("w_gate", (d, ff), d ** -0.5),
                    ("w_up", (d, ff), d ** -0.5),
                    ("w_down", (ff, d), ff ** -0.5)):
                draw(name, getattr(layer, name), shape, scale)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, s = tokens.shape
        # A sequence shard's positions are global.
        positions = (self.seq_index * s
                     + torch.arange(s, device=tokens.device)).expand(b, s)
        cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, dt)
        x = F.embedding(tokens, self.embed.to(dt))
        if self.tp_group is not None:
            x = gather_dim(x, -1, self.tp_group)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = _rmsnorm(x, self.final_norm)
        if self.tp_group is None:
            return torch.einsum("bsd,dv->bsv", x, self.unembed.to(dt))
        logits = torch.einsum("bsd,dv->bsv", copy_to_group(x, self.tp_group),
                              self.unembed.to(dt))
        return gather_dim(logits, -1, self.tp_group)


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "ln1", "ln2")


def shard_jax_params(params, index: int, size: int):
    """Rank ``index`` of ``size`` along ``model``: the JAX package's
    ``init_params`` tree (numpy arrays, or anything ``np.asarray``
    takes) with each array sliced by PARAM_SPECS (the layer stacks keep
    their leading layer dim)."""
    out = {k: shard(np.asarray(params[k]), PARAM_SPECS[k], index, size)
           for k in ("embed", "unembed", "final_norm")}
    out["layers"] = {}
    for key in _LAYER_KEYS:
        dim = PARAM_SPECS[key]
        out["layers"][key] = shard(np.asarray(params["layers"][key]),
                                   None if dim is None else dim + 1,
                                   index, size)
    return out


@torch.no_grad()
def load_jax_params(model: Transformer, params) -> Transformer:
    """Copies the JAX package's ``init_params`` tree (numpy arrays, or
    anything ``np.asarray`` takes) into ``model``: top-level tensors
    as they are, and layer i's weights as slice i of each ``[L, ...]``
    stack; a sharded model takes its rank's slices (shard_jax_params).
    Shapes must match exactly."""
    params = shard_jax_params(params, model.tp_index, model.tp)

    def put(dst: torch.Tensor, src) -> None:
        arr = np.array(src, dtype=np.float32)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"shape {arr.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    put(model.embed, params["embed"])
    put(model.unembed, params["unembed"])
    put(model.final_norm, params["final_norm"])
    stacks = params["layers"]
    for key in _LAYER_KEYS:
        stack = stacks[key]
        if stack.shape[0] != len(model.layers):
            raise ValueError(
                f"{key}: {stack.shape[0]} layers != {len(model.layers)}")
        for i, layer in enumerate(model.layers):
            put(getattr(layer, key), stack[i])
    return model
