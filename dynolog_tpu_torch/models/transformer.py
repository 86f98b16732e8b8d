"""Decoder-only transformer LM — the flagship observed workload, in
PyTorch (counterpart of ``dynolog_tpu/models/transformer.py``).

The same model as the reference, op for op: float32 parameters cast to
the compute dtype inside forward (no autocast), RMSNorm with its
variance in float32, half-split rotary embeddings, SwiGLU, and per-layer
activation checkpointing (``torch.utils.checkpoint`` stands where the
reference wraps its ``lax.scan`` body in ``jax.checkpoint``). Weight
layouts are the reference's (``wq [d, h, hd]``, ``wo [h, hd, d]``, ...),
so ``load_jax_params`` carries a JAX parameter tree over exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dynolog_tpu_torch.parallel.ring_attention import dense_causal_attention


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
    """One transformer block. x: [B, S, d]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        self.compute_dtype = cfg.compute_dtype
        self.wq = nn.Parameter(torch.empty(d, h, hd))
        self.wk = nn.Parameter(torch.empty(d, h, hd))
        self.wv = nn.Parameter(torch.empty(d, h, hd))
        self.wo = nn.Parameter(torch.empty(h, hd, d))
        self.w_gate = nn.Parameter(torch.empty(d, ff))
        self.w_up = nn.Parameter(torch.empty(d, ff))
        self.w_down = nn.Parameter(torch.empty(ff, d))
        self.ln1 = nn.Parameter(torch.ones(d))
        self.ln2 = nn.Parameter(torch.ones(d))

    def forward(self, x, cos, sin):
        dt = self.compute_dtype
        h = _rmsnorm(x, self.ln1)
        q = _rope(torch.einsum("bsd,dhk->bshk", h, self.wq.to(dt)), cos, sin)
        k = _rope(torch.einsum("bsd,dhk->bshk", h, self.wk.to(dt)), cos, sin)
        v = torch.einsum("bsd,dhk->bshk", h, self.wv.to(dt))
        attn = dense_causal_attention(q, k, v)
        x = x + torch.einsum("bshk,hkd->bsd", attn, self.wo.to(dt))

        h = _rmsnorm(x, self.ln2)
        gate = F.silu(torch.einsum("bsd,df->bsf", h, self.w_gate.to(dt)))
        up = torch.einsum("bsd,df->bsf", h, self.w_up.to(dt))
        return x + torch.einsum("bsf,fd->bsd", gate * up, self.w_down.to(dt))


class Transformer(nn.Module):
    """tokens [B, S] int64 -> logits [B, S, vocab] in the compute dtype."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty(v, d))
        self.unembed = nn.Parameter(torch.empty(d, v))
        self.final_norm = nn.Parameter(torch.ones(d))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self._init_weights(generator)
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init_weights(self, generator):
        """The reference's scheme (init_params): normal weights scaled by
        fan-in^-1/2, unit embedding, norms at one. Drawn on the CPU from
        ``generator``; torch and JAX draw different numbers from one seed,
        so parity tests load JAX's weights with load_jax_params."""
        cfg = self.cfg
        d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        self.embed.normal_(0.0, 1.0, generator=generator)
        self.unembed.normal_(0.0, d ** -0.5, generator=generator)
        for layer in self.layers:
            for name, scale in (("wq", d ** -0.5), ("wk", d ** -0.5),
                                ("wv", d ** -0.5), ("wo", (h * hd) ** -0.5),
                                ("w_gate", d ** -0.5), ("w_up", d ** -0.5),
                                ("w_down", ff ** -0.5)):
                getattr(layer, name).normal_(0.0, scale, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, dt)
        x = F.embedding(tokens, self.embed.to(dt))
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = _rmsnorm(x, self.final_norm)
        return torch.einsum("bsd,dv->bsv", x, self.unembed.to(dt))


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "ln1", "ln2")


@torch.no_grad()
def load_jax_params(model: Transformer, params) -> Transformer:
    """Copies the JAX package's ``init_params`` tree (numpy arrays, or
    anything ``np.asarray`` takes) into ``model``: top-level tensors
    as they are, and layer i's weights as slice i of each ``[L, ...]``
    stack. Shapes must match exactly."""
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
        stack = np.asarray(stacks[key])
        if stack.shape[0] != len(model.layers):
            raise ValueError(
                f"{key}: {stack.shape[0]} layers != {len(model.layers)}")
        for i, layer in enumerate(model.layers):
            put(getattr(layer, key), stack[i])
    return model
