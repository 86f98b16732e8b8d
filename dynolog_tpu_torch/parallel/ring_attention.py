"""Attention for the flagship workload (counterpart of
``dynolog_tpu/parallel/ring_attention.py``).

Only the unsharded causal attention is here; the ring over the sequence
axis comes with the port's parallel workloads.
"""

from __future__ import annotations

import torch


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, S, H, D] -> [B, S, H, D] in q's dtype.

    Written as the reference writes it (ring_attention.py:115-123), so
    the two agree to rounding: scores in the compute dtype, the causal
    mask, softmax in float32, and ``p @ v`` in float32 (JAX promotes the
    bf16 ``v`` against the float32 ``p``) before the cast back.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    mask = (torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(sk, device=q.device)[None, :])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
