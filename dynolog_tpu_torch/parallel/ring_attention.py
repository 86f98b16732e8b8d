"""Attention for the flagship workload (counterpart of
``dynolog_tpu/parallel/ring_attention.py``).

``ring_attention`` is causal attention over a sequence sharded across
the ranks of a process group: each rank keeps its query block, and the
K/V blocks travel the ring (one send/receive pair a step) while each
rank folds the visiting block into an online-softmax accumulator — the
flash-attention recurrence, written in torch ops as the reference
writes it in ``jnp``. Peak memory stays O(S/n) per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dynolog_tpu_torch.parallel.collectives import ring_shift


def _block_attn(q, k, v, q_start, k_start, scale):
    """One (local-Q x visiting-KV-block) step of the online-softmax
    recurrence. q: [B,Sq,H,D], k/v: [B,Sk,H,D], in the compute dtype as
    in the reference. Returns unnormalized (scores max, exp-sum,
    weighted-V) contributions."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    q_pos = q_start + torch.arange(sq, device=q.device)[:, None]
    k_pos = k_start + torch.arange(sk, device=q.device)[None, :]
    s = s.masked_fill(q_pos < k_pos, float("-inf"))
    # Blocks entirely in the masked future give -inf rows; exp(-inf -
    # (-inf)) would be NaN, so the max used for rescaling is clamped.
    # The output does not depend on the max (it cancels between the
    # exp-sum and weighted V), so it carries no gradient.
    m_safe = torch.clamp(s.detach().amax(dim=-1), min=-1e30)  # [B,H,Sq]
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_safe, l, o


def _fold(acc, block):
    acc_m, acc_l, acc_o = acc
    m_b, l_b, o_b = block
    m_new = torch.maximum(acc_m, m_b.float())
    alpha = torch.exp(acc_m - m_new)
    beta = torch.exp(m_b.float() - m_new)
    acc_l = acc_l * alpha + l_b.float() * beta
    acc_o = (acc_o * alpha.transpose(1, 2)[..., None]
             + o_b.float() * beta.transpose(1, 2)[..., None])
    return m_new, acc_l, acc_o


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Causal multi-head attention with q, k, v [B, S_loc, H, D] the
    rank's contiguous block of a sequence sharded over ``group`` (rank i
    holds positions i*S_loc ...). Returns [B, S_loc, H, D] in q's dtype.
    Every rank of ``group`` must call it, in the same order."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    b, s_loc, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    q_start = idx * s_loc
    acc = (torch.full((b, h, s_loc), -1e30, dtype=torch.float32,
                      device=q.device),
           torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device),
           torch.zeros((b, s_loc, h, d), dtype=torch.float32,
                       device=q.device))
    # Fold the resident block first, then shift-and-fold n-1 times: no
    # wasted rotation after the final block.
    acc = _fold(acc, _block_attn(q, k, v, q_start, idx * s_loc, scale))
    kv = torch.stack([k, v])
    for t in range(1, n):
        kv = ring_shift(kv, group)
        # After t shifts this rank holds the block that started on rank
        # (idx - t) mod n.
        src = (idx - t) % n
        acc = _fold(acc, _block_attn(q, kv[0], kv[1], q_start, src * s_loc,
                                     scale))
    _, acc_l, acc_o = acc
    # Causal masking keeps at least the diagonal, so acc_l > 0.
    return (acc_o / acc_l.transpose(1, 2)[..., None]).to(q.dtype)


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
