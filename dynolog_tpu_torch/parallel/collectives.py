"""Differentiable collectives for the parallel workloads.

Under GSPMD the reference never writes a collective's transpose: XLA
derives it. Here each collective is a ``torch.autograd.Function`` whose
backward is the transpose the reference's AD would use:

  ring_shift        send to the next rank, receive from the previous one
                    (``lax.ppermute`` by +1); backward shifts by -1
  copy_to_group     identity; backward all-reduces (Megatron's f): the
                    input is replicated and each rank uses its own shard
                    of the weights on it
  reduce_from_group all-reduce; backward identity (Megatron's g): every
                    rank goes on to compute the same replicated value
  gather_dim        all-gather along a dim; backward keeps this rank's
                    slice

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
is an all-reduce, which multiplies the gradient by the group size
wherever every rank computes the same replicated loss.

Ranks are addressed by their global rank (``dist.get_global_rank``), so
a subgroup of a larger world works as the whole world does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    # Send and receive posted together, so two neighbours never block
    # on each other's send.
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        me = dist.get_rank(ctx.group)
        return (grad.narrow(ctx.dim, me * ctx.size, ctx.size).contiguous(),
                None, None)


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` lands on rank i + shift (mod n) of ``group``."""
    return _RingShift.apply(x, group, shift)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenates every rank's ``x`` along ``dim``, in rank order."""
    return _GatherDim.apply(x, dim % x.dim(), group)


def all_reduce_grads(params, groups) -> None:
    """Sums the gradients of ``params`` over each group in ``groups`` in
    turn, as one flat buffer per dtype. A parameter without a gradient
    contributes zeros."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        for group in groups:
            dist.all_reduce(flat, group=group)
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
