"""The collectives of data and table parallelism, with their autograd rules.

The model and the training step call these only where they are given a
process group (``parallel/`` makes the groups); without one nothing here
runs.

Only ``all_reduce`` (SUM), ``all_gather`` and ``broadcast`` are used, so
that gloo (the CPU, and several ranks on one card) and NCCL (a card per
rank) carry the same code.

Two sums differ in their backward:

* :func:`sum_replicated`: every rank then computes the same thing from the
  sum (the TP gather's features, the global marginal, the MSE's numerator),
  so each rank's copy of the loss is the whole loss and the gradient of a
  rank's share is the gradient of the sum: the backward is the identity.
  After the gradient all-reduce each term counts once, not once a rank.
* :func:`sum_shared`: each rank uses the sum only for its own rows (the
  BatchNorm statistics normalize the local rows), so the gradient of a
  share is the sum of every rank's gradient: the backward sums too.

Every call counts its bytes and the host seconds spent in it
(:data:`STATS`, :func:`reset_stats`); with gloo and CUDA tensors that time
includes the staging through host memory.
"""

from __future__ import annotations

import time
from typing import Iterable, List

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "host_s": 0.0}


def group_size(group) -> int:
    """The ranks of ``group``; 1 for None (no group)."""
    return 1 if group is None else dist.get_world_size(group)


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, host_s=0.0)


def _count(t: torch.Tensor, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["host_s"] += time.perf_counter() - t0


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over ``group``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count(t, t0)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in group rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    t0 = time.perf_counter()
    dist.all_gather(out, t, group=group)
    _count(t, t0)
    return out


def broadcast_(t: torch.Tensor, src: int) -> torch.Tensor:
    """In-place copy of rank ``src``'s ``t`` to every rank."""
    t0 = time.perf_counter()
    dist.broadcast(t, src=src)
    _count(t, t0)
    return t


class _SumIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone(), ctx.group), None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; its backward is the identity."""
    return _SumIdentity.apply(x, group)


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; its backward sums the gradients too."""
    return _SumSum.apply(x, group)


def union(mask: torch.Tensor, group) -> torch.Tensor:
    """The OR of a bool tensor over ``group`` (an int32 sum, then > 0)."""
    return all_reduce_(mask.to(torch.int32), group) > 0


def all_reduce_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over ``group``, in one collective on
    one flat buffer (parameters without a gradient are skipped; every rank
    has the same set)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
