"""Exact top-k with the lowest-index tie rule, and the straight-through
top-k used by the dense HPD branch.

``torch.topk`` promises no order among equal values, so selection here is
written out: K passes of (row max, lowest column attaining it, mask that
column). That is ``lax.top_k``'s order: values descending, equal values by
ascending index.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N) -> values (..., K) descending, indices (..., K) int64."""
    n = x.shape[-1]
    col = torch.arange(n, device=x.device)
    work = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        v = work.amax(dim=-1, keepdim=True)
        i = torch.where(work == v, col, n).amin(dim=-1, keepdim=True)
        vals.append(v)
        idxs.append(i)
        work.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


class DifferentiableTopk(torch.autograd.Function):
    """Top-k over the last axis; the backward scatters the value gradients
    into zeros at the selected slots (``noop=True``: drops them)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int, noop: bool):
        values, indices = topk_lowest_index(x, k)
        ctx.save_for_backward(indices)
        ctx.num_slots = x.shape[-1]
        ctx.noop = noop
        ctx.mark_non_differentiable(indices)
        return values, indices

    @staticmethod
    def backward(ctx, grad_values, _grad_indices):
        (indices,) = ctx.saved_tensors
        shape = indices.shape[:-1] + (ctx.num_slots,)
        grad_x = torch.zeros(shape, dtype=grad_values.dtype, device=grad_values.device)
        if not ctx.noop:
            grad_x.scatter_(-1, indices, grad_values)
        return grad_x, None, None


def differentiable_topk(x: torch.Tensor, k: int, noop: bool = False):
    return DifferentiableTopk.apply(x, k, noop)
