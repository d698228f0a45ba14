"""Multi-resolution feature tables: init, top-k blend on unique vertices,
the per-pixel gather, and the per-row top-k blend.

All levels live in one (L, T, F) parameter. ``blend_unique`` gathers the
K candidate slots of every unique vertex from the (T, L*F) view of the
tables (one row gather serves all levels) and sums them with the blend
weights; ``gather_rows`` then fetches each (pixel, level, corner)'s
blended feature by vertex id. On the per-row route ``lookup_topk_blend``
gathers every (pixel, level, corner, k) slot from the flat (L*T, F) view
(the level folded into the slot id) and blends over K.

Determinism: every gather here is ``index_select`` with a fixed-order
backward (:class:`GatherSerial`): the gradient of a table row is the sum of
the gradients of the rows gathered from it, added in ascending row order by
``scatter_add_serial`` (kernel K12 on the card, its plain version on the
CPU), never by atomics. So two fits from one start give the same
parameters bit for bit, as in the JAX package (its gather backward is a
sequential scan). The port has this one backward; the JAX package's switch
``BLEND_SCATTER_BACKEND`` selects nothing here and is only checked, once at
import, so that a value the JAX package refuses is refused here too.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig, TopkBlendMode
from ..ops.cuda.scatter import scatter_add_serial

BLEND_SCATTER_BACKENDS = ("segment_sum", "vmem_serial")


def scatter_backend_from_env() -> str:
    """``BLEND_SCATTER_BACKEND`` from the environment (default
    "segment_sum"); raises ValueError on any other value than
    BLEND_SCATTER_BACKENDS."""
    value = os.environ.get("BLEND_SCATTER_BACKEND", "segment_sum")
    if value not in BLEND_SCATTER_BACKENDS:
        raise ValueError(f"BLEND_SCATTER_BACKEND={value!r}; expected one of {BLEND_SCATTER_BACKENDS}")
    return value


scatter_backend_from_env()


class GatherSerial(torch.autograd.Function):
    """rows (N, C) of a table (T, C) by flat ids (N,); the table gradient
    dt[t] = sum over the rows n with id t of g[n], added in ascending n by
    ``scatter_add_serial`` (bitwise stable, no atomics). The forward's
    ``index_select`` has checked the ids, so the backward skips the range
    check and its host sync."""

    @staticmethod
    def forward(ctx, table, flat):
        ctx.save_for_backward(flat)
        ctx.slots = table.shape[0]
        return table.index_select(0, flat)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        return scatter_add_serial(g.contiguous(), flat, ctx.slots, ids_checked=True), None


def init_tables(
    cfg: ModelConfig, generator: Optional[torch.Generator] = None, device=None
) -> nn.Parameter:
    """(L, T, F) ~ U(-1e-4, 1e-4), drawn on the CPU then moved."""
    t = torch.empty(cfg.num_levels, cfg.hash_table_size, cfg.feature_dim)
    return nn.Parameter(t.uniform_(-1e-4, 1e-4, generator=generator).to(device))


def blend_weights(probs_topk: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-candidate blend weights over the K axis (config.TopkBlendMode)."""
    if cfg.topk_blend is TopkBlendMode.RAW_SUM:
        return probs_topk
    if cfg.topk_blend is TopkBlendMode.SOFTMAX_AVG:
        return torch.softmax(probs_topk, dim=-1)
    if cfg.topk_blend is TopkBlendMode.WEIGHTED_AVG:
        return probs_topk / probs_topk.sum(dim=-1, keepdim=True)
    raise ValueError(cfg.topk_blend)


def blend_unique(
    tables: torch.Tensor,
    idx_unique: torch.Tensor,
    vals_unique: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """(L, T, F) tables, (U, K) slot ids shared by every level, (U, K)
    selected probabilities -> (L, U, F) blended per-vertex features."""
    w = blend_weights(vals_unique, cfg)
    l, t, f = tables.shape
    u, k = idx_unique.shape
    tables2 = tables.permute(1, 0, 2).reshape(t, l * f)
    rows = GatherSerial.apply(tables2, idx_unique.reshape(-1).long()).reshape(u, k, l * f)
    out = (rows * w[:, :, None]).sum(dim=1)
    return out.reshape(u, l, f).permute(1, 0, 2)


def gather_rows(per_level_table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(L, U, F) per-vertex features, (P, L, V) vertex ids -> (P, L, V, F)."""
    l, u, f = per_level_table.shape
    level = torch.arange(l, device=ids.device).view(1, l, *([1] * (ids.dim() - 2)))
    flat = (ids.long() + level * u).reshape(-1)
    return GatherSerial.apply(per_level_table.reshape(l * u, f), flat).reshape(*ids.shape, f)


def flat_gather(tables: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(L, T, F) tables, (P, L, ...) slot ids -> (P, L, ..., F): one gather
    from the (L*T, F) view serves every level."""
    l, t, f = tables.shape
    level = torch.arange(l, device=indices.device).view(1, l, *([1] * (indices.dim() - 2)))
    flat = (indices.long() + level * t).reshape(-1)
    return GatherSerial.apply(tables.reshape(l * t, f), flat).reshape(*indices.shape, f)


def lookup_topk_blend(
    tables: torch.Tensor,
    indices_topk: torch.Tensor,
    probs_topk: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """(P, L, V, K) slot ids and selected probabilities -> (P, L, V, F)
    blended features. The table gradient sums every (pixel, level, corner,
    k) row into the (L*T, F) table in row order (GatherSerial)."""
    feats = flat_gather(tables, indices_topk)                   # (P, L, V, K, F)
    w = blend_weights(probs_topk, cfg)
    return torch.sum(feats * w[..., None], dim=-2)
