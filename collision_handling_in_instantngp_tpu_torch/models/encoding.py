"""Multi-resolution feature tables: init, top-k blend on unique vertices,
the per-pixel gather, and the per-row top-k blend.

All levels live in one (L, T, F) parameter. ``blend_unique`` gathers the
K candidate slots of every unique vertex from the (T, L*F) view of the
tables (one row gather serves all levels) and sums them with the blend
weights; ``gather_rows`` then fetches each (pixel, level, corner)'s
blended feature by vertex id. On the per-row route ``lookup_topk_blend``
gathers every (pixel, level, corner, k) slot from the flat (L*T, F) view
(the level folded into the slot id) and blends over K.

Determinism: all gathers are ``index_select``, whose gradient autograd
forms with ``index_add_``. On CUDA that scatter-add uses atomics, so the
table gradient (and the vertex-feature gradient) is reproducible only
within fp32 rounding, not bitwise; the tests hold it to a tolerance.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig, TopkBlendMode


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
    l, t, f = tables.shape
    u, k = idx_unique.shape
    w = blend_weights(vals_unique, cfg)
    tables2 = tables.permute(1, 0, 2).reshape(t, l * f)
    rows = tables2.index_select(0, idx_unique.reshape(-1).long()).reshape(u, k, l * f)
    out = (rows * w[:, :, None]).sum(dim=1)
    return out.reshape(u, l, f).permute(1, 0, 2)


def gather_rows(per_level_table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(L, U, F) per-vertex features, (P, L, V) vertex ids -> (P, L, V, F)."""
    l, u, f = per_level_table.shape
    level = torch.arange(l, device=ids.device).view(1, l, *([1] * (ids.dim() - 2)))
    flat = (ids.long() + level * u).reshape(-1)
    return per_level_table.reshape(l * u, f).index_select(0, flat).reshape(*ids.shape, f)


def flat_gather(tables: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(L, T, F) tables, (P, L, ...) slot ids -> (P, L, ..., F): one gather
    from the (L*T, F) view serves every level."""
    l, t, f = tables.shape
    level = torch.arange(l, device=indices.device).view(1, l, *([1] * (indices.dim() - 2)))
    flat = (indices.long() + level * t).reshape(-1)
    return tables.reshape(l * t, f).index_select(0, flat).reshape(*indices.shape, f)


def lookup_topk_blend(
    tables: torch.Tensor,
    indices_topk: torch.Tensor,
    probs_topk: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """(P, L, V, K) slot ids and selected probabilities -> (P, L, V, F)
    blended features. The table gradient is an ``index_add_`` of every
    (pixel, level, corner, k) row into the (L*T, F) table."""
    feats = flat_gather(tables, indices_topk)                   # (P, L, V, K, F)
    w = blend_weights(probs_topk, cfg)
    return torch.sum(feats * w[..., None], dim=-2)
