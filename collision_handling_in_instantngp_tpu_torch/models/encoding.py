"""Multi-resolution feature tables: init, top-k blend on unique vertices,
the per-pixel gather, and the per-row top-k blend.

All levels live in one (L, T, F) parameter. ``blend_unique`` gathers the
K candidate slots of every unique vertex from the (T, L*F) view of the
tables (one row gather serves all levels) and sums them with the blend
weights; ``gather_rows`` then fetches each (pixel, level, corner)'s
blended feature by vertex id. On the per-row route ``lookup_topk_blend``
gathers every (pixel, level, corner, k) slot from the flat (L*T, F) view
(the level folded into the slot id) and blends over K.

Determinism: the gathers are ``index_select``, whose gradient autograd
forms with ``index_add_``. On CUDA that scatter-add uses atomics, so the
table gradient (and the vertex-feature gradient) is reproducible only
within fp32 rounding, not bitwise; the tests hold it to a tolerance.
``BLEND_SCATTER_BACKEND=vmem_serial`` (the JAX package's switch, read and
checked when this module is imported) gives ``blend_unique``'s table gradient to the
serial scatter kernel K12 instead, bitwise stable, for tables past
``_BLEND_SMATRIX_MIN_ELEMENTS`` (U * T); ``gather_rows``' gradient stays an
atomic ``index_add_``.
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


# Table-gradient reduction of blend_unique past the large-regime threshold:
# "segment_sum" (autograd's index_add_) or "vmem_serial" (kernel K12).
BLEND_SCATTER_BACKEND = scatter_backend_from_env()
# U * T past which the JAX package takes its large-regime blend. The port
# has no large-regime form of its own: the threshold only decides where
# "vmem_serial" applies, so that it runs K12 where the JAX package runs its
# serial scatter.
_BLEND_SMATRIX_MIN_ELEMENTS = 1 << 25


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
    u, t = idx_unique.shape[0], tables.shape[1]
    if BLEND_SCATTER_BACKEND == "vmem_serial" and u * t > _BLEND_SMATRIX_MIN_ELEMENTS:
        return BlendSerial.apply(tables, idx_unique, w)
    return _blend(tables, idx_unique, w)


def _blend(tables, idx_unique, w):
    l, t, f = tables.shape
    u, k = idx_unique.shape
    tables2 = tables.permute(1, 0, 2).reshape(t, l * f)
    rows = tables2.index_select(0, idx_unique.reshape(-1).long()).reshape(u, k, l * f)
    out = (rows * w[:, :, None]).sum(dim=1)
    return out.reshape(u, l, f).permute(1, 0, 2)


class BlendSerial(torch.autograd.Function):
    """``blend_unique``'s gather and K-blend with the JAX package's gather
    backward: dt[t] = sum over (u, k) with idx[u, k] = t of w[u, k] g2[u],
    added in (u, k) order by K12; dw[u, k] = <tables2[idx[u, k]], g2[u]>,
    with tables2 (T, L*F) and g2 (U, L*F)."""

    @staticmethod
    def forward(ctx, tables, idx_unique, w):
        ctx.save_for_backward(tables, idx_unique, w)
        return _blend(tables, idx_unique, w)

    @staticmethod
    def backward(ctx, g):
        tables, idx, w = ctx.saved_tensors
        l, t, f = tables.shape
        u, k = idx.shape
        tables2 = tables.permute(1, 0, 2).reshape(t, l * f)
        g2 = g.permute(1, 0, 2).reshape(u, l * f)
        flat = idx.reshape(-1)
        rows = tables2.index_select(0, flat.long()).reshape(u, k, l * f)
        dw = (rows * g2[:, None, :]).sum(dim=-1)
        scaled = (w[:, :, None] * g2[:, None, :]).reshape(u * k, l * f)
        dt2 = scatter_add_serial(scaled, flat, t)
        return dt2.reshape(t, l, f).permute(1, 0, 2), None, dw


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
