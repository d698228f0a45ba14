"""Multi-resolution feature tables: init, top-k blend on unique vertices,
the per-pixel gather, the per-row top-k blend and the vanilla hash lookup.

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

One gather and one blend, on purpose. The JAX package's ``gather_rows``
has four forms, picked by its arguments: the cell-table gather under
compaction (``ModelConfig.dedup_cell_gather``), the cell-structured
backward on the shared grid and under compaction, and the reverse maps;
its ``blend_unique`` has an S-matrix form past 2^25 elements
(``BLEND_LARGE_BACKEND``). They are TPU layouts of the same functions:
the forwards copy the same values, the gradients add the same rows in
other orders. On the H100 each lost to the per-vertex gather and the
gather blend above (PERF.md §6), so the port has those alone for
every geometry: ``ModelConfig.dedup_cell_gather`` is carried so that a
config, a checkpoint and a manifest mean the same in both packages, and
selects nothing here. ``tests/test_torch_cell_gather.py`` holds this
gather against each JAX form.

Tables sharded by slot (``parallel/mesh.py``; ``GNGFParams.shard``, a
:class:`TableShard`): a rank holds slots [lo, hi) of every level. A gather takes the ids in that
range from the local rows and zeros for the others, then sums the rows
over the mesh's model group, whose ranks hold the other slots, so every
rank has every row exactly (``sum_replicated``: the backward is the
identity); the gradient goes into the local slots alone, in row order, by
K12 over the slot range (:class:`GatherShard`). The per-row gathers index
the slot-major (T, L) view there, so that a rank's slots of every level
are one range.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, TopkBlendMode
from ..ops.cuda.scatter import scatter_add_serial
from ..ops.collectives import sum_replicated
from ..utils import prng

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


class TableShard(NamedTuple):
    """Slots [lo, hi) of T that this rank holds; ``group``: the ranks that
    hold the others (the mesh's model group). A copy of params shares it:
    a process group is a handle, not data."""

    lo: int
    hi: int
    t: int
    group: Any

    def __deepcopy__(self, memo):
        return self


class GatherShard(torch.autograd.Function):
    """rows (N, C) by ids (N,) in [0, T) from the local rows (hi - lo, C)
    of a table sharded by slot: the row of id - lo for an id in [lo, hi),
    zeros for the others. The gradient: K12 over the slot range, each local
    slot's rows added in ascending n."""

    @staticmethod
    def forward(ctx, table, ids, lo: int, hi: int, t: int):
        inside = (ids >= lo) & (ids < hi)
        rows = table.index_select(0, torch.where(inside, ids - lo, 0))
        ctx.save_for_backward(ids)
        ctx.lo, ctx.hi, ctx.t = lo, hi, t
        return rows.masked_fill_(~inside[:, None], 0.0)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = scatter_add_serial(g.contiguous(), ids, ctx.t, ids_checked=True,
                                  slot_range=(ctx.lo, ctx.hi))
        return grad, None, None, None, None


def gather_sharded(table: torch.Tensor, ids: torch.Tensor, lo: int, hi: int, t: int,
                   group) -> torch.Tensor:
    """Every row ``ids`` names, from the shards of the ranks of ``group``."""
    return sum_replicated(GatherShard.apply(table, ids, lo, hi, t), group)


def init_tables(cfg: ModelConfig, key: np.ndarray, device=None) -> nn.Parameter:
    """(L, T, F) ~ U(-1e-4, 1e-4): the JAX package's ``init_tables(key, cfg)``
    drawn on the host (``utils.prng``), then moved."""
    t = prng.uniform(key, (cfg.num_levels, cfg.hash_table_size, cfg.feature_dim), -1e-4, 1e-4)
    return nn.Parameter(torch.from_numpy(t).to(device))


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
    shard: Optional[TableShard] = None,
) -> torch.Tensor:
    """(L, T, F) tables (a rank's (L, hi - lo, F) under a ``shard``), (U, K)
    slot ids shared by every level, (U, K) selected probabilities ->
    (L, U, F) blended per-vertex features."""
    w = blend_weights(vals_unique, cfg)
    l, t, f = tables.shape
    u, k = idx_unique.shape
    tables2 = tables.permute(1, 0, 2).reshape(t, l * f)
    flat = idx_unique.reshape(-1).long()
    if shard is None:
        rows = GatherSerial.apply(tables2, flat)
    else:
        rows = gather_sharded(tables2, flat, shard.lo, shard.hi, shard.t, shard.group)
    rows = rows.reshape(u, k, l * f)
    out = (rows * w[:, :, None]).sum(dim=1)
    return out.reshape(u, l, f).permute(1, 0, 2)


def gather_rows(per_level_table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(L, U, F) per-vertex features, (P, L, V) vertex ids -> (P, L, V, F)."""
    l, u, f = per_level_table.shape
    level = torch.arange(l, device=ids.device).view(1, l, *([1] * (ids.dim() - 2)))
    flat = (ids.long() + level * u).reshape(-1)
    return GatherSerial.apply(per_level_table.reshape(l * u, f), flat).reshape(*ids.shape, f)


def flat_gather(tables: torch.Tensor, indices: torch.Tensor,
                shard: Optional[TableShard] = None) -> torch.Tensor:
    """(L, T, F) tables, (P, L, ...) slot ids -> (P, L, ..., F): one gather
    from the (L*T, F) view serves every level. Under a ``shard`` the local
    (L, hi - lo, F) tables are gathered from as the slot-major
    ((hi - lo) * L, F) view, by ids slot * L + level."""
    l, t, f = tables.shape
    level = torch.arange(l, device=indices.device).view(1, l, *([1] * (indices.dim() - 2)))
    if shard is not None:
        keys = (indices.long() * l + level).reshape(-1)
        rows = gather_sharded(tables.permute(1, 0, 2).reshape(t * l, f), keys,
                              shard.lo * l, shard.hi * l, shard.t * l, shard.group)
        return rows.reshape(*indices.shape, f)
    flat = (indices.long() + level * t).reshape(-1)
    return GatherSerial.apply(tables.reshape(l * t, f), flat).reshape(*indices.shape, f)


def lookup_vanilla(tables: torch.Tensor, indices: torch.Tensor,
                   shard: Optional[TableShard] = None) -> torch.Tensor:
    """The vanilla hash path: (P, L, V) hash ids -> (P, L, V, F). The table
    gradient sums every (pixel, level, corner) row in row order (K12 on
    the card)."""
    return flat_gather(tables, indices, shard)


def lookup_topk_blend(
    tables: torch.Tensor,
    indices_topk: torch.Tensor,
    probs_topk: torch.Tensor,
    cfg: ModelConfig,
    shard: Optional[TableShard] = None,
) -> torch.Tensor:
    """(P, L, V, K) slot ids and selected probabilities -> (P, L, V, F)
    blended features. The table gradient sums every (pixel, level, corner,
    k) row into the (L*T, F) table in row order (GatherSerial)."""
    feats = flat_gather(tables, indices_topk, shard)            # (P, L, V, K, F)
    w = blend_weights(probs_topk, cfg)
    return torch.sum(feats * w[..., None], dim=-2)
