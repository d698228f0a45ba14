"""Collision and slot-usage statistics of the selected slot ids.

* total vertices at level l == (n_l + 1)^2
* GNGF collisions per level == (n_l + 1)^2 - #distinct slot ids, per top-k
  candidate k, then the mean over k, clamped at 0 (the per-row route; the
  dedup route counts from unique-vertex presence, ``ops/dedup.py``)
* vanilla collisions per level == (n_l + 1)^2 - #distinct hash ids, NOT
  clamped (negative where the rows reach fewer vertices than slots)
* min possible collisions == max(0, (n_l + 1)^2 - T)
* slot counts (L, T): how many (row, corner[, k]) entries select each slot,
  and the same over one representative pixel per grid cell

Presence is a ``scatter_`` of True into a (groups, T) bool tensor: every
write stores the same value, so the result does not depend on order. The
counts are integer ``index_add_`` / ``bincount`` sums (exact in any order)
and an ``amin`` scatter (order-free).
"""

from __future__ import annotations

import numpy as np
import torch


def mean_as_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean over ``dim`` as XLA computes ``jnp.mean``: the sum times the
    reciprocal of the count in x's type, an ulp from sum / n where n is not
    a power of two (the mean over K = 20 top-k candidates)."""
    return x.sum(dim=dim) * torch.tensor(1.0 / x.shape[dim], dtype=x.dtype)


def _presence_per_group(flat_indices: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """(G, N) slot ids -> (G, T) bool presence masks."""
    g = flat_indices.shape[0]
    presence = torch.zeros(g, hash_table_size, dtype=torch.bool, device=flat_indices.device)
    return presence.scatter_(1, flat_indices.long(), True)


def _unique_counts_per_group(flat_indices: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """#distinct slot values per group: (G, N) -> (G,) int64."""
    return _presence_per_group(flat_indices, hash_table_size).sum(dim=1)


def hash_collisions_gngf(indices_topk: torch.Tensor, n_ls: torch.Tensor,
                         hash_table_size: int) -> torch.Tensor:
    """(P, L, V, K) slot ids -> (L,) float32: per candidate k and level,
    (n_l + 1)^2 - #distinct ids over every (pixel, corner); mean over k;
    clamped at 0."""
    p, l, v, k = indices_topk.shape
    per_kl = indices_topk.permute(3, 1, 0, 2).reshape(k * l, p * v)
    uniques = _unique_counts_per_group(per_kl, hash_table_size).reshape(k, l)
    total_vertices = (n_ls.to(torch.int64) + 1) ** 2
    coll = mean_as_xla((total_vertices[None, :] - uniques).to(torch.float32), 0)
    return torch.clamp(coll, min=0.0)


def min_possible_collisions(n_ls: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """max(0, (n_l+1)^2 - T) per level; [0, 0, 185, 833] for T=256 and
    n_ls=[8, 12, 20, 32]."""
    total_vertices = (n_ls.to(torch.int64) + 1) ** 2
    return torch.clamp(total_vertices - hash_table_size, min=0)


def hash_collisions_vanilla(indices: torch.Tensor, n_ls: torch.Tensor,
                            hash_table_size: int) -> torch.Tensor:
    """(P, L, V) hash ids -> (L,) float32 (n_l + 1)^2 - #distinct ids over
    every (pixel, corner), unclamped."""
    l = indices.shape[1]
    per_level = indices.transpose(0, 1).reshape(l, -1)
    uniques = _unique_counts_per_group(per_level, hash_table_size)
    total_vertices = (n_ls.to(torch.int64) + 1) ** 2
    return (total_vertices - uniques).to(torch.float32)


def slot_counts(indices: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """(P, L, ...) slot ids -> (L, T) int32: per level, how many entries
    select each slot (every axis but L flattened)."""
    l, t = indices.shape[1], hash_table_size
    level = torch.arange(l, device=indices.device).view(1, l, *([1] * (indices.dim() - 2)))
    flat = (indices.long() + level * t).reshape(-1)
    return torch.bincount(flat, minlength=l * t).reshape(l, t).to(torch.int32)


def slot_counts_unique(idx_unique: torch.Tensor, counts: torch.Tensor,
                       hash_table_size: int) -> torch.Tensor:
    """The dedup route's :func:`slot_counts`: (U, K) slot ids of the unique
    vertices and (L, U) per-level row counts -> (L, T) int64, slot t of
    level l counted once for every row of every vertex that selects it.
    Every level shares a vertex's K slots, so this equals
    ``slot_counts(idx_unique[ids])`` over the rows."""
    c = counts.to(torch.int64)
    out = torch.zeros(c.shape[0], hash_table_size, dtype=torch.int64, device=c.device)
    for k in range(idx_unique.shape[1]):
        out.index_add_(1, idx_unique[:, k].long(), c)
    return out


def unique_cell_slot_counts(best_indices: torch.Tensor, corners: torch.Tensor,
                            n_ls: np.ndarray, hash_table_size: int) -> torch.Tensor:
    """Slot counts over one representative pixel per grid cell: (P, L, V)
    slot ids, (P, L, V, d) corners, (L,) numpy resolutions -> (L, T) int32.

    Per level a pixel's cell key is its floor corner ``i * (n_l + 1) + j``;
    a scatter-min elects the lowest pixel row of each occupied cell, and the
    counts histogram that pixel's V slot ids. Keys index a table of
    L * max_cells entries as the JAX package indexes it: a negative key
    counts from the end once, and a key still outside the table is dropped."""
    n_ls = np.asarray(n_ls)
    p, l, _ = best_indices.shape
    dev = best_indices.device
    base = corners[:, :, 0, :].to(torch.int64)
    stride = torch.as_tensor(n_ls.astype(np.int64) + 1, device=dev)[None, :]
    cell_key = base[..., 0] * stride + base[..., 1]
    max_cells = int((np.max(n_ls) + 1) ** 2) if n_ls.size else 0
    size = l * max_cells
    flat_cell = (cell_key + torch.arange(l, device=dev)[None, :] * max_cells).reshape(-1)
    flat_cell = torch.where(flat_cell < 0, flat_cell + size, flat_cell)
    pix = torch.arange(p, device=dev)[:, None].expand(p, l).reshape(-1)
    keep = (flat_cell >= 0) & (flat_cell < size)
    rep = torch.full((size,), p, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, flat_cell[keep], pix[keep], reduce="amin")
    rep = rep.reshape(l, max_cells)
    occupied = rep < p
    per_level = best_indices.transpose(0, 1).long()                        # (L, P, V)
    rep_slots = torch.gather(
        per_level, 1, torch.clamp(rep, max=p - 1)[:, :, None].expand(-1, -1, per_level.shape[2]))
    flat_slots = rep_slots + torch.arange(l, device=dev)[:, None, None] * hash_table_size
    weights = occupied[:, :, None].expand_as(rep_slots).to(torch.int64)
    counts = torch.zeros(l * hash_table_size, dtype=torch.int64, device=dev)
    counts.index_add_(0, flat_slots.reshape(-1), weights.reshape(-1))
    return counts.reshape(l, hash_table_size).to(torch.int32)
