"""Collision statistics of the GNGF top-k slot ids.

* total vertices at level l == (n_l + 1)^2
* collisions per level == (n_l + 1)^2 - #distinct slot ids, per top-k
  candidate k, then the mean over k, clamped at 0 (the per-row route; the
  dedup route counts from unique-vertex presence, ``ops/dedup.py``)
* min possible collisions == max(0, (n_l + 1)^2 - T)

Presence is a ``scatter_`` of True into a (groups, T) bool tensor: every
write stores the same value, so the result does not depend on order.
"""

from __future__ import annotations

import torch


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
    coll = (total_vertices[None, :] - uniques).to(torch.float32).mean(dim=0)
    return torch.clamp(coll, min=0.0)


def min_possible_collisions(n_ls: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """max(0, (n_l+1)^2 - T) per level; [0, 0, 185, 833] for T=256 and
    n_ls=[8, 12, 20, 32]."""
    total_vertices = (n_ls.to(torch.int64) + 1) ** 2
    return torch.clamp(total_vertices - hash_table_size, min=0)
