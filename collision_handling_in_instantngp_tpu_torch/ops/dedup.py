"""Unique-vertex deduplication of the GNGF index network.

The index network reads the raw INTEGER vertex coordinates, and it is shared
across levels, so every vertex of every level lies on the shared grid
``{0..n_max+1}^d``. Evaluating it once per unique vertex and gathering per
pixel is the same function as evaluating it per (pixel, level, corner) row:
duplicated rows give identical outputs, and the gradient of the gather is the
count-weighted sum of the per-row gradients. The per-level loss marginal
becomes ``counts (L, U) @ p (U, T)`` against the per-level occurrence
counts.

Batches never re-shuffle, so the geometry (ids, counts) is built once on the
host with numpy. Active-vertex compaction keeps only the vertices a batch
touches (~61% of the shared grid at the scaled config); untouched vertices
have zero counts and no pixel gathers them, so dropping them is exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class DedupGeometry(NamedTuple):
    """Per-batch dedup tables (tensors on the run's device).

    ids:    (P, L, V) int64 vertex id of every row: a global id on the shared
            grid (row * side + col), or, with ``active``, an index into it.
    counts: (L, U) float32 per-level occurrence counts (U = U_c under
            compaction; padding rows carry zero).
    active: optional (U_c,) int64 sorted touched global ids, -1 padded.
    """

    ids: torch.Tensor
    counts: torch.Tensor
    active: Optional[torch.Tensor] = None


def grid_side(n_max: int) -> int:
    """floor(x * n_l) reaches n_l for x in [0, 1], plus the +1 corner: the
    shared grid is {0 .. n_max+1} per dim."""
    return int(n_max) + 2


def unique_vertex_coords(n_max: int, input_dim: int = 2) -> np.ndarray:
    """(U, d) float32: every vertex of the shared grid, id-ordered."""
    side = grid_side(n_max)
    axes = np.meshgrid(*([np.arange(side)] * input_dim), indexing="ij")
    return np.stack(axes, axis=-1).reshape(-1, input_dim).astype(np.float32)


def vertex_ids_np(corners: np.ndarray, side: int) -> np.ndarray:
    c = np.clip(corners.astype(np.int32), 0, side - 1)
    ids = c[..., 0]
    for i in range(1, c.shape[-1]):
        ids = ids * side + c[..., i]
    return ids.astype(np.int32)


def vertex_ids(corners: torch.Tensor, side: int) -> torch.Tensor:
    """(..., d) integer-valued float corners -> (...,) int64 global ids."""
    c = torch.clamp(corners.to(torch.int64), 0, side - 1)
    ids = c[..., 0]
    for i in range(1, c.shape[-1]):
        ids = ids * side + c[..., i]
    return ids


def counts_np(ids: np.ndarray, num_levels: int, u: int) -> np.ndarray:
    """(..., L, V) ids -> (L, U) float32 occurrence counts."""
    ids = np.moveaxis(ids, -2, 0).reshape(num_levels, -1)
    return np.stack(
        [np.bincount(ids[l], minlength=u).astype(np.float32)
         for l in range(num_levels)]
    )


def counts_torch(ids: torch.Tensor, num_levels: int, u: int) -> torch.Tensor:
    """Device form of :func:`counts_np` for callers without precomputed
    geometry (integer-valued float sums, exact)."""
    flat = ids.movedim(-2, 0).reshape(num_levels, -1)
    out = torch.zeros(num_levels, u, dtype=torch.float32, device=ids.device)
    return out.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))


def build_geometry_np(
    coords: np.ndarray, n_ls: np.ndarray, offsets: np.ndarray, n_max: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (ids (P, L, V), counts (L, U)) of a batch of normalized
    coords; float32 math so the floor matches the device's."""
    x = coords.astype(np.float32)
    scaled = x[:, None, :] * n_ls[None, :, None].astype(np.float32)
    corners = np.floor(scaled)[:, :, None, :] + offsets[None, None].astype(np.float32)
    side = grid_side(n_max)
    ids = vertex_ids_np(corners, side)
    return ids, counts_np(ids, len(n_ls), side ** coords.shape[-1])


def compact_geometry_np(
    ids: np.ndarray, num_levels: int, u_c: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Active-vertex compaction of one batch.

    ids: (P, L, V) global ids; u_c: compact row count (>= touched count).
    Returns active (U_c,) sorted touched ids (-1 padded), ids_local
    (P, L, V) indices into ``active``, counts_c (L, U_c)."""
    touched = np.unique(ids)
    if touched.size > u_c:
        raise ValueError(
            f"u_c={u_c} smaller than this batch's touched count {touched.size}"
        )
    active = np.full((u_c,), -1, dtype=np.int32)
    active[: touched.size] = touched
    ids_local = np.searchsorted(touched, ids).astype(np.int32)
    return active, ids_local, counts_np(ids_local, num_levels, u_c)


def active_coords(active: torch.Tensor, side: int) -> torch.Tensor:
    """(U_c,) global ids (-1 padded) -> (U_c, 2) float32 vertex coords;
    padding rows map to (0, 0) (zero counts, never gathered)."""
    ids = torch.clamp(active, min=0)
    return torch.stack([ids // side, ids % side], dim=-1).to(torch.float32)


# ------------------------- statistics on unique ids ------------------------- #

def used_slot_presence(
    idx_unique: torch.Tensor, counts: torch.Tensor, hash_table_size: int
) -> torch.Tensor:
    """(L, K, T) bool: does a vertex occupied at level l (count > 0) select
    slot t as its k-th candidate?

    Written as a scatter of True into the (L, K, T) tensor at
    (l, k, idx[v, k]) for every occupied (l, v); repeated writes store the
    same value, so the result does not depend on their order."""
    u, k = idx_unique.shape
    l_ids, v_ids = torch.nonzero(counts > 0, as_tuple=True)
    presence = torch.zeros(
        counts.shape[0], k, hash_table_size, dtype=torch.bool,
        device=idx_unique.device,
    )
    k_ids = torch.arange(k, device=idx_unique.device)
    presence[l_ids[:, None], k_ids[None, :], idx_unique[v_ids].long()] = True
    return presence


def collisions_from_presence(
    presence: torch.Tensor, n_ls: torch.Tensor
) -> torch.Tensor:
    """(L, K, T) presence -> (L,) clamped mean collisions: per (l, k)
    (n_l+1)^2 - #used slots, mean over k, clamp >= 0."""
    uniques = presence.sum(dim=-1).to(torch.float32)
    total_vertices = ((n_ls.to(torch.int64) + 1) ** 2).to(torch.float32)
    coll = (total_vertices[:, None] - uniques).mean(dim=1)
    return torch.clamp(coll, min=0.0)
