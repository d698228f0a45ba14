"""Multi-resolution grid geometry: resolution ladder, voxel corners, scaling.

Shapes are ``(P, L, ...)``: pixel-major, level second.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resolution_ladder(n_min: int, n_max: int, num_levels: int) -> np.ndarray:
    """``n_l = floor(n_min * b**l)`` with ``b = exp((ln n_max - ln n_min)/(L-1))``;
    (L,) int32. The defaults (8, 32, 4) give [8, 12, 20, 32]."""
    if num_levels == 1:
        return np.array([n_min], dtype=np.int32)
    b = float(np.exp((np.log(n_max) - np.log(n_min)) / (num_levels - 1)))
    return np.array(
        [np.floor(n_min * b**l) for l in range(num_levels)], dtype=np.int32
    )


def voxel_corner_offsets(input_dim: int) -> np.ndarray:
    """(V=2^d, d) int32 corner offsets; for d=2 the order is
    (0,0), (1,0), (0,1), (1,1), which the bilinear weights assume."""
    num_corners = 2**input_dim
    out = np.empty((num_corners, input_dim), dtype=np.int32)
    for i in range(input_dim):
        out[:, i] = ([0] * (2**i) + [1] * (2**i)) * (2 ** (input_dim - i - 1))
    return out


def scale_to_grid(
    x: torch.Tensor, n_ls: torch.Tensor, offsets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (P, d) in [0, 1] -> scaled (P, L, d) = x * n_l and corners
    (P, L, V, d) = floor(scaled) + offset, as floats (the raw vertex coords
    the index network reads). Geometry is data: callers pass no-grad x."""
    scaled = x[:, None, :] * n_ls[None, :, None].to(x.dtype)
    corners = torch.floor(scaled)[:, :, None, :] + offsets[None, None].to(x.dtype)
    return scaled, corners
