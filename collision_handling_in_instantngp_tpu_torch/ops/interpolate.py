"""Bilinear interpolation of per-corner features, level-major output."""

from __future__ import annotations

import torch


def bilinear_coeffs(scaled: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(P, L, d) scaled coords, (V, d) 0/1 offsets -> (P, L, V) weights,
    prod over dims of frac (corner steps) or 1 - frac (it does not)."""
    frac = scaled - torch.floor(scaled)
    off = offsets.to(scaled.dtype)[None, None]
    f = frac[:, :, None, :]
    return torch.prod(off * f + (1.0 - off) * (1.0 - f), dim=-1)


def interpolate(features: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """(P, L, V, F) features, (P, L, V) weights -> (P, L*F), level-major."""
    p, l, _, f = features.shape
    return torch.sum(features * coeffs[..., None], dim=2).reshape(p, l * f)
