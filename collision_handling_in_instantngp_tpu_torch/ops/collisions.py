"""Collision statistics that do not depend on the batch."""

from __future__ import annotations

import torch


def min_possible_collisions(n_ls: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """max(0, (n_l+1)^2 - T) per level; [0, 0, 185, 833] for T=256 and
    n_ls=[8, 12, 20, 32]."""
    total_vertices = (n_ls.to(torch.int64) + 1) ** 2
    return torch.clamp(total_vertices - hash_table_size, min=0)
