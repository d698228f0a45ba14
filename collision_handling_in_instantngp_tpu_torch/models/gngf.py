"""GeneralNeuralGaugeFields: the composite neural-field model, dedup route.

  coords (P, d) in [0, 1]
    -> scale_to_grid: scaled (P, L, d), corners (P, L, V, d)
    -> HPD on the unique vertices: top-k slots + loss marginal
    -> blend_unique: (L, U, F) per-vertex features; gather_rows per pixel
    -> bilinear interpolation -> (P, L*F) -> MLP decoder + sigmoid

Parameters live in :class:`GNGFParams` (``hpd``, ``tables``, ``mlp``) in the
JAX package's layout; ``params_from_jax`` / ``params_to_numpy`` carry them
across. Only the GNGF dedup route is ported: batchnorm inputs, the
vanilla hash and the per-row routes raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops import dedup as dedup_ops
from ..ops.grid import resolution_ladder, scale_to_grid, voxel_corner_offsets
from ..ops.interpolate import bilinear_coeffs, interpolate
from ..ops.precision import pdot
from . import encoding as enc
from .hpd import apply_hpd_unique
from .mlp import MLP


class GNGFStatics(NamedTuple):
    """Geometry constants (numpy)."""

    n_ls: np.ndarray            # (L,) int32 resolutions
    offsets: np.ndarray         # (V, d) int32 corner offsets
    unique_coords: np.ndarray   # (U, d) float32 shared vertex grid


class ForwardOut(NamedTuple):
    rgb: torch.Tensor                  # (P, out_channels) sigmoid outputs
    marginal: Optional[torch.Tensor]   # (L, T) loss marginal ((L, K) under keep_topk_only)
    idx_unique: torch.Tensor           # (U, K) selected slots per unique vertex
    counts: Optional[torch.Tensor]     # (L, U) per-level vertex counts


class GNGFParams(nn.Module):
    """hpd: the index network [d -> hpd_hidden -> T]; tables: (L, T, F);
    mlp: the decoder [L*F -> mlp_hidden -> out_channels]."""

    def __init__(self, hpd: MLP, tables: nn.Parameter, mlp: MLP):
        super().__init__()
        self.hpd = hpd
        self.tables = tables
        self.mlp = mlp


def dedup_enabled(cfg: ModelConfig) -> bool:
    return cfg.dedup_vertices and not cfg.use_hash_function and not cfg.batchnorm_input


def make_statics(cfg: ModelConfig) -> GNGFStatics:
    return GNGFStatics(
        n_ls=resolution_ladder(cfg.n_min, cfg.n_max, cfg.num_levels),
        offsets=voxel_corner_offsets(cfg.input_dim),
        unique_coords=dedup_ops.unique_vertex_coords(cfg.n_max, cfg.input_dim),
    )


def init_params(cfg: ModelConfig, seed: int, device="cpu") -> GNGFParams:
    """Fresh parameters from one CPU ``torch.Generator`` seeded with
    ``seed`` (same weights on any device)."""
    gen = torch.Generator().manual_seed(int(seed))
    hpd = MLP((cfg.input_dim, *cfg.hpd_hidden, cfg.hash_table_size), generator=gen, device=device)
    tables = enc.init_tables(cfg, generator=gen, device=device)
    mlp = MLP((cfg.encoded_dim, *cfg.mlp_hidden, cfg.out_channels), generator=gen, device=device)
    return GNGFParams(hpd, tables, mlp)


def params_from_jax(tree, device="cpu") -> GNGFParams:
    """{"hpd": [{"w", "b"}...], "tables": (L, T, F), "mlp": [...]} of numpy
    arrays (the JAX package's pytree) -> GNGFParams."""

    def mlp_of(layers):
        widths = [int(np.shape(layers[0]["w"])[0])] + [int(np.shape(l["w"])[1]) for l in layers]
        mlp = MLP(widths, device=device)
        with torch.no_grad():
            for w, b, lay in zip(mlp.weights, mlp.biases, layers):
                w.copy_(torch.as_tensor(np.array(lay["w"], np.float32)))
                b.copy_(torch.as_tensor(np.array(lay["b"], np.float32)))
        return mlp

    tables = nn.Parameter(
        torch.as_tensor(np.array(tree["tables"], dtype=np.float32)).to(device)
    )
    return GNGFParams(mlp_of(tree["hpd"]), tables, mlp_of(tree["mlp"]))


def params_to_numpy(params: GNGFParams) -> dict:
    """Inverse of :func:`params_from_jax`."""

    def layers_of(mlp: MLP):
        return [
            {"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
            for w, b in mlp.layers()
        ]

    return {
        "hpd": layers_of(params.hpd),
        "tables": params.tables.detach().cpu().numpy(),
        "mlp": layers_of(params.mlp),
    }


def forward(
    params: GNGFParams,
    x: torch.Tensor,
    cfg: ModelConfig,
    statics: GNGFStatics,
    dedup: Optional[dedup_ops.DedupGeometry] = None,
) -> ForwardOut:
    """Model forward on the dedup route. ``dedup``: the batch's precomputed
    geometry (the trainer builds it once); None derives ids and counts from
    ``x`` on its device."""
    if not dedup_enabled(cfg):
        raise NotImplementedError(
            "only the GNGF dedup route is ported (batchnorm input, the vanilla "
            "hash and the per-row routes: ROADMAP.md, port queue)"
        )
    dev = x.device
    n_ls = torch.as_tensor(statics.n_ls, device=dev)
    offsets = torch.as_tensor(statics.offsets, device=dev)
    with torch.no_grad():
        scaled, corners = scale_to_grid(x, n_ls, offsets)
    side = dedup_ops.grid_side(cfg.n_max)
    if dedup is not None and dedup.active is not None:
        ucoords = dedup_ops.active_coords(dedup.active, side)
    else:
        ucoords = torch.as_tensor(statics.unique_coords, device=dev)
    if dedup is not None:
        ids, counts = dedup.ids, dedup.counts
    else:
        ids = dedup_ops.vertex_ids(corners, side)
        counts = dedup_ops.counts_torch(ids, cfg.num_levels, ucoords.shape[0])

    marginal_raw, vals_u, idx_u = apply_hpd_unique(params.hpd, ucoords, cfg, counts=counts)
    feats_u = enc.blend_unique(params.tables, idx_u, vals_u, cfg)
    feats = enc.gather_rows(feats_u, ids)                       # (P, L, V, F)
    h = interpolate(feats, bilinear_coeffs(scaled, offsets))    # (P, L*F)
    rgb = params.mlp(h, cfg.hidden_activation.value, "sigmoid", cfg.matmul_precision)

    rows = x.shape[0] * cfg.num_corners
    if cfg.keep_topk_only:
        marginal = pdot(counts, vals_u, "highest") / rows
    else:
        marginal = marginal_raw / rows
    return ForwardOut(rgb=rgb, marginal=marginal, idx_unique=idx_u, counts=counts)
