"""GeneralNeuralGaugeFields: the composite neural-field model.

  coords (P, d) in [0, 1] (or raw pixel coords under batchnorm_input)
    -> [training-mode BatchNorm over the batch, frozen scale/bias]
    -> scale_to_grid: scaled (P, L, d), corners (P, L, V, d)
    -> vanilla: fast_hash of the corners, lookup_vanilla (no HPD)
     | dedup route: HPD on the unique vertices, blend_unique per vertex,
       gather_rows per pixel
     | per-row route: HPD on every (pixel, level, corner) row
       (apply_hpd_fused, or dense apply_hpd), lookup_topk_blend
    -> bilinear interpolation -> (P, L*F) -> MLP decoder + sigmoid

The dedup route runs when ``dedup_vertices`` is on, the input is not
batch-normalized, and the batch has more rows than the shared vertex grid
(or its geometry was precomputed); every other GNGF batch goes per row.

Parameters live in :class:`GNGFParams` (``hpd``, None on the vanilla path,
``tables``, ``mlp``, and ``batchnorm`` with its running statistics as
buffers) in the JAX package's layout; ``params_from_jax`` /
``params_to_numpy`` carry them across.

``forward(data_group=...)`` runs one rank's rows of a batch under data
parallelism (``parallel/mesh.py``): the BatchNorm statistics and the loss
marginal are those of every rank's rows of the group (the marginal divides
by the whole batch's rows). Tables sharded by slot (``GNGFParams.shard``, a
``TableShard`` that holds its group) are gathered across that group.
Without either nothing changes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, TopkScatterMode
from ..ops import collisions as coll_ops
from ..ops import dedup as dedup_ops
from ..ops.grid import resolution_ladder, scale_to_grid, voxel_corner_offsets
from ..ops.hashing import fast_hash
from ..ops.interpolate import bilinear_coeffs, interpolate
from ..ops.precision import pdot
from ..ops.collectives import group_size, sum_replicated, sum_shared
from ..utils import prng
from . import encoding as enc
from .hpd import apply_hpd, apply_hpd_fused, apply_hpd_unique
from .mlp import MLP, init_layers

BN_EPS = 1e-5       # torch BatchNorm1d defaults
BN_MOMENTUM = 0.1


class GNGFStatics(NamedTuple):
    """Geometry constants (numpy)."""

    n_ls: np.ndarray            # (L,) int32 resolutions
    offsets: np.ndarray         # (V, d) int32 corner offsets
    unique_coords: np.ndarray   # (U, d) float32 shared vertex grid


class DeviceStatics(NamedTuple):
    """The geometry constants as tensors on one device."""

    n_ls: torch.Tensor            # (L,) int32
    offsets: torch.Tensor         # (V, d) int32
    unique_coords: torch.Tensor   # (U, d) float32


_DEVICE_STATICS: Dict[tuple, DeviceStatics] = {}


def device_statics(statics: GNGFStatics, device) -> DeviceStatics:
    """``statics`` on ``device``, copied once per (geometry, device), so that
    no forward or epoch copies a constant from the host (a pageable copy to
    the card waits for it). Every caller gets the same tensors: read them,
    never write them. The shared vertex grid is id-ordered
    ``{0 .. side-1}^d``, so its shape names it."""
    dev = torch.device(device)
    key = (statics.n_ls.tobytes(), statics.offsets.tobytes(), statics.unique_coords.shape,
           str(dev))
    out = _DEVICE_STATICS.get(key)
    if out is None:
        out = DeviceStatics(*(torch.tensor(a, device=dev) for a in statics))
        _DEVICE_STATICS[key] = out
    return out


class ForwardOut(NamedTuple):
    rgb: torch.Tensor                     # (P, out_channels) sigmoid outputs
    marginal: Optional[torch.Tensor]      # (L, T) loss marginal ((L, K) under keep_topk_only
                                          # on the dedup route); None where probs carry it
    idx_unique: Optional[torch.Tensor] = None  # dedup: (U, K) slots per unique vertex
    counts: Optional[torch.Tensor] = None      # dedup: (L, U) per-level vertex counts
    indices: Optional[torch.Tensor] = None     # per-row: (P, L, V, K) selected slots;
                                               # vanilla: (P, L, V) hash ids
    topk_values: Optional[torch.Tensor] = None # per-row: (P, L, V, K)
    probs: Optional[torch.Tensor] = None       # per-row loss probs: dense (P, L, V, T),
                                               # or the top-k values under keep_topk_only
    bn_state: Optional[dict] = None            # updated running stats {mean, var}


class BatchNormParams(nn.Module):
    """Input BatchNorm: ``scale``/``bias`` (d,) are parameters the optimizer
    never updates (requires_grad off); the running ``mean``/``var`` are
    buffers, so a state_dict copy carries them."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, device=device), requires_grad=False)
        self.register_buffer("mean", torch.zeros(d, device=device))
        self.register_buffer("var", torch.ones(d, device=device))


class GNGFParams(nn.Module):
    """hpd: the index network [d -> hpd_hidden -> T], or None on the
    vanilla path; tables: (L, T, F); mlp: the decoder
    [L*F -> mlp_hidden -> out_channels]; batchnorm: the input BatchNorm, or
    None. ``shard`` (an ``encoding.TableShard``): the tables hold slots
    [lo, hi) of T alone, (L, hi - lo, F) (sharded by slot,
    ``parallel/mesh.py``); None: every slot."""

    def __init__(self, hpd: Optional[MLP], tables: nn.Parameter, mlp: MLP,
                 batchnorm: Optional[BatchNormParams] = None):
        super().__init__()
        self.hpd = hpd
        self.tables = tables
        self.mlp = mlp
        self.batchnorm = batchnorm
        self.shard: Optional[enc.TableShard] = None


def dedup_enabled(cfg: ModelConfig) -> bool:
    return cfg.dedup_vertices and not cfg.use_hash_function and not cfg.batchnorm_input


def make_statics(cfg: ModelConfig) -> GNGFStatics:
    return GNGFStatics(
        n_ls=resolution_ladder(cfg.n_min, cfg.n_max, cfg.num_levels),
        offsets=voxel_corner_offsets(cfg.input_dim),
        unique_coords=dedup_ops.unique_vertex_coords(cfg.n_max, cfg.input_dim),
    )


def init_params(cfg: ModelConfig, seed: int, device="cpu") -> GNGFParams:
    """Fresh parameters, bit for bit the JAX package's
    ``init_params(PRNGKey(seed), cfg)``: its key split (hpd, tables, mlp),
    drawn on the host (``utils.prng``), so the same weights on any device.
    The vanilla path has no HPD."""
    k_hpd, k_tab, k_mlp = prng.split(prng.prng_key(seed), 3)
    hpd = None
    if not cfg.use_hash_function:
        hpd = MLP(init_layers(k_hpd, (cfg.input_dim, *cfg.hpd_hidden, cfg.hash_table_size)),
                  device)
    tables = enc.init_tables(cfg, k_tab, device=device)
    mlp = MLP(init_layers(k_mlp, (cfg.encoded_dim, *cfg.mlp_hidden, cfg.out_channels)), device)
    bn = BatchNormParams(cfg.input_dim, device) if cfg.batchnorm_input else None
    return GNGFParams(hpd, tables, mlp, bn)


def mlp_from_layers(layers, device="cpu") -> MLP:
    """[{"w": (in, out), "b": (out,)}, ...] of numpy arrays -> MLP."""
    return MLP([(lay["w"], lay["b"]) for lay in layers], device)


def params_from_jax(tree, device="cpu", bn_state=None) -> GNGFParams:
    """{["hpd": [{"w", "b"}...],] "tables": (L, T, F), "mlp": [...][,
    "batchnorm": {"scale", "bias"}]} of numpy arrays (the JAX package's
    pytree; no "hpd" on the vanilla path) -> GNGFParams; ``bn_state``
    {"mean", "var"} sets the running statistics (default: fresh ones)."""
    tables = nn.Parameter(
        torch.as_tensor(np.array(tree["tables"], dtype=np.float32)).to(device)
    )
    bn = None
    if "batchnorm" in tree:
        bn = BatchNormParams(int(np.shape(tree["batchnorm"]["scale"])[0]), device)
        with torch.no_grad():
            for name, arr in (*tree["batchnorm"].items(), *(bn_state or {}).items()):
                getattr(bn, name).copy_(torch.as_tensor(np.array(arr, np.float32)))
    hpd = mlp_from_layers(tree["hpd"], device) if "hpd" in tree else None
    return GNGFParams(hpd, tables, mlp_from_layers(tree["mlp"], device), bn)


def bn_state_to_numpy(params: GNGFParams) -> Optional[dict]:
    """The running statistics {"mean", "var"} as numpy, or None."""
    if params.batchnorm is None:
        return None
    return {k: getattr(params.batchnorm, k).detach().cpu().numpy() for k in ("mean", "var")}


def params_to_numpy(params: GNGFParams) -> dict:
    """Inverse of :func:`params_from_jax` (the running statistics:
    :func:`bn_state_to_numpy`)."""

    def layers_of(mlp: MLP):
        return [
            {"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
            for w, b in mlp.layers()
        ]

    out = {
        "tables": params.tables.detach().cpu().numpy(),
        "mlp": layers_of(params.mlp),
    }
    if params.hpd is not None:
        out["hpd"] = layers_of(params.hpd)
    if params.batchnorm is not None:
        out["batchnorm"] = {k: getattr(params.batchnorm, k).detach().cpu().numpy()
                            for k in ("scale", "bias")}
    return out


def batchnorm(bn: BatchNormParams, state: dict, x: torch.Tensor, train: bool, group=None):
    """BatchNorm over (P, d): training mode normalizes with the batch's mean
    and biased variance and moves the running statistics by
    BN_MOMENTUM toward the batch's mean and unbiased variance; eval mode
    normalizes with the running statistics. Returns (y, new_state). With a
    process ``group`` the batch is every rank's rows of it: each sum is
    reduced over it (the mean, then the variance around it)."""
    if train:
        n = x.shape[0]
        total = x.sum(dim=0)
        if group is not None:
            total, n = sum_shared(total, group), n * group_size(group)
        mean = total / n
        d = x - mean
        sq = (d * d).sum(dim=0)
        if group is not None:
            sq = sum_shared(sq, group)
        var = sq / n
        unbiased = var * n / max(n - 1, 1)
        new_state = {
            "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + BN_EPS)
    return y * bn.scale + bn.bias, new_state


def use_dedup(cfg: ModelConfig, statics: GNGFStatics, batch_rows: int, has_geometry: bool) -> bool:
    """Dedup must save work: it runs when precomputed geometry is given, or
    when the batch's rows outnumber the shared vertex grid."""
    return dedup_enabled(cfg) and (
        has_geometry
        or batch_rows * cfg.num_corners * cfg.num_levels > statics.unique_coords.shape[0]
    )


def forward(
    params: GNGFParams,
    x: torch.Tensor,
    cfg: ModelConfig,
    statics: GNGFStatics,
    dedup: Optional[dedup_ops.DedupGeometry] = None,
    bn_state: Optional[dict] = None,
    train: bool = True,
    data_group=None,
) -> ForwardOut:
    """Model forward. ``dedup``: the batch's precomputed geometry (the
    trainer builds it once); None derives ids and counts from ``x`` on its
    device where the dedup route runs (counts only with ``train``: without
    them the marginal is None). ``bn_state``: running statistics
    {"mean", "var"} (default: the params' buffers); they are not modified,
    the updated ones come back in ``ForwardOut.bn_state``. ``data_group``: ``x``
    is this rank's share of the batch's rows, the group's ranks holding the
    rest (data parallelism). Tables sharded by slot (``params.shard``) are
    gathered across the shard's group."""
    consts = device_statics(statics, x.device)
    n_ls, offsets = consts.n_ls, consts.offsets
    shard = params.shard
    new_bn_state = None
    if cfg.batchnorm_input:
        bn = params.batchnorm
        state = bn_state if bn_state is not None else {"mean": bn.mean, "var": bn.var}
        x, new_bn_state = batchnorm(bn, state, x, train, data_group)
    # geometry is data, not a differentiation path
    with torch.no_grad():
        scaled, corners = scale_to_grid(x, n_ls, offsets)

    if cfg.use_hash_function:
        indices = fast_hash(corners, cfg.hash_table_size)              # (P, L, V)
        feats = enc.lookup_vanilla(params.tables, indices, shard)
        h = interpolate(feats, bilinear_coeffs(scaled, offsets))
        rgb = params.mlp(h, cfg.hidden_activation.value, "sigmoid", cfg.matmul_precision)
        return ForwardOut(rgb=rgb, marginal=None, indices=indices, bn_state=new_bn_state)
    if not use_dedup(cfg, statics, x.shape[0], dedup is not None):
        return _forward_per_row(params, cfg, scaled, corners, offsets, new_bn_state, data_group)

    side = dedup_ops.grid_side(cfg.n_max)
    if dedup is not None and dedup.active is not None:
        ucoords = dedup_ops.active_coords(dedup.active, side)
    else:
        ucoords = consts.unique_coords
    if dedup is not None:
        ids, counts = dedup.ids, dedup.counts
    else:
        # inference derives no counts: the tail gets (1, U) zeros and no
        # marginal comes back, as in the JAX package
        ids = dedup_ops.vertex_ids(corners, side)
        counts = dedup_ops.counts_torch(ids, cfg.num_levels, ucoords.shape[0]) if train else None

    marginal_raw, vals_u, idx_u = apply_hpd_unique(params.hpd, ucoords, cfg, counts=counts)
    feats_u = enc.blend_unique(params.tables, idx_u, vals_u, cfg, shard)
    feats = enc.gather_rows(feats_u, ids)                       # (P, L, V, F)
    h = interpolate(feats, bilinear_coeffs(scaled, offsets))    # (P, L*F)
    rgb = params.mlp(h, cfg.hidden_activation.value, "sigmoid", cfg.matmul_precision)

    rows = x.shape[0] * cfg.num_corners
    if counts is None:
        marginal = None
    else:
        if cfg.keep_topk_only:
            marginal_raw = pdot(counts, vals_u, "highest")
        if data_group is not None:
            marginal_raw = sum_replicated(marginal_raw, data_group)
            rows *= group_size(data_group)
        marginal = marginal_raw / rows
    return ForwardOut(rgb=rgb, marginal=marginal, idx_unique=idx_u, counts=counts)


def _forward_per_row(params, cfg, scaled, corners, offsets, bn_state,
                     data_group=None) -> ForwardOut:
    """The HPD on every (pixel, level, corner) row. The fused tail emits the
    marginal; the dense branch (fused_hpd off, or the NOOP top-k, whose
    dropped gradient only the dense branch implements) emits probs. Under
    keep_topk_only the loss marginalizes the top-k values instead. With a
    ``data_group`` the fused marginal (a mean over this rank's rows) becomes
    the mean over the group's, every rank holding as many rows."""
    if cfg.fused_hpd and cfg.topk_scatter is not TopkScatterMode.NOOP:
        marginal, topk_values, topk_indices = apply_hpd_fused(params.hpd, corners, cfg)
        probs = None
        if data_group is not None and not cfg.keep_topk_only:
            marginal = sum_replicated(marginal, data_group) / group_size(data_group)
    else:
        probs, topk_values, topk_indices = apply_hpd(params.hpd, corners, cfg)
        marginal = None
    feats = enc.lookup_topk_blend(params.tables, topk_indices, topk_values, cfg, params.shard)
    h = interpolate(feats, bilinear_coeffs(scaled, offsets))
    rgb = params.mlp(h, cfg.hidden_activation.value, "sigmoid", cfg.matmul_precision)
    if cfg.keep_topk_only:
        loss_probs, loss_marginal = topk_values, None
    else:
        loss_probs, loss_marginal = probs, marginal
    return ForwardOut(rgb=rgb, marginal=loss_marginal, indices=topk_indices,
                      topk_values=topk_values, probs=loss_probs, bn_state=bn_state)


def calc_hash_collisions(indices: torch.Tensor, cfg: ModelConfig, statics: GNGFStatics,
                         group=None):
    """(collisions, min_possible_collisions), both (L,) float32, from the
    per-row (P, L, V, K) selected slots, or the vanilla (P, L, V) hash ids
    (unclamped); with a process ``group``, from every rank's rows."""
    n_ls = device_statics(statics, indices.device).n_ls
    if cfg.use_hash_function:
        coll = coll_ops.hash_collisions_vanilla(indices, n_ls, cfg.hash_table_size, group)
    else:
        coll = coll_ops.hash_collisions_gngf(indices, n_ls, cfg.hash_table_size, group)
    min_poss = coll_ops.min_possible_collisions(n_ls, cfg.hash_table_size).to(torch.float32)
    return coll, min_poss


def calc_counts_per_level(indices: torch.Tensor, corners: torch.Tensor, cfg: ModelConfig,
                          statics: GNGFStatics) -> torch.Tensor:
    """(L, T) int32 slot counts over one pixel per grid cell; GNGF callers
    pass every candidate (P, L, V, K) and the best (k = 0) one is counted,
    vanilla callers the (P, L, V) hash ids."""
    best = indices if cfg.use_hash_function else indices[..., 0]
    return coll_ops.unique_cell_slot_counts(best, corners, statics.n_ls, cfg.hash_table_size)
