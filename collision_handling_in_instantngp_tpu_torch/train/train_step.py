"""One training epoch: a loop over fixed minibatches, then the epoch
statistics.

The pixel set is split into ``ceil(1/batch_fraction)`` slices of ONE fixed
shuffle permutation. When the pixel count does not divide, the last batch
is padded with the first pixels of the permutation and the padded rows are
masked out of the MSE, so each pixel carries one unit of gradient weight per
epoch. Where the dedup route runs, the dedup geometry of every batch (vertex
ids, counts, and the active-vertex compaction where it shrinks the grid) is
built once, on the host, and moved to the device with the batches. On the
per-row route (dedup off, batch-normalized input, or batches smaller than
the vertex grid) the BatchNorm running statistics thread through the
batches and the collisions count the epoch's per-row selected slots; the
vanilla path is a per-row route whose slots are the hash ids.

A counts (histogram) epoch also keeps what its statistics read
(:class:`EpochIds`, ``collect_ids``): the per-row slot ids, or on the dedup
route each batch's unique-vertex slots, counts and vertex ids, never the
(P, L, V, K) per-row ids (5.6 GB at K = 128 and the scaled geometry);
:func:`make_stats_fn` turns them into the slot counts and the unique-cell
counts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig, ModelConfig
from ..models import gngf
from ..ops import collisions as coll_ops
from ..ops import dedup as dedup_ops
from ..ops.collisions import min_possible_collisions
from ..ops.grid import scale_to_grid
from .loss import compute_loss

# compaction engages only when the padded touched set is below this share
# of the shared grid (the 4061 geometry touches ~89%, the scaled one ~61%)
COMPACT_MAX_SHARE = 0.85
COMPACT_ALIGN = 256


@dataclasses.dataclass
class EpochBatches:
    x: torch.Tensor              # (nb, B, d)
    y: torch.Tensor              # (nb, B, C)
    valid: List[int]             # un-padded leading rows per batch
    gather_idx: torch.Tensor     # (P,) row of each pixel in the flat batch order
    og_image: torch.Tensor       # (P, C) int32 original image, pixel order
    dedup: List[Optional[dedup_ops.DedupGeometry]]   # None per batch on the per-row route


@dataclasses.dataclass
class EpochIds:
    """The slot ids of one epoch, each batch's from its own params. Per-row
    and vanilla: ``rows`` (P_padded, L, V[, K]). Dedup route: ``unique``,
    per batch (idx_unique (U_c, K), counts (L, U_c), vertex ids (B, L, V))."""

    rows: Optional[torch.Tensor] = None
    unique: Optional[List[tuple]] = None


@dataclasses.dataclass
class EpochMetrics:
    loss: float                   # mean over batches
    mse: float
    js_kl_per_level: np.ndarray   # (L,) mean over batches
    coll_loss_per_level: np.ndarray
    collisions: np.ndarray        # (L,) this epoch's collisions
    min_possible: np.ndarray      # (L,)
    int_sq_err: float             # MSE of the truncated integer image
    match_count: int              # exactly-equal integer values
    image: Optional[torch.Tensor] = None   # (P, C) predictions in pixel order, on the device
    ids: Optional[EpochIds] = None   # counts epochs (collect_ids) only


def build_epoch_batches(
    coords: np.ndarray,
    targets: np.ndarray,
    batch_fraction: float,
    shuffled_indices: np.ndarray,
    og_image: np.ndarray,
    model_cfg: ModelConfig,
    statics: gngf.GNGFStatics,
    device,
) -> EpochBatches:
    p = coords.shape[0]
    num_batches = int(np.ceil(1.0 / batch_fraction))
    b = int(np.ceil(p / num_batches))
    pad = num_batches * b - p
    perm = np.concatenate([shuffled_indices, shuffled_indices[:pad]])
    x = coords[perm].reshape(num_batches, b, -1)
    y = targets[perm].reshape(num_batches, b, -1)
    inverse = np.zeros(p, dtype=np.int64)
    # padded duplicates: the FIRST occurrence of a pixel wins
    inverse[perm[::-1]] = np.arange(len(perm) - 1, -1, -1)
    valid = [b] * num_batches
    valid[-1] = b - pad

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)

    common = dict(
        x=dev(x, torch.float32),
        y=dev(y, torch.float32),
        valid=valid,
        gather_idx=dev(inverse),
        og_image=dev(og_image.reshape(p, -1).astype(np.int32)),
    )
    if not gngf.use_dedup(model_cfg, statics, b, False):
        return EpochBatches(dedup=[None] * num_batches, **common)

    geoms = [
        dedup_ops.build_geometry_np(x[bi], statics.n_ls, statics.offsets, model_cfg.n_max)
        for bi in range(num_batches)
    ]
    u = statics.unique_coords.shape[0]
    u_c = max(int(np.unique(ids).size) for ids, _ in geoms)
    u_c_pad = -(-u_c // COMPACT_ALIGN) * COMPACT_ALIGN
    compact = u_c_pad < COMPACT_MAX_SHARE * u and model_cfg.input_dim == 2

    dedup = []
    for ids, counts in geoms:
        if compact:
            active, ids_local, counts_c = dedup_ops.compact_geometry_np(
                ids, model_cfg.num_levels, u_c_pad
            )
            dedup.append(dedup_ops.DedupGeometry(
                dev(ids_local, torch.int64), dev(counts_c), dev(active, torch.int64)
            ))
        else:
            dedup.append(dedup_ops.DedupGeometry(dev(ids, torch.int64), dev(counts)))

    return EpochBatches(dedup=dedup, **common)


def initial_collision_state(exp: ExperimentConfig, statics: gngf.GNGFStatics, device):
    """(prev_collisions zeros (L,), min_possible (L,)) for epoch 0."""
    n_ls = torch.as_tensor(statics.n_ls, device=device)
    min_poss = min_possible_collisions(n_ls, exp.model.hash_table_size).to(torch.float32)
    return torch.zeros(exp.model.num_levels, device=device), min_poss


def run_epoch(
    params: gngf.GNGFParams,
    optimizer: torch.optim.Optimizer,
    batches: EpochBatches,
    exp: ExperimentConfig,
    statics: gngf.GNGFStatics,
    prev_collisions: torch.Tensor,
    prev_min_possible: torch.Tensor,
    collect_ids: bool = False,
) -> EpochMetrics:
    """Forward, loss, backward and Adam step for every batch in order, then
    collisions and the integer-image statistics; the epoch's scalars move to
    the host at the end. Collisions: on the dedup route the union of the
    batches' used-slot presence, on the per-row and vanilla routes the
    epoch's selected slots of every row. The BatchNorm running statistics
    move batch by batch in ``params.batchnorm``. ``collect_ids`` keeps the
    epoch's slot ids for :func:`make_stats_fn` (``EpochMetrics.ids``)."""
    mcfg = exp.model
    dev = batches.x.device
    n_ls = torch.as_tensor(statics.n_ls, device=dev)
    rgbs, losses, mses, js_kls, colls, indices, unique = [], [], [], [], [], [], []
    presence = None
    for bi in range(batches.x.shape[0]):
        out = gngf.forward(params, batches.x[bi], mcfg, statics, dedup=batches.dedup[bi])
        aux = compute_loss(
            out.rgb, batches.y[bi], out.marginal, prev_collisions, prev_min_possible,
            exp.loss, valid_rows=batches.valid[bi], probs=out.probs,
        )
        optimizer.zero_grad(set_to_none=True)
        aux.total.backward()
        optimizer.step()
        with torch.no_grad():
            if out.bn_state is not None:
                params.batchnorm.mean.copy_(out.bn_state["mean"])
                params.batchnorm.var.copy_(out.bn_state["var"])
            if out.indices is not None:
                indices.append(out.indices)
            else:
                used = dedup_ops.used_slot_presence(out.idx_unique, out.counts, mcfg.hash_table_size)
                presence = used if presence is None else presence | used
                if collect_ids:
                    unique.append((out.idx_unique.detach(), out.counts, batches.dedup[bi].ids))
        rgbs.append(out.rgb.detach())
        losses.append(aux.total.detach())
        mses.append(aux.mse.detach())
        js_kls.append(aux.js_kl_per_level.detach())
        colls.append(aux.coll_per_level)

    with torch.no_grad():
        if indices:
            collisions, _ = gngf.calc_hash_collisions(torch.cat(indices), mcfg, statics)
        else:
            collisions = dedup_ops.collisions_from_presence(presence, n_ls)
        image = torch.cat(rgbs).reshape(-1, rgbs[0].shape[-1])[batches.gather_idx]
        pred_int = (image * 255).to(torch.int32)
        diff = (pred_int - batches.og_image).to(torch.float32)
        int_sq_err = torch.mean(diff * diff)
        match_count = torch.sum(pred_int == batches.og_image)
        host = [
            t.cpu() for t in (
                torch.stack(losses).mean(), torch.stack(mses).mean(),
                torch.stack(js_kls).mean(0), torch.stack(colls).mean(0),
                collisions, prev_min_possible, int_sq_err, match_count,
            )
        ]
    return EpochMetrics(
        loss=float(host[0]), mse=float(host[1]),
        js_kl_per_level=host[2].numpy(), coll_loss_per_level=host[3].numpy(),
        collisions=host[4].numpy(), min_possible=host[5].numpy(),
        int_sq_err=float(host[6]), match_count=int(host[7]), image=image,
        ids=(None if not collect_ids else
             EpochIds(rows=torch.cat(indices)) if indices else EpochIds(unique=unique)),
    )


def make_stats_fn(exp: ExperimentConfig, statics: gngf.GNGFStatics):
    """The statistics of a counts epoch, as the JAX package's
    ``make_stats_fn``: ``stats_fn(ids, coords)`` -> (slot counts (L, T),
    unique-cell counts (L, T)), int32, on the ids' device. ``ids``: an
    :class:`EpochIds`, or the per-row (P_padded, L, V[, K]) slot ids;
    ``coords``: the epoch's (P_padded, d) rows in batch order (the rows of
    ``EpochBatches.x``, not batch-normalized). The cell counts read the best
    (k = 0) candidate of every row."""
    mcfg = exp.model
    t = mcfg.hash_table_size

    def stats_fn(ids, coords: torch.Tensor):
        if isinstance(ids, torch.Tensor):
            ids = EpochIds(rows=ids)
        dev = coords.device
        if ids.rows is not None:
            slots, rows = coll_ops.slot_counts(ids.rows, t), ids.rows
        else:
            slots = sum(coll_ops.slot_counts_unique(idx_u, counts, t)
                        for idx_u, counts, _ in ids.unique).to(torch.int32)
            # the best (k = 0) candidate of every row, as (B, L, V, 1)
            rows = torch.cat([idx_u[:, :1][vid] for idx_u, _, vid in ids.unique])
        _, corners = scale_to_grid(coords, torch.as_tensor(statics.n_ls, device=dev),
                                   torch.as_tensor(statics.offsets, device=dev))
        cells = gngf.calc_counts_per_level(rows[: corners.shape[0]], corners, mcfg, statics)
        return slots, cells

    return stats_fn
