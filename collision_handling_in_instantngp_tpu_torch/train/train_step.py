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

Data parallelism (``parallel/``): :func:`shard_batches` keeps a rank's
share of every batch's rows, with the dedup geometry of those rows alone
(so each rank's HPD runs on the vertices its rows touch, and the
counts-weighted marginals add up across ranks), and
``epoch_on_device(data_group=...)`` sums the gradients over the mesh's data
group before each Adam step, ORs the collisions' presence over it and gathers
the image from it, so every rank ends the epoch with the same parameters
and scalars.

:func:`epoch_on_device` leaves the epoch's scalars on the device (the
geometry constants and the previous epoch's collisions live there too, so an
epoch reads nothing on the host and copies nothing to the card);
:func:`run_epoch` is that epoch with one transfer to the host at its end,
and :func:`run_span` runs n epochs back to back, carrying the best epoch's
state in a :class:`BestTracker`, with the stacked scalars
(:class:`SpanMetrics`) transferred once by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig, ModelConfig
from ..models import gngf
from ..ops import collisions as coll_ops
from ..ops import dedup as dedup_ops
from ..ops.collisions import min_possible_collisions
from ..ops.grid import scale_to_grid
from ..ops import collectives
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
    valid_total: Optional[List[int]] = None   # a rank's share (shard_batches): the
                                              # whole batches' valid rows


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
    collisions_device: Optional[torch.Tensor] = None   # ``collisions`` on the device


SCALARS = ("loss", "mse", "js_kl_per_level", "coll_loss_per_level", "collisions",
           "min_possible", "int_sq_err", "match_count")


def _host_metrics(h) -> EpochMetrics:
    """EpochMetrics of one epoch's scalars on the host ({name: numpy})."""
    return EpochMetrics(
        loss=float(h["loss"]), mse=float(h["mse"]), js_kl_per_level=h["js_kl_per_level"],
        coll_loss_per_level=h["coll_loss_per_level"], collisions=h["collisions"],
        min_possible=h["min_possible"], int_sq_err=float(h["int_sq_err"]),
        match_count=int(h["match_count"]),
    )


@dataclasses.dataclass
class EpochTensors:
    """One epoch's statistics as tensors on the run's device: the fields of
    :class:`EpochMetrics`, each 0-d or (L,)."""

    loss: torch.Tensor
    mse: torch.Tensor
    js_kl_per_level: torch.Tensor
    coll_loss_per_level: torch.Tensor
    collisions: torch.Tensor
    min_possible: torch.Tensor
    int_sq_err: torch.Tensor
    match_count: torch.Tensor
    image: torch.Tensor
    ids: Optional[EpochIds] = None

    def to_host(self) -> EpochMetrics:
        """The scalars copied to the host (this waits for the epoch)."""
        m = _host_metrics({name: getattr(self, name).cpu().numpy() for name in SCALARS})
        return dataclasses.replace(m, image=self.image, ids=self.ids,
                                   collisions_device=self.collisions)


@dataclasses.dataclass
class SpanMetrics:
    """The scalars of n consecutive epochs, each field stacked on a leading
    (n,) axis (JAX ``train_step.SpanMetrics``); tensors on the device, or
    numpy arrays after :meth:`to_host`."""

    loss: torch.Tensor                  # (n,)
    mse: torch.Tensor                   # (n,)
    js_kl_per_level: torch.Tensor       # (n, L)
    coll_loss_per_level: torch.Tensor   # (n, L)
    collisions: torch.Tensor            # (n, L)
    min_possible: torch.Tensor          # (n, L)
    int_sq_err: torch.Tensor            # (n,)
    match_count: torch.Tensor           # (n,)

    @classmethod
    def stack(cls, epochs: List[EpochTensors]) -> "SpanMetrics":
        return cls(**{name: torch.stack([getattr(m, name) for m in epochs]) for name in SCALARS})

    def to_host(self) -> "SpanMetrics":
        return SpanMetrics(**{name: getattr(self, name).cpu().numpy() for name in SCALARS})

    def epoch(self, j: int) -> EpochMetrics:
        """Epoch j of a host copy, as :class:`EpochMetrics` (no image)."""
        return _host_metrics({name: getattr(self, name)[j] for name in SCALARS})


class BestTracker:
    """The best epoch's state, kept on the device (JAX ``make_jitted``'s
    ``track_best``): the params' ``state_dict`` (BatchNorm buffers
    included) and, with ``optimizer``, its state. :meth:`update` after an
    epoch selects with ``torch.where`` on ``int_sq_err <= err`` (ties go to
    the later epoch) into buffers allocated at its first call, so nothing is
    read on the host. Optimizer state that lives on the host (Adam's
    ``step``) is recorded per epoch instead and picked by :meth:`settle`
    once the host has read the best epoch (``epoch``). :meth:`reset`
    starts a new search (a fit's tracker searches one span at a time, an
    ensemble member's the whole run)."""

    def __init__(self, params: gngf.GNGFParams, optimizer: Optional[torch.optim.Optimizer] = None):
        self.params, self.optimizer = params, optimizer
        self.err: Optional[torch.Tensor] = None     # () float32, inf before any epoch
        self.epoch: Optional[torch.Tensor] = None   # () int64: the best epoch's number
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.opt: Dict[int, Dict[str, torch.Tensor]] = {}
        self.host_opt: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}   # epoch -> state

    def _allocate(self, err: torch.Tensor) -> None:
        self.err = torch.full((), float("inf"), dtype=err.dtype, device=err.device)
        self.epoch = torch.zeros((), dtype=torch.int64, device=err.device)
        self.state = {k: torch.empty_like(v) for k, v in self.params.state_dict().items()}

    def reset(self) -> None:
        if self.err is not None:
            self.err.fill_(float("inf"))
        self.host_opt.clear()

    def update(self, err: torch.Tensor, epoch: int) -> None:
        if self.err is None:
            self._allocate(err)
        better = err <= self.err
        torch.where(better, err, self.err, out=self.err)
        self.epoch.masked_fill_(better, epoch)
        for k, v in self.params.state_dict().items():
            torch.where(better, v, self.state[k], out=self.state[k])
        if self.optimizer is None:
            return
        host = {}
        for p, st in self.optimizer.state.items():
            bufs = self.opt.setdefault(id(p), {})
            for name, v in st.items():
                if v.device != err.device:
                    host.setdefault(id(p), {})[name] = v.clone()
                    continue
                if name not in bufs:
                    bufs[name] = v.clone()     # its first epoch: nothing to keep yet
                torch.where(better, v, bufs[name], out=bufs[name])
        self.host_opt[epoch] = host

    def settle(self, best_epoch: int) -> None:
        """Keep only the host-side state of ``best_epoch`` (the host's read
        of :attr:`epoch`)."""
        keep = self.host_opt.get(best_epoch)
        self.host_opt.clear()
        if keep is not None:
            self.host_opt[best_epoch] = keep

    def snapshot(self, best_epoch: int):
        """(state_dict, optimizer state {id(param): state} or None): copies
        of the best epoch's state, the trainer's checkpoint snapshot."""
        state = {k: v.clone() for k, v in self.state.items()}
        if self.optimizer is None:
            return state, None
        host = self.host_opt.get(best_epoch, {})
        opt = {pid: {**{k: v.clone() for k, v in bufs.items()}, **host.get(pid, {})}
               for pid, bufs in self.opt.items()}
        return state, opt


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
    return EpochBatches(dedup=_dedup_geometry(x, model_cfg, statics, device), **common)


def _dedup_geometry(x: np.ndarray, model_cfg: ModelConfig, statics: gngf.GNGFStatics,
                    device) -> List[dedup_ops.DedupGeometry]:
    """The dedup geometry of every batch of (nb, B, d) rows, on ``device``:
    compacted to the touched vertices where that shrinks the grid enough."""
    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)

    geoms = [
        dedup_ops.build_geometry_np(x[bi], statics.n_ls, statics.offsets, model_cfg.n_max)
        for bi in range(x.shape[0])
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
    return dedup


def shard_batches(batches: EpochBatches, lo: int, hi: int, model_cfg: ModelConfig,
                  statics: gngf.GNGFStatics) -> EpochBatches:
    """Rows [lo, hi) of every batch: a rank's share under data parallelism.
    The route stays the whole batch's (dedup or per-row); the dedup geometry
    is rebuilt on the host from these rows alone. ``gather_idx`` and
    ``og_image`` stay whole (every rank assembles the whole image)."""
    x = batches.x[:, lo:hi].contiguous()
    dedup = [None] * x.shape[0]
    if batches.dedup[0] is not None:
        dedup = _dedup_geometry(x.cpu().numpy(), model_cfg, statics, x.device)
    return EpochBatches(
        x=x, y=batches.y[:, lo:hi].contiguous(),
        valid=[min(max(v - lo, 0), hi - lo) for v in batches.valid],
        gather_idx=batches.gather_idx, og_image=batches.og_image, dedup=dedup,
        valid_total=list(batches.valid if batches.valid_total is None else batches.valid_total),
    )


def initial_collision_state(exp: ExperimentConfig, statics: gngf.GNGFStatics, device):
    """(prev_collisions zeros (L,), min_possible (L,)) for epoch 0."""
    n_ls = gngf.device_statics(statics, device).n_ls
    min_poss = min_possible_collisions(n_ls, exp.model.hash_table_size).to(torch.float32)
    return torch.zeros(exp.model.num_levels, device=device), min_poss


def epoch_on_device(
    params: gngf.GNGFParams,
    optimizer: torch.optim.Optimizer,
    batches: EpochBatches,
    exp: ExperimentConfig,
    statics: gngf.GNGFStatics,
    prev_collisions: torch.Tensor,
    prev_min_possible: torch.Tensor,
    collect_ids: bool = False,
    data_group=None,
) -> EpochTensors:
    """Forward, loss, backward and Adam step for every batch in order, then
    collisions and the integer-image statistics, all left on the device.
    Collisions: on the dedup route the union of the batches' used-slot
    presence, on the per-row and vanilla routes the epoch's selected slots
    of every row. The BatchNorm running statistics move batch by batch in
    ``params.batchnorm``. ``collect_ids`` keeps the epoch's slot ids for
    :func:`make_stats_fn` (``EpochTensors.ids``). ``data_group``: ``batches``
    is this rank's share (:func:`shard_batches`) and the group's ranks hold
    the rest; the gradients are summed over the group before each step, and
    the collisions and the image are those of every rank's rows (no counts
    epoch: ``collect_ids`` raises)."""
    if data_group is not None and collect_ids:
        raise ValueError("collect_ids: a counts epoch runs without a data group")
    mcfg = exp.model
    n_ls = gngf.device_statics(statics, batches.x.device).n_ls
    rgbs, losses, mses, js_kls, colls, indices, unique = [], [], [], [], [], [], []
    presence = None
    for bi in range(batches.x.shape[0]):
        out = gngf.forward(params, batches.x[bi], mcfg, statics, dedup=batches.dedup[bi],
                           data_group=data_group)
        aux = compute_loss(
            out.rgb, batches.y[bi], out.marginal, prev_collisions, prev_min_possible,
            exp.loss, valid_rows=batches.valid[bi], probs=out.probs, data_group=data_group,
            valid_total=None if batches.valid_total is None else batches.valid_total[bi],
        )
        optimizer.zero_grad(set_to_none=True)
        aux.total.backward()
        if data_group is not None:
            collectives.all_reduce_grads(params.parameters(), data_group)
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
            collisions, _ = gngf.calc_hash_collisions(torch.cat(indices), mcfg, statics, data_group)
        else:
            if data_group is not None:
                presence = collectives.union(presence, data_group)
            collisions = dedup_ops.collisions_from_presence(presence, n_ls)
        if data_group is None:
            image = torch.cat(rgbs)
        else:   # (nb, B / D, C) of every rank, in row order
            image = torch.cat(collectives.all_gather(torch.stack(rgbs), data_group), dim=1)
        image = image.reshape(-1, rgbs[0].shape[-1])[batches.gather_idx]
        pred_int = (image * 255).to(torch.int32)
        diff = (pred_int - batches.og_image).to(torch.float32)
        return EpochTensors(
            loss=torch.stack(losses).mean(), mse=torch.stack(mses).mean(),
            js_kl_per_level=torch.stack(js_kls).mean(0),
            coll_loss_per_level=torch.stack(colls).mean(0),
            collisions=collisions, min_possible=prev_min_possible,
            int_sq_err=torch.mean(diff * diff),
            match_count=torch.sum(pred_int == batches.og_image), image=image,
            ids=(None if not collect_ids else
                 EpochIds(rows=torch.cat(indices)) if indices else EpochIds(unique=unique)),
        )


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
    """:func:`epoch_on_device`, its scalars moved to the host at the end."""
    return epoch_on_device(params, optimizer, batches, exp, statics, prev_collisions,
                           prev_min_possible, collect_ids).to_host()


def run_span(
    params: gngf.GNGFParams,
    optimizer: torch.optim.Optimizer,
    batches: EpochBatches,
    exp: ExperimentConfig,
    statics: gngf.GNGFStatics,
    prev_collisions: torch.Tensor,
    prev_min_possible: torch.Tensor,
    n: int,
    best: Optional[BestTracker] = None,
    first_epoch: int = 0,
):
    """``n`` epochs back to back (JAX ``make_jitted(span=n)``), each feeding
    its collisions to the next; nothing is read on the host. ``best``
    (optional) is updated after every epoch, numbered from
    ``first_epoch``. No epoch but the last keeps its slot ids (a span's last
    epoch can be the stop epoch, which the trainer's statistics read; JAX's
    per-row span returns that epoch's indices too). Returns (the stacked
    scalars, the last epoch's :class:`EpochTensors`)."""
    epochs = []
    last = None
    for j in range(n):
        last = epoch_on_device(params, optimizer, batches, exp, statics, prev_collisions,
                               prev_min_possible, collect_ids=j == n - 1)
        prev_collisions = last.collisions
        if best is not None:
            best.update(last.int_sq_err, first_epoch + j)
        epochs.append(dataclasses.replace(last, image=None, ids=None))
    return SpanMetrics.stack(epochs), last


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
        consts = gngf.device_statics(statics, coords.device)
        if ids.rows is not None:
            slots, rows = coll_ops.slot_counts(ids.rows, t), ids.rows
        else:
            slots = sum(coll_ops.slot_counts_unique(idx_u, counts, t)
                        for idx_u, counts, _ in ids.unique).to(torch.int32)
            # the best (k = 0) candidate of every row, as (B, L, V, 1)
            rows = torch.cat([idx_u[:, :1][vid] for idx_u, _, vid in ids.unique])
        _, corners = scale_to_grid(coords, consts.n_ls, consts.offsets)
        cells = gngf.calc_counts_per_level(rows[: corners.shape[0]], corners, mcfg, statics)
        return slots, cells

    return stats_fn
