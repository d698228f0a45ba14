"""Training drivers: ``fit``, the epoch loop of one configuration, and
``fit_ensemble``, several configurations of one shape trained side by side.

Per epoch: the scalar metrics, PSNR from the integer-image error, the
zero-collision abort (the last two levels collision-free for the first 10
checked epochs), early stopping on the loss, and one row to the metric
logger in the JAX package's schema. Counts (histogram) epochs, the last
epoch, every ``histograms_rate``-th and the early-stop epoch, also log the
per-level slot counts ``hist_counts_level{l}_counts`` (and, for a logger
that is not null, the reconstructed ``train_image``; for one that stores
media, the per-level histogram figures).

The best-PSNR parameters, optimizer state and BatchNorm running statistics
are kept on the device; with ``save_params`` they are written to
``{checkpoint_dir}/{grid_id}_{stamp}`` at most every
``checkpoint_min_interval_s`` and flushed at the end, in the JAX package's
format (``utils/checkpoint.py``), so that either package warm-starts from
the other's run directory.

Spans (``fit(epoch_span=S)``) run up to S epochs back to back with nothing
read on the host (``train_step.run_span``), then the host loop above runs
over the span's scalars. ``fit_ensemble`` trains its members in lockstep:
span by span and, within a span, epoch by epoch, each active member's epoch
in turn, so every member runs exactly the launches of its solo fit through
the same kernels. The JAX package shares one XLA program and one stacked
batch set across a vmapped group (its ``HyperParams``, ``EpochFnCache`` and
``stack_epoch_batches``); the lockstep port compiles nothing and keeps each
member's batches apart, so it has no counterpart of them.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import ImageData, make_shuffle_permutations
from ..device import resolve_device
from ..models import gngf
from ..utils import checkpoint as ckpt
from ..utils.logging import MetricLogger, NullLogger
from ..utils.metrics import to_uint8_image
from .early_stopping import EarlyStopping
from .optimizer import load_optax_state, make_optimizer, to_optax_state
from .train_step import (
    BestTracker, EpochBatches, SpanMetrics, build_epoch_batches, epoch_on_device,
    initial_collision_state, make_stats_fn, run_epoch, run_span,
)


@dataclasses.dataclass
class FitResult:
    best_psnr: float
    final_psnr: float
    final_loss: float
    epochs_run: int
    stopped_early: bool
    zero_collision_abort: bool
    params: gngf.GNGFParams            # after the last epoch
    best_params: gngf.GNGFParams       # at the best-PSNR epoch
    history: List[Dict[str, float]]
    run_dir: Optional[str] = None      # the checkpoint directory (save_params)
    final_image: Optional[np.ndarray] = None   # (h, w[, 3]) int image of the last epoch


def psnr_from_int_sq_err(og_max: float, int_sq_err: float) -> float:
    return float(20 * np.log10(og_max) - 10 * np.log10(max(int_sq_err, 1e-12)))


def _snapshot(params: gngf.GNGFParams, optimizer: Optional[torch.optim.Optimizer]):
    """Device copies of the params (buffers included) and, where given, of
    the optimizer's state tensors ({id(param): state})."""
    state = {k: v.detach().clone() for k, v in params.state_dict().items()}
    opt = None
    if optimizer is not None:
        opt = {id(p): {k: v.clone() for k, v in s.items()} for p, s in optimizer.state.items()}
    return state, opt


def _write_checkpoint(run_dir, snapshot, params, freeze_hpd, mcfg) -> None:
    """The best snapshot in the JAX package's format (``params`` gives the
    tree's shape and the optimizer state's keys)."""
    state, opt = snapshot
    best = copy.deepcopy(params)
    best.load_state_dict(state)
    ckpt.save_run_checkpoint(run_dir, gngf.params_to_numpy(best),
                             to_optax_state(opt, params, freeze_hpd),
                             gngf.bn_state_to_numpy(best), model_cfg=mcfg)


def fit(
    exp: ExperimentConfig,
    data: ImageData,
    *,
    epochs: Optional[int] = None,
    device="cuda",
    params: Optional[gngf.GNGFParams] = None,
    verbose: bool = True,
    logger: Optional[MetricLogger] = None,
    run_name: Optional[str] = None,
    hpd_weights_path: Optional[str] = None,
    encoding_weights_path: Optional[str] = None,
    warm_start_dir: Optional[str] = None,
    log_image_every: Optional[int] = None,
    collect_history: bool = True,
    progress: bool = False,
    epoch_span: int = 1,
) -> FitResult:
    """Train one configuration. ``params``: initial weights (default: fresh
    ones from ``exp.train.seed``), moved to ``device``; the caller's copy is
    not modified. ``hpd_weights_path``: an ``HPD_model.pkl`` whose HPD is
    loaded and frozen; ``encoding_weights_path``: an ``encoding_model.pkl``
    whose tables start the run; ``warm_start_dir``: a run directory (of
    either package) whose params, optimizer state and BatchNorm statistics
    continue, its config stamp checked. ``log_image_every=N`` also logs
    ``train_image`` every N epochs. ``run_name`` names the checkpoint
    directory (default: a time stamp). ``progress=True`` shows a tqdm bar
    with the PSNR where tqdm is installed (nothing where it is not);
    ``collect_history=False`` leaves ``history`` empty and changes nothing
    else.

    ``epoch_span=S > 1`` runs up to S epochs a call with nothing read on the
    host, then evaluates logging, PSNR, the best-PSNR rule, early stopping
    and the zero-collision abort per epoch from the span's scalars, as the
    JAX package's ``fit(epoch_span=S)`` schedules it: counts epochs, the
    last epoch, a known stop and ``log_image_every`` epochs run alone, the
    others in spans cut before the next of them. The span carries its best
    epoch's state on the device, so the best-PSNR snapshot is that epoch's
    exactly. Two divergences from ``epoch_span=1``, the JAX package's: a
    stop inside a span leaves the state (``params``, ``final_image``) at the
    span's end, and a stop epoch inside a span, not its last, logs no
    ``hist_counts_*``. ``epoch_span <= 1`` is one epoch a call.

    The history rows hold the logged scalars plus ``epoch``, ``seconds``
    (the epoch and its transfer to the host; in a span, the span's time over
    its epochs, and ``span_epochs`` the span's length), ``pixels_per_s``,
    ``stats_seconds`` (the counts epoch's statistics, image and figures)
    and ``ckpt_seconds`` (the snapshot and checkpoint write)."""
    dev = resolve_device(device)
    tcfg, mcfg, lcfg = exp.train, exp.model, exp.loss
    logger = logger or NullLogger()
    epochs = epochs if epochs is not None else tcfg.epochs
    if log_image_every is not None and log_image_every < 1:
        raise ValueError(f"log_image_every must be >= 1, got {log_image_every}")
    statics = gngf.make_statics(mcfg)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, tcfg.seed, tcfg.shuffle_pixels)
    batches = build_epoch_batches(
        data.coords, data.targets, tcfg.batch_fraction, shuffled, data.image,
        mcfg, statics, dev,
    )
    if params is None:
        params = gngf.init_params(mcfg, tcfg.seed, dev)
    else:
        params = copy.deepcopy(params).to(dev)
    freeze_hpd = hpd_weights_path is not None
    if freeze_hpd:
        ckpt.load_hpd_weights(params, hpd_weights_path)
    if encoding_weights_path is not None:
        ckpt.load_encoding_weights(params, encoding_weights_path)
    if warm_start_dir is not None:
        tree, opt_tree, bn_state = ckpt.load_run_checkpoint(warm_start_dir, model_cfg=mcfg)
        params = gngf.params_from_jax(tree, dev, bn_state=bn_state)
    optimizer = make_optimizer(exp.optimizer, params, freeze_hpd=freeze_hpd)
    if warm_start_dir is not None:
        load_optax_state(optimizer, params, opt_tree)
    prev_coll, min_poss = initial_collision_state(exp, statics, dev)
    stats_fn = make_stats_fn(exp, statics)
    flat_coords = batches.x.reshape(-1, batches.x.shape[-1])

    run_dir = None
    if tcfg.save_params:
        stamp = run_name or time.strftime("%Y%m%d%H%M%S")
        rid = exp.grid_id if exp.grid_id is not None else "run"
        run_dir = os.path.join(tcfg.checkpoint_dir, f"{rid}_{stamp}")
    opt_to_keep = optimizer if run_dir is not None else None
    tracker = BestTracker(params, opt_to_keep) if epoch_span > 1 else None

    early_stopper = EarlyStopping(tolerance=tcfg.tolerance, min_delta=tcfg.min_delta)
    rate = tcfg.histograms_rate
    og_max = float(np.max(data.image))
    values_per_img = data.num_pixels * data.channels
    best_psnr, best_snapshot = 0.0, None
    last_ckpt_write = 0.0
    history: List[Dict[str, float]] = []
    check_last2: List[bool] = []
    zero_coll_abort = False
    train_loss = train_psnr = float("nan")
    epochs_run = 0
    image = None

    pbar = None
    if progress:
        try:
            from tqdm import tqdm

            pbar = tqdm(total=epochs)
        except ImportError:
            pass

    def counts_epoch(ep: int) -> bool:
        return ep == epochs - 1 or (rate > 0 and ep % rate == 0) or early_stopper.early_stop

    def image_epoch(ep: int) -> bool:
        return log_image_every is not None and ep % log_image_every == 0

    def span_length(e: int) -> int:
        if epoch_span <= 1 or counts_epoch(e) or image_epoch(e):
            return 1
        n = min(epoch_span, epochs - 1 - e)
        for every in (rate if rate > 0 else None, log_image_every):
            if every is not None:
                n = min(n, (e // every + 1) * every - e)
        return max(1, n)

    e, stop = 0, False
    while e < epochs and not stop:
        n = span_length(e)
        t0 = time.perf_counter()
        if n == 1:
            # a counts epoch keeps its slot ids; so does the epoch at which
            # the zero-collision abort can fire (its 10th check), since the
            # abort makes it the early-stop epoch
            abort_check = (tcfg.zero_collision_abort and e != 0 and len(check_last2) == 9
                           and all(check_last2))
            m = run_epoch(params, optimizer, batches, exp, statics, prev_coll, min_poss,
                          collect_ids=counts_epoch(e) or abort_check)
            rows, prev_coll, image, ids = [m], m.collisions_device, m.image, m.ids
        else:
            tracker.reset()
            span, last = run_span(params, optimizer, batches, exp, statics, prev_coll, min_poss,
                                  n, tracker, first_epoch=e)
            span = span.to_host()
            rows = [span.epoch(j) for j in range(n)]
            prev_coll, image, ids = last.collisions, last.image, last.ids
        seconds = (time.perf_counter() - t0) / n   # each epoch ends in a host transfer
        span_snapshot = None

        for j, m in enumerate(rows):
            ep = e + j
            train_loss = m.loss
            train_psnr = psnr_from_int_sq_err(og_max, m.int_sq_err)
            epochs_run = ep + 1

            if tcfg.zero_collision_abort and ep != 0 and len(check_last2) < 10:
                check_last2.append(bool(np.all(m.collisions[-2:] == 0)))
                if len(check_last2) == 10 and all(check_last2):
                    if verbose:
                        print(f"!!! Stopping at epoch: {ep} because of 0 collisions!!!")
                    zero_coll_abort = True
                    early_stopper.early_stop = True

            log: Dict[str, Any] = {
                "train_loss": train_loss,
                "train_accuracy": m.match_count / values_per_img * 100.0,
                "train_psnr": train_psnr,
                "mse_loss": m.mse,
            }
            if not mcfg.use_hash_function:
                for l in range(mcfg.num_levels):
                    js_kl, coll_loss = m.js_kl_per_level[l], m.coll_loss_per_level[l]
                    log[f"kl_div_loss_level{l}"] = float(js_kl)
                    log[f"collisions_loss_level{l}"] = float(coll_loss)
                    log[f"kl_collisions_loss_level{l}"] = float(
                        lcfg.l_js_kl * js_kl + lcfg.l_collisions * coll_loss)
            for l in range(mcfg.num_levels):
                log[f"collisions_level{l}"] = float(m.collisions[l])
                log[f"min_possible_collisions_level{l}"] = float(m.min_possible[l])

            t_stats = time.perf_counter()
            # the statistics and image are the span's last epoch's: a stop
            # epoch before it logs none
            if counts_epoch(ep) and j == n - 1:
                slot_c, _ = stats_fn(ids, flat_coords)
                slot_c = slot_c.cpu().numpy()
                for l in range(mcfg.num_levels):
                    log[f"hist_counts_level{l}_counts"] = slot_c[l]
                if not isinstance(logger, NullLogger):
                    log["train_image"] = to_uint8_image(image.cpu().numpy(), data.height,
                                                        data.width, data.channels)
                    if logger.stores_media:
                        from ..utils.histograms import counts_per_level_histograms

                        figs = counts_per_level_histograms(slot_c, mcfg.hash_table_size)
                        for l, fig in enumerate(figs):
                            log[f"hist_counts_level{l}"] = fig
            if (image_epoch(ep) and "train_image" not in log
                    and not isinstance(logger, NullLogger)):
                log["train_image"] = to_uint8_image(image.cpu().numpy(), data.height, data.width,
                                                    data.channels)
            stats_seconds = time.perf_counter() - t_stats
            logger.log(log, step=ep)

            t_ckpt = time.perf_counter()
            if train_psnr >= best_psnr:
                best_psnr = train_psnr
                if n == 1:
                    best_snapshot = _snapshot(params, opt_to_keep)
                else:
                    # the device best of the span: this epoch, or a later
                    # one of the span where the rule fires again
                    if span_snapshot is None:
                        span_snapshot = tracker.snapshot(int(tracker.epoch))
                    best_snapshot = span_snapshot
                if run_dir is not None:
                    now = time.monotonic()
                    if now - last_ckpt_write >= tcfg.checkpoint_min_interval_s:
                        _write_checkpoint(run_dir, best_snapshot, params, freeze_hpd, mcfg)
                        last_ckpt_write = now
            ckpt_seconds = time.perf_counter() - t_ckpt

            if pbar is not None:
                pbar.update(1)
                pbar.set_description(f"Training_psnr: {train_psnr}")
            if collect_history:
                history.append({
                    "epoch": ep, **{k: v for k, v in log.items() if isinstance(v, (int, float))},
                    "seconds": seconds, "pixels_per_s": data.num_pixels / seconds,
                    "stats_seconds": stats_seconds, "ckpt_seconds": ckpt_seconds,
                    **({"span_epochs": n} if n > 1 else {})})
            if verbose:
                print(f"epoch {ep}: loss {train_loss:.6f} psnr {train_psnr:.4f} "
                      f"({seconds:.3f} s, {data.num_pixels / seconds:.0f} px/s)")

            if early_stopper.early_stop:
                if verbose and not zero_coll_abort:
                    print(f"!!! Stopping at epoch: {ep} !!!")
                stop = True
                break
            if ep != 0:
                early_stopper(train_loss)
        e += n

    if pbar is not None:
        pbar.close()
    if best_snapshot is not None and run_dir is not None:
        _write_checkpoint(run_dir, best_snapshot, params, freeze_hpd, mcfg)
    logger.finish()
    best_params = copy.deepcopy(params)
    if best_snapshot is not None:
        best_params.load_state_dict(best_snapshot[0])
    return FitResult(
        best_psnr=best_psnr,
        final_psnr=train_psnr,
        final_loss=train_loss,
        epochs_run=epochs_run,
        stopped_early=early_stopper.early_stop,
        zero_collision_abort=zero_coll_abort,
        params=params,
        best_params=best_params,
        history=history,
        run_dir=run_dir,
        final_image=(None if image is None else
                     to_uint8_image(image.cpu().numpy(), data.height, data.width, data.channels)),
    )


@dataclasses.dataclass
class _Member:
    """One configuration of an ensemble and its training state."""

    exp: ExperimentConfig
    params: gngf.GNGFParams
    optimizer: torch.optim.Optimizer
    batches: EpochBatches
    prev_coll: torch.Tensor
    min_poss: torch.Tensor
    tracker: BestTracker
    image: Optional[torch.Tensor] = None


def _check_shapes(exps: List[ExperimentConfig]) -> None:
    if not exps:
        raise ValueError("fit_ensemble needs at least one configuration")
    base = exps[0]
    for i, e in enumerate(exps[1:], 1):
        what = ("model" if e.model != base.model else
                "batch_fraction" if e.train.batch_fraction != base.train.batch_fraction else None)
        if what is not None:
            raise ValueError(f"ensemble member {i} (grid {e.grid_id}) differs from member 0 "
                             f"(grid {base.grid_id}) in its {what}: ensemble configurations "
                             "must share one shape")


def fit_ensemble(
    exps: List[ExperimentConfig],
    data: ImageData,
    *,
    epochs: Optional[int] = None,
    epoch_span: int = 33,
    loggers: Optional[List[MetricLogger]] = None,
    run_names: Optional[List[str]] = None,
    verbose: bool = False,
    per_member_shuffle: bool = True,
    device="cuda",
) -> List[FitResult]:
    """Train E configurations of one shape (the same ``model`` and
    ``batch_fraction``; ValueError names the first that differs) side by
    side, with the JAX package's ``fit_ensemble`` semantics.

    Each member has its own params (from its ``train.seed``), its own
    three-group Adam from its ``exp.optimizer`` and its own loss weights.
    ``per_member_shuffle`` (where the seeds differ) gives each member its own
    pixel shuffle, so it reproduces its solo ``fit``; otherwise every member
    trains on ``exps[0]``'s. The members run in lockstep, span by span
    (``epoch_span`` epochs, fewer at the end), within a span epoch by epoch,
    each active member's epoch in turn; the scalars come to the host once a
    span. Per member, on the host: the logger rows (the reduced schema:
    loss, accuracy, PSNR, MSE, JS/KL and collisions per level), the
    zero-collision abort, and early stopping: the stop epoch is recorded one
    epoch after the loss stopper fires, and a stopped member is frozen from
    the next span boundary. Each member's best state is tracked on the
    device across spans by ``int_sq_err <=``, which includes post-stop
    epochs inside the stop span; with ``save_params`` it is the member's one
    checkpoint, under ``run_names[i]`` (default: a time stamp). The final
    image of a member frozen before the last span is that of one epoch from
    its frozen state with the update discarded, as the JAX package's span
    computes it. Histogram statistics and media are not logged (``fit``
    logs them). Returns one :class:`FitResult` per member: ``history`` is
    empty, ``params`` the member's final state and ``best_params`` its
    tracked best."""
    _check_shapes(exps)
    dev = resolve_device(device)
    base = exps[0]
    tcfg, mcfg = base.train, base.model
    epochs = epochs if epochs is not None else tcfg.epochs
    loggers = loggers or [NullLogger() for _ in exps]
    statics = gngf.make_statics(mcfg)
    seeds = [e.train.seed for e in exps]
    per_member = per_member_shuffle and len(set(seeds)) > 1
    built: Dict[int, EpochBatches] = {}

    def batches_for(seed: int) -> EpochBatches:
        if seed not in built:
            shuffled, _ = make_shuffle_permutations(data.num_pixels, seed, tcfg.shuffle_pixels)
            built[seed] = build_epoch_batches(data.coords, data.targets, tcfg.batch_fraction,
                                              shuffled, data.image, mcfg, statics, dev)
        return built[seed]

    members = []
    for e in exps:
        params = gngf.init_params(mcfg, e.train.seed, dev)
        optimizer = make_optimizer(e.optimizer, params)
        prev, min_poss = initial_collision_state(e, statics, dev)
        members.append(_Member(
            e, params, optimizer, batches_for(e.train.seed if per_member else tcfg.seed),
            prev, min_poss, BestTracker(params, optimizer if e.train.save_params else None)))

    og_max = float(np.max(data.image))
    values_per_img = data.num_pixels * data.channels
    count = len(exps)
    stoppers = [EarlyStopping(tolerance=e.train.tolerance, min_delta=e.train.min_delta)
                for e in exps]
    check_last2: List[List[bool]] = [[] for _ in exps]
    zero_abort = [False] * count
    best_psnr = [0.0] * count
    stop_epoch: List[Optional[int]] = [None] * count
    final = [(float("nan"), float("nan"))] * count     # (psnr, loss)
    active: List[int] = []

    ep = 0
    while ep < epochs and any(se is None for se in stop_epoch):
        n = min(max(1, epoch_span), epochs - ep)
        active = [i for i, se in enumerate(stop_epoch) if se is None]
        scalars = {i: [] for i in active}
        for j in range(n):
            for i in active:
                m = members[i]
                out = epoch_on_device(m.params, m.optimizer, m.batches, m.exp, statics,
                                      m.prev_coll, m.min_poss)
                m.prev_coll, m.image = out.collisions, out.image
                m.tracker.update(out.int_sq_err, ep + j)
                scalars[i].append(dataclasses.replace(out, image=None))
        host = SpanMetrics.stack([out for i in active for out in scalars[i]]).to_host()
        for i in active:
            members[i].tracker.settle(int(members[i].tracker.epoch))
        del scalars

        for j in range(n):
            for a, i in enumerate(active):
                if stop_epoch[i] is not None:
                    continue
                exp = exps[i]
                m = host.epoch(a * n + j)
                psnr = psnr_from_int_sq_err(og_max, m.int_sq_err)
                row = {"train_loss": m.loss,
                       "train_accuracy": m.match_count / values_per_img * 100,
                       "train_psnr": psnr, "mse_loss": m.mse}
                for l in range(mcfg.num_levels):
                    row[f"kl_div_loss_level{l}"] = float(m.js_kl_per_level[l])
                    row[f"collisions_level{l}"] = float(m.collisions[l])
                loggers[i].log(row, step=ep + j)
                best_psnr[i] = max(best_psnr[i], psnr)
                final[i] = (psnr, m.loss)
                e_abs = ep + j
                if exp.train.zero_collision_abort and e_abs != 0 and len(check_last2[i]) < 10:
                    check_last2[i].append(bool(np.all(m.collisions[-2:] == 0)))
                    if len(check_last2[i]) == 10 and all(check_last2[i]):
                        zero_abort[i] = True
                        stoppers[i].early_stop = True
                        stop_epoch[i] = e_abs
                        continue
                if stoppers[i].early_stop:
                    # the stopper fired on an earlier epoch's loss: this
                    # epoch still trains and logs, then the member stops
                    stop_epoch[i] = e_abs
                elif e_abs != 0:
                    stoppers[i](m.loss)
        ep += n

    for i, m in enumerate(members):
        if i not in active and ep > 0:
            # frozen before the last span: one epoch from the frozen state,
            # the update discarded
            params = copy.deepcopy(m.params)
            optimizer = make_optimizer(m.exp.optimizer, params)
            optimizer.load_state_dict(copy.deepcopy(m.optimizer.state_dict()))
            m.image = epoch_on_device(params, optimizer, m.batches, m.exp, statics, m.prev_coll,
                                      m.min_poss).image

    results = []
    for i, (m, exp) in enumerate(zip(members, exps)):
        best = copy.deepcopy(m.params)
        if m.tracker.state is not None:
            best.load_state_dict(m.tracker.state)
        run_dir = None
        if exp.train.save_params:
            name = run_names[i] if run_names else time.strftime("%Y%m%d%H%M%S")
            rid = exp.grid_id if exp.grid_id is not None else "run"
            run_dir = os.path.join(exp.train.checkpoint_dir, f"{rid}_{name}")
            snapshot = (m.tracker.snapshot(int(m.tracker.epoch)) if m.tracker.state is not None
                        else _snapshot(m.params, m.optimizer))
            _write_checkpoint(run_dir, snapshot, m.params, False, exp.model)
        loggers[i].finish()
        se = stop_epoch[i]
        results.append(FitResult(
            best_psnr=best_psnr[i],
            final_psnr=final[i][0],
            final_loss=final[i][1],
            epochs_run=(se + 1) if se is not None else min(ep, epochs),
            stopped_early=stoppers[i].early_stop,
            zero_collision_abort=zero_abort[i],
            params=m.params,
            best_params=best,
            history=[],
            run_dir=run_dir,
            final_image=(None if m.image is None else to_uint8_image(
                m.image.cpu().numpy(), data.height, data.width, data.channels)),
        ))
    if verbose:
        for exp, r in zip(exps, results):
            print(f"ensemble grid {exp.grid_id}: best PSNR {r.best_psnr:.3f} "
                  f"({r.epochs_run} epochs)")
    return results
