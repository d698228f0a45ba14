"""Single-config training driver: the epoch loop around ``run_epoch``.

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
the other's run directory. Ensembles and multi-epoch spans are not in this
port (ROADMAP.md).
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
    build_epoch_batches, initial_collision_state, make_stats_fn, run_epoch,
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
) -> FitResult:
    """Train one configuration. ``params``: initial weights (default: fresh
    ones from ``exp.train.seed``), moved to ``device``; the caller's copy is
    not modified. ``hpd_weights_path``: an ``HPD_model.pkl`` whose HPD is
    loaded and frozen; ``encoding_weights_path``: an ``encoding_model.pkl``
    whose tables start the run; ``warm_start_dir``: a run directory (of
    either package) whose params, optimizer state and BatchNorm statistics
    continue, its config stamp checked. ``log_image_every=N`` also logs
    ``train_image`` every N epochs. ``run_name`` names the checkpoint
    directory (default: a time stamp).

    The history rows hold the logged scalars plus ``epoch``, ``seconds``
    (``run_epoch`` alone), ``pixels_per_s``, ``stats_seconds`` (the counts
    epoch's statistics, image and figures) and ``ckpt_seconds`` (the
    snapshot and checkpoint write)."""
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

    def counts_epoch(ep: int) -> bool:
        return ep == epochs - 1 or (rate > 0 and ep % rate == 0) or early_stopper.early_stop

    for ep in range(epochs):
        # a counts epoch keeps its slot ids; so does the epoch at which the
        # zero-collision abort can fire (its 10th check), since the abort
        # makes it the early-stop epoch
        abort_check = (tcfg.zero_collision_abort and ep != 0 and len(check_last2) == 9
                       and all(check_last2))
        t0 = time.perf_counter()
        m = run_epoch(params, optimizer, batches, exp, statics, prev_coll, min_poss,
                      collect_ids=counts_epoch(ep) or abort_check)
        seconds = time.perf_counter() - t0  # run_epoch ends in a host transfer
        prev_coll = torch.as_tensor(m.collisions, device=dev)
        image = m.image
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
        if counts_epoch(ep):
            slot_c, _ = stats_fn(m.ids, flat_coords)
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
        if (log_image_every is not None and ep % log_image_every == 0
                and "train_image" not in log and not isinstance(logger, NullLogger)):
            log["train_image"] = to_uint8_image(image.cpu().numpy(), data.height, data.width,
                                                data.channels)
        stats_seconds = time.perf_counter() - t_stats
        logger.log(log, step=ep)

        t_ckpt = time.perf_counter()
        if train_psnr >= best_psnr:
            best_psnr = train_psnr
            best_snapshot = _snapshot(params, optimizer if run_dir is not None else None)
            if run_dir is not None:
                now = time.monotonic()
                if now - last_ckpt_write >= tcfg.checkpoint_min_interval_s:
                    _write_checkpoint(run_dir, best_snapshot, params, freeze_hpd, mcfg)
                    last_ckpt_write = now
        ckpt_seconds = time.perf_counter() - t_ckpt

        row = {"epoch": ep, **{k: v for k, v in log.items() if isinstance(v, (int, float))},
               "seconds": seconds, "pixels_per_s": data.num_pixels / seconds,
               "stats_seconds": stats_seconds, "ckpt_seconds": ckpt_seconds}
        history.append(row)
        if verbose:
            print(f"epoch {ep}: loss {train_loss:.6f} psnr {train_psnr:.4f} "
                  f"({seconds:.3f} s, {row['pixels_per_s']:.0f} px/s)")

        if early_stopper.early_stop:
            if verbose and not zero_coll_abort:
                print(f"!!! Stopping at epoch: {ep} !!!")
            break
        if ep != 0:
            early_stopper(train_loss)

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
