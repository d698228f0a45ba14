"""Single-config training driver: the epoch loop around ``run_epoch``.

Per epoch: the scalar metrics, PSNR from the integer-image error, the
zero-collision abort (the last two levels collision-free for the first 10
checked epochs) and early stopping on the loss. The best-PSNR parameters,
with the BatchNorm running statistics (buffers of the params), are kept in
memory. Checkpoint files, histogram epochs, ensembles, multi-epoch
spans and warm starts are not in this port yet (ROADMAP.md).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import ImageData, make_shuffle_permutations
from ..device import resolve_device
from ..models import gngf
from .early_stopping import EarlyStopping
from .optimizer import make_optimizer
from .train_step import build_epoch_batches, initial_collision_state, run_epoch


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


def psnr_from_int_sq_err(og_max: float, int_sq_err: float) -> float:
    return float(20 * np.log10(og_max) - 10 * np.log10(max(int_sq_err, 1e-12)))


def fit(
    exp: ExperimentConfig,
    data: ImageData,
    *,
    epochs: Optional[int] = None,
    device="cuda",
    params: Optional[gngf.GNGFParams] = None,
    verbose: bool = True,
) -> FitResult:
    """Train one configuration. ``params``: initial weights (default: fresh
    ones from ``exp.train.seed``), moved to ``device``; the caller's copy is
    not modified."""
    dev = resolve_device(device)
    tcfg, mcfg = exp.train, exp.model
    epochs = epochs if epochs is not None else tcfg.epochs
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
    optimizer = make_optimizer(exp.optimizer, params)
    prev_coll, min_poss = initial_collision_state(exp, statics, dev)

    early_stopper = EarlyStopping(tolerance=tcfg.tolerance, min_delta=tcfg.min_delta)
    og_max = float(np.max(data.image))
    values_per_img = data.num_pixels * data.channels
    best_psnr, best_state = 0.0, None
    history: List[Dict[str, float]] = []
    check_last2: List[bool] = []
    zero_coll_abort = False
    train_loss = train_psnr = float("nan")
    epochs_run = 0
    for ep in range(epochs):
        t0 = time.perf_counter()
        m = run_epoch(params, optimizer, batches, exp, statics, prev_coll, min_poss)
        seconds = time.perf_counter() - t0  # run_epoch ends in a host transfer
        prev_coll = torch.as_tensor(m.collisions, device=dev)
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

        row = {
            "epoch": ep,
            "train_loss": train_loss,
            "train_accuracy": m.match_count / values_per_img * 100.0,
            "train_psnr": train_psnr,
            "mse_loss": m.mse,
            "seconds": seconds,
            "pixels_per_s": data.num_pixels / seconds,
        }
        for l in range(mcfg.num_levels):
            row[f"kl_div_loss_level{l}"] = float(m.js_kl_per_level[l])
            row[f"collisions_loss_level{l}"] = float(m.coll_loss_per_level[l])
            row[f"collisions_level{l}"] = float(m.collisions[l])
            row[f"min_possible_collisions_level{l}"] = float(m.min_possible[l])
        history.append(row)
        if verbose:
            print(
                f"epoch {ep}: loss {train_loss:.6f} psnr {train_psnr:.4f} "
                f"({seconds:.3f} s, {row['pixels_per_s']:.0f} px/s)"
            )

        if train_psnr >= best_psnr:
            best_psnr = train_psnr
            best_state = {k: v.detach().clone() for k, v in params.state_dict().items()}

        if early_stopper.early_stop:
            if verbose and not zero_coll_abort:
                print(f"!!! Stopping at epoch: {ep} !!!")
            break
        if ep != 0:
            early_stopper(train_loss)

    best_params = copy.deepcopy(params)
    if best_state is not None:
        best_params.load_state_dict(best_state)
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
    )
