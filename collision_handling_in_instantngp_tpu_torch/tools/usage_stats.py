"""Per-level slot usage of a trained model: what the JS/KL uniformity prior
changes. Reads a run directory's ``whole_model.pkl`` (either package's),
runs the model forward over the whole image in the training's 1/3 batches
(``train=True``: the dedup route builds the loss marginal only then; the
configurations read here have no BatchNorm, so nothing else changes) and
reports per level:

  * the entropy (bits) of the top-1 slot histogram over one pixel per grid
    cell (the counts of the trainer's counts epochs,
    ``gngf.calc_counts_per_level``) against log2(T), the slots used and the
    largest slot's share;
  * the entropy (bits) of the HPD's probability marginal, the quantity the
    JS/KL loss regularizes, and its KL divergence from uniform (nats).

    python -m collision_handling_in_instantngp_tpu_torch.tools.usage_stats \\
        RUN_DIR [RUN_DIR ...] [--flagship] [--device=cpu] [--image=PATH]

``--flagship`` reads grid 4061's model (the default geometry); without it,
``instantngp_scaled_model()``. Prints one JSON line per run directory. The
image defaults to ``images/strawberry.npy``. It runs on the card unless
given ``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import ModelConfig, experiment_from_grid_id, instantngp_scaled_model
from ..data import ImageData, load_image_dataset
from ..device import resolve_device
from ..models import gngf
from ..ops import dedup as dedup_ops
from ..ops.grid import scale_to_grid
from ..utils.checkpoint import load_pytree
from .grid_leaderboard import IMAGE


def entropy_bits(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def best_slots(out: gngf.ForwardOut, corners: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The per-row selected slots (P, L, V, K) of a forward, or on the dedup
    route its best (k = 0) slot as (P, L, V, 1), from the unique vertices'
    candidates."""
    if out.indices is not None:
        return out.indices
    ids = dedup_ops.vertex_ids(corners, dedup_ops.grid_side(cfg.n_max))
    return out.idx_unique[:, :1][ids]


def stats_for_run(run_dir: str, cfg: ModelConfig, data: ImageData, batch_fraction: float = 1 / 3,
                  device: str = "cuda") -> List[Dict[str, Any]]:
    dev = resolve_device(device)
    statics = gngf.make_statics(cfg)
    consts = gngf.device_statics(statics, dev)
    params = gngf.params_from_jax(load_pytree(os.path.join(run_dir, "whole_model.pkl")), dev)
    p = data.num_pixels
    bs = int(np.ceil(p * batch_fraction))
    t, n_levels = cfg.hash_table_size, cfg.num_levels

    counts = np.zeros((n_levels, t), dtype=np.float64)
    marginal = np.zeros((n_levels, t), dtype=np.float64)
    rows = 0
    with torch.no_grad():
        for s in range(0, p, bs):
            xb = torch.from_numpy(data.coords[s:s + bs]).to(dev)
            out = gngf.forward(params, xb, cfg, statics, train=True)
            _, corners = scale_to_grid(xb, consts.n_ls, consts.offsets)
            c = gngf.calc_counts_per_level(best_slots(out, corners, cfg), corners, cfg, statics)
            counts += c.cpu().numpy().astype(np.float64)
            marginal += out.marginal.cpu().numpy().astype(np.float64) * xb.shape[0]
            rows += xb.shape[0]
    marginal /= rows

    per_level = []
    for level in range(n_levels):
        c = counts[level]
        tot = c.sum()
        p_usage = c / tot if tot else c
        m = marginal[level]
        m = m / m.sum()
        kl_uniform = float((m[m > 0] * np.log(m[m > 0] * t)).sum())   # KL(m || uniform), nats
        per_level.append({
            "level": level,
            "cells": int(tot),
            "slots_used": int((c > 0).sum()),
            "usage_entropy_bits": round(entropy_bits(p_usage), 4),
            "max_entropy_bits": round(float(np.log2(t)), 4),
            "max_slot_share": round(float(p_usage.max()), 6) if tot else None,
            "marginal_entropy_bits": round(entropy_bits(m), 4),
            "marginal_kl_uniform_nats": round(kl_uniform, 6),
        })
    return per_level


def main(run_dirs: List[str], flagship: bool = False, device: str = "cuda",
         image: str = IMAGE) -> List[Dict[str, Any]]:
    """The models the cold-seed and study runs trained: ``--flagship`` grid
    4061's, else ``instantngp_scaled_model()`` as it stands."""
    resolve_device(device)
    cfg = experiment_from_grid_id(4061).model if flagship else instantngp_scaled_model()
    data = load_image_dataset(image)
    out = []
    for rd in run_dirs:
        row = {"run_dir": rd, "levels": stats_for_run(rd, cfg, data, device=device)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def parse_args(argv: List[str]) -> Dict[str, Any]:
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    return dict(run_dirs=[a for a in argv if not a.startswith("--")],
                flagship="--flagship" in argv, device=opts.get("device", "cuda"),
                image=opts.get("image", IMAGE))


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
