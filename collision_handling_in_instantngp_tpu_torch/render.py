"""Inference: render an image of any resolution from trained parameters.

The field is continuous, so a render may super- or sub-sample the training
image. Coordinates are normalised as in training, by ``max(th, tw) - 1``
of the training shape, and the pixels go through ``gngf.forward(...,
train=False)`` in whole chunks of ``batch_rows`` (the last one padded), so
that every chunk takes the same route: the dedup route on the whole vertex
grid, or the per-row route under ``batchnorm_input``. As in the JAX
package's ``render.py``.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from .config import ModelConfig
from .data import make_coordinate_grid
from .device import resolve_device
from .models import gngf

_RENDER_CACHE: dict = {}


def make_renderer(cfg: ModelConfig, statics: gngf.GNGFStatics, batch_rows: int):
    """(params, chunks (C, R, d), bn_state=None) -> (C * R, channels)
    renderer, cached per (config, batch_rows): ``forward(..., train=False)``
    chunk by chunk under ``torch.no_grad()``."""
    key = (cfg, batch_rows)
    if key not in _RENDER_CACHE:

        def renderer(params, chunks, bn_state=None):
            with torch.no_grad():
                rgb = [gngf.forward(params, chunk, cfg, statics, bn_state=bn_state,
                                    train=False).rgb for chunk in chunks]
            return torch.cat(rgb)

        _RENDER_CACHE[key] = renderer
    return _RENDER_CACHE[key]


def render_image(
    params,
    cfg: ModelConfig,
    statics: Optional[gngf.GNGFStatics] = None,
    height: int = 508,
    width: int = 339,
    train_shape: Optional[tuple] = None,
    batch_rows: int = 65536,
    bn_state: Optional[dict] = None,
    device="cuda",
) -> np.ndarray:
    """The (height, width[, C]) uint8 image of ``params`` (GNGFParams, or
    the JAX package's numpy tree as ``whole_model.pkl`` holds it), rendered
    on ``device`` (the card unless "cpu") from a copy of them.

    train_shape: the (h, w) the field was trained on (default: (height,
      width), the native grid); another render size maps linearly onto it.
    bn_state: running BatchNorm statistics {"mean", "var"} for
      ``batchnorm_input`` configs (``bn_state.pkl`` of a run directory);
      None normalises with the fresh-init statistics (mean 0, var 1), as
      the JAX package's render does, whatever the params' buffers hold.
    """
    dev = resolve_device(device)
    if isinstance(params, dict):
        params = gngf.params_from_jax(params, dev)
    else:
        params = copy.deepcopy(params).to(dev)
    statics = statics if statics is not None else gngf.make_statics(cfg)
    th, tw = train_shape if train_shape is not None else (height, width)
    coords = make_coordinate_grid(height, width).astype(np.float32)
    if height != th:
        coords[:, 0] *= (th - 1) / max(height - 1, 1)
    if width != tw:
        coords[:, 1] *= (tw - 1) / max(width - 1, 1)
    coords = coords / (max(th, tw) - 1)
    n = coords.shape[0]
    chunks = np.pad(coords, ((0, (-n) % batch_rows), (0, 0))).reshape(-1, batch_rows,
                                                                      coords.shape[1])
    if cfg.batchnorm_input:
        if bn_state is None:
            bn_state = {"mean": np.zeros(cfg.input_dim, np.float32),
                        "var": np.ones(cfg.input_dim, np.float32)}
        bn_state = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                    for k, v in bn_state.items()}
    renderer = make_renderer(cfg, statics, batch_rows)
    rgb = renderer(params, torch.as_tensor(chunks, device=dev), bn_state)[:n].cpu().numpy()
    img = np.clip(rgb.reshape(height, width, -1) * 255.0, 0, 255).astype(np.uint8)
    return img.squeeze(-1) if img.shape[-1] == 1 else img
