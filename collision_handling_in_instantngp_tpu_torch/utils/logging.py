"""Metric logging in the JAX package's schema: one row per epoch with
train_loss, train_accuracy, train_psnr, mse_loss, per level
kl_div_loss_level{l}, collisions_loss_level{l},
kl_collisions_loss_level{l} (GNGF only), collisions_level{l},
min_possible_collisions_level{l}, and on counts epochs
hist_counts_level{l}_counts, train_image and the figures
hist_counts_level{l}.

Three backends: null, a local JSONL file (media saved as PNGs beside it,
or only named with ``save_media=False``), and wandb where it is installed
(imported only then; without it ``make_logger("wandb")`` falls back to
JSONL as the JAX package's does). A logger's ``stores_media`` says whether
the trainer should build figures for it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def _is_figure(v: Any) -> bool:
    return hasattr(v, "savefig")


def _is_image(v: Any) -> bool:
    return (
        hasattr(v, "shape")
        and getattr(v, "ndim", 0) in (2, 3)
        and hasattr(v, "dtype")
        and str(v.dtype).startswith(("uint8", "int"))
        and (v.ndim == 2 or v.shape[-1] in (1, 3, 4))
    )


class MetricLogger:
    """Interface. log() once per epoch; finish() once per run."""

    stores_media = False

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        pass


class NullLogger(MetricLogger):
    def log(self, metrics, step=None):  # noqa: D102
        pass


class JsonlLogger(MetricLogger):
    """Appends one JSON object per epoch. Media values (matplotlib figures,
    integer image arrays) are written as PNGs under ``<log stem>_media/``
    and the row stores their path (``save_media``), or a placeholder; 1-D
    arrays of up to 4,096 values (histogram counts) are inlined as lists."""

    def __init__(self, path: str, save_media: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._f = open(path, "a")
        self._save_media = save_media
        self._media_dir = os.path.splitext(path)[0] + "_media"

    @property
    def stores_media(self) -> bool:
        return self._save_media

    def _save(self, key: str, v: Any, step) -> str:
        os.makedirs(self._media_dir, exist_ok=True)
        name = f"step{step if step is not None else 0:06d}_{key}.png"
        out = os.path.join(self._media_dir, name)
        if _is_figure(v):
            v.savefig(out)
        else:
            import numpy as np

            from .histograms import _pyplot

            plt, _ = _pyplot(False)
            arr = np.asarray(v).astype("uint8")
            plt.imsave(out, arr, cmap="gray" if arr.ndim == 2 else None)
        return out

    def log(self, metrics, step=None):
        row = {"step": step, "t": round(time.time(), 3)}
        for k, v in metrics.items():
            if _is_figure(v) or _is_image(v):
                row[k] = self._save(k, v, step) if self._save_media else (
                    "<figure>" if _is_figure(v) else f"<image{tuple(v.shape)}>"
                )
            elif hasattr(v, "shape") and getattr(v, "ndim", 0) == 1 and v.shape[0] <= 4096:
                row[k] = [float(x) for x in v]
            elif hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
                row[k] = f"<array{tuple(v.shape)}>"
            else:
                try:
                    row[k] = float(v)
                except (TypeError, ValueError):
                    row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def finish(self):
        self._f.close()


class WandbLogger(MetricLogger):
    """wandb backend. Constructing raises ImportError where wandb is not
    installed. Figures and integer image arrays go as ``wandb.Image``."""

    stores_media = True

    def __init__(self, entity: str, project: str, group: str, name: str, config: dict):
        import wandb

        self._wandb = wandb
        wandb.init(entity=entity, project=project, group=group, name=name, config=config)

    def log(self, metrics, step=None):
        payload = {}
        for k, v in metrics.items():
            if _is_figure(v) or _is_image(v):
                caption = (f"Train Image, epoch:{step}" if k == "train_image"
                           else f"{k} at epoch {step}")
                payload[k] = self._wandb.Image(v, caption=caption)
            else:
                payload[k] = v
        self._wandb.log(payload)

    def finish(self):
        self._wandb.finish()


def make_logger(backend: str = "jsonl", *, path: str = "runs/log.jsonl",
                save_media: bool = True, wandb_kwargs: Optional[dict] = None) -> MetricLogger:
    if backend == "null":
        return NullLogger()
    if backend == "wandb":
        try:
            return WandbLogger(**(wandb_kwargs or {}))
        except ImportError:
            print("wandb not available; falling back to jsonl logger")
            return JsonlLogger(path, save_media=save_media)
    return JsonlLogger(path, save_media=save_media)
