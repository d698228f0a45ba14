"""Image metrics: PSNR and exact-match accuracy on integer images.

Both compare integer-valued images, the float output truncated to int
(``(output * 255).int()``) against the original uint8 image, as the JAX
package's ``utils/metrics.py`` does.
"""

from __future__ import annotations

import numpy as np


def to_uint8_image(pred01: np.ndarray, h: int, w: int, channels: int) -> np.ndarray:
    """(P, C) floats in [0, 1] -> (h, w[, C]) int32 image, truncated."""
    shape = (h, w, 3) if channels == 3 else (h, w)
    return (np.asarray(pred01) * 255).reshape(shape).astype(np.int32)


def calc_accuracy(predicted: np.ndarray, target: np.ndarray, size: int) -> float:
    """% of exactly-equal values."""
    return float(np.equal(predicted, target).sum() / size) * 100.0


def calc_psnr(pred: np.ndarray, target: np.ndarray) -> float:
    """20 log10(max(target)) - 10 log10(MSE)."""
    mse = np.square(pred.astype(np.float64) - target.astype(np.float64)).mean()
    return float(20 * np.log10(np.max(target)) - 10 * np.log10(mse))
