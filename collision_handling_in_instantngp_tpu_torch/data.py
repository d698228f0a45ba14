"""Image dataset: full coordinate grid + normalized pixel targets.

The port's own copy of the JAX package's ``data.py``. X is every (row, col)
pair in ``indexing='ij'`` order, normalized by ``max(w, h) - 1`` unless the
model batch-normalizes its input (``normalize=False``); Y is
pixels / 255. Decoding uses cv2 (BGR -> RGB), then PIL; a ``.npy`` file
holding a uint8 (h, w[, 3]) array loads without either, which is how images
reach a machine that has neither library.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class ImageData:
    coords: np.ndarray       # (P, 2) float32 (row, col) pairs, [0, 1] if normalized
    targets: np.ndarray      # (P, C) float32 pixels / 255
    height: int
    width: int
    image: np.ndarray        # original (h, w[, 3]) image as int64
    name: str

    @property
    def num_pixels(self) -> int:
        return self.height * self.width

    @property
    def channels(self) -> int:
        return self.targets.shape[1]


def _decode(path: str, bw: bool) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        raw = cv2.imread(path)
        if raw is None:
            raise ValueError(f"cv2 could not decode image: {path}")
        code = cv2.COLOR_BGR2GRAY if bw else cv2.COLOR_BGR2RGB
        return cv2.cvtColor(raw[:, :, :3], code)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"decoding {path} needs opencv-python or pillow; neither is "
            "installed. Pass a .npy uint8 image instead."
        ) from None
    with Image.open(path) as img:
        return np.asarray(img.convert("L" if bw else "RGB"))


def load_image(path: str, bw: bool = False) -> np.ndarray:
    """uint8 RGB (h, w, 3) or grayscale (h, w) image."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"image not found: {path}")
    if path.endswith(".npy"):
        img = np.load(path, allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim not in (2, 3):
            raise ValueError(
                f"{path}: expected a uint8 (h, w[, 3]) array, got "
                f"{img.dtype} {img.shape}"
            )
        if bw and img.ndim == 3:
            # ITU-R 601 luma, as cv2's BGR2GRAY
            luma = img[..., :3].astype(np.float64) @ np.array([0.299, 0.587, 0.114])
            img = np.rint(luma).astype(np.uint8)
        return img
    return _decode(path, bw)


def make_coordinate_grid(height: int, width: int) -> np.ndarray:
    """(h*w, 2) int coords in row-major (ij) order."""
    return np.stack(
        np.meshgrid(np.arange(height), np.arange(width), indexing="ij"), axis=-1
    ).reshape(-1, 2)


def image_dataset(img: np.ndarray, name: str = "image", normalize: bool = True) -> ImageData:
    """Coordinate-regression dataset of a decoded uint8 image. normalize=False
    keeps integer pixel coords (for ``batchnorm_input`` models)."""
    h, w = img.shape[0], img.shape[1]
    coords = make_coordinate_grid(h, w).astype(np.float32)
    if normalize:
        coords = coords / (max(w, h) - 1)
    targets = img.reshape(h * w, -1).astype(np.float32) / 255.0
    return ImageData(
        coords=coords, targets=targets, height=h, width=w,
        image=img.astype(np.int64), name=name,
    )


def load_image_dataset(path: str, bw: bool = False, normalize: bool = True) -> ImageData:
    return image_dataset(load_image(path, bw), os.path.basename(path), normalize)


def make_shuffle_permutations(
    num_pixels: int, seed: int, shuffle: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(shuffled_indices, reordered_indices): the fixed permutation built once
    before training, and its inverse. Pixels are never re-shuffled."""
    if shuffle:
        shuffled = np.random.default_rng(seed).permutation(num_pixels).astype(np.int32)
    else:
        shuffled = np.arange(num_pixels, dtype=np.int32)
    reordered = np.zeros(num_pixels, dtype=np.int32)
    reordered[shuffled] = np.arange(num_pixels, dtype=np.int32)
    return shuffled, reordered
