"""HPD: the learned index network that maps integer grid vertices to a
distribution over hash-table slots, followed by the straight-through top-k.

``apply_hpd_unique`` evaluates it once per unique vertex (ops/dedup.py). Small
tables run dense (the (U, T) probabilities fit easily); scaled tables
stream: the hidden stack is kernel K3 where the JAX package's gate
``hidden.supports`` holds (widths <= 512, hidden widths multiples of 8;
past it the plain stack, as JAX runs its XLA stack) and the head + softmax
+ top-k + marginal is the streamed tail (ops/fused_hpd.py), routed by the
JAX package's gate ``fused_supports(T, K, H)``: the fused pair K1/K2 where it
holds (T = 2^14 at H = 128), the split kernels K4 + K5 / K6 past it
(T = 2^16). On a CUDA tensor the stream branch launches the kernels; on a
CPU tensor it runs their plain versions.

``apply_hpd_fused`` evaluates it on every (pixel, level, corner) row (the
per-row route) without the dense (P, L, V, T) probabilities. The route
follows the config alone: "auto" with K <= 32 and T <= 2048, or
"pallas_full", runs the whole network as kernels K10/K11; "pallas" runs a
plain hidden stack and the tail kernels K8/K9; anything else the chunked
PyTorch tail. On a CPU tensor a kernel route runs its plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig, TopkScatterMode
from ..ops.cuda import hidden
from ..ops.cuda.hpd_full import hpd_full
from ..ops.cuda.hpd_stream import MAX_K
from ..ops.fused_hpd import hpd_tail, hpd_tail_unique
from ..ops.precision import pdot
from ..ops.topk import differentiable_topk
from .mlp import MLP

# dense (U, T) probability tables past this many elements stream instead
DEDUP_DENSE_MAX_ELEMENTS = 1 << 25


def apply_hpd(hpd: MLP, vertices: torch.Tensor, cfg: ModelConfig):
    """Dense: probs (..., T) (nan-sanitized softmax), top-k values and
    indices (..., K)."""
    probs = hpd(vertices, "relu", "softmax", cfg.matmul_precision)
    probs = torch.nan_to_num(probs)
    noop = cfg.topk_scatter is TopkScatterMode.NOOP
    values, indices = differentiable_topk(probs, cfg.topk_k, noop)
    return probs, values, indices


def relu_stack(h: torch.Tensor, layers, precision) -> torch.Tensor:
    """The plain hidden stack, ReLU after every layer (autograd's backward)."""
    for w, b in layers:
        h = F.relu(pdot(h, w, precision) + b)
    return h


def use_stream(cfg: ModelConfig, u: int) -> bool:
    return cfg.hpd_backend == "unique_stream" or (
        cfg.hpd_backend == "auto" and u * cfg.hash_table_size > DEDUP_DENSE_MAX_ELEMENTS
    )


def apply_hpd_unique(hpd: MLP, ucoords: torch.Tensor, cfg: ModelConfig, counts=None):
    """HPD on (U, d) unique vertices.

    counts: (L, U) per-level occurrence counts, or None (no marginal).
    Returns (marginal_raw (L, T) UNNORMALIZED or None, values (U, K),
    indices (U, K))."""
    u = ucoords.shape[0]
    noop = cfg.topk_scatter is TopkScatterMode.NOOP
    if not use_stream(cfg, u):
        probs, values, indices = apply_hpd(hpd, ucoords, cfg)
        marginal_raw = None
        if counts is not None and not cfg.keep_topk_only:
            marginal_raw = pdot(counts, probs, "highest")
        return marginal_raw, values, indices

    if cfg.topk_approx_recall is not None:
        raise NotImplementedError(
            "approximate top-k on the streamed tail is not ported "
            "(ROADMAP.md, port queue: 'K > 16 and approximate top-k')"
        )
    if cfg.topk_k > MAX_K:
        raise NotImplementedError(
            f"topk_k={cfg.topk_k} > {MAX_K} on the streamed tail is not ported "
            "(ROADMAP.md, port queue: 'K > 16 and approximate top-k')"
        )
    layers = hpd.layers()
    widths = [ucoords.shape[1]] + [w.shape[1] for w, _ in layers[:-1]]
    if len(layers) > 1 and hidden.supports(widths):
        h = hidden.hidden_stack(ucoords, layers[:-1], cfg.matmul_precision)      # K3
    else:
        h = relu_stack(ucoords, layers[:-1], cfg.matmul_precision)
    w, b = layers[-1]
    counts_in = counts if counts is not None else torch.zeros(
        1, u, dtype=torch.float32, device=ucoords.device
    )
    # K1/K2, or K4 + K5 / K6 past the fused gate (ops/fused_hpd.py)
    marginal_raw, values, indices = hpd_tail_unique(
        h, w, b, counts_in, cfg.topk_k, cfg.matmul_precision, noop
    )
    if counts is None or cfg.keep_topk_only:
        marginal_raw = None
    return marginal_raw, values, indices


# "auto" takes the whole-network kernels up to these sizes, as the JAX
# package does on an accelerator
FULL_MAX_K = 32
FULL_MAX_T = 2048


def fused_backend(cfg: ModelConfig) -> str:
    """"pallas_full" (K10/K11), "pallas" (K8/K9) or "jax" (chunked tail)."""
    backend = cfg.hpd_backend
    if backend == "auto":
        ok = cfg.topk_k <= FULL_MAX_K and cfg.hash_table_size <= FULL_MAX_T
        return "pallas_full" if ok else "jax"
    return backend if backend in ("pallas_full", "pallas") else "jax"


def apply_hpd_fused(hpd: MLP, vertices: torch.Tensor, cfg: ModelConfig):
    """vertices (P, L, V, d) -> (marginal (L, T), values (P, L, V, K),
    indices (P, L, V, K) int32)."""
    if cfg.topk_approx_recall is not None:
        raise NotImplementedError(
            "approximate top-k on the per-row tail is not ported "
            "(ROADMAP.md, port queue: 'K > 16 and approximate top-k')"
        )
    p, l, v, d = vertices.shape
    rows = vertices.permute(1, 0, 2, 3).reshape(l, p * v, d)     # level-major
    layers = hpd.layers()
    backend = fused_backend(cfg)
    if backend == "pallas_full":
        marginal, vals, idx = hpd_full(rows, layers, cfg.topk_k)
    else:
        h = relu_stack(rows, layers[:-1], cfg.matmul_precision)
        w, b = layers[-1]
        marginal, vals, idx = hpd_tail(h, w, b, cfg.topk_k, cfg.matmul_precision, backend)
    k = cfg.topk_k
    values = vals.reshape(l, p, v, k).permute(1, 0, 2, 3)
    indices = idx.reshape(l, p, v, k).permute(1, 0, 2, 3)
    return marginal, values, indices
