"""Streaming fused HPD tails as autograd Functions: over unique vertices
(the dedup route) and over every row (the per-row route).

The head layer, softmax, exact top-k and the count-weighted loss marginal
in one op: the dense (U, T) probability tensor never exists whole. The loss
only reads the per-level marginal ``counts @ p`` and the feature blend only
the top-k values and indices. The backward is the exact gradient of that
composition (softmax VJP of [marginal gradient + straight-through top-k
scatter]); under ``noop_topk`` the top-k part is dropped.

The kernels follow the JAX package's gate (``ops/cuda/hpd_stream.py:
fused_supports``): where it holds, the fused pair K1 (forward) and K2
(backward); where it fails but ``supports`` holds (first at H = 128,
T = 2^16), the split kernels K4 + K5 (forward) and K6 (backward); where
``supports`` fails too (T not a multiple of 2048), K1/K2, which take any
multiple of 128. On the CPU each runs its plain version. The residuals are
(h, w, b, counts, idx, vals, m, s): the backward recomputes p from the row
statistics (m, s) instead of keeping it.

``hpd_tail`` is the per-row counterpart, (L, N, H) rows: the per-level
marginal (already / N), and top-K selected on p. Backend "pallas" runs
kernels K8/K9 (``ops/cuda/hpd_tail.py``; their plain versions on the CPU);
any other backend runs the chunked PyTorch tail at the model's matmul
precision (the JAX package's ``lax.scan`` backend). Residuals: h, w, b, idx.
"""

from __future__ import annotations

import torch

from .cuda import hpd_stream
from .cuda.hpd_tail import hpd_tail_bwd, hpd_tail_bwd_plain, hpd_tail_fwd, hpd_tail_fwd_plain


def _split(t: int, k: int, hd: int) -> bool:
    return hpd_stream.supports(t, k) and not hpd_stream.fused_supports(t, k, hd)


class HpdTailUnique(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, counts, k: int, precision: str, noop_topk: bool):
        ctx.split = _split(w.shape[1], k, h.shape[1])
        if ctx.split:
            vals, idx, m, s = hpd_stream.hpd_stream_select(h, w, b, k, precision)
            marg = hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s, precision)
        else:
            marg, vals, idx, m, s = hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, precision)
        ctx.save_for_backward(h, w, b, counts, idx, vals, m, s)
        ctx.k, ctx.precision, ctx.noop_topk = k, precision, noop_topk
        ctx.mark_non_differentiable(idx)
        return marg, vals, idx

    @staticmethod
    def backward(ctx, g_marg, g_vals, _g_idx):
        h, w, b, counts, idx, vals, m, s = ctx.saved_tensors
        if g_marg is None:
            g_marg = torch.zeros(counts.shape[0], w.shape[1], dtype=h.dtype, device=h.device)
        if g_vals is None:
            g_vals = torch.zeros_like(vals)
        bwd = hpd_stream.hpd_tail_unique_bwd if ctx.split else hpd_stream.hpd_stream_fused_bwd
        dh, dw, db = bwd(
            h, w, b, counts, idx, vals, m, s, g_marg.contiguous(), g_vals.contiguous(),
            ctx.k, ctx.precision, ctx.noop_topk,
        )
        return dh, dw, db, None, None, None, None


def hpd_tail_unique(h, w, b, counts, k: int, precision: str = "highest",
                    noop_topk: bool = False):
    """h (U, H), w (H, T), b (T,), counts (L, U) -> (marginal_raw (L, T)
    UNNORMALIZED, vals (U, K), idx (U, K) int32)."""
    return HpdTailUnique.apply(h, w, b, counts, k, precision, noop_topk)


class HpdTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, k: int, precision: str, backend: str):
        if backend == "pallas":
            marg, vals, idx = hpd_tail_fwd(h, w, b, k)
        else:
            marg, vals, idx = hpd_tail_fwd_plain(h, w, b, k, precision)
        ctx.save_for_backward(h, w, b, idx)
        ctx.k, ctx.precision, ctx.backend = k, precision, backend
        ctx.mark_non_differentiable(idx)
        return marg, vals, idx

    @staticmethod
    def backward(ctx, g_marg, g_vals, _g_idx):
        h, w, b, idx = ctx.saved_tensors
        if g_marg is None:
            g_marg = torch.zeros(h.shape[0], w.shape[1], dtype=h.dtype, device=h.device)
        if g_vals is None:
            g_vals = torch.zeros(idx.shape, dtype=h.dtype, device=h.device)
        g_marg, g_vals = g_marg.contiguous(), g_vals.contiguous()
        if ctx.backend == "pallas":
            dh, dw, db = hpd_tail_bwd(h, w, b, idx, g_marg, g_vals, ctx.k)
        else:
            dh, dw, db = hpd_tail_bwd_plain(h, w, b, idx, g_marg, g_vals, ctx.k, ctx.precision)
        return dh, dw, db, None, None, None


def hpd_tail(h, w, b, k: int, precision: str = "highest", backend: str = "jax"):
    """h (L, N, H), w (H, T), b (T,) -> (marginal (L, T), vals (L, N, K),
    idx (L, N, K) int32)."""
    return HpdTail.apply(h, w, b, k, precision, backend)
