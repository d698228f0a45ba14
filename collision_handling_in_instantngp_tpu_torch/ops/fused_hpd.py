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

``HpdTailUniqueChunked`` is the same function as the JAX package's
``lax.scan`` tail over unique vertices (its "jax" backend, ``_unique_fwd_impl``
and ``_unique_bwd``), in plain PyTorch on whichever device the tensors are
on: the route for K > 16 and for an approximate top-k
(``models/hpd.py: unique_tail_backend``), not a fallback from the kernels.
Row chunks of ``unique_chunk_rows(T)``; the forward takes p =
nan_to_num(softmax(h w + b)), marg += counts_chunk @ p and the top-K of p
(``topk_keyed``: lax.top_k's order in one ``torch.topk``); the residuals are
(h, w, b, counts, idx) and the backward recomputes p.

``hpd_tail`` is the per-row counterpart, (L, N, H) rows: the per-level
marginal (already / N), and top-K selected on p. Backend "pallas" runs
kernels K8/K9 (``ops/cuda/hpd_tail.py``; their plain versions on the CPU);
any other backend runs the chunked PyTorch tail at the model's matmul
precision (the JAX package's ``lax.scan`` backend). Residuals: h, w, b, idx.
"""

from __future__ import annotations

import torch

from .cuda import hpd_stream
from .cuda.hpd_tail import (
    CHUNK_ROWS, TILE_BUDGET, hpd_tail_bwd, hpd_tail_bwd_plain, hpd_tail_fwd, hpd_tail_fwd_plain,
    softmax_rows,
)
from .precision import pdot
from .topk import topk_keyed


def kernel_backend(t: int, k: int, hd: int) -> str:
    """The kernels' route by the JAX gate: "split" (K4 + K5 / K6) where
    ``supports`` holds and ``fused_supports`` fails, else "fused" (K1/K2)."""
    return "split" if hpd_stream.supports(t, k) and not hpd_stream.fused_supports(t, k, hd) else "fused"


class HpdTailUnique(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, counts, k: int, precision: str, noop_topk: bool, split: bool):
        ctx.split = split
        if split:
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
        return dh, dw, db, None, None, None, None, None


def unique_chunk_rows(t: int) -> int:
    """Rows a chunk of the chunked unique tail (JAX ``_unique_chunk_rows``):
    (rows, T) fp32 temporaries near 64 MB."""
    return int(max(256, min(CHUNK_ROWS, TILE_BUDGET // max(t, 1))))


class HpdTailUniqueChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, counts, k: int, precision: str, noop_topk: bool):
        u, t = h.shape[0], w.shape[1]
        marg = torch.zeros(counts.shape[0], t, dtype=torch.float32, device=h.device)
        vals = torch.empty(u, k, dtype=torch.float32, device=h.device)
        idx = torch.empty(u, k, dtype=torch.int32, device=h.device)
        step = unique_chunk_rows(t)
        for r0 in range(0, u, step):
            r1 = min(u, r0 + step)
            p = softmax_rows(pdot(h[r0:r1], w, precision) + b)
            marg += pdot(counts[:, r0:r1], p, precision)
            v, i = topk_keyed(p, k)
            vals[r0:r1] = v
            idx[r0:r1] = i.to(torch.int32)
        ctx.save_for_backward(h, w, b, counts, idx)
        ctx.precision, ctx.noop_topk = precision, noop_topk
        ctx.mark_non_differentiable(idx)
        # an output the loss leaves out (marg under keep_topk_only) comes
        # back as None: its product is skipped, not taken on zeros
        ctx.set_materialize_grads(False)
        return marg, vals, idx

    @staticmethod
    def backward(ctx, g_marg, g_vals, _g_idx):
        h, w, b, counts, idx = ctx.saved_tensors
        precision = ctx.precision
        u, t = h.shape[0], w.shape[1]
        dh = torch.empty_like(h)
        dw = torch.zeros(h.shape[1], t, dtype=torch.float32, device=h.device)
        db = torch.zeros(t, dtype=torch.float32, device=h.device)
        step = unique_chunk_rows(t)
        for r0 in range(0, u, step):
            r1 = min(u, r0 + step)
            p = softmax_rows(pdot(h[r0:r1], w, precision) + b)
            # marginal cotangent: d marg_l / d p_row = counts_l[row] g_marg_l
            g_p = (torch.zeros_like(p) if g_marg is None
                   else pdot(counts[:, r0:r1].T, g_marg.contiguous(), precision))
            if g_vals is not None and not ctx.noop_topk:
                i = idx[r0:r1].long()       # distinct in a row: one add a column
                g_p.scatter_(1, i, g_p.gather(1, i) + g_vals[r0:r1])
            dl = p * (g_p - (g_p * p).sum(dim=1, keepdim=True))
            dh[r0:r1] = pdot(dl, w.T, precision)
            dw += pdot(h[r0:r1].T, dl, precision)
            db += dl.sum(dim=0)
        return dh, dw, db, None, None, None, None


def hpd_tail_unique(h, w, b, counts, k: int, precision: str, noop_topk: bool, backend: str):
    """h (U, H), w (H, T), b (T,), counts (L, U) -> (marginal_raw (L, T)
    UNNORMALIZED, vals (U, K), idx (U, K) int32). backend "fused" (K1/K2),
    "split" (K4 + K5 / K6), their plain versions on the CPU, or "jax" (the
    chunked tail), as ``models/hpd.py: unique_tail_backend`` picks it."""
    if backend == "jax":
        return HpdTailUniqueChunked.apply(h, w, b, counts, k, precision, noop_topk)
    if backend not in ("fused", "split"):
        raise ValueError(f"unknown unique-tail backend {backend!r}")
    return HpdTailUnique.apply(h, w, b, counts, k, precision, noop_topk, backend == "split")


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
