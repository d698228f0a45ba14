"""Fused unique-vertex HPD tail at scaled table widths (kernels K1 and K2).

Replaces ``ops/pallas/hpd_stream.py: hpd_stream_fused_fwd`` and
``hpd_stream_fused_bwd`` of the JAX package; the contract is the same.

Forward: h (U, H), w (H, T), b (T,), counts (L, U) ->
  marg (L, T) = counts @ p with p = softmax(h w + b) per row,
  vals (U, K), idx (U, K) int32: exact top-K of the raw logits (lowest
  index first among equal values), vals = exp(logit - m) / s,
  m, s (U, 1): row max and sum of exp(logit - m).
Backward: the residuals plus g_marg (L, T), g_vals (U, K) -> dh, dw, db.

For a CUDA tensor the wrappers launch the kernels of ``hpd_stream.cu``;
for a CPU tensor they run the plain version below, which processes the
rows in chunks so that (U, T) never exists whole. The plain versions are
the CPU path and the reference the kernels are held against; nothing on
the card's path calls them.
"""

from __future__ import annotations

import ctypes

import torch

from ..precision import PRECISION_CODE, kernel_precision, pdot
from ..topk import topk_lowest_index
from . import build

MAX_K = 16
MAX_H = 128
MAX_L = 32
COL_TILE = 128
# rows per plain-version chunk: (chunk, T) fp32 temporaries of <= 64 MB
PLAIN_CHUNK_ELEMS = 1 << 24


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _chunk(t: int) -> int:
    return max(1, PLAIN_CHUNK_ELEMS // max(t, 1))


# ------------------------------ plain versions ------------------------------ #

def hpd_stream_fused_fwd_plain(h, w, b, counts, k: int, precision: str):
    u = h.shape[0]
    t = w.shape[1]
    marg = torch.zeros(counts.shape[0], t, dtype=torch.float32, device=h.device)
    vals = torch.empty(u, k, dtype=torch.float32, device=h.device)
    idx = torch.empty(u, k, dtype=torch.int32, device=h.device)
    m = torch.empty(u, 1, dtype=torch.float32, device=h.device)
    s = torch.empty(u, 1, dtype=torch.float32, device=h.device)
    step = _chunk(t)
    for r0 in range(0, u, step):
        r1 = min(u, r0 + step)
        logits = pdot(h[r0:r1], w, precision) + b
        mc = logits.amax(dim=1, keepdim=True)
        e = torch.exp(logits - mc)
        sc = e.sum(dim=1, keepdim=True)
        marg += pdot(counts[:, r0:r1], e / sc, precision)
        v, i = topk_lowest_index(logits, k)
        vals[r0:r1] = torch.exp(v - mc) / sc
        idx[r0:r1] = i.to(torch.int32)
        m[r0:r1] = mc
        s[r0:r1] = sc
    return marg, vals, idx, m, s


def hpd_stream_fused_bwd_plain(
    h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k: int, precision: str,
    noop_topk: bool,
):
    u, hd = h.shape
    t = w.shape[1]
    dh = torch.empty(u, hd, dtype=torch.float32, device=h.device)
    dw = torch.zeros(hd, t, dtype=torch.float32, device=h.device)
    db = torch.zeros(t, dtype=torch.float32, device=h.device)
    step = _chunk(t)
    for r0 in range(0, u, step):
        r1 = min(u, r0 + step)
        p = torch.exp(pdot(h[r0:r1], w, precision) + b - m[r0:r1]) / s[r0:r1]
        cnt_t = counts[:, r0:r1].T
        g_p = pdot(cnt_t, g_marg, precision)
        g_rows = pdot(p, g_marg.T, precision)                      # (R, L)
        dot = (cnt_t * g_rows).sum(dim=1, keepdim=True)
        if not noop_topk:
            g_p.scatter_add_(1, idx[r0:r1].long(), g_vals[r0:r1])
            dot = dot + (g_vals[r0:r1] * vals[r0:r1]).sum(dim=1, keepdim=True)
        dl = p * (g_p - dot)
        dh[r0:r1] = pdot(dl, w.T, precision)
        dw += pdot(h[r0:r1].T, dl, precision)
        db += dl.sum(dim=0)
    return dh, dw, db


# --------------------------------- kernels ---------------------------------- #

def _lib() -> ctypes.CDLL:
    lib = build.library("hpd_stream")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hpd_fused_fwd.argtypes = [vp] * 4 + [ci] * 6 + [vp] * 7
    lib.hpd_fused_fwd.restype = ci
    lib.hpd_fused_bwd.argtypes = [vp] * 10 + [ci] * 7 + [vp] * 7
    lib.hpd_fused_bwd.restype = ci
    lib.hpd_stream_segments.argtypes = []
    lib.hpd_stream_segments.restype = ci
    return lib


def _check_inputs(h, w, b, counts, k, **more):
    u, hd = h.shape
    t = w.shape[1]
    l = counts.shape[0]
    if not (hd <= MAX_H and t % COL_TILE == 0 and t >= COL_TILE and l <= MAX_L and 1 <= k <= MAX_K):
        raise ValueError(
            f"hpd_stream kernels take H <= {MAX_H}, T a multiple of {COL_TILE}, "
            f"L <= {MAX_L}, 1 <= K <= {MAX_K}; got H={hd}, T={t}, L={l}, K={k}"
        )
    if tuple(w.shape) != (hd, t) or tuple(b.shape) != (t,) or tuple(counts.shape) != (l, u):
        raise ValueError(
            f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, "
            f"counts {tuple(counts.shape)} do not agree"
        )
    out = []
    for name, x in dict(h=h, w=w, b=b, counts=counts, **more).items():
        want = torch.int32 if name == "idx" else torch.float32
        if x.device != h.device or x.dtype != want:
            raise ValueError(f"{name}: expected {want} on {h.device}, got {x.dtype} on {x.device}")
        out.append(x.contiguous())
    return out


def _launch_fwd(h, w, b, counts, k, precision):
    dev = h.device
    h, w, b, counts = _check_inputs(h, w, b, counts, k)
    u, hd = h.shape
    t = w.shape[1]
    l = counts.shape[0]
    lib = _lib()
    f32 = dict(device=dev, dtype=torch.float32)
    marg = torch.empty(l, t, **f32)
    marg_part = torch.empty(lib.hpd_stream_segments(), l, t, **f32)
    vals = torch.empty(u, k, **f32)
    idx = torch.empty(u, k, device=dev, dtype=torch.int32)
    m = torch.empty(u, 1, **f32)
    s = torch.empty(u, 1, **f32)
    with torch.cuda.device(dev):
        code = lib.hpd_fused_fwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), counts.data_ptr(),
            u, hd, t, l, k, PRECISION_CODE[precision],
            marg.data_ptr(), marg_part.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            m.data_ptr(), s.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hpd_stream_error_string", "hpd_stream_fused_fwd")
    hpd_stream_fused_fwd.launches += 1
    return marg, vals, idx, m, s


def _launch_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision, noop_topk):
    dev = h.device
    h, w, b, counts, idx, vals, m, s, g_marg, g_vals = _check_inputs(
        h, w, b, counts, k, idx=idx, vals=vals, m=m, s=s, g_marg=g_marg, g_vals=g_vals
    )
    u, hd = h.shape
    t = w.shape[1]
    l = counts.shape[0]
    lib = _lib()
    segs = lib.hpd_stream_segments()
    f32 = dict(device=dev, dtype=torch.float32)
    dh = torch.empty(u, hd, **f32)
    dot = torch.empty(u, **f32)
    dw = torch.empty(hd, t, **f32)
    db = torch.empty(t, **f32)
    dw_part = torch.empty(segs, hd, t, **f32)
    db_part = torch.empty(segs, t, **f32)
    with torch.cuda.device(dev):
        code = lib.hpd_fused_bwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), counts.data_ptr(), idx.data_ptr(),
            vals.data_ptr(), m.data_ptr(), s.data_ptr(), g_marg.data_ptr(),
            g_vals.data_ptr(), u, hd, t, l, k, int(noop_topk), PRECISION_CODE[precision],
            dh.data_ptr(), dot.data_ptr(), dw.data_ptr(), db.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hpd_stream_error_string", "hpd_stream_fused_bwd")
    hpd_stream_fused_bwd.launches += 1
    return dh, dw, db


def hpd_stream_fused_fwd(h, w, b, counts, k: int, precision: str = "highest"):
    """(marg (L, T), vals (U, K), idx (U, K) int32, m (U, 1), s (U, 1)) (K1)."""
    precision = kernel_precision(precision)
    if _on_card(h):
        return _launch_fwd(h, w, b, counts, k, precision)
    return hpd_stream_fused_fwd_plain(h, w, b, counts, k, precision)


def hpd_stream_fused_bwd(
    h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k: int,
    precision: str = "highest", noop_topk: bool = False,
):
    """(dh (U, H), dw (H, T), db (T,)) (K2)."""
    precision = kernel_precision(precision)
    if _on_card(h):
        return _launch_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision, noop_topk)
    return hpd_stream_fused_bwd_plain(
        h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision, noop_topk
    )


hpd_stream_fused_fwd.launches = 0
hpd_stream_fused_bwd.launches = 0
