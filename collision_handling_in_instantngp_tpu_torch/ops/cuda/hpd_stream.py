"""Unique-vertex HPD tail at scaled table widths: the fused pair (kernels
K1, K2), the split kernels (K4, K5, K6) and the measurement probe (K7).

Replaces ``ops/pallas/hpd_stream.py`` of the JAX package: K1
``hpd_stream_fused_fwd``, K2 ``hpd_stream_fused_bwd``, K4
``hpd_stream_select``, K5 ``hpd_stream_marginal``, K6
``hpd_tail_unique_pallas_bwd``, K7 ``hpd_stream_fused_probe``; the
contracts are the same.

Forward (K1, or K4 then K5): h (U, H), w (H, T), b (T,), counts (L, U) ->
  marg (L, T) = counts @ p with p = softmax(h w + b) per row,
  vals (U, K), idx (U, K) int32: exact top-K of the raw logits (lowest
  index first among equal values), vals = exp(logit - m) / s,
  m, s (U, 1): row max and sum of exp(logit - m).
Backward (K2, or K6): the residuals plus g_marg (L, T), g_vals (U, K) ->
  dh, dw, db.
Probe (K7): h, w, b -> (m, s), each (U, 1): "softmax" the row max and sum
  of exp(logit - m); "dots" m = s = the row sum of the logits. K4's rows
  pass with its later phases removed, so that the ladder of
  ``tools/sweep_probe.py`` (dots, softmax, K4, K1) times each phase.

``fused_supports`` is the JAX package's gate between the two forms, copied
with its values: it only picks which kernel contract runs, as on the TPU.
Its byte limits are the TPU's VMEM budget, not a Hopper memory limit; the
Hopper kernels of both forms stream 64-column tiles at any T.

For a CUDA tensor the wrappers launch the kernels of ``hpd_stream.cu`` (K1
is K4's rows pass then K5's columns pass, counted as K1 alone), every
product on the tensor cores (3xTF32 at 'highest'). The backward (K2, K6)
takes any head width to MAX_H there, its contraction over H in CHUNK_H-deep
chunks (dh's and dW's chunks on the launch grid). The
forward past CHUNK_H takes the wide passes of ``hpd_stream.cu``: fp32 FMA
under the precision contract, the exact sweep for the rows pass (every row
counts as fixed up). The rows pass takes its
top-K from tensor-core logits by candidate refinement: the top K + 4
candidates of each row are recomputed in fp32 and a per-row guard
(:func:`select_guard_eps`) decides whether they settle the fp32 top-K; the
rows it cannot settle go to the exact fp32 sweep, a fix-up inside the same
call, whose row count ``hpd_stream_select.fixup_rows`` (and
``hpd_stream_fused_fwd.fixup_rows``) keeps as a device tensor. For a CPU
tensor the wrappers run the plain version below, which processes the rows
in chunks so that (U, T) never exists whole. The plain versions are the
CPU path and the reference the kernels are held against; nothing on the
card's path calls them.
"""

from __future__ import annotations

import ctypes

import torch

from ..precision import PRECISION_CODE, kernel_precision, pdot
from ..topk import topk_lowest_index
from . import build

MAX_K = 16
MAX_L = 32
COL_TILE = 128

# The backward (hpd_stream.cu) runs the contraction over H in CHUNK_H-deep
# chunks (HMAX, also the widest head of the forward's tensor-core passes),
# dh's chunks on its row kernels' grid.y and dW's on its columns kernel's
# grid.z, so the widest head fills 65,535 of them (hpd_stream.cu: HWIDE);
# no shared-memory plan grows with H.
CHUNK_H = 128
MAX_H = 65535 * CHUNK_H
# rows per plain-version chunk: (chunk, T) fp32 temporaries of <= 64 MB
PLAIN_CHUNK_ELEMS = 1 << 24

# The JAX package's gate (ops/pallas/hpd_stream.py): the TPU kernels tile T
# in LANE_TILE columns; the fused pair keeps an (R, T) row block in a
# FUSED_CACHE_BYTES VMEM cache and the (H, T) weight VMEM-resident up to
# FUSED_W_MAX_BYTES. These pick the kernel contract only.
LANE_TILE = 2048
FUSED_CACHE_BYTES = 32 << 20
FUSED_W_MAX_BYTES = 20 << 20


def supports(t: int, k: int) -> bool:
    """The streamed kernels' shape gate: T in whole LANE_TILE tiles, K <= MAX_K."""
    return t % LANE_TILE == 0 and t >= LANE_TILE and 1 <= k <= MAX_K


def _fused_rows(t: int) -> int:
    r = (FUSED_CACHE_BYTES // (4 * t)) // 8 * 8
    return int(max(8, min(512, r)))


def fused_supports(t: int, k: int, hd: int) -> bool:
    """True where the TPU runs the fused pair K1/K2; past it, K4-K6."""
    return supports(t, k) and hd * t * 4 <= FUSED_W_MAX_BYTES and _fused_rows(t) >= 64


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _chunk(t: int) -> int:
    return max(1, PLAIN_CHUNK_ELEMS // max(t, 1))


# The rows pass's guard (hpd_stream.cu: guard_coef; derivation there): the
# candidates' tensor-core logits may differ from the fp32 ones by at most
# eps_r = (n_f / 16 + 16) 2^-20 (sum_k |h_rk| max_t |w_kt| + max_t |b_t|),
# n_f = H fmas per fp32 logit (3H at 'high'); a row's candidates settle its
# fp32 top-K when the K-th recomputed logit exceeds the (K + GUARD_SLACK)-th
# tensor-core logit by more than 2 eps_r.
GUARD_SLACK = 4


def select_guard_eps(h, w, b, precision: str = "highest"):
    """eps_r (U,) of the rows pass's guard for h (U, H), w (H, T), b (T,)."""
    precision = kernel_precision(precision)
    hd = h.shape[1]
    n_f = (3 if precision == "high" else 1) * hd
    s = h.abs() @ w.abs().amax(dim=1) + b.abs().max()
    return (n_f / 16 + 16) * 2.0**-20 * s


# ------------------------------ plain versions ------------------------------ #

def _safe_s(s):
    """s <= 0 reads as 1, as the TPU kernels pad it: p stays finite and a
    zero count times it adds exactly 0."""
    return torch.where(s > 0, s, torch.ones_like(s))


def _p_chunk(h, w, b, m, s, precision):
    return torch.exp(pdot(h, w, precision) + b - m) / s


def _select_chunks(h, w, b, k: int, precision: str):
    """Rows in chunks: yields (r0, e (R, T) = exp(logit - m), (vals, idx
    int32, m, s) of the chunk), top-K on the raw logits."""
    step = _chunk(w.shape[1])
    for r0 in range(0, h.shape[0], step):
        logits = pdot(h[r0:r0 + step], w, precision) + b
        m = logits.amax(dim=1, keepdim=True)
        e = torch.exp(logits - m)
        s = e.sum(dim=1, keepdim=True)
        v, i = topk_lowest_index(logits, k)
        yield r0, e, (torch.exp(v - m) / s, i.to(torch.int32), m, s)


def _select_outputs(u: int, k: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(u, k, **f32), torch.empty(u, k, dtype=torch.int32, device=device),
            torch.empty(u, 1, **f32), torch.empty(u, 1, **f32))


def hpd_stream_fused_fwd_plain(h, w, b, counts, k: int, precision: str):
    marg = torch.zeros(counts.shape[0], w.shape[1], dtype=torch.float32, device=h.device)
    out = _select_outputs(h.shape[0], k, h.device)
    for r0, e, chunk in _select_chunks(h, w, b, k, precision):
        r1 = r0 + e.shape[0]
        marg += pdot(counts[:, r0:r1], e / chunk[3], precision)
        for dst, src in zip(out, chunk):
            dst[r0:r1] = src
    return (marg, *out)


def hpd_stream_select_plain(h, w, b, k: int, precision: str):
    """(vals (U, K), idx (U, K) int32, m (U, 1), s (U, 1)) (K4)."""
    out = _select_outputs(h.shape[0], k, h.device)
    for r0, e, chunk in _select_chunks(h, w, b, k, precision):
        for dst, src in zip(out, chunk):
            dst[r0:r0 + e.shape[0]] = src
    return out


def hpd_stream_marginal_plain(h, w, b, counts, m, s, precision: str):
    """marg (L, T) = counts @ p, unnormalized (K5)."""
    t = w.shape[1]
    marg = torch.zeros(counts.shape[0], t, dtype=torch.float32, device=h.device)
    s = _safe_s(s)
    step = _chunk(t)
    for r0 in range(0, h.shape[0], step):
        r1 = min(h.shape[0], r0 + step)
        p = _p_chunk(h[r0:r1], w, b, m[r0:r1], s[r0:r1], precision)
        marg += pdot(counts[:, r0:r1], p, precision)
    return marg


def _close_dot(counts, g_rows, vals, g_vals, noop_topk: bool):
    """dot (U,) = sum_l counts G (+ sum_k g_vals vals), G = p g_marg^T: the
    (U,)-thin step that K6 closes between its two launches, in plain code
    as in the JAX function."""
    dot = (counts.T * g_rows).sum(dim=1)
    if not noop_topk:
        dot = dot + (g_vals * vals).sum(dim=1)
    return dot


def hpd_stream_fused_bwd_plain(
    h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k: int, precision: str,
    noop_topk: bool,
):
    """(dh (U, H), dw (H, T), db (T,)): the plain version of K2 and of K6,
    which compute the same function."""
    u, hd = h.shape
    t = w.shape[1]
    s = _safe_s(s)
    dh = torch.empty(u, hd, dtype=torch.float32, device=h.device)
    dw = torch.zeros(hd, t, dtype=torch.float32, device=h.device)
    db = torch.zeros(t, dtype=torch.float32, device=h.device)
    step = _chunk(t)
    for r0 in range(0, u, step):
        r1 = min(u, r0 + step)
        p = _p_chunk(h[r0:r1], w, b, m[r0:r1], s[r0:r1], precision)
        cnt = counts[:, r0:r1]
        dot = _close_dot(cnt, pdot(p, g_marg.T, precision), vals[r0:r1], g_vals[r0:r1],
                         noop_topk)[:, None]
        g_p = pdot(cnt.T, g_marg, precision)
        if not noop_topk:
            g_p.scatter_add_(1, idx[r0:r1].long(), g_vals[r0:r1])
        dl = p * (g_p - dot)
        dh[r0:r1] = pdot(dl, w.T, precision)
        dw += pdot(h[r0:r1].T, dl, precision)
        db += dl.sum(dim=0)
    return dh, dw, db


hpd_tail_unique_bwd_plain = hpd_stream_fused_bwd_plain

PROBE_VARIANTS = ("softmax", "dots")


def _probe_variant(variant: str) -> str:
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; expected one of {PROBE_VARIANTS}")
    return variant


def hpd_stream_fused_probe_plain(h, w, b, precision: str, variant: str):
    """(m (U, 1), s (U, 1)) of K7, row chunk by row chunk."""
    variant = _probe_variant(variant)
    u, t = h.shape[0], w.shape[1]
    b = b.reshape(1, t)
    m = torch.empty(u, 1, dtype=torch.float32, device=h.device)
    s = torch.empty(u, 1, dtype=torch.float32, device=h.device)
    step = _chunk(t)
    for r0 in range(0, u, step):
        logits = pdot(h[r0:r0 + step], w, precision) + b
        if variant == "dots":
            m[r0:r0 + step] = s[r0:r0 + step] = logits.sum(dim=1, keepdim=True)
        else:
            mc = logits.amax(dim=1, keepdim=True)
            m[r0:r0 + step] = mc
            s[r0:r0 + step] = torch.exp(logits - mc).sum(dim=1, keepdim=True)
    return m, s


# --------------------------------- kernels ---------------------------------- #

def _lib() -> ctypes.CDLL:
    return _configure(build.library("hpd_stream"))


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """lib's launchers typed (also an instrumented build's, tools/k2_phases.py)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hpd_select.argtypes = [vp] * 3 + [ci] * 5 + [vp] * 8
    lib.hpd_marginal.argtypes = [vp] * 6 + [ci] * 5 + [vp] * 3
    lib.hpd_fused_bwd.argtypes = [vp] * 10 + [ci] * 7 + [vp] * 7
    lib.hpd_unique_bwd_g.argtypes = [vp] * 6 + [ci] * 5 + [vp] * 2
    lib.hpd_unique_bwd_main.argtypes = [vp] * 10 + [ci] * 7 + [vp] * 6
    lib.hpd_probe.argtypes = [vp] * 3 + [ci] * 5 + [vp] * 3
    for fn in (lib.hpd_select, lib.hpd_marginal, lib.hpd_fused_bwd, lib.hpd_unique_bwd_g,
               lib.hpd_unique_bwd_main, lib.hpd_probe):
        fn.restype = ci
    lib.hpd_stream_segments.argtypes = []
    lib.hpd_stream_segments.restype = ci
    return lib


def _check_inputs(h, w, b, counts, k, tile=COL_TILE, **more):
    """Contiguous, 16-byte aligned float32 (int32 for idx) tensors on h's
    device, in order h, w, b, [counts], *more; raises ValueError on a shape
    the kernels do not take. counts may be None (the select kernel has
    none)."""
    u, hd = h.shape
    t = w.shape[1]
    l = counts.shape[0] if counts is not None else 1
    if not (hd <= MAX_H and t % tile == 0 and t >= tile and l <= MAX_L and 1 <= k <= MAX_K):
        raise ValueError(
            f"hpd_stream kernels take H <= {MAX_H}, T a multiple of {tile}, "
            f"L <= {MAX_L}, 1 <= K <= {MAX_K}; got H={hd}, T={t}, L={l}, K={k}"
        )
    want = dict(h=(u, hd), w=(hd, t), b=(t,), counts=(l, u), idx=(u, k), vals=(u, k),
                m=(u, 1), s=(u, 1), dot=(u,), g_marg=(l, t), g_vals=(u, k))
    named = dict(h=h, w=w, b=b, **({} if counts is None else dict(counts=counts)), **more)
    out = []
    for name, x in named.items():
        dtype = torch.int32 if name == "idx" else torch.float32
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name}: expected shape {want[name]}, got {tuple(x.shape)}")
        if x.device != h.device or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {h.device}, got {x.dtype} on {x.device}")
        x = x.contiguous()
        # the kernels copy w, b and g_marg 16 bytes at a time (cp.async)
        out.append(x.clone() if x.data_ptr() % 16 else x)
    return out


def _f32(dev):
    return dict(device=dev, dtype=torch.float32)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _select(h, w, b, k, precision, tile, what):
    """The rows pass (K4; K1's first): (vals, idx, m, s, n_fix), n_fix a
    (1,) int32 device tensor holding the number of rows the kernel's guard
    handed to the exact fp32 fix-up. Counts nothing."""
    dev = h.device
    h, w, b = _check_inputs(h, w, b, None, k, tile=tile)
    u, hd = h.shape
    t = w.shape[1]
    lib = _lib()
    vals = torch.empty(u, k, **_f32(dev))
    idx = torch.empty(u, k, device=dev, dtype=torch.int32)
    m = torch.empty(u, 1, **_f32(dev))
    s = torch.empty(u, 1, **_f32(dev))
    absmax = torch.empty(hd + 1, **_f32(dev))                       # the guard's scratch
    fix_rows = torch.empty(max(u, 1), device=dev, dtype=torch.int32)
    n_fix = torch.empty(1, device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        code = lib.hpd_select(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), u, hd, t, k, PRECISION_CODE[precision],
            vals.data_ptr(), idx.data_ptr(), m.data_ptr(), s.data_ptr(), absmax.data_ptr(),
            fix_rows.data_ptr(), n_fix.data_ptr(), _stream(dev),
        )
    build.check(code, lib, "hpd_stream_error_string", what)
    return vals, idx, m, s, n_fix


def _marginal(h, w, b, counts, m, s, precision, tile, what):
    """The columns pass and its ordered reduce (K5; K1's second): marg.
    Counts nothing."""
    dev = h.device
    h, w, b, counts, m, s = _check_inputs(h, w, b, counts, 1, tile=tile, m=m, s=s)
    u, hd = h.shape
    t = w.shape[1]
    l = counts.shape[0]
    lib = _lib()
    marg = torch.empty(l, t, **_f32(dev))
    marg_part = torch.empty(lib.hpd_stream_segments(), l, t, **_f32(dev))
    with torch.cuda.device(dev):
        code = lib.hpd_marginal(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), counts.data_ptr(), m.data_ptr(),
            s.data_ptr(), u, hd, t, l, PRECISION_CODE[precision], marg.data_ptr(),
            marg_part.data_ptr(), _stream(dev),
        )
    build.check(code, lib, "hpd_stream_error_string", what)
    return marg


def _launch_fwd(h, w, b, counts, k, precision):
    _check_inputs(h, w, b, counts, k)
    vals, idx, m, s, n_fix = _select(h, w, b, k, precision, COL_TILE, "hpd_stream_fused_fwd")
    marg = _marginal(h, w, b, counts, m, s, precision, COL_TILE, "hpd_stream_fused_fwd")
    hpd_stream_fused_fwd.launches += 1
    hpd_stream_fused_fwd.fixup_rows = n_fix
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
    dh = torch.empty(u, hd, **_f32(dev))
    dot = torch.empty(u, **_f32(dev))
    dw = torch.empty(hd, t, **_f32(dev))
    db = torch.empty(t, **_f32(dev))
    dw_part = torch.empty(segs, hd, t, **_f32(dev))
    db_part = torch.empty(segs, t, **_f32(dev))
    with torch.cuda.device(dev):
        code = lib.hpd_fused_bwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), counts.data_ptr(), idx.data_ptr(),
            vals.data_ptr(), m.data_ptr(), s.data_ptr(), g_marg.data_ptr(),
            g_vals.data_ptr(), u, hd, t, l, k, int(noop_topk), PRECISION_CODE[precision],
            dh.data_ptr(), dot.data_ptr(), dw.data_ptr(), db.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), _stream(dev),
        )
    build.check(code, lib, "hpd_stream_error_string", "hpd_stream_fused_bwd")
    hpd_stream_fused_bwd.launches += 1
    return dh, dw, db


def _launch_select(h, w, b, k, precision):
    *out, n_fix = _select(h, w, b, k, precision, LANE_TILE, "hpd_stream_select")
    hpd_stream_select.launches += 1
    hpd_stream_select.fixup_rows = n_fix
    return tuple(out)


def _launch_marginal(h, w, b, counts, m, s, precision):
    marg = _marginal(h, w, b, counts, m, s, precision, LANE_TILE, "hpd_stream_marginal")
    hpd_stream_marginal.launches += 1
    return marg


def _launch_unique_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision,
                       noop_topk):
    out = _unique_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision,
                      noop_topk, LANE_TILE, "hpd_tail_unique_bwd")
    hpd_tail_unique_bwd.launches += 1
    return out


def _unique_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision, noop_topk,
                tile, what):
    """K6's launches (B1, the per-row dot, B2): (dh, dw, db). Counts nothing."""
    dev = h.device
    h, w, b, counts, idx, vals, m, s, g_marg, g_vals = _check_inputs(
        h, w, b, counts, k, tile=tile, idx=idx, vals=vals, m=m, s=s, g_marg=g_marg,
        g_vals=g_vals,
    )
    u, hd = h.shape
    t = w.shape[1]
    l = counts.shape[0]
    prec = PRECISION_CODE[precision]
    lib = _lib()
    segs = lib.hpd_stream_segments()
    g_rows = torch.empty(u, l, **_f32(dev))
    with torch.cuda.device(dev):
        code = lib.hpd_unique_bwd_g(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), m.data_ptr(), s.data_ptr(),
            g_marg.data_ptr(), u, hd, t, l, prec, g_rows.data_ptr(), _stream(dev),
        )
        build.check(code, lib, "hpd_stream_error_string", f"{what} (B1)")
        dot = _close_dot(counts, g_rows, vals, g_vals, noop_topk).contiguous()
        dh = torch.empty(u, hd, **_f32(dev))
        dw = torch.empty(hd, t, **_f32(dev))
        db = torch.empty(t, **_f32(dev))
        dw_part = torch.empty(segs, hd, t, **_f32(dev))
        db_part = torch.empty(segs, t, **_f32(dev))
        code = lib.hpd_unique_bwd_main(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), counts.data_ptr(), idx.data_ptr(),
            m.data_ptr(), s.data_ptr(), dot.data_ptr(), g_marg.data_ptr(), g_vals.data_ptr(),
            u, hd, t, l, k, int(noop_topk), prec, dh.data_ptr(), dw.data_ptr(), db.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), _stream(dev),
        )
    build.check(code, lib, "hpd_stream_error_string", f"{what} (B2)")
    return dh, dw, db


def _launch_probe(h, w, b, precision, variant):
    dev = h.device
    h, w, b = _check_inputs(h, w, b.reshape(-1), None, 1)
    u, hd = h.shape
    t = w.shape[1]
    lib = _lib()
    m = torch.empty(u, 1, **_f32(dev))
    s = torch.empty(u, 1, **_f32(dev))
    with torch.cuda.device(dev):
        code = lib.hpd_probe(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), u, hd, t, PRECISION_CODE[precision],
            int(variant == "dots"), m.data_ptr(), s.data_ptr(), _stream(dev),
        )
    build.check(code, lib, "hpd_stream_error_string", f"hpd_stream_fused_probe[{variant}]")
    hpd_stream_fused_probe.launches += 1
    hpd_stream_fused_probe.variant_launches[variant] += 1
    return m, s


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


def hpd_stream_select(h, w, b, k: int, precision: str = "highest"):
    """(vals (U, K), idx (U, K) int32, m (U, 1), s (U, 1)) (K4). T must be
    a multiple of LANE_TILE."""
    precision = kernel_precision(precision)
    if _on_card(h):
        return _launch_select(h, w, b, k, precision)
    return hpd_stream_select_plain(h, w, b, k, precision)


def hpd_stream_marginal(h, w, b, counts, m, s, precision: str = "highest"):
    """marg (L, T) = counts @ p, unnormalized, p from the row statistics
    (m, s) of :func:`hpd_stream_select` (K5)."""
    precision = kernel_precision(precision)
    if _on_card(h):
        return _launch_marginal(h, w, b, counts, m, s, precision)
    return hpd_stream_marginal_plain(h, w, b, counts, m, s, precision)


def hpd_tail_unique_bwd(
    h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k: int,
    precision: str = "highest", noop_topk: bool = False,
):
    """(dh (U, H), dw (H, T), db (T,)) of the split forward (K6: B1, the
    per-row dot, B2)."""
    precision = kernel_precision(precision)
    if _on_card(h):
        return _launch_unique_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k,
                                  precision, noop_topk)
    return hpd_tail_unique_bwd_plain(
        h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k, precision, noop_topk
    )


def hpd_stream_fused_probe(h, w, b, precision: str = "highest", variant: str = "softmax"):
    """(m (U, 1), s (U, 1)) of the reduced rows pass (K7); b is (T,) or
    (1, T), T a multiple of 128. Launches are counted in ``launches`` and,
    by variant, in ``variant_launches``."""
    precision = kernel_precision(precision)
    variant = _probe_variant(variant)
    if _on_card(h):
        return _launch_probe(h, w, b, precision, variant)
    return hpd_stream_fused_probe_plain(h, w, b, precision, variant)


hpd_stream_fused_fwd.launches = 0
hpd_stream_fused_bwd.launches = 0
hpd_stream_select.launches = 0
# the rows the last launch's guard handed to the fp32 fix-up: a (1,) int32
# device tensor (reading it waits for the launch), None before any launch
hpd_stream_fused_fwd.fixup_rows = None
hpd_stream_select.fixup_rows = None
hpd_stream_marginal.launches = 0
hpd_tail_unique_bwd.launches = 0
hpd_stream_fused_probe.launches = 0
hpd_stream_fused_probe.variant_launches = dict.fromkeys(PROBE_VARIANTS, 0)
