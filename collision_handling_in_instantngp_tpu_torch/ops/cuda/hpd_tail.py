"""Per-row fused HPD tail (kernels K8 and K9).

Replaces ``ops/pallas/hpd_tail.py: hpd_tail_pallas_fwd`` and
``hpd_tail_pallas_bwd`` of the JAX package; the contract is the same.

Forward: h (L, N, H), w (H, T), b (T,) ->
  marg (L, T) = sum over a level's rows of p / N, p = nan_to_num(e / sum e)
  with e = exp(logits - max) per row; vals, idx (L, N, K): K argmax passes
  on p, lowest index first among equal values.
Backward: + idx, g_marg (L, T), g_vals (L, N, K) -> dh (L, N, H), dw (H, T),
  db (T,), with g_p = g_marg[l] / N + g_vals scattered at idx and
  dlogits = p (g_p - <g_p, p>).

For a CUDA tensor the wrappers launch the kernels of ``hpd_tail.cu``,
whatever the model's matmul precision. The forward (any H) takes the
logits in fp32 FMA on the CUDA cores, each one fma chain over k
ascending, then softmax, the column sums and the top-K of p from the
same tile (``hpd_tail.cu``). The backward's three products (the logits
replay, dW, dh) run as 3xTF32 on the tensor cores (``per_row_mma.cuh``,
as in K11), softmax and dlogits in fp32; its row tile holds all of h, so
it takes head inputs up to ``bwd_max_h(T)`` (1,152 at T = 2048, 3,040 at
T = 256).
For a CPU tensor they run the plain version below at fp32. The plain
version streams the rows in chunks so that (L, N, T) never exists whole;
at the model's precision it is also the port of the JAX package's
``lax.scan`` tail (``ops/fused_hpd.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..precision import pdot
from ..topk import topk_lowest_index
from . import build

MAX_T = 2048
MAX_K = 128
CHUNK_ROWS = 4096
# (L, rows, T) fp32 temporaries of the plain version stay near 64 MB
TILE_BUDGET = 1 << 24


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


# ---------------- the per-row kernels' shared-memory plans ----------------- #
#
# The constants and strides of per_row.cuh and per_row_mma.cuh, restated
# so that a route is decided from the shapes before any launch: K9's tile
# here, K10/K11's in hpd_full.py. tests/test_torch_width_faults.py holds
# them to the headers.
THREADS = 256
WMAX = 128
SMEM_MAX = 232448                # bytes a block may use


def mma_ld(w: int) -> int:
    """per_row_mma.cuh: the row stride of a tile the head's helpers read."""
    return (w + 31) // 32 * 32 + 4


def head_stage_floats(rpt: int) -> int:
    """per_row_mma.cuh: the staged head chunks at rpt rows a thread."""
    wc = THREADS // 32 // (rpt // (2 if rpt >= 2 else 1))
    kl, kd = (64, 64) if rpt >= 4 else (16, 32)
    buf = max(kl * (wc * 32 + 8), WMAX * (kd + 4))
    return (2 if rpt >= 4 else 1) * buf


def bwd_max_h(t: int) -> int:
    """The widest head input whose 16-row backward tile fits at T = t
    (hpd_tail.cu: tail_bwd_smem at one row a thread: the h and logits tiles
    at mma_ld strides, the staged head and g_marg's row)."""
    room = (SMEM_MAX // 4 - head_stage_floats(1) - 16 * mma_ld(t) - t) // 16 - 4
    return room // 32 * 32          # round32(H) <= room


def chunk_rows(num_levels: int, t: int) -> int:
    return int(max(256, min(CHUNK_ROWS, TILE_BUDGET // max(num_levels * t, 1))))


def softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """nan_to_num(e / sum e), e = exp(logits - row max), as the TPU kernels
    write it."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return torch.nan_to_num(e / e.sum(dim=-1, keepdim=True))


# ------------------------------ plain versions ------------------------------ #

def hpd_tail_fwd_plain(h, w, b, k: int, precision: str = "highest"):
    l, n, _ = h.shape
    t = w.shape[1]
    marg = torch.zeros(l, t, dtype=torch.float32, device=h.device)
    vals = torch.empty(l, n, k, dtype=torch.float32, device=h.device)
    idx = torch.empty(l, n, k, dtype=torch.int32, device=h.device)
    step = chunk_rows(l, t)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        p = softmax_rows(pdot(h[:, r0:r1], w, precision) + b)      # (L, R, T)
        marg += p.sum(dim=1)
        v, i = topk_lowest_index(p, k)
        vals[:, r0:r1] = v
        idx[:, r0:r1] = i.to(torch.int32)
    return marg / n, vals, idx


def hpd_tail_bwd_plain(h, w, b, idx, g_marg, g_vals, k: int, precision: str = "highest"):
    l, n, hd = h.shape
    t = w.shape[1]
    dh = torch.empty(l, n, hd, dtype=torch.float32, device=h.device)
    dw = torch.zeros(hd, t, dtype=torch.float32, device=h.device)
    db = torch.zeros(t, dtype=torch.float32, device=h.device)
    g_row = (g_marg / n)[:, None, :]                                # fold the primal's 1/N
    step = chunk_rows(l, t)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        hc = h[:, r0:r1]
        p = softmax_rows(pdot(hc, w, precision) + b)
        g_p = torch.zeros_like(p).scatter_(-1, idx[:, r0:r1].long(), g_vals[:, r0:r1]) + g_row
        dl = p * (g_p - (g_p * p).sum(dim=-1, keepdim=True))
        dh[:, r0:r1] = pdot(dl, w.T, precision)
        dw += pdot(hc.reshape(-1, hd).T, dl.reshape(-1, t), precision)
        db += dl.sum(dim=(0, 1))
    return dh, dw, db


# --------------------------------- kernels ---------------------------------- #

def _lib() -> ctypes.CDLL:
    return _configure(build.library("hpd_tail"))


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a built hpd_tail library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hpd_tail_fwd.argtypes = [vp] * 3 + [ci] * 5 + [vp] * 5
    lib.hpd_tail_fwd.restype = ci
    lib.hpd_tail_bwd.argtypes = [vp] * 6 + [ci] * 5 + [vp] * 4
    lib.hpd_tail_bwd.restype = ci
    lib.hpd_tail_blocks.argtypes = [ci] * 6
    lib.hpd_tail_blocks.restype = ci
    lib.hpd_tail_head_ld.argtypes = [ci]
    lib.hpd_tail_head_ld.restype = ci
    lib.hpd_tail_head_rows.argtypes = [ci]
    lib.hpd_tail_head_rows.restype = ci
    return lib


def check_inputs(h, w, b, k, bwd=False, **more):
    """Contiguous float32/int32 copies on h's device; raises ValueError
    naming the kernels' limits (the backward's: its tile's widest H)."""
    if h.dim() != 3:
        raise ValueError(f"h must be (L, N, H), got {tuple(h.shape)}")
    l, n, hd = h.shape
    t = w.shape[1]
    if not (l >= 1 and n >= 1 and hd >= 1 and 1 <= t <= MAX_T and 1 <= k <= min(MAX_K, t)):
        raise ValueError(
            f"hpd_tail kernels take L >= 1, N >= 1, H >= 1, T <= {MAX_T}, "
            f"1 <= K <= min({MAX_K}, T); got L={l}, N={n}, H={hd}, T={t}, K={k}"
        )
    if bwd and hd > bwd_max_h(t):
        raise ValueError(
            f"hpd_tail backward (K9): its 16-row tile holds all of h, so it takes H <= "
            f"{bwd_max_h(t)} at T={t} (the card's 227 KB of shared memory a block); got H={hd}"
        )
    if tuple(w.shape) != (hd, t) or tuple(b.shape) != (t,):
        raise ValueError(f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} do not agree")
    shapes = {"idx": (l, n, k), "g_vals": (l, n, k), "g_marg": (l, t)}
    out = []
    for name, x in dict(h=h, w=w, b=b, **more).items():
        want = torch.int32 if name == "idx" else torch.float32
        if x.device != h.device or x.dtype != want:
            raise ValueError(f"{name}: expected {want} on {h.device}, got {x.dtype} on {x.device}")
        if name in shapes and tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(x.shape)}")
        out.append(x.contiguous())
    return out


def padded_head(w: torch.Tensor) -> torch.Tensor:
    """The head w (H, T) padded with zeros to (hpd_tail_head_rows(H),
    hpd_tail_head_ld(T)): H up to whole 128-row chunks of dh, so that every
    chunk the per-row kernels stage lies inside it: K8's and K9's, and K10's and
    K11's (``hpd_full.py``)."""
    hd, t = w.shape
    lib = _lib()
    w_pad = torch.zeros(lib.hpd_tail_head_rows(hd), lib.hpd_tail_head_ld(t), device=w.device,
                        dtype=torch.float32)
    w_pad[: w.shape[0], :t] = w
    return w_pad


def _launch_fwd(h, w, b, k):
    dev = h.device
    h, w, b = check_inputs(h, w, b, k)
    l, n, hd = h.shape
    t = w.shape[1]
    lib = _lib()
    f32 = dict(device=dev, dtype=torch.float32)
    w_pad = padded_head(w)
    marg = torch.empty(l, t, **f32)
    marg_part = torch.empty(lib.hpd_tail_blocks(l, n, hd, t, k, 0), t, **f32)
    vals = torch.empty(l, n, k, **f32)
    idx = torch.empty(l, n, k, device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        code = lib.hpd_tail_fwd(
            h.data_ptr(), w_pad.data_ptr(), b.data_ptr(), l, n, hd, t, k,
            marg.data_ptr(), marg_part.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hpd_tail_error_string", "hpd_tail_fwd")
    hpd_tail_fwd.launches += 1
    return marg, vals, idx


def _launch_bwd(h, w, b, idx, g_marg, g_vals, k):
    dev = h.device
    h, w, b, idx, g_marg, g_vals = check_inputs(h, w, b, k, bwd=True, idx=idx, g_marg=g_marg,
                                                g_vals=g_vals)
    l, n, hd = h.shape
    t = w.shape[1]
    lib = _lib()
    f32 = dict(device=dev, dtype=torch.float32)
    dh = torch.empty(l, n, hd, **f32)
    part = torch.empty(lib.hpd_tail_blocks(l, n, hd, t, k, 1), hd * t + t, **f32)
    dwb = torch.empty(hd * t + t, **f32)
    w_pad = padded_head(w)
    with torch.cuda.device(dev):
        code = lib.hpd_tail_bwd(
            h.data_ptr(), w_pad.data_ptr(), b.data_ptr(), idx.data_ptr(), g_marg.data_ptr(),
            g_vals.data_ptr(), l, n, hd, t, k, dh.data_ptr(), part.data_ptr(), dwb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hpd_tail_error_string", "hpd_tail_bwd")
    hpd_tail_bwd.launches += 1
    return dh, dwb[: hd * t].view(hd, t), dwb[hd * t:]


def hpd_tail_fwd(h, w, b, k: int):
    """(marg (L, T), vals (L, N, K), idx (L, N, K) int32) (K8)."""
    if _on_card(h):
        return _launch_fwd(h, w, b, k)
    return hpd_tail_fwd_plain(h, w, b, k)


def hpd_tail_bwd(h, w, b, idx, g_marg, g_vals, k: int):
    """(dh (L, N, H), dw (H, T), db (T,)) (K9)."""
    if _on_card(h):
        return _launch_bwd(h, w, b, idx, g_marg, g_vals, k)
    return hpd_tail_bwd_plain(h, w, b, idx, g_marg, g_vals, k)


hpd_tail_fwd.launches = 0
hpd_tail_bwd.launches = 0
