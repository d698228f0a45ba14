"""The whole HPD index network per row (kernels K10 and K11).

Replaces ``ops/pallas/hpd_full.py: hpd_full`` of the JAX package (its
forward and its custom VJP); the contract is the same.

Forward: verts (L, N, d) and every layer [(w_i, b_i)], the last the
  (H, T) head -> (marg (L, T), vals (L, N, K), idx (L, N, K) int32), as the
  per-row tail (``hpd_tail.py``) on the last ReLU activation.
Backward: + idx, g_marg, g_vals -> [(dW_i, db_i)] of every layer, the
  stack replayed from the vertices, with the ReLU mask ``act > 0`` on
  each layer's input. The vertices are data: their gradient is zero.

For a CUDA tensor the wrappers launch the kernels of ``hpd_full.cu``,
whatever the model's matmul precision: the hidden layers in fp32 on the
CUDA cores, the head's products as 3xTF32 on the tensor cores
(``per_row_mma.cuh``: the forward's logits, the backward's logits replay,
dW_head and dh). The forward's top-K stays that of the fp32 logits: the
top K + 4 candidates of a row by tensor-core logit are recomputed in fp32
and ranked on p, and a row whose guard cannot settle it is redone in fp32
by the kernel itself; ``hpd_full_fwd.fixup_rows`` keeps the count of the
last launch as a device tensor. For a CPU tensor they run the plain
version below: the hidden stack at fp32, then the chunked tail.
:class:`HpdFull` is the autograd Function over the pair.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import build
from .hpd_tail import hpd_tail_bwd_plain, hpd_tail_fwd_plain, padded_head

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]
MAX_LAYERS = 16
MAX_WIDTH = 512                  # the JAX package's hidden-stack width
MAX_T = 2048
MAX_K = 32


# The forward's guard (per_row_mma.cuh: GSLACK, GUARD_ABS, P_MIN,
# guard_coef, settle_row; derivation there), restated for the CPU emulation
# of the refinement (tests/test_torch_tf32_per_row.py, which holds these
# copies to the header): the top K + GUARD_SLACK candidates of a row by
# tensor-core logit settle its fp32 top-K when the K-th selected fp32 logit
# exceeds the (K + GUARD_SLACK)-th tensor-core logit by more than
# 2 eps_r + GUARD_ABS and its p is at least P_MIN.
GUARD_SLACK = 4
GUARD_ABS = 2.0**-18
P_MIN = 2.0**-100


def guard_coef(hd: int) -> float:
    """eps_r / S_r for a head input of width hd (per_row_mma.cuh: guard_coef)."""
    nk = (hd + 7) // 8
    return (1.25 * nk + hd / 16 + 2) * 2.0**-20


def guard_eps(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """eps_r (..., rows) of the forward's guard for the head input h
    (..., H), the head w (H, T) and b (T,)."""
    return guard_coef(h.shape[-1]) * (h.abs() @ w.abs().amax(dim=1) + b.abs().max())


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


# ------------------------------ plain versions ------------------------------ #

def _stack(verts: torch.Tensor, layers: Layers) -> List[torch.Tensor]:
    """Every layer's input: [verts, relu(verts W0 + b0), ...]."""
    acts = [verts]
    for w, b in layers[:-1]:
        acts.append(torch.clamp(acts[-1] @ w + b, min=0.0))
    return acts


def hpd_full_fwd_plain(verts: torch.Tensor, layers: Layers, k: int):
    h = _stack(verts, layers)[-1]
    w, b = layers[-1]
    return hpd_tail_fwd_plain(h, w, b, k)


def hpd_full_bwd_plain(verts, layers: Layers, idx, g_marg, g_vals, k: int):
    acts = _stack(verts, layers)
    w, b = layers[-1]
    dh, dw, db = hpd_tail_bwd_plain(acts[-1], w, b, idx, g_marg, g_vals, k)
    grads = [None] * len(layers)
    grads[-1] = (dw, db)
    d = dh * (acts[-1] > 0).to(dh.dtype)
    for i in reversed(range(len(layers) - 1)):
        a = acts[i].reshape(-1, acts[i].shape[-1])
        dd = d.reshape(-1, d.shape[-1])
        grads[i] = (a.T @ dd, dd.sum(dim=0))
        if i > 0:
            d = (d @ layers[i][0].T) * (acts[i] > 0).to(d.dtype)
    return grads


# --------------------------------- kernels ---------------------------------- #

def _lib() -> ctypes.CDLL:
    return _configure(build.library("hpd_full"))


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a built hpd_full library."""
    vp, ci, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.hpd_full_fwd.argtypes = [vp, vp, vp, ci, ip, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.hpd_full_fwd.restype = ci
    lib.hpd_full_bwd.argtypes = [vp, vp, vp, ci, ip, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.hpd_full_bwd.restype = ci
    lib.hpd_full_blocks.argtypes = [ci, ip, ci, ci, ci]
    lib.hpd_full_blocks.restype = ci
    return lib


def widths_of(verts: torch.Tensor, layers: Layers, k: int) -> List[int]:
    """[d, hidden..., T]; raises ValueError naming the kernels' limits."""
    if verts.dim() != 3:
        raise ValueError(f"verts must be (L, N, d), got {tuple(verts.shape)}")
    l, n, _ = verts.shape
    widths = [verts.shape[2]] + [w.shape[1] for w, _ in layers]
    t = widths[-1]
    if not (1 <= len(layers) <= MAX_LAYERS and max(widths[:-1]) <= MAX_WIDTH and t <= MAX_T
            and 1 <= k <= min(MAX_K, t) and l >= 1 and n >= 1):
        raise ValueError(
            f"hpd_full kernels take 1..{MAX_LAYERS} layers, input and hidden widths "
            f"<= {MAX_WIDTH}, T <= {MAX_T}, 1 <= K <= min({MAX_K}, T), L, N >= 1; got "
            f"widths {widths}, K={k}, L={l}, N={n}"
        )
    for (w, b), din, dout in zip(layers, widths[:-1], widths[1:]):
        if tuple(w.shape) != (din, dout) or tuple(b.shape) != (dout,):
            raise ValueError(f"layer shapes {tuple(w.shape)}, {tuple(b.shape)} break the chain {widths}")
    return widths


def _checked(t: torch.Tensor, device: torch.device, name: str, dtype=torch.float32) -> torch.Tensor:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    return t.contiguous()


def _prepare(verts, layers, k):
    dev = verts.device
    widths = widths_of(verts, layers, k)
    verts = _checked(verts, dev, "verts")
    params = torch.cat([
        torch.cat([_checked(w, dev, "w").reshape(-1), _checked(b, dev, "b")]) for w, b in layers
    ])
    cw = (ctypes.c_int * len(widths))(*widths)
    lib = _lib()
    l, n, _ = verts.shape
    blocks = lib.hpd_full_blocks(len(layers), cw, l, n, k)
    if blocks == 0:
        raise ValueError(f"hpd_full kernels: a 16-row tile of the stack {widths} does not fit in "
                         "shared memory (ROADMAP.md §3)")
    return lib, verts, params, widths, cw, blocks


def _launch_fwd(verts, layers, k):
    dev = verts.device
    lib, verts, params, widths, cw, blocks = _prepare(verts, layers, k)
    l, n, _ = verts.shape
    t = widths[-1]
    f32 = dict(device=dev, dtype=torch.float32)
    w_pad = padded_head(layers[-1][0])
    marg = torch.empty(l, t, **f32)
    marg_part = torch.empty(blocks, t, **f32)
    vals = torch.empty(l, n, k, **f32)
    idx = torch.empty(l, n, k, device=dev, dtype=torch.int32)
    n_fix = torch.empty(1, device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        code = lib.hpd_full_fwd(
            verts.data_ptr(), params.data_ptr(), w_pad.data_ptr(), len(layers), cw, l, n, k,
            marg.data_ptr(), marg_part.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            n_fix.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hpd_full_error_string", "hpd_full_fwd")
    hpd_full_fwd.launches += 1
    hpd_full_fwd.fixup_rows = n_fix
    return marg, vals, idx


def _launch_bwd(verts, layers, idx, g_marg, g_vals, k):
    dev = verts.device
    lib, verts, params, widths, cw, blocks = _prepare(verts, layers, k)
    l, n, _ = verts.shape
    t = widths[-1]
    idx = _checked(idx, dev, "idx", torch.int32)
    g_marg = _checked(g_marg, dev, "g_marg")
    g_vals = _checked(g_vals, dev, "g_vals")
    if tuple(idx.shape) != (l, n, k) or tuple(g_vals.shape) != (l, n, k) or tuple(g_marg.shape) != (l, t):
        raise ValueError(f"idx {tuple(idx.shape)}, g_vals {tuple(g_vals.shape)}, g_marg "
                         f"{tuple(g_marg.shape)} do not match L={l}, N={n}, K={k}, T={t}")
    w_pad = padded_head(layers[-1][0])
    part = torch.empty(blocks, params.numel(), device=dev, dtype=torch.float32)
    dparams = torch.empty_like(params)
    with torch.cuda.device(dev):
        code = lib.hpd_full_bwd(
            verts.data_ptr(), params.data_ptr(), w_pad.data_ptr(), len(layers), cw, l, n, k,
            idx.data_ptr(), g_marg.data_ptr(), g_vals.data_ptr(), part.data_ptr(), dparams.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hpd_full_error_string", "hpd_full_bwd")
    hpd_full_bwd.launches += 1
    grads, off = [], 0
    for w, b in layers:
        dw = dparams[off: off + w.numel()].view(w.shape)
        off += w.numel()
        grads.append((dw, dparams[off: off + b.numel()]))
        off += b.numel()
    return grads


def hpd_full_fwd(verts: torch.Tensor, layers: Layers, k: int):
    """(marg (L, T), vals (L, N, K), idx (L, N, K) int32) (K10)."""
    if _on_card(verts):
        return _launch_fwd(verts, layers, k)
    return hpd_full_fwd_plain(verts, layers, k)


def hpd_full_bwd(verts: torch.Tensor, layers: Layers, idx, g_marg, g_vals, k: int):
    """[(dW_i, db_i)] of every layer (K11)."""
    if _on_card(verts):
        return _launch_bwd(verts, layers, idx, g_marg, g_vals, k)
    return hpd_full_bwd_plain(verts, layers, idx, g_marg, g_vals, k)


hpd_full_fwd.launches = 0
hpd_full_fwd.fixup_rows = None
hpd_full_bwd.launches = 0


class HpdFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, verts, k: int, *params):
        layers = list(zip(params[0::2], params[1::2]))
        marg, vals, idx = hpd_full_fwd(verts, layers, k)
        ctx.save_for_backward(verts, idx, *params)
        ctx.k = k
        ctx.mark_non_differentiable(idx)
        return marg, vals, idx

    @staticmethod
    def backward(ctx, g_marg, g_vals, _g_idx):
        verts, idx, *params = ctx.saved_tensors
        layers = list(zip(params[0::2], params[1::2]))
        if g_marg is None:
            g_marg = torch.zeros(verts.shape[0], params[-1].shape[0], dtype=verts.dtype, device=verts.device)
        if g_vals is None:
            g_vals = torch.zeros(idx.shape, dtype=verts.dtype, device=verts.device)
        grads = hpd_full_bwd(verts, layers, idx, g_marg.contiguous(), g_vals.contiguous(), ctx.k)
        return (torch.zeros_like(verts), None, *[g for pair in grads for g in pair])


def hpd_full(verts: torch.Tensor, layers: Layers, k: int):
    """verts (L, N, d), layers [(w, b)...] -> (marg (L, T), vals (L, N, K),
    idx (L, N, K) int32), differentiable in every layer."""
    return HpdFull.apply(verts, k, *[t for pair in layers for t in pair])
