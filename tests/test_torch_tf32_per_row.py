"""The tensor-core contract of the per-row route's backward (K11), emulated
on the CPU: the hidden stack, its dW/db and its dx in fp32, as the kernel
takes them on the CUDA cores; the head's three products (the logits
replay a_head @ W, dW_head = a_head^T dl, dh = dl W^T) as 3xTF32, as
``ops/cuda/per_row_mma.cuh`` takes them on the tensor cores: x = hi + lo,
hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away from
zero, PTX ``cvt.rna.tf32.f32``) by bit masking; a product is
lo_a hi_b + hi_a lo_b + hi_a hi_b, each tf32 x tf32 product exact in fp32,
summed in fp32; dh sums chains of 128 columns of T (16 k8 steps) in fp32.
The tensor cores' own fp32 sums (rounded toward zero) are not emulated:
the card's check against the plain version (``chip_smoke.py``,
``tests/test_torch_cuda.py``) decides.

The emulation is held against the JAX package's hpd_full backward
(``jax.grad`` through the Pallas kernels in interpret mode) within
GRAD_TOL = 1e-4 normwise (max |emulated - ref| <= 1e-4 max |ref|, the
card's limit in ``chip_smoke.py``) for every layer's dW and db, at three
stacks: the per-row route's [2 -> 32 -> 64 -> 128 -> 256], a narrow one
at K = 32, and one whose widths are not powers of two. One TF32 product
per term (a single tensor-core pass) is held to what it gives on the same
inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_full as jax_full
from collision_handling_in_instantngp_tpu_torch.ops.cuda.hpd_tail import softmax_rows

GRAD_TOL = 1e-4
L, N = 2, 700
CHAIN_T = 128         # columns of T per dh chain: CHAIN = 16 k8 steps
SHAPES = [((2, 32, 64, 128, 256), 4), ((2, 8, 16, 128), 32), ((3, 16, 24, 40, 96, 512), 4)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 (10 explicit mantissa bits), ties
    away from zero: add half of the 13 dropped bits to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the tensor cores take it: three TF32 products (passes=3),
    the lo ones summed apart, or one."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        out = out + (a_lo @ b_hi + a_hi @ b_lo)
    return out


def emulated_bwd(verts, layers, idx, g_marg, g_vals, passes=3):
    """[(dW_i, db_i)] of K11 with the head's products in TF32 passes."""
    acts = [verts]
    for w, b in layers[:-1]:
        acts.append(torch.clamp(acts[-1] @ w + b, min=0.0))
    a = acts[-1]
    w, b = layers[-1]
    t = w.shape[1]
    p = softmax_rows(mm_tf32(a, w, passes) + b)
    g_p = torch.zeros_like(p).scatter_(-1, idx.long(), g_vals) + (g_marg / verts.shape[1])[:, None, :]
    dl = p * (g_p - (g_p * p).sum(dim=-1, keepdim=True))
    a2, dl2 = a.reshape(-1, a.shape[-1]), dl.reshape(-1, t)
    grads = [None] * len(layers)
    grads[-1] = (mm_tf32(a2.T, dl2, passes), dl2.sum(dim=0))
    dh = torch.zeros_like(a)
    for c0 in range(0, t, CHAIN_T):
        dh = dh + mm_tf32(dl[..., c0:c0 + CHAIN_T], w[:, c0:c0 + CHAIN_T].T, passes)
    d = dh * (a > 0).to(dh.dtype)
    for i in reversed(range(len(layers) - 1)):
        ai, dd = acts[i].reshape(-1, acts[i].shape[-1]), d.reshape(-1, d.shape[-1])
        grads[i] = (ai.T @ dd, dd.sum(dim=0))
        if i > 0:
            d = (d @ layers[i][0].T) * (acts[i] > 0).to(d.dtype)
    return grads


def _inputs(widths, k):
    rng = np.random.default_rng(65535)
    verts = rng.integers(0, 33, size=(L, N, widths[0])).astype(np.float32)
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / np.sqrt(din) if i < len(widths) - 2 else 0.2
        layers.append(((rng.standard_normal((din, dout)) * scale).astype(np.float32),
                       (rng.standard_normal(dout) * 0.1).astype(np.float32)))
    gm = rng.standard_normal((L, widths[-1])).astype(np.float32)
    gv = rng.standard_normal((L, N, k)).astype(np.float32)
    return verts, layers, gm, gv


def _case(widths, k):
    """Torch inputs (idx from the JAX forward) and the JAX K11's grads."""
    verts, layers, gm, gv = _inputs(widths, k)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    jv = jnp.asarray(verts)
    idx = jax_full.hpd_full(jv, jl, k, True)[2]

    def scalar(ls):
        marg, vals, _ = jax_full.hpd_full(jv, ls, k, True)
        return jnp.sum(marg * gm) + jnp.sum(vals * gv)

    ref = [(np.asarray(w, np.float64), np.asarray(b, np.float64)) for w, b in jax.grad(scalar)(jl)]
    t = lambda a: torch.from_numpy(np.array(a))
    args = (t(verts), [(t(w), t(b)) for w, b in layers], t(idx), t(gm), t(gv))
    return args, ref


def _normwise(got, ref):
    return np.abs(got.double().numpy() - ref).max() / np.abs(ref).max()


def _errors(args, ref, passes):
    got = emulated_bwd(*args, passes=passes)
    return {f"{nm}{i}": _normwise(a, r)
            for i, (pair, rpair) in enumerate(zip(got, ref))
            for nm, a, r in zip(("dW", "db"), pair, rpair)}


@pytest.mark.parametrize("widths,k", SHAPES)
def test_3xtf32_head_within_grad_tol(widths, k):
    args, ref = _case(widths, k)
    errs = _errors(args, ref, 3)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_one_tf32_pass_misses_grad_tol():
    """The same backward with one TF32 product per head term, at the
    per-row route's stack: at least one layer's dW or db is off by more
    than GRAD_TOL, and by far more than with 3xTF32."""
    args, ref = _case(*SHAPES[0])
    one, three = _errors(args, ref, 1), _errors(args, ref, 3)
    assert max(one.values()) > GRAD_TOL, one
    assert max(one.values()) > 10 * max(three.values()), (one, three)
