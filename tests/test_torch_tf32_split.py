"""The tensor-core contract of the tail backward (K2, K6) at 'highest',
emulated on the CPU: every product of the backward (the logits recompute,
G = p g_marg^T, g_p = counts^T g_marg, dh = dl w^T, dW = h^T dl) taken as
3xTF32, as the kernels of ``ops/cuda/hpd_stream.cu`` take it on the card:
x = hi + lo, hi = tf32(x), lo = tf32(x - hi), both rounded to nearest
(ties away from zero, PTX ``cvt.rna.tf32.f32``) by bit masking; a product
is lo_a hi_b + hi_a lo_b + hi_a hi_b, each tf32 x tf32 product exact in
fp32, summed in fp32. p = exp(l - m) / s uses the forward's m and s. The
tensor cores' own fp32 sums (rounded toward zero) are not emulated: the
kernels bound that bias by how they accumulate, and the card's check
against the plain version at the path's shapes (``chip_smoke.py``)
decides.

The emulation is held against the JAX package's K6 (the Pallas kernel in
interpret mode) on the split route's test shapes (``tests/test_torch_split.py``)
within GRAD_TOL = 1e-4 normwise (max |emulated - ref| <= 1e-4 max |ref|, the
card's limit in ``chip_smoke.py``), both ``noop_topk`` ways. One TF32
product per term (what a single tensor-core pass gives) is shown to miss
that limit on the same inputs, which is why 'highest' takes three.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream

GRAD_TOL = 1e-4
U, H, L, T = 700, 32, 3, 4096   # tests/test_torch_split.py's shapes


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 (10 explicit mantissa bits), ties
    away from zero: add half of the 13 dropped bits to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products (passes=3) or one."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        out = a_lo @ b_hi + a_hi @ b_lo + out
    return out


def emulated_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, noop, passes=3):
    """(dh, dw, db) of the tail backward with every product in TF32 passes."""
    p = torch.exp(mm_tf32(h, w, passes) + b - m) / torch.where(s > 0, s, torch.ones_like(s))
    g_rows = mm_tf32(p, g_marg.T, passes)
    dot = (counts.T * g_rows).sum(dim=1, keepdim=True)
    if not noop:
        dot = dot + (g_vals * vals).sum(dim=1, keepdim=True)
    g_p = mm_tf32(counts.T, g_marg, passes) - dot
    if not noop:
        g_p.scatter_add_(1, idx.long(), g_vals)
    dl = p * g_p
    return mm_tf32(dl, w.T, passes), mm_tf32(h.T, dl, passes), dl.sum(dim=0)


def _inputs(k):
    rng = np.random.default_rng(65535)
    h = rng.random((U, H), dtype=np.float32)
    w = rng.standard_normal((H, T)).astype(np.float32) * 0.3
    b = rng.standard_normal(T).astype(np.float32) * 0.1
    counts = rng.integers(0, 5, size=(L, U)).astype(np.float32)
    g_marg = rng.standard_normal((L, T)).astype(np.float32)
    g_vals = rng.standard_normal((U, k)).astype(np.float32)
    return h, w, b, counts, g_marg, g_vals


def _reference(k, noop):
    """Inputs as torch tensors, and the JAX K6's (dh, dw, db)."""
    h, w, b, counts, g_marg, g_vals = _inputs(k)
    jh, jw, jb, jc = map(jnp.asarray, (h, w, b, counts))
    vals, idx, m, s = jax_stream.hpd_stream_select(jh, jw, jb, k, interpret=True)
    ref = jax_stream.hpd_tail_unique_pallas_bwd(
        jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg), jnp.asarray(g_vals), k,
        noop_topk=noop, interpret=True,
    )
    t = lambda a: torch.from_numpy(np.array(a))
    args = tuple(map(t, (h, w, b, counts, idx, vals, m, s, g_marg, g_vals)))
    return args, [np.asarray(r, np.float64) for r in ref]


def _normwise(got, ref):
    return np.abs(got.double().numpy() - ref).max() / np.abs(ref).max()


def test_tf32_rounding_is_the_kernels():
    """hi keeps 11 significant bits, rounded to nearest with ties away from
    zero; hi + lo leaves at most 2^-21 of x."""
    x = torch.tensor([1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12, 1.0 + 3 * 2**-12, 3.0],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 1.0 + 2**-10, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - hi).abs() <= y.abs() * 2**-11).all()
    assert ((y - hi - lo).abs() <= y.abs() * 2**-21).all()


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("noop", [False, True])
def test_3xtf32_backward_within_grad_tol(k, noop):
    args, ref = _reference(k, noop)
    got = emulated_bwd(*args, noop)
    for name, a, r in zip(("dh", "dw", "db"), got, ref):
        assert _normwise(a, r) <= GRAD_TOL, (name, _normwise(a, r))


def test_one_tf32_pass_misses_grad_tol():
    """The same backward with one TF32 product per term: at least one of
    dh, dW, db is off by more than GRAD_TOL, and by far more than 3xTF32."""
    args, ref = _reference(4, False)
    one = [_normwise(a, r) for a, r in zip(emulated_bwd(*args, False, passes=1), ref)]
    three = [_normwise(a, r) for a, r in zip(emulated_bwd(*args, False, passes=3), ref)]
    assert max(one) > GRAD_TOL
    assert max(one) > 10 * max(three)
