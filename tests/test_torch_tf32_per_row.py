"""The tensor-core contract of the per-row route's kernels, emulated on the
CPU: K11 (the whole network's backward), K9 (the per-row tail's backward)
and K10 (the whole network's forward).

The head's products (the logits, dW_head = a^T dl, dh = dl W^T) run as
3xTF32, as ``ops/cuda/per_row_mma.cuh`` takes them on the tensor cores:
x = hi + lo, hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties
away from zero, PTX ``cvt.rna.tf32.f32``) by bit masking; a product is
lo_a hi_b + hi_a lo_b + hi_a hi_b, each tf32 x tf32 product exact in fp32,
summed in fp32; dh sums chains of 128 columns of T (16 k8 steps) in fp32.
K11 runs the hidden layers' dW and their dh that way too (dh's chains 64
deep, a staged chunk); its replay of the hidden stack stays fp32 on the
CUDA cores (the forward's arithmetic). The backward tests leave the tensor cores' own fp32
sums (rounded toward zero) to the card's check against the plain version
(``chip_smoke.py``, ``tests/test_torch_cuda.py``); the forward's tests
emulate them (each MMA its exact sum truncated toward zero once), since
K10's top-K rests on a bound of the tensor-core logits' error.

The backward emulations are held against the JAX package's Pallas kernels
in interpret mode (K11: ``jax.grad`` through hpd_full; K9:
hpd_tail_pallas_bwd) within GRAD_TOL = 1e-4 normwise (max |emulated - ref|
<= 1e-4 max |ref|, the card's limit in ``chip_smoke.py``). K10's candidate
refinement (top K + 4 by tensor-core logit, an fp32 recompute ranked on p
under one s, the guard, the fp32 redo of the rows it cannot settle) is held
against the JAX hpd_full forward: top-K identical on every row, with planted
exact ties, ties in p of distinct logits, near-ties at the K-th place that
only the fp32 recompute orders and near-tie clusters the guard hands to the
fp32 redo; marg and vals within FWD_TOL = 1e-5. One TF32 product per term
(a single tensor-core pass) is held to what it gives on the same inputs.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_full as jax_full
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_tail as jax_tail
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full
from collision_handling_in_instantngp_tpu_torch.ops.cuda.hpd_tail import softmax_rows
from collision_handling_in_instantngp_tpu_torch.ops.topk import topk_lowest_index

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
L, N = 2, 700
CHAIN_T = 128         # columns of T per dh chain: CHAIN = 16 k8 steps
HID_CHAIN = 64        # K11's hidden dh: contraction per chain (a staged chunk)
# the per-row route's stack, a narrow one at K = 32, a deep one at T = 512,
# and hidden widths that are not multiples of 8
SHAPES = [((2, 32, 64, 128, 256), 4), ((2, 8, 16, 128), 32), ((3, 16, 24, 40, 96, 512), 4),
          ((3, 24, 37, 203), 8)]


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


def emulated_head_bwd(a, w, b, idx, g_marg, g_vals, passes=3):
    """(dh, dW, db) of the head on its input a (L, N, H), its products in
    TF32 passes: the per-row tail's backward (K9), and K11's head (dh before
    the ReLU mask)."""
    t = w.shape[1]
    p = softmax_rows(mm_tf32(a, w, passes) + b)
    g_p = torch.zeros_like(p).scatter_(-1, idx.long(), g_vals) + (g_marg / a.shape[1])[:, None, :]
    dl = p * (g_p - (g_p * p).sum(dim=-1, keepdim=True))
    a2, dl2 = a.reshape(-1, a.shape[-1]), dl.reshape(-1, t)
    dh = torch.zeros_like(a)
    for c0 in range(0, t, CHAIN_T):
        dh = dh + mm_tf32(dl[..., c0:c0 + CHAIN_T], w[:, c0:c0 + CHAIN_T].T, passes)
    return dh, mm_tf32(a2.T, dl2, passes), dl2.sum(dim=0)


def mm_chains(a: torch.Tensor, b: torch.Tensor, passes: int, chain: int = HID_CHAIN) -> torch.Tensor:
    """a @ b in chains of ``chain`` along the contraction, each as
    mm_tf32, added in fp32 in order."""
    out = mm_tf32(a[..., :chain], b[:chain], passes)
    for k0 in range(chain, a.shape[-1], chain):
        out = out + mm_tf32(a[..., k0:k0 + chain], b[k0:k0 + chain], passes)
    return out


def emulated_bwd(verts, layers, idx, g_marg, g_vals, passes=3):
    """[(dW_i, db_i)] of K11 with the head's three products and the hidden
    layers' dW and dh in TF32 passes, the replay of the stack in fp32."""
    acts = [verts]
    for w, b in layers[:-1]:
        acts.append(torch.clamp(acts[-1] @ w + b, min=0.0))
    a = acts[-1]
    w, b = layers[-1]
    grads = [None] * len(layers)
    dh, dw, db = emulated_head_bwd(a, w, b, idx, g_marg, g_vals, passes)
    grads[-1] = (dw, db)
    d = dh * (a > 0).to(dh.dtype)
    for i in reversed(range(len(layers) - 1)):
        ai, dd = acts[i].reshape(-1, acts[i].shape[-1]), d.reshape(-1, d.shape[-1])
        grads[i] = (mm_tf32(ai.T, dd, passes), dd.sum(dim=0))
        if i > 0:
            d = mm_chains(d, layers[i][0].T, passes) * (acts[i] > 0).to(d.dtype)
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


@functools.lru_cache(maxsize=None)
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
    """K11 with its tensor-core products as 3xTF32 (the head's three and the
    hidden layers' dW and dh) against the JAX backward: every layer's dW and
    db within GRAD_TOL."""
    args, ref = _case(widths, k)
    errs = _errors(args, ref, 3)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_one_tf32_pass_misses_grad_tol():
    """The same backward with one TF32 product per term of each of those
    products, at the per-row route's stack: at least one layer's dW or db
    is off by more than GRAD_TOL, and by far more than with 3xTF32."""
    args, ref = _case(*SHAPES[0])
    one, three = _errors(args, ref, 1), _errors(args, ref, 3)
    assert max(one.values()) > GRAD_TOL, one
    assert max(one.values()) > 10 * max(three.values()), (one, three)


# the parent's answers of hpd_full.supports(widths, k) and tile_rpt(widths),
# before K11's hidden layers moved to the tensor cores (its padded tile is
# taken only where it fits beside the compact one's route)
ROUTES = [((2, 32, 64, 128, 256), 4, True, 4),       # the per-row route's stack
          ((2, 8, 16, 128), 32, True, 4),
          ((3, 16, 24, 40, 96, 512), 4, True, 2),
          ((3, 24, 37, 203), 8, True, 4),
          ((2, 256, 512, 256, 256), 4, True, 1),     # past 128 wide
          ((2, 512, 512, 2048), 4, False, 0)]        # no tile fits


@pytest.mark.parametrize("widths,k,supported,rpt", ROUTES)
def test_per_row_routes_stay(widths, k, supported, rpt):
    """Every stack K10/K11 took keeps its tile: supports stays True where it
    was and tile_rpt keeps its rows; the per-row route's stack takes the
    padded backward tile at 64 rows (232,192 of 232,448 bytes)."""
    if supported:
        assert hpd_full.supports(widths, k)
    assert hpd_full.tile_rpt(widths) == rpt
    if widths == ROUTES[0][0]:
        assert hpd_full.bwd_padded(widths)
        assert 4 * hpd_full.tile_floats(widths, 4, padded=True)[1] == 232_192


# ------------------------- K9: the per-row tail's backward -------------------------

TAIL_SHAPES = [(2, 700, 128, 256, 4), (2, 300, 100, 2048, 4), (1, 200, 37, 200, 8)]


def _tail_case(l, n, hd, t, k):
    """Torch inputs of K9 (idx from the JAX forward) and the JAX backward."""
    rng = np.random.default_rng(65535)
    h = (rng.random((l, n, hd)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((hd, t)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(t) * 0.1).astype(np.float32)
    gm = rng.standard_normal((l, t)).astype(np.float32)
    gv = rng.standard_normal((l, n, k)).astype(np.float32)
    jh, jw, jb = map(jnp.asarray, (h, w, b))
    idx = jax_tail.hpd_tail_pallas_fwd(jh, jw, jb, k, interpret=True)[2]
    ref = jax_tail.hpd_tail_pallas_bwd(jh, jw, jb, idx, jnp.asarray(gm), jnp.asarray(gv), k,
                                       interpret=True)
    t_ = lambda x: torch.from_numpy(np.array(x))
    return (t_(h), t_(w), t_(b), t_(idx), t_(gm), t_(gv)), [np.asarray(r, np.float64) for r in ref]


def _tail_errors(args, ref, passes):
    got = emulated_head_bwd(*args, passes=passes)
    return {nm: _normwise(a, r) for nm, a, r in zip(("dh", "dw", "db"), got, ref)}


@pytest.mark.parametrize("l,n,hd,t,k", TAIL_SHAPES)
def test_k9_3xtf32_within_grad_tol(l, n, hd, t, k):
    """K9's dh (no mask: the head input's own gradient), dW and db with
    the three products as 3xTF32, at H not a multiple of 32 and at T = 2048
    (the kernel's 16-row tile), against the JAX hpd_tail_pallas_bwd."""
    args, ref = _tail_case(l, n, hd, t, k)
    errs = _tail_errors(args, ref, 3)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_k9_one_tf32_pass_misses_grad_tol():
    args, ref = _tail_case(*TAIL_SHAPES[0])
    one, three = _tail_errors(args, ref, 1), _tail_errors(args, ref, 3)
    assert max(one.values()) > GRAD_TOL, one
    assert max(one.values()) > 10 * max(three.values()), (one, three)


# ---------------- K10: the forward's exact top-K by candidate refinement ----------------

def _trunc32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def logits_tc(a, w, b, passes=3):
    """head_logits: one chain of k8 steps over H; per step, in the kernel's
    order, lo_a hi_b onto the lo accumulator, hi_a hi_b onto its own, hi_a
    lo_b onto the lo one, each MMA its exact sum truncated toward zero; the
    accumulators added in fp32, then + b."""
    big = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    small = torch.zeros_like(big)
    for k0 in range(0, a.shape[1], 8):
        ak, wk = a[:, k0:k0 + 8], w[k0:k0 + 8]
        ah, wh = tf32(ak), tf32(wk)
        if passes == 3:
            small = _trunc32(small.double() + tf32(ak - ah).double() @ wh.double())
        big = _trunc32(big.double() + ah.double() @ wh.double())
        if passes == 3:
            small = _trunc32(small.double() + ah.double() @ tf32(wk - wh).double())
    return (big + small) + b


def logits_fp32_chain(a, w, b):
    """The CUDA-core logits: acc = fma(a_k, w_k, acc) over k ascending (one
    rounding each), then + b."""
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = (a[:, k:k + 1].double() * w[k].double() + acc.double()).float()
    return acc + b


def test_k10_guard_eps_bounds_the_tensor_core_logits():
    """|head_logits' logit - fp32 logit| <= eps_r (hpd_full.guard_eps) on
    every (row, column) of the per-row stack's head input, and eps_r is far
    below the logits' spread (the guard settles almost every row)."""
    verts, layers, _, _ = _inputs(*SHAPES[0])
    a, tl = _torch(verts, layers)
    for w, b in tl[:-1]:
        a = torch.clamp(a @ w + b, min=0.0)
    a = a.reshape(-1, a.shape[-1])
    w, b = tl[-1]
    diff = (logits_tc(a, w, b).double() - logits_fp32_chain(a, w, b).double()).abs()
    eps = hpd_full.guard_eps(a, w, b).double()
    assert (diff <= eps[:, None]).all() and diff.max() > 0
    assert (eps < 1e-3 * logits_fp32_chain(a, w, b).std(dim=1)).all()


def rank_on_p(ex, cols, top, s, k):
    """settle_row's ranking of one row's candidates: p = nan_to_num(exp(l -
    top) / s) under one s, the top K by (p desc, column asc)."""
    p = torch.nan_to_num(torch.exp(ex - top) / s)
    order = sorted(range(len(cols)), key=lambda c: (-p[c].item(), int(cols[c])))[:k]
    return [int(cols[c]) for c in order], [p[c].item() for c in order], order


def emulated_fwd(verts, layers, k, passes=3):
    """K10: (marg (L, T), vals, idx (L, N, K), redone (L, N) bool)."""
    a = verts
    for w, b in layers[:-1]:
        a = torch.clamp(a @ w + b, min=0.0)
    w, b = layers[-1]
    l, n, hd = a.shape
    t = w.shape[1]
    kc = min(k + hpd_full.GUARD_SLACK, t)
    a2 = a.reshape(-1, hd)
    tc = logits_tc(a2, w, b, passes)
    m_tc = tc.amax(dim=1, keepdim=True)
    e_tc = torch.exp(tc - m_tc)
    s_tc = e_tc.sum(dim=1)
    p_tc = torch.nan_to_num(e_tc / s_tc[:, None])
    marg = p_tc.reshape(l, n, t).sum(dim=1) / n
    lv, cand = topk_lowest_index(tc, kc)
    exact = logits_fp32_chain(a2, w, b)
    ex = exact.gather(1, cand)
    top = ex.amax(dim=1)
    s = torch.clamp(s_tc - torch.exp(lv - m_tc).sum(dim=1), min=0) + torch.exp(ex - top[:, None]).sum(dim=1)
    eps = hpd_full.guard_eps(a2, w, b)
    vals = torch.empty(l * n, k)
    idx = torch.empty(l * n, k, dtype=torch.int64)
    redone = torch.zeros(l * n, dtype=torch.bool)
    p_exact, i_exact = topk_lowest_index(softmax_rows(exact), k)
    for r in range(l * n):
        cols, ps, order = rank_on_p(ex[r], cand[r], top[r], s[r], k)
        gap = ex[r, order[-1]] - lv[r, -1]
        if ps[-1] >= hpd_full.P_MIN and (kc >= t or gap > 2 * eps[r] + hpd_full.GUARD_ABS):
            idx[r], vals[r] = torch.tensor(cols), torch.tensor(ps)
        else:
            idx[r], vals[r], redone[r] = i_exact[r], p_exact[r], True
    return marg, vals.reshape(l, n, k), idx.reshape(l, n, k), redone.reshape(l, n)


def _planted_network(t=256, hd=128, n=1024):
    """verts (1, N, 2) and layers [2 -> H -> T] with (K = 4):
    - h_0 = 1 on every row; h_1 = verts[..., 1], 1 on every 8th row, else 0;
      h_2 = 0.2 + 0.8 v, h_3 = 1 - 0.8 v, v = verts[..., 0] outside
      [0.375, 0.625);
    - head columns 30 and 70 identical (w and b): an exact tie at the top,
      150 next (the same column, b 0.1 lower);
    - columns 120 and 45, 4th and 5th on every row: identical but for
      w[2, 45] = 2e-5, w[3, 45] = -2e-5: they differ by 2e-5 (h_2 - h_3),
      4e-6 to 1.6e-5 (far below the guard's eps, far above fp32 rounding),
      in either order;
    - on the rows where h_1 = 1, 8 columns above all others, within 1.4e-4
      (bias steps of 2e-5): the K-th and the 8th candidate are closer than
      2 eps, so the guard hands these rows to the fp32 redo."""
    rng = np.random.default_rng(65535)
    v = rng.uniform(0.0, 0.75, size=n)
    v = np.where(v < 0.375, v, v + 0.25).astype(np.float32)
    lift = (np.arange(n) % 8 == 0).astype(np.float32)
    verts = np.stack([v, lift], axis=-1)[None]
    w0 = (rng.standard_normal((2, hd)) * 0.5).astype(np.float32)
    b0 = (rng.standard_normal(hd) * 0.3).astype(np.float32)
    w0[:, :4] = [[0, 0, 0.8, -0.8], [0, 1, 0, 0]]
    b0[:4] = [1, 0, 0.2, 1]
    w = (rng.standard_normal((hd, t)) * 0.05).astype(np.float32)
    w[:4] = 0.0
    b = (rng.standard_normal(t) * 0.05).astype(np.float32)
    base = w[:, 30].copy()
    for col, bias in ((30, 3.0), (70, 3.0), (150, 2.9), (120, 2.0), (45, 2.0)):
        w[:, col] = base
        b[col] = bias
    w[2, 45], w[3, 45] = 2e-5, -2e-5
    cluster = [200, 6, 99, 123, 77, 160, 41, 101]
    for j, col in enumerate(cluster):
        w[:, col] = base
        w[1, col] = 10.0
        b[col] = (j * 37 % 8) * 2e-5
    return verts, [(w0, b0), (w, b)], lift.astype(bool), cluster


def _p_tie_network(t=256, n=300):
    """Every row's head input is 0 (ReLU of a bias of -100), so the logits
    are b: b[37] = -2^-26 and b[251] = 0 give one p (exp(-2^-26) rounds to
    1), the rest lie 0.01 apart below -1. Ranked on p, column 37 comes
    first; ranked on the logit, 251 would."""
    rng = np.random.default_rng(7)
    verts = rng.integers(0, 9, size=(2, n, 2)).astype(np.float32)
    w0 = rng.random((2, 16)).astype(np.float32)
    b0 = np.full(16, -100.0, np.float32)
    w = rng.standard_normal((16, t)).astype(np.float32)
    b = (-1.0 - 0.01 * rng.permutation(t)).astype(np.float32)
    b[37], b[251] = -(2.0 ** -26), 0.0
    return verts, [(w0, b0), (w, b)]


def _jax_fwd(verts, layers, k):
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    return [np.asarray(x) for x in jax_full.hpd_full(jnp.asarray(verts), jl, k, True)]


def _torch(verts, layers):
    t = lambda x: torch.from_numpy(np.array(x))
    return t(verts), [(t(w), t(b)) for w, b in layers]


def test_k10_refinement_matches_jax_on_planted_ties():
    verts, layers, lifted, cluster = _planted_network()
    marg_ref, vals_ref, idx_ref = _jax_fwd(verts, layers, 4)
    marg, vals, idx, redone = emulated_fwd(*_torch(verts, layers), 4)
    # the guard: every lifted row goes to the fp32 redo, every other row is
    # settled by the recompute
    assert redone.numpy()[0, lifted].all() and not redone.numpy()[0, ~lifted].any()
    # the planted structure is as described: the exact tie first, both
    # orders of the near tie, the cluster's top 4 on the lifted rows
    rest = idx_ref[0, ~lifted]
    assert (rest[:, :3] == [30, 70, 150]).all()
    assert set(rest[:, 3]) == {120, 45}
    assert set(idx_ref[0, lifted].ravel()) <= set(cluster)
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    assert _normwise(marg, marg_ref.astype(np.float64)) <= FWD_TOL
    assert _normwise(vals, vals_ref.astype(np.float64)) <= FWD_TOL


def test_k10_refinement_ranks_on_p():
    """Distinct logits with one p: the settled rows rank them as the JAX
    kernel does, the lower column first (no row needs the redo)."""
    verts, layers = _p_tie_network()
    _, _, idx_ref = _jax_fwd(verts, layers, 2)
    _, _, idx, redone = emulated_fwd(*_torch(verts, layers), 2)
    assert (idx_ref[..., 0] == 37).all() and (idx_ref[..., 1] == 251).all()
    assert not redone.any()
    np.testing.assert_array_equal(idx.numpy(), idx_ref)


@pytest.mark.parametrize("widths,k", [((2, 32, 64, 128, 256), 4), ((3, 16, 24, 40, 96, 512), 8)])
def test_k10_refinement_matches_jax_on_random_stacks(widths, k):
    verts, layers, _, _ = _inputs(widths, k)
    marg_ref, vals_ref, idx_ref = _jax_fwd(verts, layers, k)
    marg, vals, idx, redone = emulated_fwd(*_torch(verts, layers), k)
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    assert _normwise(marg, marg_ref.astype(np.float64)) <= FWD_TOL
    assert _normwise(vals, vals_ref.astype(np.float64)) <= FWD_TOL
    assert redone.float().mean() < 0.01


def test_k10_one_tf32_pass_misses_fwd_tol():
    """K10's marg from one TF32 product per logit term misses FWD_TOL, by
    far more than 3xTF32."""
    verts, layers, _, _ = _inputs(*SHAPES[0])
    marg_ref = _jax_fwd(verts, layers, 4)[0].astype(np.float64)
    tv, tl = _torch(verts, layers)
    one = _normwise(emulated_fwd(tv, tl, 4, passes=1)[0], marg_ref)
    three = _normwise(emulated_fwd(tv, tl, 4, passes=3)[0], marg_ref)
    assert three <= FWD_TOL and one > FWD_TOL and one > 10 * three, (one, three)


def test_k10_ranking_residual_case():
    """The one difference the kernel comments name: two candidates whose e
    are one ulp apart divide to one p under one s and to two under another
    (the kernel's s comes from tensor-core terms), so they swap places: the
    lower column first on a tie, the larger e first otherwise."""
    ex = torch.tensor([-(2.0 ** -24), 0.0])    # column 5's e = 1 - 2^-24, column 9's 1
    cols = torch.tensor([5, 9])
    e = torch.exp(ex)
    assert e[0] == torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)) and e[1] == 1
    # an s under which the two quotients round to one p, and one under which not
    ss = [torch.tensor(3.0 + j * 2.0 ** -20) for j in range(64)]
    tie = [s for s in ss if e[0] / s == e[1] / s]
    split = [s for s in ss if e[0] / s != e[1] / s]
    assert tie and split
    assert rank_on_p(ex, cols, 0.0, tie[0], 2)[0] == [5, 9]
    assert rank_on_p(ex, cols, 0.0, split[0], 2)[0] == [9, 5]
    # with the plain version's own s the ranking is topk_lowest_index's on p
    for s in (tie[0], split[0]):
        p = torch.nan_to_num(e / s)
        assert [int(cols[i]) for i in topk_lowest_index(p, 2)[1]] == rank_on_p(ex, cols, 0.0, s, 2)[0]


def test_k10_guard_constants_match_the_header():
    """The CPU emulation's guard (hpd_full: GUARD_SLACK, GUARD_ABS, P_MIN,
    guard_coef) is the kernel's: the constants and guard_coef's expression
    as ``ops/cuda/per_row_mma.cuh`` states them, and settle_row's test
    written in those names."""
    import os
    import re

    path = os.path.join(os.path.dirname(hpd_full.__file__), "per_row_mma.cuh")
    with open(path) as f:
        src = f.read()
    hexf = r"(0x[0-9a-fA-F.]+p[-+]?\d+)f"
    assert int(re.search(r"constexpr int GSLACK = (\d+);", src).group(1)) == hpd_full.GUARD_SLACK
    assert float.fromhex(re.search(r"constexpr float GUARD_ABS = " + hexf, src).group(1)) == hpd_full.GUARD_ABS
    assert float.fromhex(re.search(r"constexpr float P_MIN = " + hexf, src).group(1)) == hpd_full.P_MIN
    assert "p_last >= P_MIN && (all || ex[last] - lv_last > 2.f * eps + GUARD_ABS)" in src
    body = re.search(r"float guard_coef\(int H\) \{\s*const int nk = \(H \+ 7\) / 8;\s*return ([^;]+);\s*\}", src)
    assert body, "guard_coef's form changed: restate it in hpd_full.guard_coef and here"
    expr = re.sub(hexf, lambda m: repr(float.fromhex(m.group(1))), body.group(1))
    expr = re.sub(r"(\d+\.\d*|\.\d+)f\b", r"\1", expr)
    for hd in range(1, 129):
        want = eval(expr, {}, {"H": hd, "nk": (hd + 7) // 8})
        assert hpd_full.guard_coef(hd) == pytest.approx(want, rel=1e-6), hd
