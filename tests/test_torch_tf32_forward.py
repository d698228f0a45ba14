"""The tensor-core contract of the forward passes (K1, K4, K5; K7 shares
the rows pass's tiling) at 'highest', emulated on the CPU.

The kernels of ``ops/cuda/hpd_stream.cu`` take every forward product as
3xTF32 on the tensor cores: x = hi + lo, hi = tf32(x), lo = tf32(x - hi),
rounded to nearest (ties away from zero); a product is lo_a hi_b + hi_a lo_b
+ hi_a hi_b. Chains hold at most 4 k8 steps from zeroed accumulators, the
products with a lo operand in one, hi_a hi_b in another, added in fp32 at
the chain's end; chains are added in fp32; the logits split their 128-deep
contraction between two warpgroups (two chains each, the halves added
last). Past H = 128 the contraction runs in 128-deep chunks (zero past H in
the last): each warpgroup adds its two chains of every chunk to its running
sum, chunk by chunk, and the halves meet after the last. The columns pass
then sums marg^T = p^T counts^T per 64-row tile,
one chain per warpgroup (rows 0-31 and 32-63 of the tile), the two
warpgroups' sums added at the end of a row segment and the 8 segments in
order.

The rows pass selects the top K of the fp32 logits (one fma chain over k
ascending, then + b, the CUDA-core kernel's arithmetic) from tensor-core
logits: the top K + 4 candidates by tensor-core value are recomputed in
fp32, and a row whose K-th recomputed logit does not exceed its (K + 4)-th
tensor-core logit by more than 2 eps_r (``hpd_stream.select_guard_eps``)
goes to the exact fp32 sweep. Here each MMA is emulated as its exact sum
truncated toward zero once (the tensor cores' fp32 accumulation rounds
toward zero), and the fp32 chain as one rounding per fma.

Held against the JAX package's K5 and K4 (the Pallas kernels in interpret
mode): marg within the card's FWD_TOL = 1e-5 normwise (one TF32 pass
misses it), and top-K indices equal on every row, with planted exact ties
(lowest index first), near-ties at the K-th place that only the fp32
recompute orders, and near-tie clusters that the guard hands to the fix-up.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream
from collision_handling_in_instantngp_tpu_torch.ops.topk import topk_lowest_index

FWD_TOL = 1e-5
H, T, K = 128, 2048, 4
CHAIN = 32            # columns of a chain: 4 k8 steps
CHUNK = hpd_stream.CHUNK_H   # depth of a chunk of the contraction
SEGS, TILE = 8, 64    # row segments and row tile of the columns pass
WIDE_HS = (136, 256, 640)    # heads of 2, 2 and 5 chunks (136: 8 columns in the last)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32, ties away from zero (the kernels'
    to_tf32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _parts(a, b, passes):
    """The (A, B) operand pairs of a product, in the kernels' order."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return [(a_hi, b_hi)]
    return [(tf32(a - a_hi), b_hi), (a_hi, tf32(b - b_hi)), (a_hi, b_hi)]


def chain_fp32(a, b, passes=3):
    """One chain of a @ b (a's columns <= CHAIN): hi_a hi_b summed in fp32
    from zero, plus (at 3 passes) the lo products' own sum."""
    parts = _parts(a, b, passes)
    big = parts[-1][0] @ parts[-1][1]
    if passes == 1:
        return big
    return big + (parts[0][0] @ parts[0][1] + parts[1][0] @ parts[1][1])


def trunc32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def chain_truncating(a, b):
    """One chain of a @ b at 3xTF32, each MMA (one k8 step of one of the three
    products) its exact sum added to its accumulator (the lo products', or
    hi_a hi_b's) and truncated toward zero; the two added in fp32 at the end."""
    big = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    small = torch.zeros_like(big)
    for k0 in range(0, a.shape[1], 8):
        (l1, h1), (l2, h2), (x, y) = _parts(a[:, k0:k0 + 8], b[k0:k0 + 8], 3)
        small = trunc32(small.double() + l1.double() @ h1.double())
        small = trunc32(small.double() + l2.double() @ h2.double())
        big = trunc32(big.double() + x.double() @ y.double())
    return big + small


def logits_tc(h, w, b, chain=chain_fp32, **kw):
    """h w + b as the kernels take the logits: H in CHUNK-deep chunks, zero
    past H (one chunk at H <= 128); warpgroup wg sums columns 64 wg + [0, 64)
    of every chunk in chains added in fp32 to its running sum, chunk by
    chunk; then the halves, then b. A chain over zero columns adds an exact
    0, as the kernels' shorter chains at the end of H do."""
    pad = -h.shape[1] % CHUNK
    h = torch.nn.functional.pad(h, (0, pad))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    sums = [torch.zeros(h.shape[0], w.shape[1]) for _ in range(2)]
    for c0 in range(0, h.shape[1], CHUNK):
        for wg in range(2):
            for k0 in range(c0 + CHUNK // 2 * wg, c0 + CHUNK // 2 * (wg + 1), CHAIN):
                sums[wg] = sums[wg] + chain(h[:, k0:k0 + CHAIN], w[k0:k0 + CHAIN], **kw)
    return (sums[0] + sums[1]) + b


def logits_fp32_chain(h, w, b):
    """The fp32 logits of the CUDA-core sweep: acc = fma(h_k, w_k, acc) over
    k ascending (one rounding each), then + b."""
    acc = torch.zeros(h.shape[0], w.shape[1], dtype=torch.float32)
    for k in range(h.shape[1]):
        acc = (h[:, k:k + 1].double() * w[k].double() + acc.double()).float()
    return acc + b


def emulated_marginal(h, w, b, counts, m, s, passes=3):
    """marg (L, T) of the columns pass: p per row, then per 64-row tile one
    chain per warpgroup, the warpgroups' running sums added at the end of
    each row segment, the segments in order."""
    p = torch.exp(logits_tc(h, w, b, passes=passes) - m) * (1 / s)
    u = h.shape[0]
    seg_rows = -(-(-(-u // TILE)) // SEGS) * TILE
    marg = torch.zeros(counts.shape[0], w.shape[1])
    for r_seg in range(0, u, seg_rows):
        acc = [torch.zeros_like(marg), torch.zeros_like(marg)]
        for r0 in range(r_seg, min(u, r_seg + seg_rows), TILE):
            for wg in range(2):
                rows = slice(r0 + 32 * wg, min(u, r_seg + seg_rows, r0 + 32 * wg + 32))
                if rows.start < rows.stop:
                    # marg^T = p^T (A) counts^T (B)
                    acc[wg] = acc[wg] + chain_fp32(p[rows].T, counts[:, rows].T, passes).T
        marg = marg + (acc[0] + acc[1])
    return marg


def _normwise(got, ref):
    return np.abs(got.double().numpy() - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.from_numpy(np.array(a))


def _columns_case(hd, u, t, seed):
    """marg of the emulated columns pass at 3 and 1 TF32 passes, each
    normwise against JAX K5 (interpret mode) on JAX K4's m and s; w scaled
    by sqrt(128 / hd), so that the logits spread as at H = 128."""
    rng = np.random.default_rng(seed)
    l = 16
    h = rng.random((u, hd), dtype=np.float32) * 0.5
    w = rng.standard_normal((hd, t)).astype(np.float32) * np.float32(0.1 * (H / hd) ** 0.5)
    b = rng.standard_normal(t).astype(np.float32) * 0.1
    counts = rng.integers(0, 8, size=(l, u)).astype(np.float32)
    jh, jw, jb = map(jnp.asarray, (h, w, b))
    _, _, m, s = jax_stream.hpd_stream_select(jh, jw, jb, K, interpret=True)
    ref = np.asarray(jax_stream.hpd_stream_marginal(jh, jw, jb, jnp.asarray(counts), m, s,
                                                    interpret=True), np.float64)
    args = tuple(map(_t, (h, w, b, counts, m, s)))
    return (_normwise(emulated_marginal(*args, passes=3), ref),
            _normwise(emulated_marginal(*args, passes=1), ref))


def test_columns_pass_within_fwd_tol_of_jax_k5():
    three, one = _columns_case(H, 1500, T, 65535)
    assert three <= FWD_TOL, three
    assert one > FWD_TOL and one > 10 * three, (one, three)


@pytest.mark.parametrize("hd", WIDE_HS)
def test_chunked_columns_pass_within_fwd_tol_of_jax_k5(hd):
    """Past H = 128: marg of the chunked 3xTF32 logits within FWD_TOL of JAX
    K5 (a few hundred rows); one TF32 pass misses it."""
    three, one = _columns_case(hd, 300, T, hd)
    assert three <= FWD_TOL, three
    assert one > FWD_TOL and one > 10 * three, (one, three)


def _guard_case(hd, u, t, seed):
    rng = np.random.default_rng(seed)
    h = _t(rng.random((u, hd), dtype=np.float32))
    w = _t(rng.standard_normal((hd, t)).astype(np.float32) * np.float32(0.1 * (H / hd) ** 0.5))
    b = _t(rng.standard_normal(t).astype(np.float32) * 0.1)
    tc = logits_tc(h, w, b, chain=chain_truncating)
    exact = logits_fp32_chain(h, w, b)
    eps = hpd_stream.select_guard_eps(h, w, b)
    diff = (tc.double() - exact.double()).abs()
    assert (diff <= eps.double()[:, None]).all()
    assert diff.max() > 0
    return exact, eps


def test_guard_eps_bounds_the_tensor_core_logits():
    """|tensor-core logit - fp32 logit| <= eps_r on every (row, column) of
    seeded random h, w, b at H = 128, and eps_r is far below the logits'
    spread (the guard passes almost every row)."""
    exact, eps = _guard_case(H, 512, T, 7)
    assert (eps < 1e-3 * exact.std(dim=1)).all()


@pytest.mark.parametrize("hd", WIDE_HS)
def test_chunked_guard_eps_bounds_the_tensor_core_logits(hd):
    """The same past H = 128, on the chunked logits (each MMA truncating),
    with the guard re-derived for nc chunks; eps_r grows with H (S_r and
    the fp32 chain's fmas), but the guard still settles every row of this
    data: its K-th fp32 logit exceeds its (K + 4)-th by more than 2 eps_r."""
    exact, eps = _guard_case(hd, 256, 1024, 7 + hd)
    top = exact.topk(K + hpd_stream.GUARD_SLACK, dim=1).values
    assert (top[:, K - 1] - top[:, -1] > 2 * eps).all()


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_guard_eps_of_one_chunk_is_unchanged(precision):
    """select_guard_eps is (n_f / 16 + 16) 2^-20 S_r bit for bit at H <= 128
    (one chunk), and adds (nc - 1) / 2 to the coefficient at nc chunks."""
    rng = np.random.default_rng(11)
    mult = 3 if precision == "high" else 1
    for hd in (8, 100, 128, 129, 256, 640, 1000):
        h = _t(rng.random((64, hd), dtype=np.float32))
        w = _t(rng.standard_normal((hd, 256)).astype(np.float32))
        b = _t(rng.standard_normal(256).astype(np.float32))
        s = h.abs() @ w.abs().amax(dim=1) + b.abs().max()
        nc = -(-hd // 128)
        coef = mult * hd / 16 + 16 if nc == 1 else mult * hd / 16 + 16 + (nc - 1) / 2
        assert torch.equal(hpd_stream.select_guard_eps(h, w, b, precision), coef * 2.0**-20 * s), hd


def _planted_inputs(hd=H, u=1024, gap=2e-5):
    """h, w, b with planted ties (K, T = 4, 2048; w scaled by sqrt(128 /
    hd), so that the logits spread as at H = 128):
    - columns 300 and 700 identical (w and b): an exact tie at the top,
      1500 next (the same column, b 0.1 lower);
    - columns 1200 and 450, 4th and 5th on every row: identical but for
      w[2, 450] = gap, with h[:, 2] = +-[0.2, 1]: they differ by 0.2 gap
      to gap (far below the guard's eps, far above fp32 rounding, which
      grows with H), in either order;
    - on the rows of SET (every 8th), feature 1 lifts 8 columns above all
      others, all within 1.4e-4 (bias steps of 2e-5): the K-th and the 8th
      candidate are closer than 2 eps, so the guard hands these rows to the
      fix-up."""
    rng = np.random.default_rng(65535)
    h = rng.random((u, hd), dtype=np.float32) * 0.5
    h[:, 0] = 1.0
    h[:, 1] = 0.0
    h[::8, 1] = 1.0
    h[:, 2] = (rng.choice([-1.0, 1.0], size=u) * rng.uniform(0.2, 1.0, size=u)).astype(np.float32)
    w = rng.standard_normal((hd, T)).astype(np.float32) * np.float32(0.05 * (H / hd) ** 0.5)
    w[0:3] = 0.0
    b = rng.standard_normal(T).astype(np.float32) * 0.05
    base = w[:, 300].copy()
    for col, bias in ((300, 3.0), (700, 3.0), (1500, 2.9), (1200, 2.0), (450, 2.0)):
        w[:, col] = base
        b[col] = bias
    w[2, 450] = gap
    cluster = [1800, 60, 999, 1234, 77, 1600, 401, 1001]
    for j, col in enumerate(cluster):
        w[:, col] = base
        w[1, col] = 10.0
        b[col] = (j * 37 % 8) * 2e-5
    return h, w, b, cluster


def emulated_select(h, w, b, k):
    """The rows pass's top-K: (idx (U, K), candidates (U, K + 4), fixed (U,)
    bool: the rows the guard hands to the exact fp32 sweep)."""
    kc = k + hpd_stream.GUARD_SLACK
    tc = logits_tc(h, w, b, chain=chain_truncating)
    exact = logits_fp32_chain(h, w, b)
    tc_vals, cand = topk_lowest_index(tc, kc)
    ex = exact.gather(1, cand)
    # the candidates by (fp32 value desc, index asc)
    idx = torch.empty(h.shape[0], k, dtype=torch.int64)
    e_k = torch.empty(h.shape[0])
    for r in range(h.shape[0]):
        order = sorted(range(kc), key=lambda c: (-ex[r, c].item(), cand[r, c].item()))[:k]
        idx[r] = cand[r, order]
        e_k[r] = ex[r, order[-1]]
    fixed = ~(e_k - tc_vals[:, -1] > 2 * hpd_stream.select_guard_eps(h, w, b))
    _, exact_idx = topk_lowest_index(exact, k)
    return torch.where(fixed[:, None], exact_idx, idx), cand, fixed


def test_rows_pass_refinement_matches_jax_k4_on_planted_ties():
    _planted_case(*_planted_inputs())


@pytest.mark.parametrize("hd", WIDE_HS)
def test_chunked_refinement_matches_jax_k4_on_planted_ties(hd):
    """Past H = 128, on the chunked logits and the guard re-derived for nc
    chunks: the same ties, near-ties 2e-5 to 1e-4 apart (fp32 rounding
    differences between summation orders reach a few 1e-6 at 640 terms)."""
    _planted_case(*_planted_inputs(hd, 512, 1e-4))


def _planted_case(h, w, b, cluster):
    ref_idx = np.asarray(jax_stream.hpd_stream_select(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), K, interpret=True)[1])
    th, tw, tb = _t(h), _t(w), _t(b)
    idx, cand, fixed = emulated_select(th, tw, tb, K)
    lifted = np.zeros(h.shape[0], bool)
    lifted[::8] = True
    # the guard: every lifted row goes to the fix-up, every other row is
    # settled by the recompute, with both near-tied columns among its candidates
    assert fixed.numpy()[lifted].all() and not fixed.numpy()[~lifted].any()
    for col in (1200, 450):
        assert (cand[~torch.from_numpy(lifted)] == col).any(dim=1).all()
    # the planted structure is as described: exact tie first, both orders of
    # the near tie occur, the cluster's top 4 on the lifted rows
    assert (ref_idx[~lifted, :2] == [300, 700]).all()
    fourth = ref_idx[~lifted, 3]
    assert set(fourth) == {1200, 450}
    assert set(ref_idx[lifted].ravel()) <= set(cluster)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    # and the port's plain version agrees
    np.testing.assert_array_equal(hpd_stream.hpd_stream_select_plain(th, tw, tb, K, "highest")[1].numpy(),
                                  ref_idx)
