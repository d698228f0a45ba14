"""The last width faults of ROADMAP §3.1 on the CPU, against the JAX package
on the same numpy inputs: heads wider than 512 on the streamed tail (K1,
K2, K4-K6) and on the per-row tail (K8/K9), and the per-row stacks whose
row tile K10/K11 cannot hold, which "auto" now sends to a plain hidden
stack and K8/K9 (the JAX package runs them through ``hpd_full``).

Each kernel's plain version (what its wrapper runs for a CPU tensor) is
held against the JAX Pallas kernel in interpret mode. Tolerances, normwise
(max |port - JAX| <= tol * max |JAX|; fp32 both sides, the summation order
differs): forward 1e-5, gradients 1e-4, top-K indices exactly equal. The
gate that routes the stacks restates the C plan of ``hpd_full.cu``; its
constants are held to the headers here, the plan itself to the kernels'
own ``hpd_full_blocks`` in ``tests/test_torch_cuda.py``.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_full as jax_full
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_tail as jax_tail
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.models import hpd as port_hpd
from collision_handling_in_instantngp_tpu_torch.models.mlp import MLP
from collision_handling_in_instantngp_tpu_torch.ops import fused_hpd
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full, hpd_stream, hpd_tail

CUDA = pathlib.Path(hpd_full.__file__).parent
FWD, GRAD = 1e-5, 1e-4
DEEP = (2, 512, 512, 512, 512, 2048)     # four hidden layers of 512 at T = 2048
WIDE_H = 640


def _t(a):
    return torch.from_numpy(np.array(a))


def _normwise(got, ref, tol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err} > {tol} * {np.abs(ref).max()}"


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_tile_plan_constants_match_the_headers():
    """hpd_tail.py's copies of the shared-memory plan (which hpd_full.py's
    gate also reads): per_row.cuh's constants, per_row_mma.cuh's staged
    head (Grid) and row stride, hpd_tail.cu's backward tile."""
    per_row = (CUDA / "per_row.cuh").read_text()
    for name in ("THREADS", "BK", "TT", "WMAX", "SMEM_MAX"):
        assert _constant(per_row, name) == getattr(hpd_tail, name), name
    assert "constexpr int BS = TT + 1;" in per_row
    mma = (CUDA / "per_row_mma.cuh").read_text()
    for line in ("static constexpr int KL = RPT >= 4 ? 64 : 16;",
                 "static constexpr int KD = RPT >= 4 ? 64 : 32;",
                 "static constexpr int NBUF = RPT >= 4 ? 2 : 1;",
                 "static constexpr int LDL = CB + 8;", "static constexpr int LDD = KD + 4;",
                 "static constexpr int MT = RPT >= 2 ? 2 : 1;",
                 "return round32(w) + 4;"):
        assert line in mma, line
    assert [hpd_tail.head_stage_floats(r) for r in (1, 2, 4)] == [4608, 4608, 17408]
    tail = (CUDA / "hpd_tail.cu").read_text()
    assert ("return sizeof(float) * ((size_t)R * mma_ld(H) + head_stage_floats(R / 16) +\n"
            "                          (size_t)R * mma_ld(T) + T);") in tail


def test_chunked_backward_plan_matches_the_source():
    """The streamed backward's plan (K2, K6) restated from the shapes and
    held to hpd_stream.cu and stream_tile.cuh: the tile constants, the
    shared-memory sums of the row kernels and the columns kernel (one
    128-deep chunk of h, w, dh and dW whatever H: 225,536 and 216,832 of a
    block's 232,448 bytes, one 8-warp block per SM), the chunks on the
    launch grid, and MAX_H, where the chunks fill grid.y / grid.z's
    65,535."""
    src = (CUDA / "hpd_stream.cu").read_text()
    tile = (CUDA / "stream_tile.cuh").read_text()
    r, hmax = _constant(tile, "R"), _constant(tile, "HMAX")
    bt, lp, hitw, kmax, lmax = (_constant(src, n) for n in ("BT", "LP", "HITW", "KMAX", "LMAX"))
    assert (r, hmax, bt, lp, hitw, _constant(src, "SEGS")) == (64, 128, 64, 32, 512, 8)
    assert (hmax, kmax, lmax) == (hpd_stream.CHUNK_H, hpd_stream.MAX_K, hpd_stream.MAX_L)
    for line in ("constexpr int BWD_SMEM_ROWS = 2 * R * HMAX + 2 * R * BT + 2 * R * LP + 4 * LP * BT +\n"
                 "                              2 * HMAX * BT + 2 * BT + 2 * R * KMAX + 3 * R + HITW;",
                 "constexpr int COLS_STAGE = R * HMAX + R * LMAX + 2 * R * KMAX + 3 * R;",
                 "constexpr int BWD_SMEM_COLS =\n"
                 "    2 * BT * HMAX + 2 * BT * LP + 2 * BT * R + BT + 4 * BT + 2 * COLS_STAGE;",
                 "size_t bwd_rows_smem() { return sizeof(float) * BWD_SMEM_ROWS + 1024; }",
                 "size_t bwd_cols_smem() { return sizeof(float) * BWD_SMEM_COLS + 1024; }",
                 "int h_chunks(int H) { return (H + HMAX - 1) / HMAX; }",
                 "constexpr int HWIDE = 65535 * HMAX;",
                 "const dim3 rows_grid((u + R - 1) / R, h_chunks(H));",
                 "const dim3 rows_grid(row_blocks, part == 1 ? 1 : h_chunks(H));",
                 "const dim3 cols_grid(T / BT, SEGS, h_chunks(H));"):
        assert line in src, line
    rows = (2 * r * hmax + 2 * r * bt + 2 * r * lp + 4 * lp * bt + 2 * hmax * bt + 2 * bt
            + 2 * r * kmax + 3 * r + hitw)
    cols = (2 * bt * hmax + 2 * bt * lp + 2 * bt * r + bt + 4 * bt
            + 2 * (r * hmax + r * lmax + 2 * r * kmax + 3 * r))
    assert (4 * rows + 1024, 4 * cols + 1024) == (225_536, 216_832)
    assert max(4 * rows, 4 * cols) + 1024 <= 232_448
    # the fp32 chunk of h (rows) / w (columns) is staged in dl's / dl^T's two tiles
    assert r * hmax == 2 * r * bt and hmax * bt == 2 * bt * r
    chunks = lambda h: -(-h // hmax)
    assert [chunks(h) for h in (37, 128, 129, 136, 200, 256, 384, 640, 1000)] == \
        [1, 1, 2, 2, 2, 2, 3, 5, 8]
    assert chunks(hpd_stream.MAX_H) == 65535 and hpd_stream.MAX_H == 65535 * 128
    # the forward takes every H the backward does: no head that trains raises
    hpd_stream._check_inputs(torch.zeros(4, 1000), torch.zeros(1000, 2048), torch.zeros(2048),
                             torch.zeros(2, 4), 4)


@pytest.mark.parametrize("widths,rpt", [((2, 32, 64, 128, 256), 4), ((2, 256, 512, 256, 256), 1),
                                        ((2, 128, 128), 4), (DEEP, 0), ((2, 512, 512, 2048), 0),
                                        ((2, 512, 2048), 1), ((2, 512, 512, 512, 512, 256), 1)])
def test_full_tile_plan(widths, rpt):
    """The plan's row tile by stack: the per-row route's default at 64
    rows, the wide stack at 16, and the deep stack in none (its 16-row
    backward tile needs 322,496 bytes of 232,448)."""
    assert hpd_full.tile_rpt(widths) == rpt
    assert hpd_full.supports(widths, 4) == (rpt > 0)
    if widths == DEEP:
        assert hpd_full.tile_floats(widths, 1)[1] * 4 == 322_496


def test_tail_backward_limit_figures():
    """K9's tile holds all of h: H <= 1,152 at T = 2048, 3,040 at T = 256;
    the forward (K8) takes any H."""
    assert hpd_tail.bwd_max_h(2048) == 1152 and hpd_tail.bwd_max_h(256) == 3040
    h = torch.zeros(1, 4, 1153)
    hpd_tail.check_inputs(h, torch.zeros(1153, 2048), torch.zeros(2048), 4)
    with pytest.raises(ValueError, match="H <= 1152 at T=2048"):
        hpd_tail.check_inputs(h, torch.zeros(1153, 2048), torch.zeros(2048), 4, bwd=True)
    hpd_tail.check_inputs(torch.zeros(1, 4, 1152), torch.zeros(1152, 2048), torch.zeros(2048), 4,
                          bwd=True)


@pytest.mark.parametrize("hidden,t,k,backend,want", [
    ((32, 64, 128), 256, 4, "auto", "pallas_full"),
    ((512,) * 4, 2048, 4, "auto", "pallas"),
    ((512,) * 4, 2048, 4, "pallas_full", "pallas"),
    ((512,) * 4, 256, 4, "auto", "pallas_full"),
    ((512,) * 4, 2048, 33, "auto", "jax"),
    ((1200,), 2048, 4, "auto", "pallas"),
    ((1200,), 2048, 4, "pallas_full", "pallas"),
    ((1200,), 256, 4, "pallas_full", "pallas"),
])
def test_fused_backend_gate(hidden, t, k, backend, want):
    """"auto" and "pallas_full" take K10/K11 only where their tile fits the
    stack, else K8/K9; a head past K9's tile (1,200 at T = 2048) is never
    sent to a plain version: K9's shape check raises on it, naming the
    limit."""
    cfg = tcfg.ModelConfig(hpd_hidden=hidden, hash_table_size=t, topk_k=k, hpd_backend=backend)
    assert port_hpd.fused_backend(cfg) == want
    hd = hidden[-1]
    args = (torch.zeros(1, 4, hd), torch.zeros(hd, t), torch.zeros(t), k)
    if hd > hpd_tail.bwd_max_h(t):
        with pytest.raises(ValueError, match=f"H <= {hpd_tail.bwd_max_h(t)} at T={t}"):
            hpd_tail.check_inputs(*args, bwd=True)
    else:
        hpd_tail.check_inputs(*args, bwd=True)


def test_auto_routes_overflowing_stack_like_jax(monkeypatch):
    """[2 -> 512 -> 512 -> 512 -> 512 -> 2048], K = 4 through
    apply_hpd_fused "auto": the plain stack and K8/K9's plain versions,
    against the JAX package's hpd_full (interpret): top-K identical,
    marginal and values 1e-5, every layer's gradients 1e-4."""
    k = 4
    cfg = tcfg.ModelConfig(hpd_hidden=DEEP[1:-1], hash_table_size=DEEP[-1], topk_k=k)
    calls = []
    real = fused_hpd.hpd_tail_fwd
    monkeypatch.setattr(fused_hpd, "hpd_tail_fwd", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(12)
    torch.manual_seed(12)
    net = MLP(DEEP)
    p_, l_, v_ = 24, 2, 4
    verts = rng.integers(0, 33, size=(p_, l_, v_, 2)).astype(np.float32)
    gm = rng.standard_normal((l_, DEEP[-1])).astype(np.float32)
    gv = rng.standard_normal((p_, l_, v_, k)).astype(np.float32)
    marg, vals, idx = port_hpd.apply_hpd_fused(net, _t(verts), cfg)
    assert calls == [1]
    (torch.sum(marg * _t(gm)) + torch.sum(vals * _t(gv))).backward()

    rows = np.transpose(verts, (1, 0, 2, 3)).reshape(l_, p_ * v_, 2)
    jl = tuple((jnp.asarray(w.detach().numpy()), jnp.asarray(b.detach().numpy()))
               for w, b in net.layers())
    gv_rows = np.transpose(gv, (1, 0, 2, 3)).reshape(l_, p_ * v_, k)
    ref = jax_full.hpd_full(jnp.asarray(rows), jl, k, True)
    ref_g = jax.grad(lambda ls: (lambda o: jnp.sum(o[0] * gm) + jnp.sum(o[1] * gv_rows))(
        jax_full.hpd_full(jnp.asarray(rows), ls, k, True)))(jl)
    to_rows = lambda a: np.transpose(a.detach().numpy(), (1, 0, 2, 3)).reshape(l_, p_ * v_, k)
    np.testing.assert_array_equal(to_rows(idx), np.asarray(ref[2]))
    _normwise(marg.detach().numpy(), ref[0], FWD, "marg")
    _normwise(to_rows(vals), ref[1], FWD, "vals")
    for i, ((w, b), (rw, rb)) in enumerate(zip(net.layers(), ref_g)):
        _normwise(w.grad.numpy(), rw, GRAD, f"dW{i}")
        _normwise(b.grad.numpy(), rb, GRAD, f"db{i}")


def _stream_inputs(rng, k, u=300, t=2048, l=3):
    h = (rng.random((u, WIDE_H)) * 0.2 / np.sqrt(WIDE_H / 128)).astype(np.float32)
    w = rng.standard_normal((WIDE_H, t)).astype(np.float32) * 0.3
    b = rng.standard_normal(t).astype(np.float32) * 0.1
    counts = rng.integers(0, 5, size=(l, u)).astype(np.float32)
    g_marg = rng.standard_normal((l, t)).astype(np.float32)
    g_vals = rng.standard_normal((u, k)).astype(np.float32)
    return h, w, b, counts, g_marg, g_vals


@pytest.mark.parametrize("form", ["fused", "split"])
def test_stream_head_past_512_matches_pallas(rng, form):
    """K1/K2 (fused) and K4, K5, K6 (split) at H = 640."""
    k = 4
    h, w, b, counts, g_marg, g_vals = _stream_inputs(rng, k)
    jh, jw, jb, jc = map(jnp.asarray, (h, w, b, counts))
    ref = jax_stream.hpd_stream_select(jh, jw, jb, k, interpret=True)
    vals, idx, m, s = ref
    if form == "fused":
        out = hpd_stream.hpd_stream_fused_fwd(_t(h), _t(w), _t(b), _t(counts), k)
        ref_f = jax_stream.hpd_stream_fused_fwd(jh, jw, jb, jc, k, interpret=True)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref_f[2]))
        for name, a, r in zip(("marg", "vals", "idx", "m", "s"), out, ref_f):
            if name != "idx":
                _normwise(a.numpy(), r, FWD, name)
        ref_b = jax_stream.hpd_stream_fused_bwd(jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg),
                                                jnp.asarray(g_vals), k, interpret=True)
        bwd = hpd_stream.hpd_stream_fused_bwd
    else:
        out = hpd_stream.hpd_stream_select(_t(h), _t(w), _t(b), k)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(idx))
        for name, a, r in zip(("vals", "idx", "m", "s"), out, ref):
            if name != "idx":
                _normwise(a.numpy(), r, FWD, name)
        ref_m = jax_stream.hpd_stream_marginal(jh, jw, jb, jc, m, s, interpret=True)
        out_m = hpd_stream.hpd_stream_marginal(_t(h), _t(w), _t(b), _t(counts), _t(m), _t(s))
        _normwise(out_m.numpy(), ref_m, FWD, "marg")
        ref_b = jax_stream.hpd_tail_unique_pallas_bwd(
            jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg), jnp.asarray(g_vals), k,
            interpret=True)
        bwd = hpd_stream.hpd_tail_unique_bwd
    out_b = bwd(_t(h), _t(w), _t(b), _t(counts), _t(idx), _t(vals), _t(m), _t(s), _t(g_marg),
                _t(g_vals), k)
    for name, a, r in zip(("dh", "dw", "db"), out_b, ref_b):
        _normwise(a.numpy(), r, GRAD, name)


def test_per_row_tail_past_512_matches_pallas(rng):
    """The per-row tail K8/K9 at H = 640."""
    k, t, n = 4, 256, 600
    h = rng.standard_normal((2, n, WIDE_H)).astype(np.float32) * 0.5
    w = (rng.standard_normal((WIDE_H, t)) * 0.2 / np.sqrt(WIDE_H / 64)).astype(np.float32)
    b = rng.standard_normal(t).astype(np.float32) * 0.1
    g_marg = rng.standard_normal((2, t)).astype(np.float32)
    g_vals = rng.standard_normal((2, n, k)).astype(np.float32)
    jh, jw, jb = map(jnp.asarray, (h, w, b))
    ref = jax_tail.hpd_tail_pallas_fwd(jh, jw, jb, k, interpret=True)
    out = hpd_tail.hpd_tail_fwd(_t(h), _t(w), _t(b), k)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    _normwise(out[0].numpy(), ref[0], FWD, "marg")
    _normwise(out[1].numpy(), ref[1], FWD, "vals")
    ref_b = jax_tail.hpd_tail_pallas_bwd(jh, jw, jb, ref[2], jnp.asarray(g_marg),
                                         jnp.asarray(g_vals), k, interpret=True)
    out_b = hpd_tail.hpd_tail_bwd(_t(h), _t(w), _t(b), _t(ref[2]), _t(g_marg), _t(g_vals), k)
    for name, a, r in zip(("dh", "dw", "db"), out_b, ref_b):
        _normwise(a.numpy(), r, GRAD, name)
