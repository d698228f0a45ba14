"""The split streamed tail (kernels K4, K5, K6) and the serial blend scatter
(K12) of the port on the CPU: each kernel's plain PyTorch version (what the
wrapper runs for a CPU tensor) against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs; the gate between the fused and the
split forms; the routing; the split autograd Function against the JAX
custom VJP; the blend's serial table gradient against the JAX ``_blend_core``.

Tolerances at 'highest' (fp32 both sides, summation order differs):
forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5, top-K
indices exactly equal. Inputs keep every product term O(1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.models import encoding as jenc
from collision_handling_in_instantngp_tpu.ops.fused_hpd import hpd_tail_unique as jax_tail
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream
from collision_handling_in_instantngp_tpu.ops.pallas.scatter_probe import scatter_add_vmem
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.models import encoding as enc
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.models.hpd import apply_hpd_unique
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream, scatter
from collision_handling_in_instantngp_tpu_torch.ops.fused_hpd import hpd_tail_unique, kernel_backend

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
U, H, L = 700, 32, 3                 # U: not a multiple of the 512- or 256-row blocks
T = 2 * hpd_stream.LANE_TILE         # two lane tiles: the running merge runs


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, k, u=U):
    h = rng.random((u, H), dtype=np.float32)                  # post-ReLU
    w = rng.standard_normal((H, T)).astype(np.float32) * 0.3
    b = rng.standard_normal(T).astype(np.float32) * 0.1
    counts = rng.integers(0, 5, size=(L, u)).astype(np.float32)
    g_marg = rng.standard_normal((L, T)).astype(np.float32)
    g_vals = rng.standard_normal((u, k)).astype(np.float32)
    return h, w, b, counts, g_marg, g_vals


@pytest.mark.parametrize("k", [1, 4, 16])
def test_select_plain_matches_pallas(rng, k):
    h, w, b, _, _, _ = _inputs(rng, k)
    ref = jax_stream.hpd_stream_select(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k,
                                       interpret=True)
    out = hpd_stream.hpd_stream_select(_t(h), _t(w), _t(b), k)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for name, a, r in zip(("vals", "idx", "m", "s"), out, ref):
        if name != "idx":
            np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **FWD)


def test_marginal_plain_matches_pallas(rng):
    """Same (m, s) into both. Rows 0-9 carry zero counts and s = 0: they
    must add exactly nothing (the TPU kernel reads s <= 0 as 1)."""
    h, w, b, counts, _, _ = _inputs(rng, 4)
    _, _, m, s = jax_stream.hpd_stream_select(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), 4,
                                              interpret=True)
    m, s = np.array(m), np.array(s)
    ref = jax_stream.hpd_stream_marginal(*map(jnp.asarray, (h, w, b, counts, m, s)),
                                         interpret=True)
    out = hpd_stream.hpd_stream_marginal(*map(_t, (h, w, b, counts, m, s)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    counts[:, :10] = 0.0
    s[:10] = 0.0
    without = hpd_stream.hpd_stream_marginal(*map(_t, (h, w, b, counts, m, s)))
    assert torch.isfinite(without).all()
    rest = hpd_stream.hpd_stream_marginal(*map(_t, (h[10:], w, b, counts[:, 10:], m[10:], s[10:])))
    np.testing.assert_allclose(without.numpy(), rest.numpy(), **FWD)


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("noop", [False, True])
def test_unique_bwd_plain_matches_pallas(rng, k, noop):
    h, w, b, counts, g_marg, g_vals = _inputs(rng, k)
    jh, jw, jb, jc = map(jnp.asarray, (h, w, b, counts))
    vals, idx, m, s = jax_stream.hpd_stream_select(jh, jw, jb, k, interpret=True)
    ref = jax_stream.hpd_tail_unique_pallas_bwd(
        jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg), jnp.asarray(g_vals), k,
        noop_topk=noop, interpret=True,
    )
    out = hpd_stream.hpd_tail_unique_bwd(
        _t(h), _t(w), _t(b), _t(counts), _t(idx), _t(vals), _t(m), _t(s), _t(g_marg),
        _t(g_vals), k, noop_topk=noop,
    )
    for name, a, r in zip(("dh", "dw", "db"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **GRAD)


def test_select_planted_tie_selects_lowest_index(rng):
    """Equal w columns and b entries give exactly equal logits in two
    different lane tiles; the lower index comes first, in the plain version
    and in the Pallas kernel."""
    k = 4
    h, w, b, _, _, _ = _inputs(rng, k, u=64)
    hi, lo = T - 100, 37
    w[:, hi] = w[:, lo] = np.abs(w).max(axis=1) * 3.0
    b[hi] = b[lo] = 1.0
    vals, idx, _, _ = hpd_stream.hpd_stream_select(_t(h), _t(w), _t(b), k)
    assert (idx[:, 0] == lo).all() and (idx[:, 1] == hi).all()
    assert torch.equal(vals[:, 0], vals[:, 1])
    ref = jax_stream.hpd_stream_select(*map(jnp.asarray, (h, w, b)), k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1]))


def test_fused_gate_matches_jax():
    for t in (256, 2048, 3000, 4096, 2**14, 2**15, 2**16, 2**17, 2**20):
        for k in (1, 4, 16, 17, 128):
            for hd in (16, 32, 64, 128, 256, 512):
                assert hpd_stream.fused_supports(t, k, hd) == jax_stream.fused_supports(t, k, hd), (t, k, hd)
                assert hpd_stream.supports(t, k) == jax_stream.supports(t, k), (t, k)
    assert not hpd_stream.fused_supports(2**16, 4, 128)
    assert hpd_stream.fused_supports(2**14, 4, 128)


# (T, FUSED_W_MAX_BYTES or None to keep it, route)
ROUTES = [(2**16, None, "split"), (2**14, None, "fused"), (4096, 0, "split"), (2304, 0, "fused")]


@pytest.mark.parametrize("t,w_max,route", ROUTES)
def test_unique_routing(monkeypatch, t, w_max, route):
    """apply_hpd_unique follows the gate: past it the split wrappers launch
    (spied, with the device check saying "card") and K1/K2 never do; where
    it holds, or where T is not a multiple of 2048, K1/K2 only."""
    if w_max is not None:
        monkeypatch.setattr(hpd_stream, "FUSED_W_MAX_BYTES", w_max)
    cfg = tcfg.ModelConfig(hash_table_size=t, num_levels=2, hpd_hidden=(8, 128),
                           hpd_backend="unique_stream")
    params = gngf.init_params(cfg, 0)
    calls = []

    def spy(name, plain):
        def launch(*args):
            calls.append(name)
            return plain(*args)
        return launch

    plains = {"fwd": hpd_stream.hpd_stream_fused_fwd_plain,
              "bwd": hpd_stream.hpd_stream_fused_bwd_plain,
              "select": hpd_stream.hpd_stream_select_plain,
              "marginal": hpd_stream.hpd_stream_marginal_plain,
              "unique_bwd": hpd_stream.hpd_tail_unique_bwd_plain}
    for name, plain in plains.items():
        monkeypatch.setattr(hpd_stream, f"_launch_{name}", spy(name, plain))
    monkeypatch.setattr(hpd_stream, "_on_card", lambda x: True)
    rng = np.random.default_rng(0)
    ucoords = torch.as_tensor(rng.integers(0, 30, size=(40, 2)), dtype=torch.float32)
    counts = torch.as_tensor(rng.integers(0, 3, size=(2, 40)), dtype=torch.float32)
    marg, vals, _ = apply_hpd_unique(params.hpd, ucoords, cfg, counts)
    (marg.sum() + vals.sum()).backward()
    want = ["marginal", "select", "unique_bwd"] if route == "split" else ["bwd", "fwd"]
    assert sorted(calls) == want


def test_split_autograd_matches_jax_vjp(rng, monkeypatch):
    """Both gates forced off: the port's autograd Function through K4/K5/K6
    (plain versions) against the JAX custom VJP through the Pallas split
    kernels (interpret mode); forward outputs and gradients of
    <marg, g_marg> + <vals, g_vals>."""
    monkeypatch.setattr(jax_stream, "FUSED_W_MAX_BYTES", 0)
    monkeypatch.setattr(hpd_stream, "FUSED_W_MAX_BYTES", 0)
    k = 4
    h, w, b, counts, g_marg, g_vals = _inputs(rng, k)

    def jax_scalar(h_, w_, b_):
        marg, vals, _ = jax_tail(h_, w_, b_, jnp.asarray(counts), k, "highest", False,
                                 None, "pallas_interpret")
        return jnp.sum(marg * g_marg) + jnp.sum(vals * g_vals)

    jm, jv, ji = jax_tail(*map(jnp.asarray, (h, w, b, counts)), k, "highest", False, None,
                          "pallas_interpret")
    ref = jax.grad(jax_scalar, argnums=(0, 1, 2))(*map(jnp.asarray, (h, w, b)))
    th, tw, tb = (_t(a).clone().requires_grad_() for a in (h, w, b))
    backend = kernel_backend(w.shape[1], k, h.shape[1])
    assert backend == "split"
    marg, vals, idx = hpd_tail_unique(th, tw, tb, _t(counts), k, "highest", False, backend)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(marg.detach().numpy(), np.asarray(jm), **FWD)
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(jv), **FWD)
    (torch.sum(marg * _t(g_marg)) + torch.sum(vals * _t(g_vals))).backward()
    for name, a, r in zip(("dh", "dw", "db"), (th.grad, tw.grad, tb.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **GRAD)


@pytest.mark.parametrize("c", [2, 32])
def test_scatter_plain_matches_pallas(rng, c):
    """Duplicate slots across rows (N = 1204 rows into T = 64 slots), N not a
    multiple of the chunk."""
    t, n = 64, 1204
    rows = rng.standard_normal((n, c)).astype(np.float32)
    idx = rng.integers(0, t, size=n).astype(np.int32)
    ref = scatter_add_vmem(jnp.asarray(rows), jnp.asarray(idx), t, chunk=512, interpret=True)
    out = scatter.scatter_add_serial(_t(rows), _t(idx), t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    bad = idx.copy()
    bad[5] = t
    with pytest.raises(ValueError):
        scatter.scatter_add_serial(_t(rows), _t(bad), t)


def test_scatter_prepare_ranges(rng):
    """K12's index preparation: a stable permutation of the row ids by slot
    and each slot's range in it (empty slots included); ValueError on an
    idx outside [0, T), as in the plain version."""
    t, n = 50, 600
    idx = rng.integers(0, t // 2, size=n).astype(np.int32) * 2
    order, offsets = scatter.prepare(_t(idx), t)
    assert order.dtype == offsets.dtype == torch.int32 and offsets.shape == (t + 1,)
    np.testing.assert_array_equal(order.numpy(), np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(offsets.numpy(), np.searchsorted(np.sort(idx), np.arange(t + 1)))
    for bad in (-1, t):
        idx[7] = bad
        with pytest.raises(ValueError):
            scatter.prepare(_t(idx), t)
        scatter.prepare(_t(idx), t, check=False)      # ids a gather has checked: no check


@pytest.mark.parametrize("n, c, t, narrow", [
    (3_700_000, 2, 2_600_000, True),      # gather_rows' gradient at T = 2^14
    (3_700_000, 2, 1024, False),          # the per-row blend's: long slots
    (647_168, 32, 65_536, False),         # the blend's: rows of L * F = 32
    (32 * 100, 4, 100, True), (32 * 100 + 1, 4, 100, False), (100, 5, 100, False)])
def test_scatter_narrow_path(n, c, t, narrow):
    """K12's variant: rows of at most 4 columns in slots of at most 32 rows
    on average take the narrow kernel, all others the ring."""
    assert scatter.narrow_path(n, c, t) is narrow


def _serial_sum(rows, idx, t):
    """Each slot's rows added one after another in row order (np.cumsum
    accumulates sequentially)."""
    order = np.argsort(idx, kind="stable")
    bounds = np.searchsorted(idx[order], np.arange(t + 1))
    out = np.zeros((t, rows.shape[1]), np.float32)
    for slot in np.nonzero(np.diff(bounds))[0]:
        out[slot] = np.cumsum(rows[order[bounds[slot]:bounds[slot + 1]]], axis=0)[-1]
    return out


@pytest.mark.parametrize("layout", ["random", "one_slot", "empty_slots"])
def test_scatter_plain_is_serial_sum(rng, layout):
    """The plain version (K12's reference on the card) is bitwise the serial
    row-order sum, with one long slot and with empty slots."""
    t, n, c = 256, 3000, 32
    rows = rng.standard_normal((n, c)).astype(np.float32) * 10
    idx = {"random": rng.integers(0, t, size=n),
           "one_slot": np.where(rng.random(n) < 0.8, 7, rng.integers(0, t, size=n)),
           "empty_slots": rng.integers(0, t // 4, size=n) * 4}[layout].astype(np.int32)
    out = scatter.scatter_add_serial_plain(_t(rows), _t(idx), t)
    np.testing.assert_array_equal(out.numpy(), _serial_sum(rows, idx, t))


def _blend_setup(rng, u=301, t=64, k=4):
    tables = rng.standard_normal((L, t, 2)).astype(np.float32)
    idx = np.stack([rng.choice(t, size=k, replace=False) for _ in range(u)]).astype(np.int32)
    vals = rng.random((u, k)).astype(np.float32)
    g = rng.standard_normal((L, u, 2)).astype(np.float32)
    return tables, idx, vals, g


def test_blend_serial_grads_match_jax(rng, monkeypatch):
    """blend_unique (its table gradient through scatter_add_serial, the
    port's one backward) against the JAX blend under its vmem_serial
    settings (threshold 0: the Pallas kernel, interpret)."""
    monkeypatch.setattr(jenc, "_BLEND_SMATRIX_MIN_ELEMENTS", 0)
    monkeypatch.setattr(jenc, "BLEND_LARGE_BACKEND", "gather")
    monkeypatch.setattr(jenc, "BLEND_SCATTER_BACKEND", "vmem_serial")
    monkeypatch.setattr(jenc, "BLEND_SCATTER_INTERPRET", True)
    calls = []

    def counted(rows, idx, t, **kw):
        calls.append(rows.shape)
        return scatter.scatter_add_serial(rows, idx, t, **kw)

    monkeypatch.setattr(enc, "scatter_add_serial", counted)
    tables, idx, vals, g = _blend_setup(rng)
    jc, tc = jcfg.ModelConfig(), tcfg.ModelConfig()

    def jax_scalar(tables_, vals_):
        return jnp.sum(jenc.blend_unique(tables_, jnp.asarray(idx), vals_, jc) * g)

    out_ref = jenc.blend_unique(jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(vals), jc)
    ref = jax.grad(jax_scalar, argnums=(0, 1))(jnp.asarray(tables), jnp.asarray(vals))
    tt, tv = _t(tables).requires_grad_(), _t(vals).requires_grad_()
    out = enc.blend_unique(tt, _t(idx), tv, tc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), **FWD)
    torch.sum(out * _t(g)).backward()
    assert calls == [(idx.size, L * 2)]
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref[0]), **FWD)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(ref[1]), **FWD)


def test_blend_backend_default_and_refusal(rng, monkeypatch):
    """The blend's table gradient is the serial row-order sum, one serial
    scatter per backward, bitwise equal run to run, whatever the
    environment says; the environment's value is read with "segment_sum"
    as default, and an unknown one raises."""
    calls = []

    def counted(rows, idx, t, **kw):
        calls.append((rows.shape, kw))
        return scatter.scatter_add_serial(rows, idx, t, **kw)

    monkeypatch.setattr(enc, "scatter_add_serial", counted)
    tables, idx, vals, _ = _blend_setup(rng)
    cfg = tcfg.ModelConfig()
    grads = []
    for _ in range(2):
        tt = _t(tables).requires_grad_()
        enc.blend_unique(tt, _t(idx), _t(vals), cfg).sum().backward()
        grads.append(tt.grad)
    assert calls == [((idx.size, L * 2), {"ids_checked": True})] * 2
    assert torch.equal(grads[0], grads[1])
    monkeypatch.delenv("BLEND_SCATTER_BACKEND", raising=False)
    assert enc.scatter_backend_from_env() == "segment_sum"
    monkeypatch.setenv("BLEND_SCATTER_BACKEND", "vmem_serial")
    assert enc.scatter_backend_from_env() == "vmem_serial"
    monkeypatch.setenv("BLEND_SCATTER_BACKEND", "vmem")
    with pytest.raises(ValueError):
        enc.scatter_backend_from_env()
