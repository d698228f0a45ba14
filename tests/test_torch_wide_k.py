"""K > 16 and approximate top-k on the HPD's streamed tails, on the CPU.

The port's chunked unique tail (``ops/fused_hpd.py: HpdTailUniqueChunked``,
the route ``models/hpd.py: unique_tail_backend`` takes for K > 16 or a
recall target) against the JAX package's ``hpd_tail_unique(...,
backend="jax")`` and its custom VJP; the per-row chunked tail with a recall
target against JAX ``hpd_tail``; the routing of both; and the port's ``fit``
against the JAX ``fit`` at a small streamed geometry at K = 20 and at K = 4
with a recall target.

``jax.lax.approx_max_k`` is exact off a TPU (XLA lowers it to a top-k on
the CPU), so the JAX side's recall target and the port's exact
lowest-index top-k compute one function here.

Inputs are dyadic (h in eighths, w in sixteenths, b in 64ths) so that every
logit is exact in fp32 whatever the order of its sum: the logits of a row
are then equal or at least 1/64 apart, p's ranking cannot flip on a
rounding difference between the two libraries, and the many exact ties
test the lowest-index rule. Tolerances (normwise: max |port - jax| <=
tol * max |jax|): marg and vals 1e-5, dh / dW / db 1e-4, indices identical
on every row; the slice's as tests/test_torch_slice.py (per-epoch loss rtol
1e-5, PSNR and collisions exactly equal, parameters atol 1e-5).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.models.hpd import apply_hpd_fused as jax_apply_fused
from collision_handling_in_instantngp_tpu.models.hpd import apply_hpd_unique as jax_apply_unique
from collision_handling_in_instantngp_tpu.ops.fused_hpd import hpd_tail as jax_row_tail
from collision_handling_in_instantngp_tpu.ops import collisions as jcoll
from collision_handling_in_instantngp_tpu.ops import dedup as jdedup
from collision_handling_in_instantngp_tpu.ops.fused_hpd import hpd_tail_unique as jax_tail
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf, hpd
from collision_handling_in_instantngp_tpu_torch.ops import collisions, dedup, fused_hpd
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream
from collision_handling_in_instantngp_tpu_torch.ops.topk import topk_keyed, topk_lowest_index
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
H, L = 64, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _normwise(got, ref, tol, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def _inputs(seed, u, t, k):
    rng = np.random.default_rng(seed)
    h = (rng.integers(0, 5, (u, H)) / 8).astype(np.float32)          # post-ReLU
    w = (rng.integers(-4, 5, (H, t)) / 16).astype(np.float32)
    b = (rng.integers(-8, 9, t) / 64).astype(np.float32)
    counts = rng.integers(0, 5, (L, u)).astype(np.float32)
    g_marg = rng.standard_normal((L, t)).astype(np.float32)
    g_vals = rng.standard_normal((u, k)).astype(np.float32)
    return h, w, b, counts, g_marg, g_vals


def _both_tails(h, w, b, counts, g_marg, g_vals, k, noop=False, approx=None, use_marg=True):
    """(JAX (marg, vals, idx), JAX grads, port outputs, port grads) of
    <marg, g_marg> + <vals, g_vals> (the marginal's term dropped under
    ``use_marg=False``, as under keep_topk_only)."""
    def jax_scalar(h_, w_, b_):
        marg, vals, idx = jax_tail(h_, w_, b_, jnp.asarray(counts), k, "highest", noop, approx, "jax")
        return jnp.sum(marg * g_marg) * use_marg + jnp.sum(vals * g_vals), (marg, vals, idx)

    (_, jout), jgrads = jax.value_and_grad(jax_scalar, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (h, w, b)))
    th, tw, tb = (_t(a).clone().requires_grad_() for a in (h, w, b))
    out = fused_hpd.hpd_tail_unique(th, tw, tb, _t(counts), k, "highest", noop, "jax")
    scalar = torch.sum(out[1] * _t(g_vals))
    if use_marg:
        scalar = scalar + torch.sum(out[0] * _t(g_marg))
    scalar.backward()
    return jout, jgrads, out, (th.grad, tw.grad, tb.grad)


def _check(jout, jgrads, out, grads):
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    for name, a, r in zip(("marg", "vals"), out, jout):
        _normwise(a.detach().numpy(), r, FWD_TOL, name)
    for name, a, r in zip(("dh", "dw", "db"), grads, jgrads):
        _normwise(a.numpy(), r, GRAD_TOL, name)


# (K, T, U): U not a multiple of the chunk (4,096 rows at T = 2048 and
# 4096); 4,396 rows take a whole chunk and a partial one
CASES = [(17, 2048, 700), (17, 4096, 700), (20, 2048, 4396), (20, 4096, 700),
         (32, 2048, 700), (32, 4096, 700), (128, 2048, 4396), (128, 4096, 700)]


@pytest.mark.parametrize("k,t,u", CASES)
def test_unique_tail_matches_jax(k, t, u):
    h, w, b, counts, g_marg, g_vals = _inputs(k + t + u, u, t, k)
    assert u % fused_hpd.unique_chunk_rows(t)
    _check(*_both_tails(h, w, b, counts, g_marg, g_vals, k))


@pytest.mark.parametrize("option", ["noop_topk", "counts_zero", "approx", "keep_topk_only"])
@pytest.mark.parametrize("k", [20, 128])
def test_unique_tail_options_match_jax(k, option):
    """noop_topk drops the top-k scatter from the backward; zero counts give
    a zero marginal and only the top-k gradient; a recall target (0.95) is
    the JAX approx_max_k, exact off the TPU; keep_topk_only leaves the
    marginal out of the loss."""
    t, u = 2048, 700
    h, w, b, counts, g_marg, g_vals = _inputs(k + 7, u, t, k)
    kw = {}
    if option == "noop_topk":
        kw = dict(noop=True)
    elif option == "counts_zero":
        counts = np.zeros_like(counts)
    elif option == "approx":
        kw = dict(approx=0.95)
    else:
        kw = dict(use_marg=False)
    jout, jgrads, out, grads = _both_tails(h, w, b, counts, g_marg, g_vals, k, **kw)
    if option == "counts_zero":
        assert not out[0].any()
    _check(jout, jgrads, out, grads)


def test_unique_tail_planted_ties_take_the_lowest_index():
    """Equal w columns and equal b entries make exactly equal logits: 30
    planted columns, scattered over the table, top every row, so K = 20
    takes the 20 lowest of them in ascending order, as JAX lax.top_k does."""
    k, t, u = 20, 2048, 300
    h, w, b, counts, g_marg, g_vals = _inputs(3, u, t, k)
    planted = np.random.default_rng(4).choice(t, size=30, replace=False)
    w[:, planted] = 0.5                      # h >= 0: the row's largest logits
    b[planted] = 0.5
    jout, jgrads, out, grads = _both_tails(h, w, b, counts, g_marg, g_vals, k)
    rows = (h.sum(1) > 0)                    # a zero row ties every column
    want = np.sort(planted)[:k]
    assert (out[2].numpy()[rows] == want).all()
    _check(jout, jgrads, out, grads)


@pytest.mark.parametrize("k", [4, 20, 128])
def test_keyed_topk_is_the_k_pass_selection(k):
    """topk_keyed (one torch.topk of int64 keys) equals topk_lowest_index
    (K passes) on rows with ties, negative values, zeros of both signs and
    infinities."""
    x = torch.from_numpy(np.random.default_rng(k).integers(-6, 7, (300, 512)) / 4).float()
    x[::7, 100:300] = x[::7, 100:101]
    x[1], x[2, :5] = -x[1].abs(), -0.0
    x[3, 9], x[4, 11] = float("inf"), float("-inf")
    v1, i1 = topk_lowest_index(x, k)
    v2, i2 = topk_keyed(x, k)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)


@pytest.mark.parametrize("k", [20, 128])
def test_per_row_tail_with_approx_matches_jax(k):
    """The per-row chunked tail (the port's "jax" backend) against JAX
    hpd_tail with a recall target of 0.95 (approx_max_k, exact here)."""
    t, n = 256, 1100
    h, w, b, _, _, _ = _inputs(k, 2 * n, t, k)
    h = h.reshape(2, n, H)
    rng = np.random.default_rng(k + 1)
    g_marg = rng.standard_normal((2, t)).astype(np.float32)
    g_vals = rng.standard_normal((2, n, k)).astype(np.float32)

    def jax_scalar(h_, w_, b_):
        marg, vals, idx = jax_row_tail(h_, w_, b_, k, "highest", "jax", 0.95)
        return jnp.sum(marg * g_marg) + jnp.sum(vals * g_vals), (marg, vals, idx)

    (_, jout), jgrads = jax.value_and_grad(jax_scalar, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (h, w, b)))
    th, tw, tb = (_t(a).clone().requires_grad_() for a in (h, w, b))
    out = fused_hpd.hpd_tail(th, tw, tb, k, "highest", "jax")
    (torch.sum(out[0] * _t(g_marg)) + torch.sum(out[1] * _t(g_vals))).backward()
    _check(jout, jgrads, out, (th.grad, tw.grad, tb.grad))


@pytest.mark.parametrize("backend", ["auto", "pallas", "pallas_full", "jax"])
@pytest.mark.parametrize("k", [20, 128])
def test_per_row_route_runs_with_approx(k, backend):
    """apply_hpd_fused takes a recall target on every per-row route (the
    kernel routes ignore it, as the JAX package's do) and gives the JAX
    chunked tail's outputs on JAX's weights."""
    kw = dict(hash_table_size=256, hpd_hidden=(8, 16), topk_k=k, topk_approx_recall=0.95)
    jc = jcfg.ModelConfig(hpd_backend="jax", **kw)
    tc = tcfg.ModelConfig(hpd_backend=backend, **kw)
    jp = jgngf.init_params(jax.random.PRNGKey(5), jc)
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    verts = np.random.default_rng(5).integers(0, 40, size=(30, 3, 4, 2)).astype(np.float32)
    jm, jv, ji = jax_apply_fused(jp["hpd"], jnp.asarray(verts), jc)
    tm, tv, ti = hpd.apply_hpd_fused(tp.hpd, _t(verts), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _normwise(tm.detach().numpy(), jm, FWD_TOL, "marg")
    _normwise(tv.detach().numpy(), jv, FWD_TOL, "vals")


@pytest.mark.parametrize("k", [4, 20, 32, 128])
def test_collision_means_match_jax_bit_for_bit(k):
    """The per-level collisions are a mean over the K candidates, which XLA
    takes as the sum times 1/K: at K = 20 that is an ulp from sum / K, and
    the slice compares collisions exactly. Both routes' counts (dedup
    presence and per-row ids) against the JAX package's, bit for bit."""
    rng = np.random.default_rng(k)
    n_ls = np.array([8, 12, 20, 32])
    presence = rng.random((4, k, 256)) < 0.3
    np.testing.assert_array_equal(
        dedup.collisions_from_presence(_t(presence), _t(n_ls)).numpy(),
        np.asarray(jdedup.collisions_from_presence(jnp.asarray(presence), jnp.asarray(n_ls))))
    ids = rng.integers(0, 256, (50, 4, 4, k)).astype(np.int32)
    np.testing.assert_array_equal(
        collisions.hash_collisions_gngf(_t(ids), _t(n_ls), 256).numpy(),
        np.asarray(jcoll.hash_collisions_gngf(jnp.asarray(ids), jnp.asarray(n_ls), 256)))


# ------------------------------ routing --------------------------------- #

def test_unique_tail_backend_on_the_scaled_grid():
    """At instantngp_scaled_model() (T = 2^14, H = 128) every topk_k of the
    grid axis: K1/K2 for 1 and 4, the chunked tail past 16; a recall target
    sends K = 4 there too; past the fused gate (T = 2^16) the split kernels;
    T not a multiple of 2048 keeps K1/K2."""
    cfg = tcfg.instantngp_scaled_model()
    t, hd = cfg.hash_table_size, cfg.hpd_hidden[-1]
    want = {1: "fused", 4: "fused", 20: "jax", 32: "jax", 128: "jax"}
    assert sorted(want) == sorted(tcfg.GRID_SEARCH_AXES["topk_k"])
    for k, route in want.items():
        assert hpd.unique_tail_backend(dataclasses.replace(cfg, topk_k=k), t, k, hd) == route
    approx = dataclasses.replace(cfg, topk_approx_recall=0.95)
    assert hpd.unique_tail_backend(approx, t, 4, hd) == "jax"
    assert hpd.unique_tail_backend(cfg, 2**16, 4, hd) == "split"
    assert hpd.unique_tail_backend(cfg, 2**16, 20, hd) == "jax"
    assert hpd.unique_tail_backend(cfg, 2304, 4, hd) == "fused"


SPY_ROUTES = [(dict(topk_k=4), ["hidden_bwd", "hidden_fwd", "tail_bwd", "tail_fwd"]),
              (dict(topk_k=16), ["hidden_bwd", "hidden_fwd", "tail_bwd", "tail_fwd"]),
              (dict(topk_k=17), ["hidden_bwd", "hidden_fwd"]),
              (dict(topk_k=128), ["hidden_bwd", "hidden_fwd"]),
              (dict(topk_k=4, topk_approx_recall=0.95), ["hidden_bwd", "hidden_fwd"])]


@pytest.mark.parametrize("kw,want", SPY_ROUTES)
def test_unique_routing_spy(monkeypatch, kw, want):
    """With the device check saying "card": K <= 16 without a recall target
    launches K1/K2 (K3 for the hidden stack); K > 16 or a recall target
    takes the chunked tail, and K3 still runs the hidden stack."""
    cfg = tcfg.ModelConfig(hash_table_size=2048, num_levels=2, hpd_hidden=(8, 128),
                           hpd_backend="unique_stream", **kw)
    params = gngf.init_params(cfg, 0)
    calls = []

    def spy(name, plain):
        def launch(*args):
            calls.append(name)
            return plain(*args)
        return launch

    monkeypatch.setattr(hpd_stream, "_launch_fwd", spy("tail_fwd", hpd_stream.hpd_stream_fused_fwd_plain))
    monkeypatch.setattr(hpd_stream, "_launch_bwd", spy("tail_bwd", hpd_stream.hpd_stream_fused_bwd_plain))
    monkeypatch.setattr(hidden, "_launch_fwd", spy("hidden_fwd", hidden.hidden_stack_fwd_plain))
    monkeypatch.setattr(hidden, "_launch_bwd", spy("hidden_bwd", hidden.hidden_stack_bwd_plain))
    monkeypatch.setattr(hpd_stream, "_on_card", lambda x: True)
    monkeypatch.setattr(hidden, "_on_card", lambda x: True)
    monkeypatch.setattr(fused_hpd.HpdTailUniqueChunked, "apply",
                        spy("chunked", fused_hpd.HpdTailUniqueChunked.apply))
    rng = np.random.default_rng(0)
    ucoords = torch.as_tensor(rng.integers(0, 30, size=(40, 2)), dtype=torch.float32)
    counts = torch.as_tensor(rng.integers(0, 3, size=(2, 40)), dtype=torch.float32)
    marg, vals, idx = hpd.apply_hpd_unique(params.hpd, ucoords, cfg, counts)
    (marg.sum() + vals.sum()).backward()
    assert vals.shape == idx.shape == (40, cfg.topk_k)
    assert sorted(c for c in calls if c != "chunked") == want
    assert ("chunked" in calls) == ("tail_fwd" not in want)


def test_inference_without_counts_matches_jax():
    """counts None (inference): no marginal, the top-K of the chunked tail
    on JAX's weights equal to the JAX package's."""
    kw = dict(hash_table_size=2048, num_levels=2, hpd_hidden=(8, 16), topk_k=20,
              hpd_backend="unique_stream")
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jgngf.init_params(jax.random.PRNGKey(9), jc)
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(9).integers(0, 50, size=(500, 2)).astype(np.float32)
    jm, jv, ji = jax_apply_unique(jp["hpd"], jnp.asarray(x), jc)
    tm, tv, ti = hpd.apply_hpd_unique(tp.hpd, _t(x), tc)
    assert jm is None and tm is None
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _normwise(tv.detach().numpy(), jv, FWD_TOL, "vals")


# ------------------------------- the slice ------------------------------- #

EPOCHS = 3
# grid 4062 is grid 4061 with K = 20; 4061 has K = 4
SLICES = {"k20": (4062, {}), "k4_approx": (4061, dict(topk_approx_recall=0.95))}
GEOMETRY = dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
                hpd_backend="unique_stream", mlp_hidden=(16,))


@pytest.fixture(scope="module", params=sorted(SLICES))
def runs(request):
    grid_id, extra = SLICES[request.param]
    kw = {**GEOMETRY, **extra}
    jexp = jcfg.experiment_from_grid_id(grid_id, base_model=jcfg.ModelConfig(**kw))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = tcfg.experiment_from_grid_id(grid_id, base_model=tcfg.ModelConfig(**kw), base_train=tcfg.TrainConfig(save_params=False))
    assert (texp.model.topk_k, texp.model.topk_approx_recall) == (
        20 if grid_id == 4062 else 4, extra.get("topk_approx_recall"))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_hpd.HpdTailUniqueChunked, "apply",
                   lambda *a, _f=fused_hpd.HpdTailUniqueChunked.apply: calls.append(1) or _f(*a))
        jres = jax_fit(jexp, jdata, epochs=EPOCHS, verbose=False)
        tres = fit(texp, data, epochs=EPOCHS, device="cpu", params=start, verbose=False)
    return texp, jres, tres, calls


def test_wide_k_slice_took_the_chunked_tail(runs):
    _, _, _, calls = runs
    assert len(calls) >= 3 * EPOCHS


def test_wide_k_slice_epochs_match_jax(runs):
    texp, jres, tres, _ = runs
    assert len(tres.history) == len(jres.history) == EPOCHS
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_psnr"] == j["train_psnr"], ep
        for l in range(texp.model.num_levels):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
    assert tres.best_psnr == jres.best_psnr


def test_wide_k_slice_params_match_jax(runs):
    _, jres, tres, _ = runs
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    np.testing.assert_allclose(tp["tables"], jp["tables"], rtol=0, atol=1e-5)
    for group in ("hpd", "mlp"):
        for i, (a, b) in enumerate(zip(tp[group], jp[group])):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                           err_msg=f"{group}[{i}].{key}")
