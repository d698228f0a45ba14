"""The port's per-row route on the CPU against the JAX package: the plain
versions of kernels K8-K11 against the Pallas kernels in interpret mode,
the p-tie rule, BatchNorm, the per-row table blend, the collision count,
one per-row forward, and the routing of ``apply_hpd_fused``.

Tolerances (fp32 both sides, summation order differs): forward atol 1e-6
with identical top-K indices; gradients atol 5e-5 (the JAX package's own
tests of these kernels use the same), plus rtol 1e-5 where a gradient sums
O(10) terms over 1,400 rows (the first layer's dW with vertex coords up
to 32); elementwise fp32 math rtol 1e-6; reductions, and BatchNorm (whose
variance sums rounded squares), rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import load_image_dataset as jax_load_dataset
from collision_handling_in_instantngp_tpu.models import encoding as jenc
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.ops import collisions as jcoll
from collision_handling_in_instantngp_tpu.ops.fused_hpd import hpd_tail as jax_tail
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_full as jax_full
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_tail as jax_tail_kernels
from collision_handling_in_instantngp_tpu.train import loss as jloss
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import load_image_dataset
from collision_handling_in_instantngp_tpu_torch.models import encoding, gngf, hpd
from collision_handling_in_instantngp_tpu_torch.ops import collisions
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full, hpd_tail
from collision_handling_in_instantngp_tpu_torch.ops.fused_hpd import hpd_tail as port_tail
from collision_handling_in_instantngp_tpu_torch.train import loss
from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer

FWD = dict(rtol=0, atol=1e-6)
GRAD = dict(rtol=0, atol=5e-5)
GRAD_STACK = dict(rtol=1e-5, atol=5e-5)
FP = dict(rtol=1e-6, atol=1e-7)
RED = dict(rtol=1e-5, atol=1e-6)
L, N, H = 2, 1100, 128          # N not a multiple of the Pallas 512-row block


def _t(a):
    return torch.from_numpy(np.array(a))


def _tail_inputs(rng, t, k):
    h = rng.standard_normal((L, N, H)).astype(np.float32) * 0.5
    w = rng.standard_normal((H, t)).astype(np.float32) * 0.2
    b = rng.standard_normal(t).astype(np.float32) * 0.1
    g_marg = rng.standard_normal((L, t)).astype(np.float32)
    g_vals = rng.standard_normal((L, N, k)).astype(np.float32)
    return h, w, b, g_marg, g_vals


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_tail_fwd_plain_matches_pallas(rng, t, k):
    h, w, b, _, _ = _tail_inputs(rng, t, k)
    ref = jax_tail_kernels.hpd_tail_pallas_fwd(*map(jnp.asarray, (h, w, b)), k, interpret=True)
    out = hpd_tail.hpd_tail_fwd(_t(h), _t(w), _t(b), k)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), err_msg="marg", **FWD)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), err_msg="vals", **FWD)


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_tail_bwd_plain_matches_pallas(rng, t, k):
    h, w, b, g_marg, g_vals = _tail_inputs(rng, t, k)
    jh, jw, jb = map(jnp.asarray, (h, w, b))
    _, _, idx = jax_tail_kernels.hpd_tail_pallas_fwd(jh, jw, jb, k, interpret=True)
    ref = jax_tail_kernels.hpd_tail_pallas_bwd(
        jh, jw, jb, idx, jnp.asarray(g_marg), jnp.asarray(g_vals), k, interpret=True)
    out = hpd_tail.hpd_tail_bwd(_t(h), _t(w), _t(b), _t(idx), _t(g_marg), _t(g_vals), k)
    for name, a, r in zip(("dh", "dw", "db"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **GRAD)


@pytest.mark.parametrize("backend", ["pallas", "jax"])
def test_tail_autograd_matches_jax_vjp(rng, backend):
    """The autograd Function over K8/K9 (or the chunked tail) gives the
    JAX custom VJP's gradients of <marg, g_marg> + <vals, g_vals>."""
    k, t = 4, 256
    h, w, b, g_marg, g_vals = _tail_inputs(rng, t, k)

    def jax_scalar(h_, w_, b_):
        marg, vals, _ = jax_tail(h_, w_, b_, k, "highest", "pallas_interpret")
        return jnp.sum(marg * g_marg) + jnp.sum(vals * g_vals)

    ref = jax.grad(jax_scalar, argnums=(0, 1, 2))(*map(jnp.asarray, (h, w, b)))
    th, tw, tb = (_t(a).clone().requires_grad_() for a in (h, w, b))
    marg, vals, _ = port_tail(th, tw, tb, k, "highest", backend)
    (torch.sum(marg * _t(g_marg)) + torch.sum(vals * _t(g_vals))).backward()
    for name, a, r in zip(("dh", "dw", "db"), (th.grad, tw.grad, tb.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **GRAD)


def _full_inputs(rng, widths, n=700):
    verts = rng.integers(0, 33, size=(L, n, widths[0])).astype(np.float32)
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / np.sqrt(din) if i < len(widths) - 2 else 0.2
        layers.append(((rng.standard_normal((din, dout)) * scale).astype(np.float32),
                       (rng.standard_normal(dout) * 0.1).astype(np.float32)))
    return verts, layers


@pytest.mark.parametrize("widths,k", [((2, 32, 64, 128, 256), 4), ((2, 8, 16, 128), 32),
                                      ((3, 128), 1)])
def test_full_plain_matches_pallas(rng, widths, k):
    """K10/K11 plain versions against hpd_full in interpret mode: outputs,
    and jax.grad over every layer through the autograd Function."""
    verts, layers = _full_inputs(rng, widths)
    t = widths[-1]
    gm = rng.standard_normal((L, t)).astype(np.float32)
    gv = rng.standard_normal((L, verts.shape[1], k)).astype(np.float32)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    ref = jax_full.hpd_full(jnp.asarray(verts), jl, k, True)

    def jax_scalar(ls):
        marg, vals, _ = jax_full.hpd_full(jnp.asarray(verts), ls, k, True)
        return jnp.sum(marg * gm) + jnp.sum(vals * gv)

    ref_g = jax.grad(jax_scalar)(jl)
    params = [_t(a).clone().requires_grad_() for pair in layers for a in pair]
    tv = _t(verts).clone().requires_grad_()
    out = hpd_full.hpd_full(tv, list(zip(params[0::2], params[1::2])), k)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(ref[0]), err_msg="marg", **FWD)
    np.testing.assert_allclose(out[1].detach().numpy(), np.asarray(ref[1]), err_msg="vals", **FWD)
    (torch.sum(out[0] * _t(gm)) + torch.sum(out[1] * _t(gv))).backward()
    for i, (rw, rb) in enumerate(ref_g):
        np.testing.assert_allclose(params[2 * i].grad.numpy(), np.asarray(rw), err_msg=f"dW{i}", **GRAD_STACK)
        np.testing.assert_allclose(params[2 * i + 1].grad.numpy(), np.asarray(rb), err_msg=f"db{i}", **GRAD_STACK)
    assert (tv.grad == 0).all()       # vertex coords are data


def planted_p_tie(t):
    """Head bias with two columns whose logits differ but whose p are equal:
    exp(-2^-26) rounds to 1 = exp(0), so e, and then p, tie. The larger
    logit sits at the higher column: selection on logits would pick it
    first, selection on p (lowest index among equal p) the lower column."""
    lo, hi = 37, t - 5
    b = np.full(t, -1.0, np.float32)
    b[lo], b[hi] = -(2.0 ** -26), 0.0
    return b, lo, hi


def test_planted_p_tie_selects_lowest_index(rng):
    t, k = 256, 4
    b, lo, hi = planted_p_tie(t)
    h = np.zeros((L, 40, H), np.float32)            # logits = b on every row
    w = rng.standard_normal((H, t)).astype(np.float32)
    p = hpd_tail.softmax_rows(_t(b)[None])[0]
    assert b[lo] != b[hi] and p[lo] == p[hi]        # the plant: distinct logits, equal p
    out = hpd_tail.hpd_tail_fwd(_t(h), _t(w), _t(b), k)
    idx = out[2].numpy()
    assert (idx[..., 0] == lo).all() and (idx[..., 1] == hi).all()
    ref = jax_tail_kernels.hpd_tail_pallas_fwd(*map(jnp.asarray, (h, w, b)), k, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(ref[2]))
    # the whole-network route: a hidden layer with negative bias feeds the
    # head zeros, so its logits are the planted bias too
    verts = rng.integers(0, 9, size=(L, 40, 2)).astype(np.float32)
    layers = [(np.abs(rng.standard_normal((2, 16))).astype(np.float32), np.full(16, -100.0, np.float32)),
              (w[:16], b)]
    out = hpd_full.hpd_full_fwd(_t(verts), [(_t(a), _t(c)) for a, c in layers], k)
    assert (out[2][..., 0] == lo).all() and (out[2][..., 1] == hi).all()
    ref = jax_full.hpd_full(jnp.asarray(verts), tuple((jnp.asarray(a), jnp.asarray(c)) for a, c in layers), k, True)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 500, size=(777, 2)).astype(np.float32)
    scale = np.array([1.5, 0.5], np.float32)
    bias = np.array([0.25, -1.0], np.float32)
    state = {"mean": np.array([3.0, 4.0], np.float32), "var": np.array([2.0, 9.0], np.float32)}
    y_j, s_j = jgngf._batchnorm({"scale": scale, "bias": bias},
                                {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x), train)
    bn = gngf.BatchNormParams(2)
    with torch.no_grad():
        bn.scale.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    y_t, s_t = gngf.batchnorm(bn, {k: _t(v) for k, v in state.items()}, _t(x), train)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **RED)
    for key in ("mean", "var"):
        np.testing.assert_allclose(s_t[key].numpy(), np.asarray(s_j[key]), err_msg=key, **RED)


def test_batchnorm_params_roundtrip_and_frozen():
    """params_from_jax / params_to_numpy carry "batchnorm"; the running
    statistics are buffers; the optimizer has no group for the BatchNorm."""
    cfg = jcfg.ModelConfig(batchnorm_input=True, hash_table_size=64, hpd_hidden=(8,))
    jp = jax.tree_util.tree_map(np.asarray, jgngf.init_params(jax.random.PRNGKey(1), cfg))
    state = {"mean": np.array([1.0, 2.0], np.float32), "var": np.array([3.0, 4.0], np.float32)}
    tp = gngf.params_from_jax(jp, bn_state=state)
    back = gngf.params_to_numpy(tp)
    for key in ("scale", "bias"):
        np.testing.assert_array_equal(back["batchnorm"][key], jp["batchnorm"][key])
    for key, v in gngf.bn_state_to_numpy(tp).items():
        np.testing.assert_array_equal(v, state[key])
    assert {"batchnorm.mean", "batchnorm.var"} <= set(dict(tp.named_buffers()))
    opt = make_optimizer(tcfg.OptimizerConfig(), tp)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(tp.batchnorm.scale) not in in_groups and id(tp.batchnorm.bias) not in in_groups
    fresh = gngf.init_params(tcfg.ModelConfig(batchnorm_input=True), 0)
    assert gngf.bn_state_to_numpy(fresh)["var"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("blend", list(tcfg.TopkBlendMode))
def test_lookup_topk_blend_matches_jax(blend):
    rng = np.random.default_rng(12)
    l, t, f, p, v, k = 3, 64, 2, 30, 4, 4
    tables = rng.standard_normal((l, t, f)).astype(np.float32)
    idx = np.stack([rng.permutation(t)[:k] for _ in range(p * l * v)]).reshape(p, l, v, k).astype(np.int32)
    vals = rng.random((p, l, v, k)).astype(np.float32) + 0.1
    gout = rng.standard_normal((p, l, v, f)).astype(np.float32)
    jc = jcfg.ModelConfig(topk_blend=jcfg.TopkBlendMode(blend.value))

    def jax_fn(tab, vv):
        return jnp.sum(jenc.lookup_topk_blend(tab, jnp.asarray(idx), vv, jc) * gout)

    val_j, (gt_j, gv_j) = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(tables), jnp.asarray(vals))
    tt, tv = _t(tables).requires_grad_(), _t(vals).requires_grad_()
    out = encoding.lookup_topk_blend(tt, _t(idx), tv, tcfg.ModelConfig(topk_blend=blend))
    val_t = (out * _t(gout)).sum()
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), **RED)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), **RED)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv_j), **RED)


def test_hash_collisions_gngf_matches_jax():
    rng = np.random.default_rng(13)
    n_ls = np.array([8, 12, 20, 32], np.int32)
    for t in (64, 256):
        idx = rng.integers(0, t, size=(150, 4, 4, 3)).astype(np.int32)
        got = collisions.hash_collisions_gngf(_t(idx), _t(n_ls), t)
        want = jcoll.hash_collisions_gngf(jnp.asarray(idx), jnp.asarray(n_ls), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = tcfg.ModelConfig()
    coll, minp = gngf.calc_hash_collisions(_t(idx), cfg, gngf.make_statics(cfg))
    assert minp.tolist() == [0, 0, 185, 833] and coll.dtype == torch.float32


def test_marginal_from_probs_matches_jax():
    rng = np.random.default_rng(14)
    probs = rng.random((20, 3, 4, 16)).astype(np.float32)
    want = np.stack([np.asarray(jloss.marginal_slot_distribution(jnp.asarray(probs[:, l]))) for l in range(3)])
    np.testing.assert_allclose(loss.marginal_slot_distribution(_t(probs)).numpy(), want, **RED)


@pytest.mark.parametrize("kw", [dict(batchnorm_input=True), dict(dedup_vertices=False, fused_hpd=False),
                                dict(dedup_vertices=False, keep_topk_only=True)])
def test_per_row_forward_matches_jax(kw):
    """One per-row forward (200 pixels) on JAX's weights: rgb, loss
    marginal or probs, indices and the updated BatchNorm statistics."""
    jc = jcfg.ModelConfig(hash_table_size=128, mlp_hidden=(16,), hpd_hidden=(8, 16), **kw)
    tc = tcfg.ModelConfig(hash_table_size=128, mlp_hidden=(16,), hpd_hidden=(8, 16), **kw)
    jp = jgngf.init_params(jax.random.PRNGKey(15), jc)
    x = np.random.default_rng(15).integers(0, 40, size=(200, 2)).astype(np.float32)
    if not kw.get("batchnorm_input"):
        x = x / 39.0
    out_j = jgngf.forward(jp, jnp.asarray(x), jc, jgngf.make_statics(jc), bn_state=jgngf.init_bn_state(jc))
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    out_t = gngf.forward(tp, _t(x), tc, gngf.make_statics(tc))
    assert out_t.idx_unique is None                       # the per-row route ran
    np.testing.assert_array_equal(out_t.indices.numpy(), np.asarray(out_j.indices))
    np.testing.assert_allclose(out_t.rgb.detach().numpy(), np.asarray(out_j.rgb), **RED)
    for name in ("marginal", "probs"):
        a, b = getattr(out_t, name), getattr(out_j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **RED)
    if kw.get("batchnorm_input"):
        for key in ("mean", "var"):
            np.testing.assert_allclose(out_t.bn_state[key].numpy(), np.asarray(out_j.bn_state[key]), **RED)


def test_raw_coords_dataset_matches_jax(tmp_path):
    import cv2

    img = np.random.default_rng(16).integers(0, 256, size=(9, 7, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "img.png"), img)
    t = load_image_dataset(str(tmp_path / "img.png"), normalize=False)
    j = jax_load_dataset(str(tmp_path / "img.png"), normalize=False)
    np.testing.assert_array_equal(t.coords, j.coords)
    assert t.coords.max() == 8.0


ROUTES = [
    (dict(), "full"),                                          # auto, K <= 32, T <= 2048
    (dict(hpd_backend="pallas_full"), "full"),
    (dict(hpd_backend="pallas"), "tail"),
    (dict(topk_k=128), "chunked"),                             # auto past K = 32
    (dict(hash_table_size=4096), "chunked"),                   # auto past T = 2048
    (dict(hpd_backend="jax"), "chunked"),
    (dict(topk_scatter=tcfg.TopkScatterMode.NOOP), "dense"),
    (dict(fused_hpd=False), "dense"),
]


@pytest.mark.parametrize("kw,route", ROUTES)
def test_per_row_routing(monkeypatch, kw, route):
    """apply_hpd_fused follows the config: the kernel wrappers launch where
    the route says (spied, with the device check saying "card"), and
    nowhere else."""
    cfg = tcfg.ModelConfig(**{**dict(batchnorm_input=True, hash_table_size=256, hpd_hidden=(8, 16)), **kw})
    params = gngf.init_params(cfg, 0)
    calls = []

    def spy(name, plain):
        def launch(*args):
            calls.append(name)
            return plain(*args)
        return launch

    monkeypatch.setattr(hpd_tail, "_launch_fwd", spy("tail_fwd", hpd_tail.hpd_tail_fwd_plain))
    monkeypatch.setattr(hpd_tail, "_launch_bwd", spy("tail_bwd", hpd_tail.hpd_tail_bwd_plain))
    monkeypatch.setattr(hpd_full, "_launch_fwd", spy("full_fwd", hpd_full.hpd_full_fwd_plain))
    monkeypatch.setattr(hpd_full, "_launch_bwd", spy("full_bwd", hpd_full.hpd_full_bwd_plain))
    monkeypatch.setattr(hpd_tail, "_on_card", lambda t: True)
    monkeypatch.setattr(hpd_full, "_on_card", lambda t: True)
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 30, size=(40, 2)), dtype=torch.float32)
    out = gngf.forward(params, x, cfg, gngf.make_statics(cfg))
    (out.rgb.sum() + (out.marginal if out.marginal is not None else out.probs).sum()).backward()
    want = {"full": ["full_bwd", "full_fwd"], "tail": ["tail_bwd", "tail_fwd"]}.get(route, [])
    assert sorted(calls) == want
    assert (out.probs is not None) == (route == "dense")
    assert params.hpd.weights[0].grad is not None and params.hpd.weights[0].grad.abs().sum() > 0


def test_per_row_kernels_refuse_shapes():
    """Shapes past the kernels' limits raise ValueError naming them, before
    any launch."""
    h, w, b = torch.zeros(1, 4, 520), torch.zeros(520, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="H <= 512"):
        hpd_tail.check_inputs(h, w, b, 4)
    with pytest.raises(ValueError, match="T <= 2048"):
        hpd_tail.check_inputs(torch.zeros(1, 4, 8), torch.zeros(8, 4096), torch.zeros(4096), 4)
    with pytest.raises(ValueError, match="K <= min"):
        hpd_tail.check_inputs(torch.zeros(1, 4, 8), torch.zeros(8, 256), torch.zeros(256), 129)
    v = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="K <= min"):
        hpd_full.widths_of(v, [(torch.zeros(2, 8), torch.zeros(8)), (torch.zeros(8, 256), torch.zeros(256))], 33)
    with pytest.raises(ValueError, match="hidden widths"):
        hpd_full.widths_of(v, [(torch.zeros(2, 520), torch.zeros(520)), (torch.zeros(520, 64), torch.zeros(64))], 4)
    assert hpd.fused_backend(dataclasses.replace(tcfg.ModelConfig(), topk_k=32)) == "pallas_full"
