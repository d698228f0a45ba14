"""The port's vanilla hash path on the CPU against the JAX package's.

* ``fast_hash``: ids exactly equal to JAX's on random corners up to 2^20
  (integer and float), at T = 2^8, 2^14, 2^16 and 2^24; a T that is not a
  power of two raises.
* forward: rgb rtol 1e-6 (fp32 products in another order), the hash ids
  and ``calc_hash_collisions`` exactly equal, unclamped (the corners at
  n_l + 1 of the far edge's pixels reach more than (n_l + 1)^2 vertices,
  so a large table gives negative collisions).
* the slice: a 3-epoch ``fit`` from the JAX init against JAX ``fit`` at two
  geometries, one with ``batchnorm_input``: per-epoch loss rtol 1e-5,
  accuracy, collisions and the last epoch's integer image exactly equal;
  PSNR within 1e-5 dB (it is the fp32 mean of the integer squared errors,
  which XLA and PyTorch sum in different orders: 4e-7 dB apart on one
  epoch here with identical integer images); parameters atol 1e-5; every
  scalar key of JAX's history present with equal values, and no JS/KL or
  collision-loss key.
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
from collision_handling_in_instantngp_tpu.ops.hashing import fast_hash as jax_fast_hash
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.ops.hashing import fast_hash
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

EPOCHS = 3
LOSS_KEYS = ("kl_div_loss_level", "collisions_loss_level", "kl_collisions_loss_level")
GEOMETRIES = {
    "default": {},
    "batchnorm": dict(batchnorm_input=True),
    "scaled_small": dict(hash_table_size=2**12, num_levels=8, n_min=8, n_max=96),
}


@pytest.mark.parametrize("t", [2**8, 2**14, 2**16, 2**24])
@pytest.mark.parametrize("d", [2, 3])
def test_fast_hash_matches_jax(t, d):
    rng = np.random.default_rng(t + d)
    corners = rng.integers(0, 2**20 + 1, size=(4096, d))
    want = np.asarray(jax_fast_hash(jnp.asarray(corners.astype(np.int32)), t))
    got = fast_hash(torch.as_tensor(corners.astype(np.int32)), t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    floats = corners.astype(np.float32)            # scale_to_grid's corners are floats
    np.testing.assert_array_equal(fast_hash(torch.as_tensor(floats), t).numpy(),
                                  np.asarray(jax_fast_hash(jnp.asarray(floats), t)))
    assert want.min() >= 0 and want.max() < t


def test_fast_hash_casts_as_jax():
    """Negative and huge float corners saturate, negative ints wrap, as
    JAX's astype(uint32) does (batch-normalized coords reach negatives)."""
    floats = np.array([[-1.5, 3.0], [-3e9, 2.0], [5e9, 7.0], [-0.5, 4294967295.0]], np.float32)
    ints = np.array([[-1, 3], [-2**31, 2], [2**31 - 1, -7]], np.int32)
    for a in (floats, ints):
        for t in (2**8, 2**24):
            np.testing.assert_array_equal(fast_hash(torch.as_tensor(a), t).numpy(),
                                          np.asarray(jax_fast_hash(jnp.asarray(a), t)))


@pytest.mark.parametrize("t", [0, 3, 100, 2**8 + 1])
def test_fast_hash_rejects_non_power_of_two(t):
    with pytest.raises(ValueError, match="power of two"):
        fast_hash(torch.zeros(4, 2), t)


def _models(kw):
    kw = dict(use_hash_function=True, **kw)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_vanilla_forward_matches_jax(name):
    jm, tm = _models(GEOMETRIES[name])
    jp = jgngf.init_params(jax.random.PRNGKey(3), jm)
    assert "hpd" not in jp
    # tables scaled up so that the features move the decoder
    jp = dict(jp, tables=jp["tables"] * 1e3)
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert tp.hpd is None and "hpd" not in gngf.params_to_numpy(tp)
    x = np.random.default_rng(0).random((2000, 2)).astype(np.float32) * (9.0 if tm.batchnorm_input else 1.0)
    jst, tst = jgngf.make_statics(jm), gngf.make_statics(tm)
    jo = jgngf.forward(jp, jnp.asarray(x), jm, jst)
    to = gngf.forward(tp, torch.as_tensor(x), tm, tst)
    assert to.marginal is None and to.probs is None and to.idx_unique is None
    np.testing.assert_allclose(to.rgb.detach().numpy(), np.asarray(jo.rgb), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to.indices.numpy(), np.asarray(jo.indices))
    jc, jmin = jgngf.calc_hash_collisions(jo.indices, jm, jst)
    tc, tmin = gngf.calc_hash_collisions(to.indices, tm, tst)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))


def test_vanilla_collisions_unclamped():
    """A 64 x 64 pixel grid over [0, 1]^2 reaches (n + 2)^2 vertices per
    level (corners up to n + 1); at T = 2^16 they hash to more distinct ids
    than the (n + 1)^2 the count subtracts from, so the collisions go
    negative, as in the JAX package, and equal its values."""
    jm, tm = _models(dict(hash_table_size=2**16, n_min=8, n_max=16))
    g = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    x = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    jst, tst = jgngf.make_statics(jm), gngf.make_statics(tm)
    jp = jgngf.init_params(jax.random.PRNGKey(0), jm)
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jo = jgngf.forward(jp, jnp.asarray(x), jm, jst)
    to = gngf.forward(tp, torch.as_tensor(x), tm, tst)
    jc, _ = jgngf.calc_hash_collisions(jo.indices, jm, jst)
    tc, _ = gngf.calc_hash_collisions(to.indices, tm, tst)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() < 0).all(), tc


def _image():
    return np.random.default_rng(65535).integers(0, 256, size=(23, 20, 3)).astype(np.uint8)


SLICE_GEOMETRIES = ("default", "batchnorm")


@pytest.fixture(scope="module", params=SLICE_GEOMETRIES)
def runs(request):
    jm, tm = _models(GEOMETRIES[request.param])
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jm)
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tm)
    texp = dataclasses.replace(texp, train=dataclasses.replace(texp.train, save_params=False))
    data = image_dataset(_image(), "synthetic", normalize=not tm.batchnorm_input)
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jres = jax_fit(jexp, jdata, epochs=EPOCHS, verbose=False)
    tres = fit(texp, data, epochs=EPOCHS, device="cpu", params=start, verbose=False)
    return texp, jres, tres


def test_vanilla_slice_epochs_match_jax(runs):
    texp, jres, tres = runs
    assert len(tres.history) == len(jres.history) == EPOCHS
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_accuracy"] == j["train_accuracy"], ep
        assert abs(t["train_psnr"] - j["train_psnr"]) <= 1e-5, (ep, t["train_psnr"], j["train_psnr"])
        for l in range(texp.model.num_levels):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
    np.testing.assert_array_equal(tres.final_image, jres.final_image)


def test_vanilla_slice_params_match_jax(runs):
    _, jres, tres = runs
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    assert sorted(tp) == sorted(jp) and "hpd" not in tp
    np.testing.assert_allclose(tp["tables"], jp["tables"], rtol=0, atol=1e-5)
    for i, (a, b) in enumerate(zip(tp["mlp"], jp["mlp"])):
        for key in ("w", "b"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5, err_msg=f"mlp[{i}].{key}")
    if "batchnorm" in jp:
        np.testing.assert_array_equal(tp["batchnorm"]["scale"], jp["batchnorm"]["scale"])
        jbn = jax.tree_util.tree_map(np.asarray, jres.state.bn_state)
        tbn = gngf.bn_state_to_numpy(tres.params)
        for k in ("mean", "var"):
            np.testing.assert_allclose(tbn[k], jbn[k], rtol=1e-6)


def test_vanilla_slice_history_keys_match_jax(runs):
    """Every scalar key of JAX's history is in the port's rows with its
    value (collisions exactly, the rest rtol 1e-5); no JS/KL or
    collision-loss key on the vanilla path."""
    _, jres, tres = runs
    for j, t in zip(jres.history, tres.history):
        assert set(j) <= set(t), set(j) - set(t)
        assert not [k for k in t if k.startswith(LOSS_KEYS)]
        for k, v in j.items():
            if k.startswith("collisions_level") or k.startswith("min_possible"):
                assert t[k] == v, k
            elif k != "train_psnr":
                np.testing.assert_allclose(t[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert set(t) - set(j) == {"epoch", "seconds", "pixels_per_s", "stats_seconds",
                                   "ckpt_seconds"}
