"""The port's copy of JAX's PRNG (``utils/prng.py``) and the init it feeds,
bit for bit against ``jax.random`` and the JAX package's ``init_params``.

A seed names one start in both packages: the port's ``fit`` without
``params=`` gives the JAX package's history on the 24 x 20 image of
``tests/test_torch_slice.py`` (loss rtol 1e-5, PSNR and collision counts
equal, as there).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils import prng

SEEDS = (0, 7, 42, 2026, 65535, 2 ** 31 - 1)
CONFIGS = {
    "4061": {},
    "scaled": "scaled",
    "vanilla": dict(use_hash_function=True),
    "batchnorm": dict(batchnorm_input=True),
}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", (0, 7, 2026, 2 ** 31 - 1))
def test_key_split_bits_match_jax(seed):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(key, n), np.asarray(jax.random.split(jkey, n)))
    for shape in ((1,), (7,), (3, 5), (33, 17)):
        np.testing.assert_array_equal(prng.random_bits(key, shape),
                                      np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))


@pytest.mark.parametrize("shape", ((3,), (129,), (128, 256), (4, 256, 2)))
def test_uniform_matches_jax_bitwise(shape):
    """The shapes on which a float32 multiply then add missed the fused
    multiply-add of XLA's CPU by an ulp."""
    for seed in (1, 2026):
        key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
        for lo, hi in ((0.0, 1.0), (-1e-4, 1e-4), (-0.125, 0.125), (-1 / np.sqrt(3), 1 / np.sqrt(3))):
            ours = prng.uniform(key, shape, lo, hi)
            ref = jax.random.uniform(jkey, shape, jnp.float32, lo, hi)
            assert ours.dtype == np.float32 and ours.shape == shape
            np.testing.assert_array_equal(_bits(ours), _bits(ref))


def _model_cfgs(name):
    kw = CONFIGS[name]
    if kw == "scaled":
        return jcfg.instantngp_scaled_model(), tcfg.instantngp_scaled_model()
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**kw))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**kw))
    return jexp.model, texp.model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_bitwise_jax(name):
    jm, tm = _model_cfgs(name)
    for seed in SEEDS:
        ref = jax.tree_util.tree_map(np.asarray, jgngf.init_params(jax.random.PRNGKey(seed), jm))
        ours = gngf.params_to_numpy(gngf.init_params(tm, seed))
        assert sorted(ours) == sorted(ref), seed
        np.testing.assert_array_equal(_bits(ours["tables"]), _bits(ref["tables"]))
        for group in ("hpd", "mlp"):
            if group not in ref:
                continue
            assert len(ours[group]) == len(ref[group])
            for a, b in zip(ours[group], ref[group]):
                for k in ("w", "b"):
                    assert np.shape(a[k]) == np.shape(b[k])
                    np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=f"{seed} {k}")
        if "batchnorm" in ref:
            for k in ("scale", "bias"):
                np.testing.assert_array_equal(ours["batchnorm"][k], ref["batchnorm"][k])


def test_fit_from_seed_gives_jax_history():
    """No ``params=``: both trainers start from their own init of one seed."""
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jexp = jcfg.experiment_from_grid_id(4061)
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = tcfg.experiment_from_grid_id(4061, base_train=tcfg.TrainConfig(save_params=False))
    jres = jax_fit(jexp, jdata, epochs=3, verbose=False)
    tres = fit(texp, data, epochs=3, device="cpu", verbose=False)
    assert len(tres.history) == len(jres.history) == 3
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_psnr"] == j["train_psnr"], ep
        for l in range(texp.model.num_levels):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
