"""The port's per-row training route against the JAX package's ``fit``, on
the CPU.

Both trainers start from the same weights (JAX init, copied with
``params_from_jax``) and train 3 epochs (9 Adam steps) on the same small
synthetic image at the CLI's default geometry (T=2^8, 4 levels, K=4):

* "batchnorm": ``batchnorm_input=True`` on raw pixel coords (the dataset
  loaded with ``normalize=False``, as the CLI does), grid id 4061;
* "no_dedup": ``dedup_vertices=False``, grid id 4061;
* "topk_only": ``dedup_vertices=False``, grid id 16061 (4061 with
  ``keep_topk_only``: the loss marginalizes the top-k values).

On the CPU the port's "auto" route runs the plain versions of K10/K11 and
JAX its ``lax.scan`` tail; both select the top-K on p.

Tolerances: per-epoch loss rtol 1e-5, PSNR and collisions exactly equal
(PSNR comes from the truncated integer image, collisions from slot sets);
parameters after the last epoch atol 1e-5; BatchNorm running statistics
rtol 1e-5 (the variance sums rounded squares in another order).
"""

import dataclasses

import numpy as np
import jax
import pytest

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

EPOCHS = 3
CASES = {
    "batchnorm": (dict(batchnorm_input=True), 4061),
    "no_dedup": (dict(dedup_vertices=False), 4061),
    "topk_only": (dict(dedup_vertices=False), 16061),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    kw, gid = CASES[request.param]
    jexp = jcfg.experiment_from_grid_id(gid, base_model=jcfg.ModelConfig(**kw))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = tcfg.experiment_from_grid_id(gid, base_model=tcfg.ModelConfig(**kw), base_train=tcfg.TrainConfig(save_params=False))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic", normalize=not texp.model.batchnorm_input)
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jres = jax_fit(jexp, jdata, epochs=EPOCHS, verbose=False)
    tres = fit(texp, data, epochs=EPOCHS, device="cpu", params=start, verbose=False)
    return texp, jres, tres


def test_per_row_epochs_match_jax(runs):
    texp, jres, tres = runs
    assert len(tres.history) == len(jres.history) == EPOCHS
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_psnr"] == j["train_psnr"], ep
        for l in range(texp.model.num_levels):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
    assert tres.best_psnr == jres.best_psnr


def test_per_row_params_match_jax(runs):
    texp, jres, tres = runs
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    assert set(tp) == set(jp)
    np.testing.assert_allclose(tp["tables"], jp["tables"], rtol=0, atol=1e-5)
    for group in ("hpd", "mlp"):
        for i, (a, b) in enumerate(zip(tp[group], jp[group])):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                           err_msg=f"{group}[{i}].{key}")
    if texp.model.batchnorm_input:
        for key in ("scale", "bias"):                    # frozen
            np.testing.assert_array_equal(tp["batchnorm"][key], jp["batchnorm"][key])
        for key, v in gngf.bn_state_to_numpy(tres.params).items():
            np.testing.assert_allclose(v, np.asarray(jres.state.bn_state[key]), rtol=1e-5, err_msg=key)
