"""The port's training slice against the JAX package's ``fit``, on the CPU.

Both trainers start from the same weights (JAX init, copied with
``params_from_jax``) and train 3 epochs (9 Adam steps) on the same small
synthetic image:

* "stream": a small geometry that streams the HPD tail
  (hpd_backend="unique_stream"; JAX runs its lax.scan tail on the CPU, the
  port the plain versions of K1-K3) and where active-vertex compaction
  engages;
* "dense": the CLI's default grid-4061 geometry (T=2^8, 4 levels), dense
  HPD branch.

Tolerances: per-epoch loss rtol 1e-5 and PSNR / collisions exactly equal
(PSNR comes from the truncated integer image, collisions from slot sets);
parameters after the last epoch atol 1e-5 (fp32 summation order over 9
Adam steps moved them by < 1e-6 when this was written).
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
from collision_handling_in_instantngp_tpu.models.hpd import apply_hpd_unique as jax_apply_hpd
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, make_shuffle_permutations
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.models.hpd import apply_hpd_unique, use_stream
from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

EPOCHS = 3
GEOMETRIES = {
    "stream": dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
                   hpd_backend="unique_stream", mlp_hidden=(16,)),
    "dense": {},
}


def _image():
    return np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)


def _exps(name):
    kw = GEOMETRIES[name]
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**kw))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    return jexp, tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**kw),
                                              base_train=tcfg.TrainConfig(save_params=False))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def runs(request):
    jexp, texp = _exps(request.param)
    data = image_dataset(_image(), "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jres = jax_fit(jexp, jdata, epochs=EPOCHS, verbose=False)
    tres = fit(texp, data, epochs=EPOCHS, device="cpu", params=start, verbose=False)
    return request.param, texp, data, jres, tres


def test_slice_epochs_match_jax(runs):
    _, texp, _, jres, tres = runs
    assert len(tres.history) == len(jres.history) == EPOCHS
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_psnr"] == j["train_psnr"], ep
        for l in range(texp.model.num_levels):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
    assert tres.best_psnr == jres.best_psnr


def test_slice_params_match_jax(runs):
    _, _, _, jres, tres = runs
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    np.testing.assert_allclose(tp["tables"], jp["tables"], rtol=0, atol=1e-5)
    for group in ("hpd", "mlp"):
        for i, (a, b) in enumerate(zip(tp[group], jp[group])):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                           err_msg=f"{group}[{i}].{key}")


def test_slice_history_keys_match_jax(runs):
    """Every scalar key of JAX's history is in the port's rows, with
    kl_collisions_loss_level{l} = l_js_kl * js_kl + l_collisions * coll
    beside the JS/KL and collision-loss terms: collisions exactly equal,
    the rest rtol 1e-5."""
    _, texp, _, jres, tres = runs
    for j, t in zip(jres.history, tres.history):
        assert set(j) <= set(t), set(j) - set(t)
        assert {f"kl_collisions_loss_level{l}" for l in range(texp.model.num_levels)} <= set(j)
        for k, v in j.items():
            if k.startswith(("collisions_level", "min_possible", "train_psnr")):
                assert t[k] == v, k
            else:
                np.testing.assert_allclose(t[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_slice_topk_indices_match_except_p_ties(runs):
    """Top-K on the trained weights, batch 0's vertices: the port selects on
    logits, the JAX lax.scan tail on probabilities. Rows may differ only
    where two probabilities of JAX's selection tie in fp32 (distinct logits
    rounding to one p); count them and bound them."""
    _, texp, data, jres, tres = runs
    statics = gngf.make_statics(texp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, texp.train.seed)
    batches = build_epoch_batches(data.coords, data.targets, texp.train.batch_fraction,
                                  shuffled, data.image, texp.model, statics, "cpu")
    geom = batches.dedup[0]
    ucoords = (gngf.dedup_ops.active_coords(geom.active, texp.model.n_max + 2)
               if geom.active is not None else torch.as_tensor(statics.unique_coords))
    jmodel = _exps(runs[0])[0].model
    jp = jres.state.params
    _, jvals, jidx = jax_apply_hpd(jp["hpd"], jnp.asarray(ucoords.numpy()), jmodel,
                                   counts=jnp.asarray(geom.counts.numpy()))
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    with torch.no_grad():
        _, tvals, tidx = apply_hpd_unique(tp.hpd, ucoords, texp.model, counts=geom.counts)
    jidx, tidx = np.asarray(jidx), tidx.numpy()
    bad = np.nonzero((jidx != tidx).any(axis=1))[0]
    # every differing row selects the same probability values (a p tie)
    np.testing.assert_allclose(tvals.numpy()[bad], np.asarray(jvals)[bad], rtol=1e-5, atol=1e-7)
    assert len(bad) <= max(1, 0.01 * len(jidx)), (len(bad), len(jidx))


def test_stream_case_streams_and_compacts():
    """The "stream" geometry really takes the streamed tail, and its batches
    really are compacted (fewer rows than the shared vertex grid)."""
    _, texp = _exps("stream")
    data = image_dataset(_image(), "synthetic")
    statics = gngf.make_statics(texp.model)
    batches = build_epoch_batches(
        data.coords, data.targets, texp.train.batch_fraction,
        np.arange(data.num_pixels, dtype=np.int32), data.image, texp.model, statics, "cpu",
    )
    u = statics.unique_coords.shape[0]
    for geom in batches.dedup:
        assert geom.active is not None
        assert geom.counts.shape[1] < u
        assert use_stream(texp.model, geom.counts.shape[1])
