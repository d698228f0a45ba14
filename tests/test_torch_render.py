"""The port's render against the JAX package's, on the CPU.

Same weights (JAX init, carried with ``params_from_jax``) and the same
render arguments; the uint8 images must be equal, entry for entry:

* "dense": T = 32, HPD [2 -> 8 -> 16 -> 32], decoder [8 -> 16 -> 3], the
  dedup route with the dense HPD (128-row chunks hold more rows than the
  34 x 34 vertex grid);
* "stream": T = 2048, L = 4, n = 8..48, ``hpd_backend="unique_stream"``:
  the dedup route's streamed tail (K1's plain version here), fed the
  (1, U) zero counts of inference;
* "bn": ``batchnorm_input`` at T = 32 (the per-row route), with a saved
  ``bn_state`` and without one (then the fresh-init statistics, as JAX's
  render uses, whatever the params' running buffers hold);

at the native size, 2x supersampled with ``train_shape``, and with one
channel. Then ``forward(train=False)`` against JAX's (no marginal, the
tail fed (1, U) zeros), and two round trips: a port ``fit`` checkpoint
rendered within 0.3 dB of its best PSNR (the bound of JAX's own
``tests/test_checkpoint_render_roundtrip.py``), and a JAX-written run
directory rendered by the port as JAX renders it.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.data import make_coordinate_grid
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.render import render_image as jax_render
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu.utils import checkpoint as jckpt
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch import render
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.models import hpd as thpd
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt
from collision_handling_in_instantngp_tpu_torch.utils.metrics import calc_psnr

CFGS = {
    "dense": (dict(hash_table_size=32, hpd_hidden=(8, 16), mlp_hidden=(16,)), 128),
    "stream": (dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
                    hpd_backend="unique_stream", hpd_hidden=(8, 16), mlp_hidden=(16,)), 256),
    "bn": (dict(hash_table_size=32, hpd_hidden=(8, 16), mlp_hidden=(16,),
                batchnorm_input=True), 64),
}


def _setup(name, **over):
    kw, rows = CFGS[name]
    kw = {**kw, **over}
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jparams = jgngf.init_params(jax.random.PRNGKey(7), jc)
    # tables of unit scale: the init's 1e-4 renders a flat image
    jparams["tables"] = jnp.asarray(np.random.default_rng(5).normal(
        size=jparams["tables"].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jc, tc, jparams, tree, rows


SHAPES = {
    "native": dict(height=12, width=9),
    "supersampled": dict(height=24, width=18, train_shape=(12, 9)),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", ["dense", "stream"])
@pytest.mark.parametrize("channels", [3, 1])
def test_render_matches_jax(name, shape, channels):
    jc, tc, jparams, tree, rows = _setup(name, out_channels=channels)
    want = jax_render(jparams, jc, batch_rows=rows, **SHAPES[shape])
    got = render.render_image(gngf.params_from_jax(tree), tc, batch_rows=rows, device="cpu",
                              **SHAPES[shape])
    h, w = SHAPES[shape]["height"], SHAPES[shape]["width"]
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape == ((h, w, 3) if channels == 3 else (h, w))
    assert len(np.unique(want)) > 20            # an image, not a flat field
    np.testing.assert_array_equal(got, want)
    # the numpy tree renders the same as the params made from it
    np.testing.assert_array_equal(
        render.render_image(tree, tc, batch_rows=rows, device="cpu", **SHAPES[shape]), want)


@pytest.mark.parametrize("given", [True, False], ids=["bn_state", "fresh"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batchnorm_render_matches_jax(shape, given):
    jc, tc, jparams, tree, rows = _setup("bn")
    rng = np.random.default_rng(3)
    saved = {"mean": rng.uniform(0.2, 0.6, 2).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 2).astype(np.float32)}
    # running buffers far from both: a render without bn_state must not read them
    params = gngf.params_from_jax(tree, bn_state={"mean": np.full(2, 40, np.float32),
                                                  "var": np.full(2, 900, np.float32)})
    bn = saved if given else None
    want = jax_render(jparams, jc, batch_rows=rows, bn_state=bn, **SHAPES[shape])
    got = render.render_image(params, tc, batch_rows=rows, bn_state=bn, device="cpu",
                              **SHAPES[shape])
    np.testing.assert_array_equal(got, want)
    other = jax_render(jparams, jc, batch_rows=rows, bn_state=None if given else saved,
                       **SHAPES[shape])
    assert not np.array_equal(got, other)       # the statistics do reach the image
    # the caller's params (buffers included) are not modified
    assert torch.equal(params.batchnorm.mean, torch.full((2,), 40.0))


def test_renderer_is_cached_per_config_and_rows():
    _, tc, *_ = _setup("dense")
    statics = gngf.make_statics(tc)
    r = render.make_renderer(tc, statics, 64)
    assert render.make_renderer(tc, statics, 64) is r
    assert render.make_renderer(tc, statics, 128) is not r


def test_render_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc, _, tree, _ = _setup("dense")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render.render_image(tree, tc, height=4, width=4)


@pytest.mark.parametrize("keep_topk_only", [False, True])
def test_forward_without_train_derives_no_counts(monkeypatch, keep_topk_only):
    """forward(train=False) on the dedup route: rgb as JAX's, no marginal,
    and the streamed tail fed (1, U) zero counts; train=True feeds it the
    (L, U) counts and returns the marginal."""
    jc, tc, jparams, tree, _ = _setup("stream", keep_topk_only=keep_topk_only)
    params = gngf.params_from_jax(tree)
    statics = gngf.make_statics(tc)
    jstatics = jgngf.make_statics(jc)
    coords = (make_coordinate_grid(24, 20).astype(np.float32) / 23.0)[:300]
    real, seen = thpd.hpd_tail_unique, []

    def spy(h, w, b, counts, *a, **kw):
        seen.append(counts.clone())
        return real(h, w, b, counts, *a, **kw)

    monkeypatch.setattr(thpd, "hpd_tail_unique", spy)
    u = statics.unique_coords.shape[0]
    with torch.no_grad():
        out = gngf.forward(params, torch.as_tensor(coords), tc, statics, train=False)
    ref = jgngf.forward(jparams, jnp.asarray(coords), jc, jstatics, train=False)
    assert out.marginal is None and ref.marginal is None
    assert len(seen) == 1 and seen[0].shape == (1, u) and not seen[0].any()
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), rtol=1e-5, atol=1e-6)

    seen.clear()
    out = gngf.forward(params, torch.as_tensor(coords), tc, statics, train=True)
    ref = jgngf.forward(jparams, jnp.asarray(coords), jc, jstatics, train=True)
    assert seen[0].shape == (tc.num_levels, u) and seen[0].sum() == 300 * 4 * tc.num_levels
    np.testing.assert_allclose(out.marginal.detach().numpy(), np.asarray(ref.marginal),
                               rtol=1e-5, atol=1e-7)


def _data(h=10, w=8):
    img = np.random.default_rng(65535).integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    data = image_dataset(img, "t.png")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=h, width=w,
                       image=data.image, name=data.name)
    return data, jdata


def _roundtrip_exp(pkg, tmp_path):
    exp = pkg.experiment_from_grid_id(4061)
    return dataclasses.replace(
        exp,
        model=dataclasses.replace(exp.model, hash_table_size=32, hpd_hidden=(8,),
                                  mlp_hidden=(16,)),
        train=dataclasses.replace(exp.train, epochs=8, checkpoint_dir=str(tmp_path / "w"),
                                  checkpoint_min_interval_s=0.0),
    )


def test_fit_checkpoint_render_roundtrip(tmp_path):
    data, _ = _data()
    exp = _roundtrip_exp(tcfg, tmp_path)
    res = fit(exp, data, device="cpu", verbose=False)
    tree = ckpt.load_pytree(f"{res.run_dir}/whole_model.pkl")
    recon = render.render_image(gngf.params_from_jax(tree), exp.model, height=data.height,
                                width=data.width, batch_rows=32, device="cpu")
    psnr = calc_psnr(recon.astype(np.int64), data.image)
    assert abs(psnr - res.best_psnr) < 0.3, (psnr, res.best_psnr)


def test_port_renders_a_jax_run_directory_as_jax_does(tmp_path):
    data, jdata = _data()
    jexp = _roundtrip_exp(jcfg, tmp_path)
    jres = jax_fit(jexp, jdata, verbose=False, epochs=3)
    jtree = jax.tree_util.tree_map(jnp.asarray, jckpt.load_pytree(f"{jres.run_dir}/whole_model.pkl"))
    want = jax_render(jtree, jexp.model, height=data.height, width=data.width, batch_rows=32)
    texp = _roundtrip_exp(tcfg, tmp_path)
    tree = ckpt.load_pytree(f"{jres.run_dir}/whole_model.pkl")
    got = render.render_image(tree, texp.model, height=data.height, width=data.width,
                              batch_rows=32, device="cpu")
    np.testing.assert_array_equal(got, want)
