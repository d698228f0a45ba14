"""The port's split streamed tail (K4, K5, K6) and serial blend scatter (K12)
inside ``fit``, against the JAX package's ``fit``, on the CPU.

Both trainers start from the same weights (JAX init, copied with
``params_from_jax``) and train 3 epochs (9 Adam steps) on a small synthetic
image through a streamed geometry (T = 4096, 4 levels,
hpd_backend="unique_stream"). The port's fused gate is forced off
(``FUSED_W_MAX_BYTES = 0``), so its tail runs the plain versions of K4-K6;
the JAX side runs its lax.scan tail on the CPU, the same function. The JAX
blend takes its large-regime path (threshold forced to 0) with the table
gradient reduced by ``segment_sum`` or ``vmem_serial`` (the JAX Pallas kernel
in interpret mode); the port's gathers have one backward, which reduces
their gradients with K12's plain version (``models/encoding.py:
GatherSerial``), held against both.

Tolerances as in tests/test_torch_slice.py: per-epoch loss rtol 1e-5, PSNR
and collisions exactly equal, parameters after the last epoch atol 1e-5.
"""

import dataclasses

import numpy as np
import jax
import pytest

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import encoding as jenc
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import encoding as enc
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream, scatter
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

EPOCHS = 3
GEOMETRY = dict(hash_table_size=4096, num_levels=4, n_min=8, n_max=48,
                hpd_backend="unique_stream", mlp_hidden=(16,))


def _counted(calls, name, fn):
    def wrapper(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)
    return wrapper


@pytest.fixture(scope="module", params=["segment_sum", "vmem_serial"])
def runs(request):
    backend = request.param
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**GEOMETRY))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**GEOMETRY))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, "_BLEND_SMATRIX_MIN_ELEMENTS", 0)
        mp.setattr(jenc, "BLEND_LARGE_BACKEND", "gather")
        mp.setattr(jenc, "BLEND_SCATTER_BACKEND", backend)
        mp.setattr(jenc, "BLEND_SCATTER_INTERPRET", True)
        mp.setattr(hpd_stream, "FUSED_W_MAX_BYTES", 0)
        for name in ("hpd_stream_select", "hpd_stream_marginal", "hpd_tail_unique_bwd",
                     "hpd_stream_fused_fwd", "hpd_stream_fused_bwd"):
            mp.setattr(hpd_stream, name, _counted(calls, name, getattr(hpd_stream, name)))
        mp.setattr(enc, "scatter_add_serial", _counted(calls, "scatter_add_serial",
                                                       scatter.scatter_add_serial))
        jres = jax_fit(jexp, jdata, epochs=EPOCHS, verbose=False)
        tres = fit(texp, data, epochs=EPOCHS, device="cpu", params=start, verbose=False)
    return backend, texp, jres, tres, calls


def test_split_slice_took_the_split_route(runs):
    _, _, _, _, calls = runs
    steps = 3 * EPOCHS
    assert calls.get("hpd_stream_select", 0) >= steps and calls.get("hpd_stream_marginal", 0) >= steps
    assert calls.get("hpd_tail_unique_bwd") == steps
    assert "hpd_stream_fused_fwd" not in calls and "hpd_stream_fused_bwd" not in calls
    # the blend's table gradient and gather_rows' vertex-feature gradient,
    # under either backend
    assert calls.get("scatter_add_serial", 0) == 2 * steps


def test_split_slice_epochs_match_jax(runs):
    _, texp, jres, tres, _ = runs
    assert len(tres.history) == len(jres.history) == EPOCHS
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_psnr"] == j["train_psnr"], ep
        for l in range(texp.model.num_levels):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
    assert tres.best_psnr == jres.best_psnr


def test_split_slice_params_match_jax(runs):
    _, _, jres, tres, _ = runs
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    np.testing.assert_allclose(tp["tables"], jp["tables"], rtol=0, atol=1e-5)
    for group in ("hpd", "mlp"):
        for i, (a, b) in enumerate(zip(tp[group], jp[group])):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                           err_msg=f"{group}[{i}].{key}")
