"""``ModelConfig.dedup_cell_gather`` and the JAX package's gather forms on
the CPU, against the port's one gather.

The JAX package's ``gather_rows`` has four forms (the cell table under
compaction, the cell-structured backward on the shared grid and under
compaction, the reverse maps); the port has the per-vertex gather alone
(``models/encoding.py``). Each JAX form is held here against it on the same
table, ids and cotangent: the forward equal, the table gradient normwise
1e-5 (max |port - JAX| <= 1e-5 max |JAX|: sums of O(100) unit normals in
other orders; JAX ``tests/test_dedup.py:296, 380, 702``). The field is
carried and selects nothing in the port: its loss and gradients are bitwise
the same with it on and off, and ``fit`` with it on and off matches JAX's
3-epoch history at a compacting geometry (JAX ``test_dedup.py:615``'s p =
300; loss rtol 1e-5). A JAX checkpoint stamped with the field off loads as
off.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import encoding as jenc
from collision_handling_in_instantngp_tpu.ops import dedup as jdedup
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu.utils import checkpoint as jckpt
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import encoding, gngf
from collision_handling_in_instantngp_tpu_torch.ops import dedup
from collision_handling_in_instantngp_tpu_torch.tools import ablate_scaled, attribution
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt

SMALL = dict(hash_table_size=64, hpd_hidden=(8, 16), mlp_hidden=(16,), topk_k=3, fused_hpd=False)


def assert_normwise(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _geometry(rng, p, n_max=32):
    cfg = tcfg.ModelConfig(**SMALL, n_max=n_max)
    statics = gngf.make_statics(cfg)
    coords = rng.random((p, 2)).astype(np.float32)
    ids, counts = dedup.build_geometry_np(coords, statics.n_ls, statics.offsets, cfg.n_max)
    return cfg, statics, ids, counts


FORMS = ("per_vertex", "cells", "cells_few_rows", "cells_compact", "cell_table", "rev")


def _form_args(form, rng):
    """(table (L, U, F) numpy, the port's ids, JAX's kwargs, padded rows)
    for JAX's ``gather_rows`` form ``form``; the JAX geometry is built by
    the JAX package's own helpers."""
    p, n_max = (37, 64) if form == "cells_few_rows" else (307, 32)
    cfg, statics, ids, _ = _geometry(rng, p, n_max)
    side = dedup.grid_side(cfg.n_max)
    cell_info = (tuple(int(n) for n in statics.n_ls), side)
    l, f = cfg.num_levels, cfg.feature_dim
    if form in ("cells_compact", "cell_table"):
        # compact rows past the touched count, and cells past each level's
        # count: the padding of an epoch's smaller batches
        u_c = -(-np.unique(ids).size // 64) * 64 + 64
        active, ids_local, counts_c = dedup.compact_geometry_np(ids, l, u_c)
        j_active, j_ids_local, j_counts_c, base = jdedup.compact_geometry_np(ids, l, u_c)
        for a, b in ((active, j_active), (ids_local, j_ids_local), (counts_c, j_counts_c)):
            np.testing.assert_array_equal(a, b)
        j = dict(cell_info=cell_info, active=jnp.asarray(active), base=jnp.asarray(base))
        if form == "cell_table":
            corners, pixel_cell = jdedup.cell_geometry_np(ids, active, side)
            j.update(cell_corners=tuple(jnp.asarray(np.pad(c, ((0, 5), (0, 0)))) for c in corners),
                     pixel_cell=jnp.asarray(pixel_cell))
        table = rng.standard_normal((l, u_c, f)).astype(np.float32)
        return table, ids_local, j, active < 0
    table = rng.standard_normal((l, side * side, f)).astype(np.float32)
    if form == "per_vertex":
        return table, ids, {}, None
    if form == "rev":
        rev = jdedup.build_reverse_maps_np(ids, statics.n_ls, side)
        maps = jdedup.local_of_global_np(statics.n_ls, side)
        return table, ids, dict(
            rev=tuple(jnp.asarray(r) for r in rev),
            local_maps=tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in maps)), None
    return table, ids, dict(cell_info=cell_info), None


@pytest.mark.parametrize("form", FORMS)
def test_gather_rows_matches_jax_form(form, rng):
    table, ids, j_kw, padded = _form_args(form, rng)
    cot = rng.standard_normal((*ids.shape, table.shape[-1])).astype(np.float32)
    out_j, vjp = jax.vjp(lambda tab: jenc.gather_rows(tab, jnp.asarray(ids), **j_kw),
                         jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    out_t = encoding.gather_rows(tab, torch.from_numpy(ids).long())
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    out_t.backward(torch.from_numpy(cot))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    assert_normwise(tab.grad.numpy(), want)
    if padded is not None:
        assert padded.any() and not tab.grad.numpy()[:, padded].any()


def _image_data():
    img = np.random.default_rng(3).integers(0, 256, size=(20, 15, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    return data, jdata


def _texp(cell):
    return tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(
        **SMALL, dedup_cell_gather=cell), base_train=tcfg.TrainConfig(save_params=False))


def test_field_selects_nothing_in_the_port():
    """Batch 0 of a compacting geometry: the same geometry, loss and
    gradients, bit for bit, with the field on and off."""
    data, _ = _image_data()
    res = []
    for cell in (True, False):
        texp = _texp(cell)
        batch = attribution.batch_zero(texp, data, "cpu")
        assert batch.geom.active is not None
        params = gngf.init_params(texp.model, texp.train.seed, "cpu")
        loss = attribution.real_loss(texp, params, batch)
        weights = [p for p in params.parameters() if p.requires_grad]
        res.append((batch.geom, loss.detach(), torch.autograd.grad(loss, weights)))
    (g_on, l_on, d_on), (g_off, l_off, d_off) = res
    for a, b in zip(g_on, g_off):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert torch.equal(l_on, l_off)
    assert len(d_on) == len(d_off) and all(torch.equal(a, b) for a, b in zip(d_on, d_off))
    assert ablate_scaled.with_cell_gather(_texp(True), False) == _texp(False)


@pytest.mark.parametrize("cell", [True, False])
def test_fit_with_the_field_on_and_off_matches_jax(cell):
    """p = 300 pixels at T = 64, n = 8..32: 1/3 batches compact, so JAX
    takes its cell table (field on) or its compact cell-structured
    backward (off); the port its one gather."""
    data, jdata = _image_data()
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(
        **SMALL, dedup_cell_gather=cell))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = _texp(cell)
    jres = jax_fit(jexp, jdata, epochs=3, verbose=False)
    tres = fit(texp, data, epochs=3, device="cpu", verbose=False)
    assert len(tres.history) == len(jres.history) == 3
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        for lv in range(texp.model.num_levels):
            assert t[f"collisions_level{lv}"] == j[f"collisions_level{lv}"], (ep, lv)


def test_jax_checkpoint_with_the_field_off_loads_as_off(tmp_path):
    tree = {"tables": np.zeros((1, 2, 1), np.float32), "mlp": []}
    jdir = str(tmp_path / "j")
    jckpt.save_run_checkpoint(jdir, tree, {}, model_cfg=jcfg.ModelConfig(dedup_cell_gather=False))
    ckpt.validate_run_checkpoint(jdir, tcfg.ModelConfig(dedup_cell_gather=False))
    with pytest.raises(ckpt.CheckpointMismatchError, match="dedup_cell_gather"):
        ckpt.validate_run_checkpoint(jdir, tcfg.ModelConfig())
    assert tcfg.ModelConfig().dedup_cell_gather is True
    assert tcfg.experiment_from_grid_id(4061).model.dedup_cell_gather is True
