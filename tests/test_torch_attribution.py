"""The step split by stage (``tools/attribution.py``, ``floor_table.py``,
``ablate_scaled.py``, ``gather_probe.py``) on the CPU.

Each stage prefix's probe is held against the JAX package's functions
composed in the JAX tool's order (``tools/attribution.py: prefix``), from the
same weights (``params_from_jax``), at a small streamed geometry and at the
default one (rtol 1e-5); the last prefix is bitwise the port's ``forward``
plus ``compute_loss``. ``floors_ms`` equals the JAX tool's, loaded by path;
the ablation's stage probes hold against JAX's stage programs, with
``dedup_cell_gather`` on and off, and the probe's gathers and scatters
against numpy.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import make_shuffle_permutations as jshuffle
from collision_handling_in_instantngp_tpu.models import encoding as jenc
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.models.hpd import apply_hpd_unique as japply_hpd_unique
from collision_handling_in_instantngp_tpu.models.mlp import apply_mlp
from collision_handling_in_instantngp_tpu.ops import dedup as jdedup
from collision_handling_in_instantngp_tpu.ops.grid import scale_to_grid as jscale_to_grid
from collision_handling_in_instantngp_tpu.ops.interpolate import (
    bilinear_coeffs as jbilinear_coeffs, interpolate as jinterpolate,
)
from collision_handling_in_instantngp_tpu.train.loss import compute_loss as jcompute_loss
from collision_handling_in_instantngp_tpu.train.optimizer import make_optimizer as jmake_optimizer
from collision_handling_in_instantngp_tpu.train.train_step import (
    build_epoch_batches as jbuild_epoch_batches,
)
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter
from collision_handling_in_instantngp_tpu_torch.tools import (
    ablate_scaled, attribution, floor_table, gather_probe, roofline,
)
from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = {
    "stream": dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
                   hpd_backend="unique_stream", mlp_hidden=(16,)),
    "dense": {},
}
JAX_STAGES = ("noop", "geometry", "hidden", "tail", "blend", "decoder", "loss")


def _image():
    return np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)


def _exps(name):
    kw = GEOMETRIES[name]
    return (jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**kw)),
            tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**kw)))


def _jax_batch(jexp, data):
    """Batch 0 and its dedup geometry as the JAX tools build them."""
    mcfg = jexp.model
    statics = jgngf.make_statics(mcfg)
    shuffled, _ = jshuffle(data.num_pixels, jexp.train.seed, True)
    b = jbuild_epoch_batches(data.coords, data.targets, jexp.train.batch_fraction, shuffled,
                             og_image=data.image, model_cfg=mcfg, statics=statics)
    first = lambda a: None if a is None else a[0]
    dedup = jdedup.DedupGeometry(
        b.dedup_ids[0], b.dedup_counts[0], first(b.dedup_rev), first(b.dedup_active),
        first(b.dedup_base),
        tuple(c[0] for c in b.dedup_cell_corners) if b.dedup_cell_corners is not None else None,
        first(b.dedup_pixel_cell))
    return statics, b.x[0], b.y[0], b.valid[0], dedup


def _jprobe(*trees):
    leaves = [l for t in trees for l in jax.tree_util.tree_leaves(t) if hasattr(l, "dtype")]
    return functools.reduce(jnp.add, [jnp.sum(l).astype(jnp.float32) for l in leaves])


def _jax_prefixes(jexp, params, statics, bx, by, nvalid, dedup):
    """Every stage's probe of the JAX tool's ``prefix`` (its body, with the
    plain hidden stack, which the Pallas kernel computes)."""
    mcfg, lcfg = jexp.model, jexp.loss
    n_ls, offsets = jnp.asarray(statics.n_ls), jnp.asarray(statics.offsets)
    side = jdedup.grid_side(mcfg.n_max)
    compacted = dedup.active is not None
    cell_info = (tuple(int(n) for n in statics.n_ls), side)
    out = {"noop": _jprobe(bx) + _jprobe(params)}
    scaled, _ = jscale_to_grid(bx, n_ls, offsets)
    ucoords = (jdedup.active_coords(dedup.active, side) if compacted
               else jnp.asarray(statics.unique_coords))
    coeffs = jbilinear_coeffs(scaled, offsets)
    out["geometry"] = _jprobe(ucoords, coeffs)
    h = ucoords
    for layer in params["hpd"][:-1]:
        h = jax.nn.relu(jnp.matmul(h, layer["w"], precision=mcfg.matmul_precision) + layer["b"])
    out["hidden"] = _jprobe(h, coeffs)
    marginal_raw, vals_u, idx_u = japply_hpd_unique(params["hpd"], ucoords, mcfg,
                                                    counts=dedup.counts)
    out["tail"] = _jprobe(marginal_raw, vals_u, idx_u, coeffs)
    feats_u = jenc.blend_unique(params["tables"], idx_u, vals_u, mcfg)
    feats = jenc.gather_rows(feats_u, dedup.ids, cell_info=cell_info, active=dedup.active,
                             base=dedup.base,
                             cell_corners=dedup.cell_corners if mcfg.dedup_cell_gather else None,
                             pixel_cell=dedup.pixel_cell)
    h_pix = jinterpolate(feats, coeffs)
    out["blend"] = _jprobe(h_pix, marginal_raw)
    rgb = apply_mlp(params["mlp"], h_pix, hidden_activation=mcfg.hidden_activation.value,
                    final_activation="sigmoid", precision=mcfg.matmul_precision)
    out["decoder"] = _jprobe(rgb, marginal_raw)
    prev_coll = jnp.zeros((mcfg.num_levels,), jnp.float32)
    prev_min = jnp.ones((mcfg.num_levels,), jnp.float32)
    marginal = marginal_raw / (bx.shape[0] * mcfg.num_corners)
    out["loss"] = jcompute_loss(rgb, by, None, prev_coll, prev_min, lcfg, mcfg.num_levels,
                                marginals=marginal, valid_rows=nvalid).total
    return out


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    jexp, texp = _exps(request.param)
    data = image_dataset(_image(), "synthetic")
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    params = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    batch = attribution.batch_zero(texp, data, "cpu")
    jbatch = _jax_batch(jexp, data)
    return request.param, jexp, texp, data, jparams, params, batch, jbatch


def test_prefix_probes_match_jax(case):
    _, jexp, texp, _, jparams, params, batch, jbatch = case
    ref = jax.jit(lambda p: _jax_prefixes(jexp, p, *jbatch))(jparams)
    prefix = attribution.make_prefix(texp, params, batch)
    with torch.no_grad():
        for stage in attribution.STAGES:
            got = float(prefix(stage))
            np.testing.assert_allclose(got, float(ref[stage]), rtol=1e-5, err_msg=stage)
    assert attribution.STAGES == JAX_STAGES


def test_last_prefix_is_the_real_loss_bitwise(case):
    _, _, texp, _, _, params, batch, _ = case
    prefix = attribution.make_prefix(texp, params, batch)
    loss = attribution.check_gate(texp, params, batch, prefix)
    with torch.no_grad():
        assert torch.equal(prefix("loss"), attribution.real_loss(texp, params, batch))
    assert np.isfinite(loss)


def test_gate_raises_on_a_drifted_mirror(case):
    _, _, texp, _, _, params, batch, _ = case
    prefix = attribution.make_prefix(texp, params, batch)
    with pytest.raises(RuntimeError, match="diverged"):
        attribution.check_gate(texp, params, batch, lambda s: prefix(s) * (1 + 2 ** -20))


def _ablate_against_jax(jexp, texp, jparams, batch, jbatch):
    """The port's ablation stage probes against JAX's stage programs."""
    statics, bx, by, nvalid, dedup = jbatch
    mcfg = jexp.model
    prev_coll = jnp.zeros((mcfg.num_levels,), jnp.float32)
    prev_min = jnp.ones((mcfg.num_levels,), jnp.float32)

    def loss_fn(p):
        out = jgngf.forward(p, bx, mcfg, statics, train=True, dedup=dedup, need_indices=False)
        return jcompute_loss(out.rgb, by, out.probs, prev_coll, prev_min, jexp.loss,
                             mcfg.num_levels, marginals=out.marginal, valid_rows=nvalid).total

    def floats(tree):   # the port's probe leaves Adam's step counts out
        return [l for l in jax.tree_util.tree_leaves(tree) if jnp.issubdtype(l.dtype, jnp.floating)]

    tx = jmake_optimizer(jexp.optimizer, jparams)

    @jax.jit
    def stages(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, new_state = tx.update(grads, tx.init(p), p)
        update = _jprobe(floats((optax.apply_updates(p, updates), new_state)))
        return dict(fwd=loss, grad=loss + _jprobe(grads), update=update, step=loss + update)

    ref = stages(jparams)

    def programs():
        fresh = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        return ablate_scaled.stage_programs(texp, fresh, batch, make_optimizer(texp.optimizer, fresh))

    got = {name: float(programs()[name]().detach()) for name in ("fwd", "grad", "update", "step")}
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], float(want), rtol=1e-5, err_msg=name)


def test_ablate_stage_probes_match_jax(case):
    _, jexp, texp, _, jparams, _, batch, jbatch = case
    _ablate_against_jax(jexp, texp, jparams, batch, jbatch)


def test_attribution_json_keys_and_rows_sum(tmp_path):
    path = tmp_path / "img.npy"
    np.save(path, _image())
    out = tmp_path / "att.json"
    res = attribution.main(["--mode", "gngf", "--device", "cpu", "--reps", "1",
                            "--image", str(path), "--json-out", str(out)])
    with open(os.path.join(REPO, "evidence", "attribution_scaled_highest.json")) as fh:
        jax_art = json.load(fh)
    with open(out) as fh:
        ours = json.load(fh)
    assert set(jax_art) <= set(ours) and "power_limit_w" in ours
    assert set(jax_art["dims"]) == set(ours["dims"])
    # the committed artifact predates the JAX tool's "noop" row
    assert [r["stage"] for r in ours["rows"]] == [*JAX_STAGES, "optimizer"]
    theirs = {r["stage"]: set(r) for r in jax_art["rows"]}
    for mine in ours["rows"]:
        assert set(mine) == theirs.get(mine["stage"], theirs["loss"]), mine["stage"]
    total = sum(r["d_fwdbwd_ms"] for r in ours["rows"])
    assert total == pytest.approx(ours["step_ms"], rel=1e-9)
    assert res["device_kind"] == "cpu" and ours["power_limit_w"] is None


def _jax_floor_table():
    spec = importlib.util.spec_from_file_location("jax_floor_table",
                                                  os.path.join(REPO, "tools", "floor_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_floors_match_jax_floor_table(capsys):
    with open(os.path.join(REPO, "evidence", "attribution_scaled_highest.json")) as fh:
        att = json.load(fh)
    jax_ft = _jax_floor_table()
    for rate in (1e12, 165e12):
        assert floor_table.floors_ms(att, rate) == jax_ft.floors_ms(att, rate)
    # the card's rates by stage: the kernels' 3xTF32 for the streamed route,
    # cuBLAS's fp32 for the decoder; a TPU's artifact has no peaks here
    att_card = dict(att, device_kind="NVIDIA H100 80GB HBM3")
    rates = floor_table.stage_rates(att_card)
    assert rates == {"hidden": roofline.PEAK_TF32_TENSOR_FLOPS / 3,
                     "tail": roofline.PEAK_TF32_TENSOR_FLOPS / 3,
                     "decoder": roofline.PEAK_FP32_FLOPS}
    fl = floor_table.floors_ms(att_card, rates)
    assert fl["tail"] == jax_ft.floors_ms(att, rates["tail"])["tail"]
    assert floor_table.stage_rates(att) is None
    assert floor_table.main([os.path.join(REPO, "evidence", "attribution_scaled_highest.json")]) == {}
    assert "no peaks" in capsys.readouterr().out


def test_gather_probe_rows_match_numpy():
    x = gather_probe.make_inputs(300, 64, 4, 4, 2, "cpu")
    tab2, flat = x.tables2.numpy(), x.flat.numpy()
    rows_np = tab2[flat]
    np.testing.assert_array_equal(gather_probe.take_rows(x).numpy(), rows_np)
    want = np.einsum("uklf,uk->luf", rows_np.reshape(300, 4, 4, 2), x.w.numpy())
    np.testing.assert_allclose(gather_probe.take_blend(x).numpy(), want, rtol=1e-5, atol=1e-12)
    dt = np.zeros((64, 8), np.float64)
    np.add.at(dt, flat, x.rows.numpy().astype(np.float64))
    assert gather_probe.check_k12(x) == 0.0
    for fn in (gather_probe.scatter_k12, gather_probe.scatter_index_add, gather_probe.scatter_sorted):
        np.testing.assert_allclose(fn(x).numpy(), dt, rtol=1e-5, atol=1e-6, err_msg=fn.__name__)
    np.testing.assert_array_equal(gather_probe.scatter_k12(x).numpy(),
                                  scatter.scatter_add_serial_plain(x.rows, x.flat, 64).numpy())
    w = torch.softmax(x.w, dim=-1).numpy()
    want = np.einsum("uklf,uk->luf", rows_np.reshape(300, 4, 4, 2), w)
    np.testing.assert_allclose(gather_probe.blend_fwd(x).numpy(), want, rtol=1e-5, atol=1e-12)
    d_tables, _ = gather_probe.blend_bwd(x)
    g_rows = (w[:, :, None] * x.g.numpy().transpose(1, 0, 2).reshape(300, 1, 8)).reshape(-1, 8)
    dt2 = np.zeros((64, 8))
    np.add.at(dt2, flat, g_rows)
    np.testing.assert_allclose(d_tables.permute(1, 0, 2).reshape(64, 8).numpy(), dt2,
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def stream_off():
    """The streamed geometry (compacting) with ``dedup_cell_gather`` off in
    both packages: the weights, batch 0 of each."""
    jexp, texp = _exps("stream")
    jexp = dataclasses.replace(jexp, model=dataclasses.replace(jexp.model, dedup_cell_gather=False))
    texp = ablate_scaled.with_cell_gather(texp, False)
    data = image_dataset(_image(), "synthetic")
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    return jexp, texp, jparams, attribution.batch_zero(texp, data, "cpu"), _jax_batch(jexp, data)


def test_cell_gather_ab_probes_match_jax(stream_off):
    """The field-off stage probes of the compacting streamed geometry
    against JAX's field-off programs (the field-on ones are
    test_ablate_stage_probes_match_jax's): the port's one gather holds
    both of JAX's."""
    jexp, texp = stream_off[:2]
    assert stream_off[3].geom.active is not None and stream_off[4][4].cell_corners is None
    assert not texp.model.dedup_cell_gather and not jexp.model.dedup_cell_gather
    _ablate_against_jax(*stream_off)


def test_ablate_cell_gather_runs_both_on_the_cpu(tmp_path):
    """``ablate_scaled --cell-gather`` at the default geometry on a 24 x 20
    image, whose 1/3 batches compact: a run with the field on and one with
    it off, every stage time finite."""
    path = tmp_path / "img.npy"
    np.save(path, _image())
    res = ablate_scaled.main(["--cell-gather", "--device", "cpu", "--reps", "1", "--mode", "gngf",
                              "--image", str(path)])
    assert set(res["cell_gather"]) == {"on", "off"} and res["ms"] == res["cell_gather"]["on"]["ms"]
    for label, run in res["cell_gather"].items():
        assert run["dedup_cell_gather"] == (label == "on")
        assert set(run["ms"]) == {"fwd", "grad", "update", "step"}
        assert all(np.isfinite(v) and v > 0 for v in run["ms"].values())
