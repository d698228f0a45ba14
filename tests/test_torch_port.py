"""The port's modules on the CPU against the JAX package, one function at a
time, plus the port's own contracts: import hygiene, routing of the stream
branch to the kernel wrappers, device selection, the image asset, weight
transfer and initialization.

Tolerances: exact where both sides do the same integer/geometry work;
rtol 1e-6 / atol 1e-7 for fp32 elementwise math; rtol 1e-5 / atol 1e-6 for
reductions whose summation order differs.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import load_image as jax_load_image
from collision_handling_in_instantngp_tpu.data import load_image_dataset as jax_load_dataset
from collision_handling_in_instantngp_tpu.data import make_shuffle_permutations as jax_perms
from collision_handling_in_instantngp_tpu.models import encoding as jenc
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.ops import collisions as jcoll
from collision_handling_in_instantngp_tpu.ops import dedup as jdedup
from collision_handling_in_instantngp_tpu.ops import grid as jgrid
from collision_handling_in_instantngp_tpu.ops import interpolate as jinterp
from collision_handling_in_instantngp_tpu.ops.topk import differentiable_topk as jax_topk
from collision_handling_in_instantngp_tpu.train import loss as jloss
from collision_handling_in_instantngp_tpu.train.optimizer import make_optimizer as jax_optimizer
from collision_handling_in_instantngp_tpu_torch import cli, config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import (
    image_dataset, load_image, load_image_dataset, make_shuffle_permutations,
)
from collision_handling_in_instantngp_tpu_torch.device import resolve_device
from collision_handling_in_instantngp_tpu_torch.models import encoding, gngf, hpd
from collision_handling_in_instantngp_tpu_torch.ops import collisions, dedup, grid, interpolate
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream
from collision_handling_in_instantngp_tpu_torch.ops.topk import differentiable_topk
from collision_handling_in_instantngp_tpu_torch.train import loss
from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "collision_handling_in_instantngp_tpu_torch"
FP = dict(rtol=1e-6, atol=1e-7)
RED = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_port_imports_no_jax():
    """Every module of the port imports without jax or the JAX package."""
    mods = []
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'collision_handling_in_instantngp_tpu' "
        "or m.startswith('collision_handling_in_instantngp_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 25


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "collision_handling_in_instantngp_tpu." not in src


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_stream_branch_routes_to_kernel_wrappers(monkeypatch):
    """On CPU tensors the stream branch runs the plain versions; when the
    device check says "card", it calls the kernel launchers instead."""
    cfg = tcfg.ModelConfig(hash_table_size=256, num_levels=2, n_min=4, n_max=8,
                           hpd_backend="unique_stream", topk_k=2)
    params = gngf.init_params(cfg, 0)
    x = _t(dedup.unique_vertex_coords(cfg.n_max))
    counts = torch.ones(cfg.num_levels, x.shape[0])
    calls = []

    def launch_fwd(h, w, b, c, k, precision):
        calls.append("tail_fwd")
        return hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, c, k, precision)

    def launch_bwd(*args):
        calls.append("tail_bwd")
        return hpd_stream.hpd_stream_fused_bwd_plain(*args)

    def launch_hfwd(x_, layers, precision):
        calls.append("hidden_fwd")
        return hidden.hidden_stack_fwd_plain(x_, layers, precision)

    def launch_hbwd(x_, layers, gh, precision):
        calls.append("hidden_bwd")
        return hidden.hidden_stack_bwd_plain(x_, layers, gh, precision)

    def run():
        marg, vals, _ = hpd.apply_hpd_unique(params.hpd, x, cfg, counts)
        (marg.sum() + vals.sum()).backward()

    monkeypatch.setattr(hpd_stream, "_launch_fwd", launch_fwd)
    monkeypatch.setattr(hpd_stream, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(hidden, "_launch_fwd", launch_hfwd)
    monkeypatch.setattr(hidden, "_launch_bwd", launch_hbwd)
    run()
    assert calls == []                                  # CPU tensors: plain versions
    monkeypatch.setattr(hpd_stream, "_on_card", lambda t: True)
    monkeypatch.setattr(hidden, "_on_card", lambda t: True)
    run()
    assert sorted(calls) == ["hidden_bwd", "hidden_fwd", "tail_bwd", "tail_fwd"]


def test_stream_branch_refuses_unported_options():
    """K > 16 and a recall target run on the stream branch (the chunked
    tail); the vanilla hash, not ported yet, still raises, naming its
    ROADMAP item."""
    cfg = tcfg.ModelConfig(hash_table_size=256, num_levels=2, n_min=4, n_max=8,
                           hpd_backend="unique_stream", topk_k=20)
    params = gngf.init_params(cfg, 0)
    x = _t(dedup.unique_vertex_coords(cfg.n_max))
    counts = torch.ones(cfg.num_levels, x.shape[0])
    for run_cfg in (cfg, dataclasses.replace(cfg, topk_k=4, topk_approx_recall=0.95)):
        assert hpd.unique_tail_backend(run_cfg, cfg.hash_table_size, run_cfg.topk_k, 64) == "jax"
        marg, vals, idx = hpd.apply_hpd_unique(params.hpd, x, run_cfg, counts)
        assert marg.shape == (cfg.num_levels, cfg.hash_table_size)
        assert vals.shape == idx.shape == (x.shape[0], run_cfg.topk_k)
        assert torch.isfinite(marg).all() and torch.isfinite(vals).all()
    with pytest.raises(NotImplementedError, match="Vanilla hash"):
        gngf.forward(params, torch.rand(8, 2), dataclasses.replace(cfg, use_hash_function=True),
                     gngf.make_statics(cfg))


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    data = image_dataset(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit(tcfg.experiment_from_grid_id(4061), data, epochs=1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_on_cpu(tmp_path, capsys):
    img = np.random.default_rng(0).integers(0, 256, size=(12, 10, 3)).astype(np.uint8)
    np.save(tmp_path / "tiny.npy", img)
    rc = cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", "4061",
                   "-e", "4062", "--epochs", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "grid 4061: best PSNR" in out and "grid 4062: best PSNR" in out


def test_grid_configs_match_jax():
    assert tcfg.get_grid_search_configs() == jcfg.get_grid_search_configs()
    for gid in (0, 4061, 3761, 47999):
        j = dataclasses.asdict(jcfg.experiment_from_grid_id(gid))
        t = dataclasses.asdict(tcfg.experiment_from_grid_id(gid))
        for group in ("loss", "optimizer"):
            assert t[group] == j[group], (gid, group)
        assert_model_fields_match(t["model"], j["model"])
        tt = dict(t["train"])
        jt = {k: v for k, v in j["train"].items() if k in tt}
        assert tt == jt, gid
    assert_model_fields_match(dataclasses.asdict(tcfg.instantngp_scaled_model()),
                              dataclasses.asdict(jcfg.instantngp_scaled_model()))


def assert_model_fields_match(t: dict, j: dict) -> None:
    """Every field of the port's ModelConfig equals the JAX one; the JAX
    config has only the TPU gather-layout field the port leaves out."""
    norm = lambda d: {k: (v.value if hasattr(v, "value") else v) for k, v in d.items()}
    assert set(j) - set(t) == {"dedup_cell_gather"}
    assert norm(t) == {k: v for k, v in norm(j).items() if k in t}


def test_strawberry_npy_equals_jax_decode():
    npy = load_image(os.path.join(REPO, "images", "strawberry.npy"))
    ref = jax_load_image(os.path.join(REPO, "images", "strawberry.jpeg"))
    assert npy.dtype == np.uint8 and npy.shape == (508, 339, 3)
    np.testing.assert_array_equal(npy, ref)


def test_dataset_and_permutations_match_jax():
    path = os.path.join(REPO, "images", "strawberry.jpeg")
    t = load_image_dataset(path)
    j = jax_load_dataset(path)
    np.testing.assert_array_equal(t.coords, j.coords)
    np.testing.assert_array_equal(t.targets, j.targets)
    np.testing.assert_array_equal(t.image, j.image)
    for a, b in zip(make_shuffle_permutations(1000, 65535), jax_perms(1000, 65535)):
        np.testing.assert_array_equal(a, b)


def test_npy_loader_rejects_wrong_dtype(tmp_path):
    np.save(tmp_path / "f.npy", np.zeros((3, 3, 3), np.float32))
    with pytest.raises(ValueError):
        load_image(str(tmp_path / "f.npy"))
    with pytest.raises(FileNotFoundError):
        load_image(str(tmp_path / "missing.npy"))


def test_params_roundtrip_from_jax():
    cfg = jcfg.instantngp_scaled_model(hash_table_size=2048, num_levels=4)
    jp = jax.tree_util.tree_map(np.asarray, jgngf.init_params(jax.random.PRNGKey(3), cfg))
    tp = gngf.params_from_jax(jp)
    back = gngf.params_to_numpy(tp)
    np.testing.assert_array_equal(back["tables"], jp["tables"])
    for group in ("hpd", "mlp"):
        assert len(back[group]) == len(jp[group])
        for a, b in zip(back[group], jp[group]):
            np.testing.assert_array_equal(a["w"], b["w"])
            np.testing.assert_array_equal(a["b"], b["b"])
    assert tp.hpd.weights[-1].shape == (128, 2048)        # (in, out): head read as (H, T)


def test_init_matches_torch_linear_distribution():
    cfg = tcfg.instantngp_scaled_model()
    p = gngf.init_params(cfg, 65535)
    for mlp in (p.hpd, p.mlp):
        for w, b in mlp.layers():
            bound = 1.0 / np.sqrt(w.shape[0])
            assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
            assert b.abs().max() <= bound
    head = p.hpd.weights[-1].detach().numpy().ravel()
    np.testing.assert_allclose(head.var(), (1 / 128) / 3, rtol=0.02)
    tab = p.tables.detach().numpy().ravel()
    assert np.abs(tab).max() <= 1e-4
    np.testing.assert_allclose(tab.var(), (1e-4) ** 2 / 3, rtol=0.02)
    torch.manual_seed(0)
    ref = torch.nn.Linear(128, 2048).weight.detach().numpy().ravel()
    np.testing.assert_allclose(head.var(), ref.var(), rtol=0.03)
    q = gngf.init_params(cfg, 65535)
    assert torch.equal(p.tables, q.tables)                # a seed fixes the weights


@pytest.mark.parametrize("n_min,n_max,levels", [(8, 32, 4), (16, 512, 16)])
def test_geometry_matches_jax(n_min, n_max, levels):
    n_t = grid.resolution_ladder(n_min, n_max, levels)
    np.testing.assert_array_equal(n_t, jgrid.resolution_ladder(n_min, n_max, levels))
    off = grid.voxel_corner_offsets(2)
    np.testing.assert_array_equal(off, jgrid.voxel_corner_offsets(2))
    x = np.random.default_rng(1).random((64, 2), dtype=np.float32)
    s_t, c_t = grid.scale_to_grid(_t(x), _t(n_t), _t(off))
    s_j, c_j = jgrid.scale_to_grid(jnp.asarray(x), jnp.asarray(n_t), jnp.asarray(off))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    co_t = interpolate.bilinear_coeffs(s_t, _t(off))
    co_j = jinterp.bilinear_coeffs(s_j, jnp.asarray(off))
    np.testing.assert_allclose(co_t.numpy(), np.asarray(co_j), **FP)
    feats = np.random.default_rng(2).standard_normal((64, levels, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(interpolate.interpolate(_t(feats), co_t).numpy(),
                               np.asarray(jinterp.interpolate(jnp.asarray(feats), co_j)), **FP)


def test_dedup_geometry_matches_jax():
    cfg = jcfg.instantngp_scaled_model(n_max=64, num_levels=6)
    st = jgngf.make_statics(cfg)
    x = np.random.default_rng(4).random((500, 2), dtype=np.float32)
    ids_t, counts_t = dedup.build_geometry_np(x, st.n_ls, st.offsets, cfg.n_max)
    ids_j, counts_j = jdedup.build_geometry_np(x, st.n_ls, st.offsets, cfg.n_max)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(counts_t, counts_j)
    u_c = -(-np.unique(ids_t).size // 256) * 256
    for a, b in zip(dedup.compact_geometry_np(ids_t, 6, u_c), jdedup.compact_geometry_np(ids_j, 6, u_c)):
        np.testing.assert_array_equal(a, b)
    active = dedup.compact_geometry_np(ids_t, 6, u_c)[0]
    np.testing.assert_array_equal(
        dedup.active_coords(_t(active).long(), 66).numpy(),
        np.asarray(jdedup.active_coords(jnp.asarray(active), 66)),
    )
    np.testing.assert_array_equal(dedup.unique_vertex_coords(64), jdedup.unique_vertex_coords(64))
    # device-side ids/counts (no precomputed geometry) equal the host ones
    n_ls, off = _t(st.n_ls), _t(st.offsets)
    _, corners = grid.scale_to_grid(_t(x), n_ls, off)
    ids_dev = dedup.vertex_ids(corners, 66)
    np.testing.assert_array_equal(ids_dev.numpy(), ids_t)
    np.testing.assert_array_equal(dedup.counts_torch(ids_dev, 6, 66 * 66).numpy(), counts_t)


def test_presence_and_collisions_match_jax():
    rng = np.random.default_rng(5)
    u, k, t, l = 300, 4, 512, 3
    idx = np.stack([rng.permutation(t)[:k] for _ in range(u)]).astype(np.int32)
    counts = (rng.random((l, u)) < 0.3).astype(np.float32) * rng.integers(1, 4, (l, u))
    pres_t = dedup.used_slot_presence(_t(idx), _t(counts), t)
    pres_j = jdedup.used_slot_presence(jnp.asarray(idx), jnp.asarray(counts), t)
    np.testing.assert_array_equal(pres_t.numpy(), np.asarray(pres_j))
    n_ls = np.array([4, 8, 12], np.int32)
    np.testing.assert_array_equal(
        dedup.collisions_from_presence(pres_t, _t(n_ls)).numpy(),
        np.asarray(jdedup.collisions_from_presence(pres_j, jnp.asarray(n_ls))),
    )
    n_ls = np.array([8, 12, 20, 32], np.int32)
    np.testing.assert_array_equal(collisions.min_possible_collisions(_t(n_ls), 256).numpy(),
                                  [0, 0, 185, 833])
    np.testing.assert_array_equal(collisions.min_possible_collisions(_t(n_ls), 256).numpy(),
                                  np.asarray(jcoll.min_possible_collisions(jnp.asarray(n_ls), 256)))


@pytest.mark.parametrize("blend", list(tcfg.TopkBlendMode))
def test_blend_and_gather_match_jax(blend):
    rng = np.random.default_rng(6)
    l, t, f, u, k, p = 3, 64, 2, 40, 4, 25
    tables = rng.standard_normal((l, t, f)).astype(np.float32)
    idx = np.stack([rng.permutation(t)[:k] for _ in range(u)]).astype(np.int32)
    vals = rng.random((u, k)).astype(np.float32) + 0.1
    ids = rng.integers(0, u, size=(p, l, 4)).astype(np.int32)
    gout = rng.standard_normal((p, l, 4, f)).astype(np.float32)
    tcfg_ = tcfg.ModelConfig(topk_blend=blend)
    jcfg_ = jcfg.ModelConfig(topk_blend=jcfg.TopkBlendMode(blend.value))

    def jax_fn(tab, v):
        return jnp.sum(jenc.gather_rows(jenc.blend_unique(tab, jnp.asarray(idx), v, jcfg_),
                                        jnp.asarray(ids)) * gout)

    val_j, (gt_j, gv_j) = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(tables), jnp.asarray(vals))
    tt, tv = _t(tables).requires_grad_(), _t(vals).requires_grad_()
    out = encoding.gather_rows(encoding.blend_unique(tt, _t(idx), tv, tcfg_), _t(ids))
    val_t = (out * _t(gout)).sum()
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), **RED)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), **RED)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv_j), **RED)


def test_dense_topk_matches_jax_with_ties():
    """Straight-through top-k: lowest index first on exact ties, gradient
    scattered to the selected slots (NOOP: none)."""
    x = np.array([[0.1, 0.5, 0.5, 0.2, 0.5], [0.3, 0.3, 0.3, 0.3, 0.3]], np.float32)
    g = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    vj, ij = jax_topk(jnp.asarray(x), 3, 5)
    xt = _t(x).requires_grad_()
    vt, it = differentiable_topk(xt, 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy(), [[1, 2, 4], [0, 1, 2]])
    (vt * _t(g)).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jax_topk(a, 3, 5)[0] * g))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    xt.grad = None
    (differentiable_topk(xt, 3, True)[0] * _t(g)).sum().backward()
    assert (xt.grad == 0).all()


def test_loss_matches_jax():
    rng = np.random.default_rng(7)
    pred = rng.random((30, 3)).astype(np.float32)
    target = rng.random((30, 3)).astype(np.float32)
    marg = rng.random((4, 64)).astype(np.float32) + 0.01
    marg /= marg.sum(1, keepdims=True)
    coll = rng.random(4).astype(np.float32) * 100
    minp = np.array([0, 0, 185, 833], np.float32)
    cfg = jcfg.LossConfig(gamma=-2.0, epsilon=1.0, l_mse=10.0, l_js_kl=1.0, l_collisions=1e-3)
    tl = tcfg.LossConfig(**dataclasses.asdict(cfg))

    def jf(p, m):
        aux = jloss.compute_loss(p, jnp.asarray(target), None, jnp.asarray(coll), jnp.asarray(minp),
                                 cfg, 4, marginals=m, valid_rows=27)
        return aux.total, aux

    (tot_j, aux_j), (gp_j, gm_j) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pred), jnp.asarray(marg))
    tp, tm = _t(pred).requires_grad_(), _t(marg).requires_grad_()
    aux_t = loss.compute_loss(tp, _t(target), tm, _t(coll), _t(minp), tl, valid_rows=27)
    aux_t.total.backward()
    np.testing.assert_allclose(aux_t.total.item(), float(tot_j), **RED)
    np.testing.assert_allclose(aux_t.js_kl_per_level.detach().numpy(), np.asarray(aux_j.js_kl_per_level), **RED)
    np.testing.assert_allclose(aux_t.coll_per_level.numpy(), np.asarray(aux_j.coll_per_level), **FP)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp_j), **RED)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(gm_j), **RED)
    assert not aux_t.coll_per_level.requires_grad


def test_adam_steps_match_optax():
    """Three-group Adam with L2 weight decay: 3 steps of torch.optim.Adam vs
    the JAX package's optax chain on the same gradients."""
    cfg = jcfg.ModelConfig(hash_table_size=64, mlp_hidden=(8,), hpd_hidden=(8, 16))
    jp = jgngf.init_params(jax.random.PRNGKey(0), cfg)
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ocfg = jcfg.OptimizerConfig(mlp_lr=1e-3, hpd_lr=1e-4)
    tx = jax_optimizer(ocfg, jp)
    state = tx.init(jp)
    topt = make_optimizer(tcfg.OptimizerConfig(**dataclasses.asdict(ocfg)), tp)
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        upd, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        tgrads = gngf.params_from_jax(grads)
        for p, g in zip(tp.parameters(), tgrads.parameters()):
            p.grad = g.detach().clone()
        topt.step()
    back = gngf.params_to_numpy(tp)
    jn = jax.tree_util.tree_map(np.asarray, jp)
    np.testing.assert_allclose(back["tables"], jn["tables"], rtol=1e-5, atol=1e-9)
    for group in ("hpd", "mlp"):
        for a, b in zip(back[group], jn[group]):
            np.testing.assert_allclose(a["w"], b["w"], rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(a["b"], b["b"], rtol=1e-5, atol=1e-8)


def test_forward_without_precomputed_geometry_matches_jax():
    """gngf.forward deriving ids/counts on the device (dedup=None) equals
    the JAX forward on the same weights."""
    cfg = jcfg.ModelConfig(hash_table_size=64, mlp_hidden=(16,), hpd_hidden=(8, 16))
    jp = jgngf.init_params(jax.random.PRNGKey(9), cfg)
    x = np.random.default_rng(9).random((400, 2), dtype=np.float32)
    out_j = jgngf.forward(jp, jnp.asarray(x), cfg, jgngf.make_statics(cfg))
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    tc = tcfg.ModelConfig(hash_table_size=64, mlp_hidden=(16,), hpd_hidden=(8, 16))
    out_t = gngf.forward(tp, _t(x), tc, gngf.make_statics(tc))
    np.testing.assert_allclose(out_t.rgb.detach().numpy(), np.asarray(out_j.rgb), **RED)
    np.testing.assert_allclose(out_t.marginal.detach().numpy(), np.asarray(out_j.marginal), **RED)
