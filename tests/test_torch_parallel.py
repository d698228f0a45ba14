"""The port's data parallelism over pixels, tables sharded by slot and
grid sharding across processes (``parallel/``), against the JAX package,
on the CPU.

Each case starts its gloo ranks once (``parallel.launch.spawn``: spawned
processes that meet through a ``FileStore`` under ``tmp_path``, joined
under a timeout of their own) and compares what they return with the JAX
package's epoch in this process, on the same inputs and weights
(``params_from_jax``). The cases mirror ``tests/test_parallel.py``:
DP invariance, TP (1 x 2) and (2 x 2), TP with compacted geometry, TP at
the scaled geometry class (the port's plain tails), plus DP on the per-row
route with BatchNorm and DP + TP on the vanilla route; K12's plain version
with a slot range; the port's two-process smoke.

Tolerances are JAX's own (``tests/test_parallel.py``): losses rtol 2e-5,
every parameter after ``gather_params`` rtol 2e-4 / atol 1e-7; collisions
exactly equal.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
    shard_state_and_batches,
)
from collision_handling_in_instantngp_tpu.train.train_step import (
    build_epoch_batches as jax_build_epoch_batches,
    make_epoch_fn,
)
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import ImageData
from collision_handling_in_instantngp_tpu_torch.ops.cuda.scatter import (
    scatter_add_serial, scatter_add_serial_plain,
)
from collision_handling_in_instantngp_tpu_torch.parallel import launch, train_parallel
from collision_handling_in_instantngp_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 65535
RANK_TIMEOUT = 240


def _tiny_problem(rng, h=8, w=6):
    """tests/test_parallel.py's problem: an (h, w) grid, random targets, a
    random pixel order."""
    img = rng.random((h * w, 3), dtype=np.float32)
    coords = (
        np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1)
        .reshape(-1, 2).astype(np.float32) / (max(h, w) - 1)
    )
    perm = rng.permutation(h * w).astype(np.int32)
    return coords, img, perm


def _random_points(rng, n=192):
    """tests/test_parallel.py's compacted and scaled-class problem."""
    coords = rng.random((n, 2), dtype=np.float32)
    img = rng.random((n, 3), dtype=np.float32)
    perm = rng.permutation(n).astype(np.int32)
    return coords, img, perm


def _data(coords, img):
    og = (img * 255).astype(np.int64)
    return ImageData(coords=coords, targets=img, height=coords.shape[0], width=1,
                     image=og.reshape(-1, 1, img.shape[1]), name="points")


def _exps(kw, jax_only=None, scaled=False):
    """(JAX experiment, port experiment) of grid 4061 with the model's
    fields ``kw`` replaced (``scaled``: ``instantngp_scaled_model(**kw)``),
    as tests/test_parallel.py builds them; ``jax_only``: fields of the JAX
    model alone (its TPU gather layouts, the same function)."""
    jexp = jcfg.experiment_from_grid_id(4061)
    texp = tcfg.experiment_from_grid_id(4061, base_train=tcfg.TrainConfig(save_params=False))
    if scaled:
        jm, tm = jcfg.instantngp_scaled_model(**kw), tcfg.instantngp_scaled_model(**kw)
    else:
        jm, tm = dataclasses.replace(jexp.model, **kw), dataclasses.replace(texp.model, **kw)
    jm = dataclasses.replace(jm, **(jax_only or {}))
    return dataclasses.replace(jexp, model=jm), dataclasses.replace(texp, model=tm)


def _jax_run(jexp, coords, img, perm, epochs, devices=1, geometry=False):
    """The JAX epoch on one CPU device (or sharded over ``devices``): its
    start params (numpy), per-epoch losses and collisions, final params."""
    statics = jgngf.make_statics(jexp.model)
    extra = dict(model_cfg=jexp.model, statics=statics) if geometry else {}
    batches = jax_build_epoch_batches(coords, img, 1 / 3, perm,
                                      og_image=(img * 255).astype(np.int64), **extra)
    init_state, make_jitted = make_epoch_fn(jexp, statics)
    state, tx = init_state(jax.random.PRNGKey(SEED))
    start = jax.tree_util.tree_map(np.asarray, state.params)
    epoch = make_jitted(tx, coords.shape[0])
    if devices > 1:
        state, batches = shard_state_and_batches(state, batches, jax_make_mesh(jax.devices()[:devices]))
    losses, colls = [], []
    for _ in range(epochs):
        state, m, _ = epoch(state, batches)
        losses.append(float(m.loss))
        colls.append(np.asarray(m.collisions).tolist())
    bn = None if state.bn_state is None else jax.tree_util.tree_map(np.asarray, state.bn_state)
    return dict(start=start, losses=losses, collisions=colls,
                params=jax.tree_util.tree_map(np.asarray, state.params), bn_state=bn)


def _spawn(tmp_path, world, model_parallel, texp, coords, img, perm, epochs, start):
    """The port's ranks on the JAX run's batches: the pixels in ``perm``'s
    order, unshuffled."""
    texp = dataclasses.replace(texp, train=dataclasses.replace(texp.train, shuffle_pixels=False))
    spec = dict(exp=texp, data=_data(coords[perm], img[perm]), epochs=epochs,
                model_parallel=model_parallel, shard_tables=model_parallel > 1, device="cpu",
                params=start)
    return launch.spawn(train_parallel.rank_worker, world, (spec,),
                        store_dir=str(tmp_path / "ranks"), device="cpu", timeout=RANK_TIMEOUT,
                        threads=1)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _check_ranks(results, ref, check_collisions=True):
    """Every rank: the reference's losses (rtol 2e-5), every parameter leaf
    (rtol 2e-4, atol 1e-7) and collisions exactly; every rank the same."""
    ref_leaves = dict(_leaves(ref["params"]))
    for r in results:
        losses = [h["loss"] for h in r["history"]]
        np.testing.assert_allclose(losses, ref["losses"], rtol=2e-5, err_msg=f"rank {r['rank']}")
        if check_collisions:
            assert [h["collisions"] for h in r["history"]] == ref["collisions"], r["rank"]
        got = dict(_leaves(r["params"]))
        assert sorted(got) == sorted(ref_leaves)
        for path, a in got.items():
            np.testing.assert_allclose(a, ref_leaves[path], rtol=2e-4, atol=1e-7,
                                       err_msg=f"rank {r['rank']} param {path}")
    first = [h["loss"] for h in results[0]["history"]]
    assert all([h["loss"] for h in r["history"]] == first for r in results)


# ------------------------------- the mesh ----------------------------------- #

@pytest.mark.parametrize("mp", [1, 2, 4])
def test_mesh_coords_are_jax_device_grid(mp):
    """Rank r sits where the JAX mesh of 8 devices puts device r."""
    devices = jax.devices()
    assert len(devices) == 8
    grid = jax_make_mesh(devices, model_parallel=mp).devices
    assert grid.shape == (8 // mp, mp)
    for i, row in enumerate(grid):
        for j, d in enumerate(row):
            assert tmesh.mesh_coords(devices.index(d), mp) == (i, j)


def test_make_mesh_raises_as_jax(tmp_path):
    """World 1 in a one-process gloo group: (1, 1), the whole batch and
    every slot; model_parallel that does not divide the world raises JAX's
    ValueError."""
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(jax.devices()[:1], model_parallel=3)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        tmesh.initialize_distributed(device="cpu")      # idempotent: the group stays
        m = tmesh.make_mesh(device="cpu")
        assert (m.shape, m.data_index, m.model_index) == ((1, 1), 0, 0)
        assert tmesh.batch_rows(16, m) == (0, 16) and tmesh.slot_range(256, m) == (0, 256)
        with pytest.raises(ValueError) as err:
            tmesh.make_mesh(model_parallel=3, device="cpu")
        assert str(err.value) == str(jerr.value)
    finally:
        dist.destroy_process_group()


def test_shares_raise_where_they_do_not_divide():
    m = tmesh.Mesh(rank=3, world_size=4, data=2, model=2, data_index=1, model_index=1,
                   data_group=None, model_group=None, device=torch.device("cpu"))
    assert tmesh.batch_rows(16, m) == (8, 16) and tmesh.slot_range(256, m) == (128, 256)
    with pytest.raises(ValueError, match="batch"):
        tmesh.batch_rows(15, m)
    with pytest.raises(ValueError, match="slots"):
        tmesh.slot_range(255, m)


# ---------------------------- DP and TP runs -------------------------------- #

def test_dp_invariance(tmp_path):
    """Two ranks over the pixels of tests/test_parallel.py's problem: the
    JAX single-device losses and JAX's own 2-device sharded epoch (rtol
    2e-5), the same parameters and collisions."""
    coords, img, perm = _tiny_problem(np.random.default_rng(SEED))
    jexp, texp = _exps({})
    ref = _jax_run(jexp, coords, img, perm, 3)
    ref2 = _jax_run(jexp, coords, img, perm, 3, devices=2)
    np.testing.assert_allclose(ref2["losses"], ref["losses"], rtol=2e-5)
    results = _spawn(tmp_path, 2, 1, texp, coords, img, perm, 3, ref["start"])
    _check_ranks(results, ref)
    for r in results:
        np.testing.assert_allclose([h["loss"] for h in r["history"]], ref2["losses"], rtol=2e-5)
        assert r["mesh"] == [2, 1] and r["coords"] == [r["rank"], 0]
        assert r["history"][0]["collective_calls"] > 0


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_table_tp_matches_replicated(tmp_path, world):
    """Tables sharded by slot over 2 ranks of the model axis, (1 x 2) and
    (2 x 2): the unsharded JAX run's losses, every parameter (the tables
    gathered) and collisions; the ranks' places and groups are the JAX
    grid's."""
    coords, img, perm = _tiny_problem(np.random.default_rng(SEED))
    jexp, texp = _exps({})
    ref = _jax_run(jexp, coords, img, perm, 3)
    results = _spawn(tmp_path, world, 2, texp, coords, img, perm, 3, ref["start"])
    _check_ranks(results, ref)
    grid = jax_make_mesh(jax.devices()[:world], model_parallel=2).devices
    ids = np.vectorize(lambda d: jax.devices().index(d))(grid)
    for r in results:
        i, j = r["coords"]
        assert ids[i, j] == r["rank"]
        assert r["data_group_ranks"] == ids[:, j].tolist()
        assert r["model_group_ranks"] == ids[i, :].tolist()


def test_tp_with_compacted_geometry(tmp_path):
    """tests/test_parallel.py's compacted dedup geometry (T = 64, fused_hpd
    off) on a (2 x 2) mesh: each rank compacts its own rows' vertices."""
    jexp, texp = _exps(dict(hash_table_size=64, hpd_hidden=(8, 16), mlp_hidden=(16,), topk_k=3,
                            fused_hpd=False, n_max=16), jax_only=dict(dedup_cell_gather=True))
    coords, img, perm = _random_points(np.random.default_rng(SEED))
    ref = _jax_run(jexp, coords, img, perm, 2, geometry=True)
    results = _spawn(tmp_path, 4, 2, texp, coords, img, perm, 2, ref["start"])
    _check_ranks(results, ref)


def test_tp_scaled_shapes(tmp_path):
    """The scaled geometry class (T = 2^12, L = 4, n = 8..16, the streamed
    tail: the port's plain K1-K3, JAX's lax.scan tail) on a (1 x 2) mesh."""
    jexp, texp = _exps(dict(hash_table_size=2**12, num_levels=4, n_min=8, n_max=16,
                            hpd_backend="unique_stream"), scaled=True)
    coords, img, perm = _random_points(np.random.default_rng(SEED))
    ref = _jax_run(jexp, coords, img, perm, 2, geometry=True)
    results = _spawn(tmp_path, 2, 2, texp, coords, img, perm, 2, ref["start"])
    _check_ranks(results, ref)


def test_dp_per_row_batchnorm(tmp_path):
    """Two ranks on the per-row route with the input BatchNorm (raw
    coordinates): the statistics are the whole batch's, the running ones
    JAX's."""
    coords, img, perm = _tiny_problem(np.random.default_rng(SEED))
    raw = coords * 7.0
    jexp, texp = _exps(dict(batchnorm_input=True))
    ref = _jax_run(jexp, raw, img, perm, 3)
    results = _spawn(tmp_path, 2, 1, texp, raw, img, perm, 3, ref["start"])
    _check_ranks(results, ref)
    for r in results:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["bn_state"][k], ref["bn_state"][k], rtol=1e-6)


def test_dp_tp_vanilla(tmp_path):
    """The vanilla hash on a (2 x 2) mesh: tables sharded by slot, pixels
    over the data axis; collisions from every rank's hash ids."""
    coords, img, perm = _tiny_problem(np.random.default_rng(SEED))
    jexp, texp = _exps(dict(use_hash_function=True))
    ref = _jax_run(jexp, coords, img, perm, 3)
    results = _spawn(tmp_path, 4, 2, texp, coords, img, perm, 3, ref["start"])
    _check_ranks(results, ref)


def test_rank_failure_fails_the_spawn(tmp_path):
    """A rank that raises fails the whole call with its traceback."""
    coords, img, perm = _tiny_problem(np.random.default_rng(SEED))
    spec = dict(exp=_exps({})[1], data=_data(coords, img), epochs=1, model_parallel=3,
                device="cpu")
    with pytest.raises(RuntimeError, match="not divisible by model_parallel=3"):
        launch.spawn(train_parallel.rank_worker, 2, (spec,), store_dir=str(tmp_path / "r"),
                     device="cpu", timeout=RANK_TIMEOUT, threads=1)


# ------------------------------ K12's range --------------------------------- #

@pytest.mark.parametrize("slot_range", [(0, 64), (64, 128), (17, 90), (40, 40), (0, 128)])
def test_scatter_plain_slot_range_is_rows_of_the_whole(slot_range):
    """K12's plain version over a slot range is rows [lo, hi) of the whole
    scatter, bitwise (each slot's rows in row order)."""
    g = torch.Generator().manual_seed(SEED)
    idx = torch.randint(0, 128, (5000,), generator=g)
    idx[:300] = 77                                                 # a hot slot
    rows = torch.randn(5000, 32, generator=g)
    whole = scatter_add_serial_plain(rows, idx, 128)
    lo, hi = slot_range
    got = scatter_add_serial(rows, idx, 128, slot_range=slot_range)
    assert got.shape == (hi - lo, 32)
    assert torch.equal(got, whole[lo:hi])


def test_scatter_slot_range_raises():
    rows, idx = torch.zeros(4, 2), torch.tensor([0, 1, 2, 9])
    with pytest.raises(ValueError, match="outside"):
        scatter_add_serial_plain(rows, idx, 8, slot_range=(0, 4))
    with pytest.raises(ValueError, match="slot range"):
        scatter_add_serial_plain(rows, idx.clamp(max=7), 8, slot_range=(4, 9))


# --------------------------- several processes ----------------------------- #

def test_two_process_smoke():
    """The port's tools/multihost_smoke.py: two gloo processes, a DP epoch
    equal to the single-process run, and run_grid_search(shard_index=None)
    over 4060-4063 split [4060, 4062] | [4061, 4063]."""
    proc = subprocess.run(
        [sys.executable, "-m", "collision_handling_in_instantngp_tpu_torch.tools.multihost_smoke",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MULTIHOST SMOKE OK" in proc.stdout, proc.stdout[-2000:]
    assert "[4060, 4062] | [4061, 4063]" in proc.stdout
