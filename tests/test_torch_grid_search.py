"""The port's grid driver against the JAX package's, on the CPU.

Both drivers sweep grid ids 0-2 (K = 1, 4, 20) of a tiny model
(T = 32, HPD [2 -> 8 -> 32], decoder [8 -> 8 -> 3]) on the same seeded
8 x 6 image for 2 epochs, from the same weights: the port's
``gngf.init_params`` is replaced by the JAX init carried over with
``params_from_jax``. The manifest rows must agree: ``grid_id``, ``image``,
``epochs_run``, ``stopped_early``, ``zero_collision_abort`` and ``run_dir``
equal, ``best_psnr`` and ``final_psnr`` equal (PSNR comes from the truncated
integer image), ``final_loss`` rtol 1e-5 (the slice tests' tolerances,
``tests/test_torch_slice.py``). The bookkeeping (resume, id lists,
shards, bounds) runs with ``fit`` replaced in both packages, so each id
costs nothing.
"""

import dataclasses
import enum
import json
import sys
import types

import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train import grid_search as jgs
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.train import grid_search as tgs
from collision_handling_in_instantngp_tpu_torch.train import trainer

SMALL = dict(hash_table_size=32, hpd_hidden=(8,), mlp_hidden=(8,))
IDS = [0, 1, 2]
ROW_KEYS = ["grid_id", "image", "best_psnr", "final_psnr", "final_loss", "epochs_run",
            "stopped_early", "zero_collision_abort", "run_dir"]


def _data():
    img = np.random.default_rng(65535).integers(0, 256, size=(8, 6, 3)).astype(np.uint8)
    data = image_dataset(img, "tiny.png")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    return data, jdata


def jax_model(cfg: tcfg.ModelConfig) -> jcfg.ModelConfig:
    """The JAX package's ModelConfig of the same fields (enums by value)."""
    base = jcfg.ModelConfig()
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = type(getattr(base, f.name))(v.value) if isinstance(v, enum.Enum) else v
    return jcfg.ModelConfig(**kw)


def _jax_init(cfg, seed, device="cpu"):
    jp = jgngf.init_params(jax.random.PRNGKey(seed), jax_model(cfg))
    return gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both drivers over IDS, each into its own manifest."""
    out = tmp_path_factory.mktemp("sweeps")
    data, jdata = _data()
    jman, tman = str(out / "jax.jsonl"), str(out / "torch.jsonl")
    jrows = jgs.run_grid_search(
        jdata, 0, 3, base_model=jcfg.ModelConfig(**SMALL),
        base_train=jcfg.TrainConfig(save_params=False), epochs=2, manifest_path=jman,
        verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gngf, "init_params", _jax_init)
        trows = tgs.run_grid_search(
            data, 0, 3, base_model=tcfg.ModelConfig(**SMALL),
            base_train=tcfg.TrainConfig(save_params=False), epochs=2, manifest_path=tman,
            verbose=False, device="cpu")
    return data, jdata, jrows, trows, jman, tman


def test_driver_rows_match_jax(sweeps):
    _, _, jrows, trows, jman, tman = sweeps
    assert [r["grid_id"] for r in trows] == [r["grid_id"] for r in jrows] == IDS
    for j, t in zip(jrows, trows):
        assert list(t) == list(j) == ROW_KEYS
        for k in ("grid_id", "image", "epochs_run", "stopped_early", "zero_collision_abort",
                  "run_dir", "best_psnr", "final_psnr"):
            assert t[k] == j[k], (t["grid_id"], k, t[k], j[k])
            assert type(t[k]) is type(j[k]), k
        np.testing.assert_allclose(t["final_loss"], j["final_loss"], rtol=1e-5)
    # the manifests hold the returned rows, one line each
    assert list(tgs.load_manifest(tman).values()) == trows
    assert list(jgs.load_manifest(jman).values()) == jrows


def test_manifest_lines_are_byte_compatible(tmp_path):
    row = {"grid_id": 7, "image": "strawberry.npy", "best_psnr": 21.123456789012345,
           "final_psnr": 20.5, "final_loss": 0.0123, "epochs_run": 5000, "stopped_early": False,
           "zero_collision_abort": True, "run_dir": None}
    tgs.append_manifest(str(tmp_path / "t" / "m.jsonl"), row)
    jgs.append_manifest(str(tmp_path / "j" / "m.jsonl"), row)
    tbytes = (tmp_path / "t" / "m.jsonl").read_bytes()
    assert tbytes == (tmp_path / "j" / "m.jsonl").read_bytes()
    assert tgs.load_manifest(str(tmp_path / "j" / "m.jsonl")) == {7: row}
    assert jgs.load_manifest(str(tmp_path / "t" / "m.jsonl")) == {7: row}


def _no_fit(*a, **kw):
    raise AssertionError("a manifest id was trained again")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_replays_the_other_packages_manifest(sweeps, monkeypatch, tmp_path, writer):
    """Each driver, given the other's manifest, trains nothing and returns
    the stored rows; an id outside it is trained and appended."""
    data, jdata, jrows, trows, jman, tman = sweeps
    src, rows = (jman, jrows) if writer == "jax" else (tman, trows)
    path = tmp_path / "m.jsonl"
    path.write_bytes(open(src, "rb").read())
    monkeypatch.setattr(trainer, "fit", _no_fit)
    monkeypatch.setattr(jgs, "fit", _no_fit)
    assert tgs.run_grid_search(data, 0, 3, manifest_path=str(path), verbose=False,
                               device="cpu") == rows
    assert jgs.run_grid_search(jdata, 0, 3, manifest_path=str(path), verbose=False) == rows
    calls = []
    monkeypatch.setattr(trainer, "fit", _fake_fit(calls))
    out = tgs.run_grid_search(data, ids=[2, 4061, 0], manifest_path=str(path), verbose=False,
                              device="cpu")
    assert calls == [4061] and [r["grid_id"] for r in out] == [2, 4061, 0]
    assert out[0] == rows[2] and out[2] == rows[0]
    assert list(tgs.load_manifest(str(path))) == [0, 1, 2, 4061]


def _fake_fit(calls):
    def fit(exp, data, **kw):
        calls.append(exp.grid_id)
        return trainer.FitResult(float(exp.grid_id), 1.0, 0.5, 2, False, False, None, None, [])
    return fit


def _jax_fake_fit(calls):
    def fit(exp, data, **kw):
        calls.append(exp.grid_id)
        return types.SimpleNamespace(best_psnr=float(exp.grid_id), final_psnr=1.0, final_loss=0.5,
                                     epochs_run=2, stopped_early=False,
                                     zero_collision_abort=False, run_dir=None)
    return fit


def _both(monkeypatch, **kw):
    """(port ids trained, JAX ids trained) of one call of each driver with
    ``fit`` replaced; a ValueError's message stands in for the ids."""
    data, jdata = _data()
    out = []
    for run, d, target, fake in ((tgs.run_grid_search, data, trainer, _fake_fit),
                                 (jgs.run_grid_search, jdata, jgs, _jax_fake_fit)):
        calls = []
        monkeypatch.setattr(target, "fit", fake(calls))
        extra = {"device": "cpu"} if run is tgs.run_grid_search else {}
        try:
            rows = run(d, manifest_path=None, verbose=False, **kw, **extra)
            assert [r["grid_id"] for r in rows] == calls
            out.append(calls)
        except ValueError as e:
            out.append(str(e))
    return tuple(out)


@pytest.mark.parametrize("kw", [
    dict(start_id=4061, end_id=4066, shard_index=0, shard_count=2),
    dict(start_id=4061, end_id=4066, shard_index=1, shard_count=2),
    dict(ids=[4061, 4062, 4064], shard_index=0, shard_count=2),
    dict(ids=[4061, 4062, 4064], shard_index=1, shard_count=2),
    dict(ids=[9, 3, 47999]),
    dict(start_id=47998),
    dict(start_id=5, end_id=5),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_ids_and_shards_match_jax(monkeypatch, kw):
    port, ref = _both(monkeypatch, **kw)
    assert isinstance(port, list) and port == ref


@pytest.mark.parametrize("kw", [
    dict(start_id=48001, end_id=48002),
    dict(start_id=0, end_id=48001),
    dict(start_id=-1, end_id=3),
    dict(ids=[4061, 48000, -2]),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_out_of_range_ids_raise_as_jax(monkeypatch, kw):
    port, ref = _both(monkeypatch, **kw)
    assert isinstance(port, str) and port == ref and "47999" in port


def test_none_shard_reads_the_process_group(monkeypatch, tmp_path):
    """Without a process group a None shard is 0 of 1 (every id); inside a
    one-process gloo group it is that group's rank and world size, read
    from torch.distributed (a rank 1 of 2 stood in for by patching the
    group's answers)."""
    assert not dist.is_initialized()
    assert tgs.resolve_shard(None, None) == (0, 1)
    ids = [4061, 4062, 4063, 4064]
    port, _ = _both(monkeypatch, ids=ids, shard_index=None, shard_count=None)
    assert port == ids
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        assert tgs.resolve_shard(None, None) == (0, 1)
        assert tgs.resolve_shard(None, 3) == (0, 1)
        assert tgs.resolve_shard(2, 3) == (2, 3)
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
        port, _ = _both(monkeypatch, ids=ids, shard_index=None, shard_count=None)
        assert port == ids[1::2]
    finally:
        dist.destroy_process_group()


def _small_exp():
    return tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**SMALL),
                                        base_train=tcfg.TrainConfig(save_params=False))


def test_fit_span_of_zero_is_one_epoch_a_call():
    """A span of 1 or less is one epoch a call, as in JAX."""
    data, _ = _data()
    assert len(trainer.fit(_small_exp(), data, epochs=1, device="cpu", verbose=False,
                           epoch_span=0).history) == 1


def test_collect_history_false_changes_only_the_history():
    data, _ = _data()
    full = trainer.fit(_small_exp(), data, epochs=3, device="cpu", verbose=False)
    bare = trainer.fit(_small_exp(), data, epochs=3, device="cpu", verbose=False,
                       collect_history=False)
    assert len(full.history) == 3 and bare.history == []
    for k in ("best_psnr", "final_psnr", "final_loss", "epochs_run", "stopped_early",
              "zero_collision_abort"):
        assert getattr(bare, k) == getattr(full, k), k
    for a, b in ((full.params, bare.params), (full.best_params, bare.best_params)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    np.testing.assert_array_equal(bare.final_image, full.final_image)


@pytest.mark.parametrize("tqdm_installed", [True, False])
def test_progress_bar_with_and_without_tqdm(monkeypatch, capsys, tqdm_installed):
    """progress=True draws a bar where tqdm imports and trains the same
    without one where its import fails (the card's machine has no tqdm)."""
    if tqdm_installed:
        pytest.importorskip("tqdm")
    else:
        monkeypatch.setitem(sys.modules, "tqdm", None)       # import tqdm raises ImportError
    data, _ = _data()
    ref = trainer.fit(_small_exp(), data, epochs=2, device="cpu", verbose=False)
    res = trainer.fit(_small_exp(), data, epochs=2, device="cpu", verbose=False, progress=True)
    assert res.final_loss == ref.final_loss and res.best_psnr == ref.best_psnr
    assert ("Training_psnr" in capsys.readouterr().err) == tqdm_installed


def test_driver_passes_its_options_to_fit(monkeypatch):
    data, _ = _data()
    seen = []

    def fake(exp, d, **kw):
        seen.append(kw)
        return trainer.FitResult(1.0, 1.0, 0.5, 2, False, False, None, None, [])

    monkeypatch.setattr(trainer, "fit", fake)
    tgs.run_grid_search(data, ids=[4061], manifest_path=None, verbose=False, device="cpu",
                        epochs=3, progress=True, log_image_every=2, hpd_weights_path="h.pkl",
                        encoding_weights_path="e.pkl", compile_cache=False)
    (kw,) = seen
    assert kw["collect_history"] is False and kw["progress"] is True
    assert kw["epochs"] == 3 and kw["log_image_every"] == 2 and kw["device"] == "cpu"
    assert kw["hpd_weights_path"] == "h.pkl" and kw["encoding_weights_path"] == "e.pkl"


def test_manifest_rows_are_json(sweeps):
    """The port's rows hold plain Python values (no numpy scalars), so the
    JSONL line is what JAX writes for the same numbers."""
    *_, tman = sweeps
    for line in open(tman):
        row = json.loads(line)
        assert list(row) == ROW_KEYS
        assert isinstance(row["best_psnr"], float) and isinstance(row["epochs_run"], int)
