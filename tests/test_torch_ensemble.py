"""Ensembles in the port (``trainer.fit_ensemble``, the grid driver's
``ensemble_size`` and the CLI's ``--ensemble``), on the CPU.

At ``tests/test_torch_grid_search.py``'s sizes (T = 32, HPD [2 -> 8 -> 32],
decoder [8 -> 8 -> 3], a seeded 8 x 6 image; grids 4061, 4051 and 3961,
one shape class with different loss weights and learning rates):

* every member of a port ensemble is bitwise its port solo ``fit``: best
  and final PSNR, loss, epochs, final image, final and best params, and the
  best checkpoint;
* against the JAX package's ``fit_ensemble`` from the same weights (the
  JAX init carried over with ``params_from_jax``), JAX's own bounds
  (``tests/test_ensemble.py``): best PSNR and final loss rtol 1e-5,
  ``epochs_run`` equal, mean |image difference| < 2; for per-member seeds
  and for a member that stops early and is frozen before the last span
  (its final image one epoch from its frozen state, the update discarded);
* the grid driver's ensembled manifest rows equal the per-config path's,
  and the JAX driver resumes them.
"""

import dataclasses
import enum
import json
import os

import numpy as np
import jax
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train import grid_search as jgs
from collision_handling_in_instantngp_tpu.train.trainer import fit_ensemble as jax_ensemble
from collision_handling_in_instantngp_tpu_torch import cli
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.train import grid_search as tgs
from collision_handling_in_instantngp_tpu_torch.train import trainer
from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt

SMALL = dict(hash_table_size=32, hpd_hidden=(8,), mlp_hidden=(8,))
IDS = [4061, 4051, 3961]
ROW_KEYS = ["grid_id", "image", "best_psnr", "final_psnr", "final_loss", "epochs_run",
            "stopped_early", "zero_collision_abort", "run_dir"]


def _data():
    img = np.random.default_rng(65535).integers(0, 256, size=(8, 6, 3)).astype(np.uint8)
    data = image_dataset(img, "tiny.png")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    return data, jdata


def _texps(ids=IDS, **train):
    return [tcfg.experiment_from_grid_id(
        i, base_model=tcfg.ModelConfig(**SMALL),
        base_train=tcfg.TrainConfig(**dict(dict(save_params=False), **train))) for i in ids]


def _jexps(ids=IDS, **train):
    out = []
    for i in ids:
        e = jcfg.experiment_from_grid_id(i, base_model=jcfg.ModelConfig(**SMALL))
        out.append(dataclasses.replace(e, train=dataclasses.replace(
            e.train, **dict(dict(save_params=False), **train))))
    return out


def _jax_init(cfg, seed, device="cpu"):
    """The port's init replaced by JAX's of the same config and seed."""
    base = jcfg.ModelConfig()
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = type(getattr(base, f.name))(v.value) if isinstance(v, enum.Enum) else v
    jp = jgngf.init_params(jax.random.PRNGKey(seed), jcfg.ModelConfig(**kw))
    return gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device)


def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_members_equal_their_solo_fits(tmp_path):
    """9 epochs, span 4, checkpoints on: each member is its solo fit, bit
    for bit, and so is its best checkpoint (Adam's moments and count)."""
    data, _ = _data()
    exps = _texps(save_params=True, checkpoint_dir=str(tmp_path / "ens"))
    ens = trainer.fit_ensemble(exps, data, epochs=9, epoch_span=4, device="cpu",
                               run_names=[f"ens{g}" for g in IDS])
    for exp, r in zip(exps, ens):
        solo_exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, checkpoint_dir=str(tmp_path / "solo")))
        solo = trainer.fit(solo_exp, data, epochs=9, device="cpu", verbose=False,
                           run_name="solo")
        for k in ("best_psnr", "final_psnr", "final_loss", "epochs_run", "stopped_early",
                  "zero_collision_abort"):
            assert getattr(r, k) == getattr(solo, k), (exp.grid_id, k)
        assert r.epochs_run == 9 and r.history == []
        np.testing.assert_array_equal(r.final_image, solo.final_image)
        _state_equal(r.params, solo.params)
        _state_equal(r.best_params, solo.best_params)
        assert r.run_dir == os.path.join(str(tmp_path / "ens"), f"{exp.grid_id}_ens{exp.grid_id}")
        for a, b in zip(ckpt.load_run_checkpoint(r.run_dir, model_cfg=exp.model),
                        ckpt.load_run_checkpoint(solo.run_dir, model_cfg=exp.model)):
            _leaves_equal(a, b)


def test_members_must_share_one_shape():
    data, _ = _data()
    exps = _texps([4061, 4062])        # K = 4 and K = 20
    with pytest.raises(ValueError, match=r"member 1 \(grid 4062\).*model"):
        trainer.fit_ensemble(exps, data, epochs=1, device="cpu")
    other = dataclasses.replace(exps[0], train=dataclasses.replace(exps[0].train,
                                                                   batch_fraction=0.5))
    with pytest.raises(ValueError, match="batch_fraction"):
        trainer.fit_ensemble([exps[0], other], data, epochs=1, device="cpu")


def _both(monkeypatch, ids, epochs, span, **train):
    data, jdata = _data()
    jres = jax_ensemble(_jexps(ids, **train), jdata, epochs=epochs, epoch_span=span)
    monkeypatch.setattr(gngf, "init_params", _jax_init)
    tres = trainer.fit_ensemble(_texps(ids, **train), data, epochs=epochs, epoch_span=span,
                                device="cpu")
    return jres, tres


def _close(j, t):
    np.testing.assert_allclose(t.best_psnr, j.best_psnr, rtol=1e-5)
    np.testing.assert_allclose(t.final_loss, j.final_loss, rtol=1e-5)
    assert t.epochs_run == j.epochs_run
    assert t.stopped_early == j.stopped_early
    assert t.final_image.shape == j.final_image.shape
    assert np.abs(t.final_image.astype(np.int32) - j.final_image.astype(np.int32)).mean() < 2.0


def test_ensemble_matches_jax(monkeypatch):
    jres, tres = _both(monkeypatch, IDS, 9, 4)
    for j, t in zip(jres, tres):
        _close(j, t)
        assert t.epochs_run == 9


def test_member_seeds_match_jax(monkeypatch):
    """Grid 4061 at seeds 1 and 2: each member its own init and shuffle
    (genuinely different runs), each as JAX's member of the same seed."""
    data, jdata = _data()
    ids = [4061, 4061]
    jexps = [dataclasses.replace(e, train=dataclasses.replace(e.train, seed=s))
             for e, s in zip(_jexps(ids), (1, 2))]
    texps = [dataclasses.replace(e, train=dataclasses.replace(e.train, seed=s))
             for e, s in zip(_texps(ids), (1, 2))]
    jres = jax_ensemble(jexps, jdata, epochs=5, epoch_span=5)
    monkeypatch.setattr(gngf, "init_params", _jax_init)
    tres = trainer.fit_ensemble(texps, data, epochs=5, epoch_span=5, device="cpu")
    assert tres[0].final_loss != tres[1].final_loss
    for j, t in zip(jres, tres):
        _close(j, t)
    solo = trainer.fit(texps[1], data, epochs=5, device="cpu", verbose=False)
    assert tres[1].final_loss == solo.final_loss
    np.testing.assert_array_equal(tres[1].final_image, solo.final_image)


def test_early_stopping_member_matches_jax(monkeypatch):
    """Member 0 (tolerance 2, min_delta 1e9) stops at epoch 4, inside the
    span 4-7, and is frozen for the span 8-11; member 1 runs all 12 epochs.
    epochs_run and the final images (member 0's: one epoch from its frozen
    state) as JAX's; member 0's final image is not its solo fit's."""
    data, jdata = _data()
    jexps = _jexps([4061, 4051])
    jexps[0] = dataclasses.replace(jexps[0], train=dataclasses.replace(
        jexps[0].train, tolerance=2, min_delta=1e9))
    texps = _texps([4061, 4051])
    texps[0] = dataclasses.replace(texps[0], train=dataclasses.replace(
        texps[0].train, tolerance=2, min_delta=1e9))
    jres = jax_ensemble(jexps, jdata, epochs=12, epoch_span=4)
    monkeypatch.setattr(gngf, "init_params", _jax_init)
    tres = trainer.fit_ensemble(texps, data, epochs=12, epoch_span=4, device="cpu")
    assert [t.epochs_run for t in tres] == [j.epochs_run for j in jres] == [5, 12]
    assert [t.stopped_early for t in tres] == [True, False]
    for j, t in zip(jres, tres):
        _close(j, t)
    solo = trainer.fit(texps[0], data, epochs=12, device="cpu", verbose=False)
    assert solo.epochs_run == 5 and solo.best_psnr == tres[0].best_psnr
    assert not np.array_equal(solo.final_image, tres[0].final_image)


def test_grid_driver_ensembles_rows_resumed_by_jax(tmp_path):
    """ensemble_size 2, span 5, ids 4061, 4051, 3961, 4062 (two shape
    classes: chunks [4061, 4051], [3961], [4062]): the rows equal the
    per-config path's at span 5, key for key; then the JAX driver, on the
    ensembled manifest, trains nothing and returns the same rows."""
    data, jdata = _data()
    ids = [4061, 4051, 3961, 4062]
    kw = dict(base_model=tcfg.ModelConfig(**SMALL), base_train=tcfg.TrainConfig(save_params=False),
              epochs=6, verbose=False, device="cpu", epoch_span=5, ids=ids)
    man_e, man_s = str(tmp_path / "ens.jsonl"), str(tmp_path / "solo.jsonl")
    rows_e = tgs.run_grid_search(data, manifest_path=man_e, ensemble_size=2, **kw)
    rows_s = tgs.run_grid_search(data, manifest_path=man_s, **kw)
    assert [r["grid_id"] for r in rows_e] == [4061, 4051, 3961, 4062]
    assert rows_e == rows_s
    for r in rows_e:
        assert list(r) == ROW_KEYS
    with open(man_e) as f:
        assert [json.loads(line) for line in f] == rows_e

    def no_fit(*a, **k):
        raise AssertionError("the JAX driver trained an id the manifest holds")

    jrows = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgs, "fit", no_fit)
        mp.setattr(jgs, "fit_ensemble", no_fit, raising=False)
        jrows = jgs.run_grid_search(jdata, ids=ids, base_model=jcfg.ModelConfig(**SMALL),
                                    manifest_path=man_e, verbose=False, ensemble_size=2)
    assert jrows == rows_e


@pytest.mark.parametrize("flags", [["--epoch_span", "3"],
                                   ["--epoch_span", "3", "--ensemble", "2"]])
def test_cli_span_and_ensemble_run(tmp_path, monkeypatch, flags):
    """The CLI on the CPU over grids 4060-4061 (K = 1 and 4: two shape
    classes) with a span, and with ensembles of 2: a manifest row and a
    checkpoint per id (weights/{id}_ens{id}/ for the ensembles)."""
    img = np.random.default_rng(65535).integers(0, 256, size=(8, 6, 3)).astype(np.uint8)
    np.save(tmp_path / "tiny.npy", img)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", "4060", "-e", "4061",
                     "--epochs", "4", "--device", "cpu", "--logger", "null", *flags]) == 0
    with open("runs/grid_manifest.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["grid_id"] for r in rows] == [4060, 4061]
    for r in rows:
        assert r["epochs_run"] == 4 and np.isfinite(r["best_psnr"])
        assert os.path.isfile(os.path.join(r["run_dir"], "whole_model.pkl"))
        if "--ensemble" in flags:
            assert os.path.basename(r["run_dir"]) == f"{r['grid_id']}_ens{r['grid_id']}"
