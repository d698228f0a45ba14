"""Counts epochs, the metric loggers and the CLI's logging flags of the
port, on the CPU against the JAX package.

* ``make_stats_fn``: the slot counts and the unique-cell counts of one
  epoch exactly equal to JAX's ``make_stats_fn`` on JAX's epoch ids, for
  the per-row route (with and without BatchNorm), the dedup route at K = 4
  and at K = 20 (the chunked tail) and the vanilla hash; the image has a
  padded tail (920 pixels in 3 batches of 307). On the dedup route the port
  counts from each batch's unique-vertex slots weighted by the vertex
  counts, never the per-row ids; the same function on JAX's per-row ids
  gives the same integers.
* the JSONL rows of a run with a counts epoch every epoch have JAX's keys
  and counts, figures and image aside; ``make_logger("wandb")`` without
  wandb falls back as JAX's does; ``_tick_step`` equals JAX's; a figure
  without matplotlib raises an ImportError naming it; a media-storing
  logger gets the figures.
* the CLI's new flags parse as JAX's do, ``-t`` selects JAX's test logger
  and ``--logger null`` the null one; without matplotlib its JSONL logs
  keep no media (so a run on a machine without it does not fail).
"""

import dataclasses
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import cli as jcli
from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.data import make_shuffle_permutations as jax_perms
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train import train_step as jts
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu.utils import histograms as jhist
from collision_handling_in_instantngp_tpu.utils import logging as jlog
from collision_handling_in_instantngp_tpu_torch import cli, config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, make_shuffle_permutations
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.models.hpd import unique_tail_backend
from collision_handling_in_instantngp_tpu_torch.train import train_step as tts
from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils import histograms, logging as tlog

STREAM = dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream")
ROUTES = {
    "per_row": (4061, dict(dedup_vertices=False)),
    "per_row_bn": (4061, dict(batchnorm_input=True)),
    "dedup_k4": (4061, {}),
    "dedup_k20": (4062, STREAM),
    "vanilla": (4061, dict(use_hash_function=True)),
}


def _image(shape=(23, 20)):
    return np.random.default_rng(65535).integers(0, 256, size=(*shape, 3)).astype(np.uint8)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stats_match_jax(route):
    grid_id, kw = ROUTES[route]
    jexp = jcfg.experiment_from_grid_id(grid_id, base_model=jcfg.ModelConfig(**kw))
    texp = tcfg.experiment_from_grid_id(grid_id, base_model=tcfg.ModelConfig(**kw))
    data = image_dataset(_image((40, 23)), "synthetic", normalize=not texp.model.batchnorm_input)
    assert data.num_pixels % 3 != 0                       # a padded tail
    if route == "dedup_k20":
        m = texp.model
        assert unique_tail_backend(m, m.hash_table_size, m.topk_k, m.hpd_hidden[-1]) == "jax"

    jst = jgngf.make_statics(jexp.model)
    shuffled, _ = jax_perms(data.num_pixels, jexp.train.seed, jexp.train.shuffle_pixels)
    jb = jts.build_epoch_batches(data.coords, data.targets, jexp.train.batch_fraction, shuffled,
                                 og_image=data.image, model_cfg=jexp.model, statics=jst)
    init_state, make_jitted = jts.make_epoch_fn(jexp, jst)
    state, tx = init_state(jax.random.PRNGKey(jexp.train.seed))
    _, _, jidx = make_jitted(tx, data.num_pixels)(state, jb)
    jcoords = jnp.asarray(np.asarray(jb.x).reshape(-1, np.asarray(jb.x).shape[-1]))
    jslot, jcell = (np.asarray(a) for a in jts.make_stats_fn(jexp, jst)(jidx, jcoords))

    tst = gngf.make_statics(texp.model)
    perm, _ = make_shuffle_permutations(data.num_pixels, texp.train.seed, texp.train.shuffle_pixels)
    tb = tts.build_epoch_batches(data.coords, data.targets, texp.train.batch_fraction, perm,
                                 data.image, texp.model, tst, "cpu")
    params = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    opt = make_optimizer(texp.optimizer, params)
    prev, min_poss = tts.initial_collision_state(texp, tst, "cpu")
    m = tts.run_epoch(params, opt, tb, texp, tst, prev, min_poss, collect_ids=True)
    coords = tb.x.reshape(-1, tb.x.shape[-1])
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
    stats_fn = tts.make_stats_fn(texp, tst)
    tslot, tcell = stats_fn(m.ids, coords)
    assert (m.ids.unique is not None) == route.startswith("dedup")
    assert tslot.dtype == tcell.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), jslot)
    np.testing.assert_array_equal(tcell.numpy(), jcell)
    # the same function on JAX's own per-row ids
    pslot, pcell = stats_fn(torch.as_tensor(np.array(jidx)), coords)
    np.testing.assert_array_equal(pslot.numpy(), jslot)
    np.testing.assert_array_equal(pcell.numpy(), jcell)
    assert jslot.sum() == np.asarray(jidx).size             # every row, padded tail included
    if route != "per_row_bn":                               # raw coords leave the cell table
        assert jcell.sum() > 0


def _schema_runs(tmp_path, kw):
    """JAX and the port, 2 epochs with a counts epoch each, logged to JSONL
    without media."""
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**kw))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**kw))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(
        jexp.train, save_params=False, histograms_rate=1))
    texp = dataclasses.replace(texp, train=dataclasses.replace(
        texp.train, save_params=False, histograms_rate=1))
    data = image_dataset(_image(), "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_fit(jexp, jdata, epochs=2, verbose=False, logger=jlog.JsonlLogger(str(jpath), save_media=False))
    fit(texp, data, epochs=2, device="cpu", params=start, verbose=False,
        logger=tlog.JsonlLogger(str(tpath), save_media=False))
    read = lambda p: [json.loads(line) for line in p.read_text().splitlines()]
    return texp, read(jpath), read(tpath)


@pytest.mark.parametrize("kw", [{}, dict(use_hash_function=True)], ids=["gngf", "vanilla"])
def test_jsonl_schema_matches_jax(tmp_path, kw):
    texp, jrows, trows = _schema_runs(tmp_path, kw)
    assert len(jrows) == len(trows) == 2
    media = {"t", "train_image"} | {f"hist_counts_level{l}" for l in range(texp.model.num_levels)}
    for j, t in zip(jrows, trows):
        assert set(j) - media == set(t) - media
        assert t["train_image"] == j["train_image"] == "<image(23, 20, 3)>"
        assert not set(t) & (media - {"t", "train_image"})   # no figures without media
        for l in range(texp.model.num_levels):
            assert t[f"hist_counts_level{l}_counts"] == j[f"hist_counts_level{l}_counts"]
        assert t["step"] == j["step"]


def test_media_logger_gets_figures_and_image(tmp_path):
    exp = tcfg.experiment_from_grid_id(4061)
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, save_params=False, histograms_rate=100))
    path = tmp_path / "run.jsonl"
    fit(exp, image_dataset(_image()), epochs=2, device="cpu", verbose=False,
        logger=tlog.JsonlLogger(str(path)), log_image_every=1)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for row in rows:                                      # both epochs are counts epochs
        assert row["train_image"].endswith("_train_image.png")
        for l in range(exp.model.num_levels):
            assert row[f"hist_counts_level{l}"].endswith(f"_hist_counts_level{l}.png")
            assert len(row[f"hist_counts_level{l}_counts"]) == exp.model.hash_table_size
    assert len(list((tmp_path / "run_media").glob("*.png"))) == 2 * (1 + exp.model.num_levels)


def test_figures_need_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        histograms.counts_per_level_histograms(np.ones((2, 16), np.int32), 16)


def test_wandb_falls_back_as_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    kwargs = dict(entity="e", project="p", group="g", name="n", config={})
    j = jlog.make_logger("wandb", path=str(tmp_path / "j.jsonl"), wandb_kwargs=kwargs)
    jout = capsys.readouterr().out
    t = tlog.make_logger("wandb", path=str(tmp_path / "t.jsonl"), wandb_kwargs=kwargs)
    tout = capsys.readouterr().out
    assert isinstance(j, jlog.JsonlLogger) and isinstance(t, tlog.JsonlLogger)
    assert tout == jout == "wandb not available; falling back to jsonl logger\n"
    assert t.stores_media and not tlog.JsonlLogger(str(tmp_path / "x.jsonl"), False).stores_media
    assert isinstance(tlog.make_logger("null"), tlog.NullLogger)
    j.finish(), t.finish()


def test_tick_step_matches_jax():
    for e in range(4, 21):
        assert histograms._tick_step(2**e) == jhist._tick_step(2**e), e


def test_reference_wandb_config_matches_jax():
    for gid in (0, 4061, 4064, 47999):
        jexp = jcfg.experiment_from_grid_id(gid)
        texp = tcfg.experiment_from_grid_id(gid)
        assert tcfg.reference_wandb_config(texp, "img") == jcfg.reference_wandb_config(jexp, "img")


def test_cli_flags_parse_as_jax(tmp_path, monkeypatch):
    argv = ["-f", "tiny.npy", "-s", "4061", "-e", "4061", "-t", "--logger", "null",
            "--wandb_entity", "e", "--wandb_project", "p", "--wandb_name", "n",
            "-ewp", "enc.pkl", "-hwp", "hpd.pkl", "--log_image_every", "5"]
    ta, ja = cli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    for k in ("is_test", "logger", "wandb_entity", "wandb_project", "wandb_name",
              "encoding_weights_path", "hpd_weights_path", "log_image_every"):
        assert getattr(ta, k) == getattr(ja, k), k

    monkeypatch.chdir(tmp_path)
    exp = tcfg.experiment_from_grid_id(4061)
    monkeypatch.setitem(sys.modules, "matplotlib", None)      # as on a machine without it
    bare = cli.make_logger_factory(ta, "tiny")(exp)
    assert isinstance(bare, tlog.JsonlLogger) and not bare.stores_media
    bare.finish()
    monkeypatch.delitem(sys.modules, "matplotlib")
    test_logger = cli.make_logger_factory(ta, "tiny")(exp)
    assert isinstance(test_logger, tlog.JsonlLogger) and test_logger.stores_media
    assert (tmp_path / "runs" / "tiny_4061_test.jsonl").exists()      # JAX's -t log
    test_logger.finish()
    ta.is_test = False
    assert isinstance(cli.make_logger_factory(ta, "tiny")(exp), tlog.NullLogger)
    ta.logger = "jsonl"
    plain = cli.make_logger_factory(ta, "tiny")(exp)
    assert isinstance(plain, tlog.JsonlLogger) and (tmp_path / "runs" / "tiny_4061.jsonl").exists()
    plain.finish()


def test_cli_passes_weights_and_logger_to_fit(tmp_path, monkeypatch):
    from collision_handling_in_instantngp_tpu_torch.train import trainer

    calls = []

    def fake_fit(exp, data, **kw):
        calls.append((exp.grid_id, kw))
        return trainer.FitResult(1.0, 1.0, 0.1, 1, False, False, None, None, [], run_dir="w/x")

    monkeypatch.setattr(trainer, "fit", fake_fit)
    monkeypatch.chdir(tmp_path)
    np.save(tmp_path / "tiny.npy", np.zeros((4, 4, 3), np.uint8))
    assert cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", "4061", "-e", "4062",
                     "--device", "cpu", "--logger", "null", "-hwp", "h.pkl", "-ewp", "e.pkl",
                     "--log_image_every", "3", "--epochs", "2"]) == 0
    assert [gid for gid, _ in calls] == [4061, 4062]
    for _, kw in calls:
        assert kw["hpd_weights_path"] == "h.pkl" and kw["encoding_weights_path"] == "e.pkl"
        assert kw["log_image_every"] == 3 and kw["epochs"] == 2
        assert isinstance(kw["logger"], tlog.NullLogger)


def test_zero_collision_abort_epoch_is_a_counts_epoch(monkeypatch):
    """The zero-collision abort makes its epoch (the 10th check) the
    early-stop epoch, a counts epoch: run_epoch keeps that epoch's ids
    beforehand, and the row logs its counts (collisions forced to 0)."""
    from collision_handling_in_instantngp_tpu_torch.train import trainer

    real, collected, rows = trainer.run_epoch, [], []

    def zero_collisions(*args, **kw):
        m = real(*args, **kw)
        collected.append(kw["collect_ids"])
        m.collisions = np.zeros_like(m.collisions)
        return m

    class Rows(tlog.MetricLogger):
        def log(self, metrics, step=None):
            rows.append(metrics)

    monkeypatch.setattr(trainer, "run_epoch", zero_collisions)
    exp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(use_hash_function=True),
                                       base_train=tcfg.TrainConfig(save_params=False))
    res = fit(exp, image_dataset(_image()), epochs=20, device="cpu", verbose=False, logger=Rows())
    assert res.zero_collision_abort and res.epochs_run == 11
    assert [ep for ep, r in enumerate(rows) if "hist_counts_level0_counts" in r] == [0, 10]
    assert collected == [True] + [False] * 9 + [True]


def test_image_metrics_match_jax():
    from collision_handling_in_instantngp_tpu.utils import metrics as jmet
    from collision_handling_in_instantngp_tpu_torch.utils import metrics as tmet

    rng = np.random.default_rng(3)
    for shape, channels in (((12, 9, 3), 3), ((12, 9), 1)):
        target = rng.integers(0, 256, size=shape).astype(np.uint8)
        pred01 = rng.random((108, channels)).astype(np.float32)
        img = tmet.to_uint8_image(pred01, 12, 9, channels)
        np.testing.assert_array_equal(img, jmet.to_uint8_image(pred01, 12, 9, channels))
        assert tmet.calc_psnr(img, target) == jmet.calc_psnr(img, target)
        assert tmet.calc_accuracy(img, target, img.size) == jmet.calc_accuracy(img, target, img.size)
