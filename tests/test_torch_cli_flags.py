"""The port's CLI flags that the JAX package's CLI has (``cli.py:31-78``),
on the CPU: ``--should_bw``, ``--manifest``, ``--shard-index`` /
``--shard-count``, ``--platform``, ``--epoch_span`` / ``--ensemble`` and
the ``-t`` figure. Runs that only check which ids reach ``fit`` replace it
(``trainer.fit``); ``--should_bw``, ``--platform cpu`` and ``-t`` train
for real on a seeded 8 x 6 colour ``.npy``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from collision_handling_in_instantngp_tpu.cli import build_parser as jax_parser
from collision_handling_in_instantngp_tpu_torch import cli
from collision_handling_in_instantngp_tpu_torch.train import trainer
from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt
from collision_handling_in_instantngp_tpu_torch.utils import logging as tlog


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A seeded 8 x 6 colour image in tmp_path, the working directory (the
    CLI writes runs/ and weights/ there); returns the leading arguments."""
    img = np.random.default_rng(65535).integers(0, 256, size=(8, 6, 3)).astype(np.uint8)
    np.save(tmp_path / "tiny.npy", img)
    monkeypatch.chdir(tmp_path)
    return ["-f", "tiny.npy", "--images_dir", str(tmp_path)]


def _record(monkeypatch):
    calls = []

    def fake_fit(exp, data, **kw):
        calls.append((exp.grid_id, exp.model.out_channels, data.channels, kw["device"]))
        return trainer.FitResult(1.0, 1.0, 0.5, 1, False, False, None, None, [])

    monkeypatch.setattr(trainer, "fit", fake_fit)
    return calls


def test_new_flags_parse_as_in_the_jax_cli():
    """Every flag of this slice takes the JAX CLI's spelling and default."""
    argv = ["--should_bw", "--manifest", "m.jsonl", "--shard-index", "-1", "--shard-count", "4",
            "--platform", "cpu", "--epoch_span", "3", "--ensemble", "2"]
    ta, ja = cli.build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for k in ("should_bw", "manifest", "shard_index", "shard_count", "platform", "epoch_span",
              "ensemble"):
        assert getattr(ta, k) == getattr(ja, k), k
    td, jd = cli.build_parser().parse_args([]), jax_parser().parse_args([])
    for k in ("should_bw", "manifest", "shard_index", "shard_count", "platform", "epoch_span",
              "ensemble"):
        assert getattr(td, k) == getattr(jd, k), k


def test_should_bw_trains_one_channel_with_the_bw_wandb_config(tiny, monkeypatch):
    real_fit, seen, configs = trainer.fit, [], []

    def spy(exp, data, **kw):
        res = real_fit(exp, data, **kw)
        seen.append((exp.model.out_channels, data.channels, data.image.shape, res))
        return res

    real_make = tlog.make_logger

    def make_logger(backend="jsonl", **kw):
        if backend == "wandb":
            configs.append(kw["wandb_kwargs"]["config"])
            return tlog.NullLogger()
        return real_make(backend, **kw)

    monkeypatch.setattr(trainer, "fit", spy)
    monkeypatch.setattr(tlog, "make_logger", make_logger)
    assert cli.main([*tiny, "--should_bw", "-s", "4061", "-e", "4061", "--epochs", "2",
                     "--device", "cpu", "--logger", "wandb"]) == 0
    ((out_channels, channels, shape, res),) = seen
    assert out_channels == channels == 1 and shape == (8, 6)
    assert res.final_image.shape == (8, 6)
    assert res.params.mlp.weights[-1].shape[-1] == 1
    tree = ckpt.load_pytree(os.path.join(res.run_dir, "whole_model.pkl"))
    assert tree["mlp"][-1]["w"].shape[-1] == 1
    (config,) = configs
    assert config["color"] == "BW" and config["id_grid_search_params"] == 4061


def test_manifest_flag_resumes(tiny, monkeypatch, capsys):
    calls = _record(monkeypatch)
    args = [*tiny, "-s", "4061", "-e", "4062", "--device", "cpu", "--logger", "null",
            "--manifest", "sweep/m.jsonl"]
    assert cli.main(args) == 0
    assert [c[0] for c in calls] == [4061, 4062]
    rows = [json.loads(line) for line in open("sweep/m.jsonl")]
    assert [r["grid_id"] for r in rows] == [4061, 4062]
    calls.clear()
    assert cli.main([*args[:-4], "-e", "4063", *args[-4:]]) == 0
    assert [c[0] for c in calls] == [4063]
    out = capsys.readouterr().out
    assert "grid 4061: already complete (manifest), skipping" in out
    assert "grid 4063: best PSNR 1.000 (1 epochs)" in out


@pytest.mark.parametrize("shard,want", [
    (("0", "2"), [4061, 4063, 4065]),
    (("1", "2"), [4062, 4064]),
    (("2", "3"), [4063]),
    (("-1", "-1"), [4061, 4062, 4063, 4064, 4065]),
])
def test_shard_flags_pick_the_ids(tiny, monkeypatch, shard, want):
    calls = _record(monkeypatch)
    assert cli.main([*tiny, "-s", "4061", "-e", "4065", "--device", "cpu", "--logger", "null",
                     "--shard-index", shard[0], "--shard-count", shard[1]]) == 0
    assert [c[0] for c in calls] == want


def test_platform_cpu_overrides_the_default_device(tiny, monkeypatch):
    """--platform cpu runs on the CPU whatever --device says (a JAX command
    line runs unchanged); --platform auto keeps --device, here the card,
    which this machine lacks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([*tiny, "-s", "4061", "-e", "4061", "--epochs", "1", "--logger", "null",
                     "--platform", "cpu"]) == 0
    assert os.path.exists("runs/grid_manifest.jsonl")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([*tiny, "-s", "4062", "-e", "4062", "--platform", "auto"])


@pytest.mark.parametrize("matplotlib_installed", [True, False])
def test_test_mode_renders_and_saves_the_comparison(tiny, monkeypatch, capsys,
                                                    matplotlib_installed):
    """-t renders the last id's best checkpoint at the image's size; the
    figure is written where matplotlib is installed, and a line says so
    where it is not (the render runs either way)."""
    if matplotlib_installed:
        pytest.importorskip("matplotlib")
    else:
        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda name, *a: None if name == "matplotlib" else real(name, *a))
    from collision_handling_in_instantngp_tpu_torch import render

    renders, real_render = [], render.render_image

    def spy(params, cfg, **kw):
        img = real_render(params, cfg, **kw)
        renders.append((cfg.out_channels, kw, img))
        return img

    monkeypatch.setattr(render, "render_image", spy)
    assert cli.main([*tiny, "-t", "-s", "4061", "-e", "4061", "--epochs", "2",
                     "--device", "cpu"]) == 0
    ((channels, kw, img),) = renders
    assert kw["height"] == 8 and kw["width"] == 6 and str(kw["device"]) == "cpu"
    assert img.shape == (8, 6, 3) and img.dtype == np.uint8
    out = capsys.readouterr().out
    png = "runs/tiny_4061_comparison.png"
    if matplotlib_installed:
        assert os.path.getsize(png) > 0 and f"comparison figure: {png}" in out
    else:
        assert not os.path.exists(png)
        assert "matplotlib not available; no comparison figure is written" in out
