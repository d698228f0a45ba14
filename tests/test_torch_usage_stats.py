"""The port's ``tools/usage_stats.py`` against the JAX package's, on the
CPU, and the macaw images the study's tools read.

A 2-epoch checkpoint of grid 4061's model from the port's
``fit(save_params=True)`` on a 96 x 96 crop of the strawberry (batches of
3,072 rows, more than the 1,156 shared vertices: the dedup route, as on the
card) is read by both ``stats_for_run`` functions on that crop: the integer
fields must be equal, the float fields within 1e-4 of JAX's rounded values.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from collision_handling_in_instantngp_tpu.config import (
    experiment_from_grid_id as jax_experiment_from_grid_id,
)
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.data import load_image as jax_load_image
from collision_handling_in_instantngp_tpu_torch.config import experiment_from_grid_id
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, load_image
from collision_handling_in_instantngp_tpu_torch.tools import usage_stats
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_KEYS = ("level", "cells", "slots_used")


def _jax_usage_stats():
    spec = importlib.util.spec_from_file_location(
        "jax_usage_stats", os.path.join(REPO, "tools", "usage_stats.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_usage_stats_matches_jax(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    img = load_image(os.path.join(REPO, "images", "strawberry.npy"))[200:296, 100:196]
    data = image_dataset(np.ascontiguousarray(img), "crop")
    exp = experiment_from_grid_id(4061)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, save_params=True))
    run_dir = fit(exp, data, epochs=2, device="cpu", verbose=False, run_name="usage").run_dir
    assert os.path.exists(os.path.join(run_dir, "whole_model.pkl"))

    port = usage_stats.stats_for_run(run_dir, exp.model, data, device="cpu")
    jax = _jax_usage_stats().stats_for_run(
        run_dir, jax_experiment_from_grid_id(4061).model,
        JImageData(**dataclasses.asdict(data)))
    assert len(port) == len(jax) == exp.model.num_levels
    for t, j in zip(port, jax):
        assert list(t) == list(j)
        assert {k: t[k] for k in INT_KEYS} == {k: j[k] for k in INT_KEYS}
        for key in set(j) - set(INT_KEYS):
            assert t[key] == pytest.approx(j[key], abs=1e-4), (t["level"], key)
    assert 0 < port[0]["slots_used"] <= 256 and port[-1]["cells"] > port[0]["cells"]


def test_main_reads_run_dirs(monkeypatch, tmp_path, capsys):
    """``main --flagship`` on the CPU: one JSON line per run directory."""
    monkeypatch.chdir(tmp_path)
    img = load_image(os.path.join(REPO, "images", "strawberry.npy"))[:96, :96]
    path = tmp_path / "crop.npy"
    np.save(path, np.ascontiguousarray(img))
    exp = experiment_from_grid_id(4061)
    res = fit(exp, image_dataset(img, "crop.npy"), epochs=1, device="cpu", verbose=False,
              run_name="main")
    rows = usage_stats.main(**usage_stats.parse_args(
        [res.run_dir, "--flagship", "--device=cpu", f"--image={path}"]))
    assert [r["run_dir"] for r in rows] == [res.run_dir]
    assert [lv["level"] for lv in rows[0]["levels"]] == [0, 1, 2, 3]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"run_dir"')


@pytest.mark.parametrize("name", ["macaw", "macaw2"])
def test_macaw_npy_equals_jax_decode(name):
    npy = load_image(os.path.join(REPO, "images", f"{name}.npy"))
    ref = jax_load_image(os.path.join(REPO, "images", f"{name}.jpg"))
    assert npy.dtype == np.uint8 and npy.shape == (508, 339, 3)
    np.testing.assert_array_equal(npy, ref)
