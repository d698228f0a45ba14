"""``scripts/stop_replay.py``: the stopper replayed over a log of a run with
early stopping off gives what ``fit`` returns at that tolerance; the
one-sided Fisher p against scipy; the column comparison of two logs."""

import dataclasses
import gzip
import importlib.util
import json
import os

import numpy as np
import pytest
from scipy import stats

from collision_handling_in_instantngp_tpu_torch.config import TrainConfig, experiment_from_grid_id
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils.logging import JsonlLogger

EPOCHS = 14
_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                     "stop_replay.py")
_spec = importlib.util.spec_from_file_location("stop_replay", _PATH)
stop_replay = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stop_replay)


def _fit(tmp_path, tolerance, log=None):
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    exp = experiment_from_grid_id(4061, base_train=TrainConfig(save_params=False))
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, tolerance=tolerance))
    logger = JsonlLogger(str(tmp_path / log), save_media=False) if log else None
    res = fit(exp, image_dataset(img, "synthetic"), epochs=EPOCHS, device="cpu", verbose=False,
              logger=logger)
    if logger is not None:
        logger.finish()
    return res


def test_replay_gives_fits_stop(tmp_path):
    _fit(tmp_path, 10 ** 9, "free_seed65535.jsonl")
    rows = stop_replay.read_log(str(tmp_path / "free_seed65535.jsonl"))
    assert len(rows) == EPOCHS
    stopped = 0
    for tol in (1, 2, 3):
        res = _fit(tmp_path, tol)
        r = stop_replay.replay(rows, tol, EPOCHS)
        assert (r["epochs_run"], r["stopped_early"]) == (res.epochs_run, res.stopped_early), tol
        assert r["best_psnr"] == res.best_psnr and r["final_psnr"] == res.final_psnr, tol
        stopped += res.stopped_early
    assert stopped > 0          # the stop path itself was exercised
    table = stop_replay.paired_table({"a": [str(tmp_path / "free_seed65535.jsonl")],
                                      "b": [str(tmp_path / "free_seed65535.jsonl")]}, 1, EPOCHS)
    assert table["rows"][0]["seed"] == 65535 and table["stops"]["a"] == table["stops"]["b"]


@pytest.mark.parametrize("a,b", [(0, 3), (0, 6), (3, 3), (2, 5), (6, 0)])
def test_fisher_one_sided_matches_scipy(a, b):
    want = stats.fisher_exact([[b, 12 - b], [a, 12 - a]], alternative="greater")[1]
    assert stop_replay.fisher_one_sided(a, 12, b, 12) == pytest.approx(want, rel=1e-12)
    # 3 stops of 6 against 0 of 6: C(6,3) / C(12,3)
    assert stop_replay.fisher_one_sided(0, 6, 3, 6) == pytest.approx(20 / 220)


def test_compare_first_difference_and_gaps(tmp_path):
    base = [{"step": e, "train_loss": 1.0 / (e + 1), "mse_loss": 0.5, "train_psnr": 10.0 + e,
             **{f"collisions_level{l}": 5.0 for l in range(4)}} for e in range(30)]
    other = json.loads(json.dumps(base))
    other[11]["collisions_level3"] = 5.25
    other[20]["train_loss"] += 1e-3
    cmp = stop_replay.compare(base, other, [11, 20, 50])
    assert cmp["collisions_level3"]["first_differs"] == 11
    assert cmp["collisions_level0"]["first_differs"] is None
    assert cmp["train_loss"]["first_differs"] == 20
    assert cmp["train_loss"]["gap"]["20"] == pytest.approx(1e-3)
    assert cmp["train_loss"]["gap"]["50"] is None
    path = tmp_path / "log_seed3.jsonl.gz"
    with gzip.open(path, "wt") as f:
        f.writelines(json.dumps(r) + "\n" for r in reversed(other))
    assert stop_replay.read_log(str(path)) == other and stop_replay.seed_of(str(path)) == 3
    state = stop_replay.replay(base, 10 ** 9, counter_at=29)
    assert state["last_improvement"] == 29 and state["counter"] == 0
