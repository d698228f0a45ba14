"""The port's ``tools/run_cold.py`` against the JAX package's, on the CPU.

For each command line, the JAX tool runs as a script (its ``fit``, image
loader and JSONL logger swapped for recorders in the JAX package's modules,
which the tool imports from; the JAX file is untouched) and the port's tool
runs with the same swaps in its own module. The ``ExperimentConfig`` each
passes to ``fit`` must be equal field for field (the JAX model config's
TPU gather-layout field aside), and so must ``fit``'s other arguments, the
log's path and the summary line's keys. One seed also trains on the CPU
for 2 epochs through the port's real ``fit``.
"""

import dataclasses
import json
import os
import runpy
import sys
import types

import pytest

import collision_handling_in_instantngp_tpu.data as jdata
import collision_handling_in_instantngp_tpu.train.trainer as jtrainer
import collision_handling_in_instantngp_tpu.utils.logging as jlogging
from collision_handling_in_instantngp_tpu_torch.tools import run_cold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGVS = [
    [],
    ["5000", "65535", "7", "42"],
    ["5000", "65535", "--scaled", "--encoding_lr=0.01"],
    ["300", "7", "--precision=high", "--no_hist"],
    ["5000", "65535", "--scaled", "--encoding_lr=0.01", "--l_js_kl=0", "--l_collisions=0"],
    ["100", "123", "--precision=default", "--scaled", "--l_collisions=0.1"],
]


class Recorder:
    def __init__(self):
        self.fits, self.logs = [], []

    def fit(self, exp, data, **kw):
        self.fits.append((exp, kw))
        return types.SimpleNamespace(epochs_run=kw["epochs"], best_psnr=20.0, final_psnr=19.5,
                                     final_loss=0.01, run_dir=None)

    def logger(self, path, *a, **kw):
        self.logs.append(path)
        return types.SimpleNamespace(log=lambda *a, **k: None, finish=lambda: None)


def _jax_run(argv, monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(jtrainer, "fit", rec.fit)
    monkeypatch.setattr(jdata, "load_image_dataset", lambda path: path)
    monkeypatch.setattr(jlogging, "JsonlLogger", rec.logger)
    monkeypatch.setattr(sys, "argv", ["run_cold.py", *argv])
    runpy.run_path(os.path.join(REPO, "tools", "run_cold.py"), run_name="__main__")
    return rec


def _port_run(argv, monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(run_cold, "fit", rec.fit)
    monkeypatch.setattr(run_cold, "load_image_dataset", lambda path: path)
    monkeypatch.setattr(run_cold, "JsonlLogger", rec.logger)
    rows = run_cold.main(**run_cold.parse_args(argv))
    return rec, rows


def _norm(d):
    return {k: (v.value if hasattr(v, "value") else v) for k, v in d.items()}


def assert_same_experiment(t, j):
    t, j = dataclasses.asdict(t), dataclasses.asdict(j)
    for group in ("loss", "optimizer"):
        assert t[group] == j[group], group
    assert set(j["model"]) == set(t["model"])
    assert _norm(t["model"]) == _norm(j["model"])
    assert set(t["train"]) <= set(j["train"])
    assert t["train"] == {k: v for k, v in j["train"].items() if k in t["train"]}
    assert t["grid_id"] == j["grid_id"] == 4061


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_experiments_match_jax(argv, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    jrec = _jax_run(argv, monkeypatch)
    jlines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    trec, rows = _port_run(argv, monkeypatch)
    tlines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(trec.fits) == len(jrec.fits) >= 1
    for (texp, tkw), (jexp, jkw) in zip(trec.fits, jrec.fits):
        assert_same_experiment(texp, jexp)
        for key in ("epochs", "run_name", "epoch_span", "collect_history", "verbose"):
            assert tkw[key] == jkw[key], key
        assert tkw["device"] == "cuda"
    assert trec.logs == jrec.logs
    assert tlines == rows and len(tlines) == len(jlines)
    for t, j in zip(tlines, jlines):
        assert list(t) == list(j)
        assert {k: v for k, v in t.items() if k != "image"} == {
            k: v for k, v in j.items() if k != "image"}
        assert (t["image"], j["image"]) == ("strawberry.npy", "strawberry.jpeg")


def test_cold_experiment_fields():
    exp = run_cold.cold_experiment(7, precision="high", scaled=True, encoding_lr=0.01,
                                   l_js_kl=0.0, l_collisions=0.0, no_hist=True)
    assert (exp.train.seed, exp.train.tolerance, exp.train.histograms_rate) == (7, 10**9, 10**9)
    assert (exp.model.hash_table_size, exp.model.num_levels, exp.model.matmul_precision) == (
        2**14, 16, "high")
    assert exp.train.batch_fraction == 1 / 3 and exp.optimizer.encoding_lr == 0.01
    assert (exp.loss.l_js_kl, exp.loss.l_collisions) == (0.0, 0.0)
    assert run_cold.run_tag("high", True, 0.01, 0.0, 0.0) == "_high_scaled_elr0.01_jskl0_lcoll0"


def test_two_cpu_epochs_write_the_log(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    rows = run_cold.main(2, [7], no_hist=True, device="cpu")
    assert rows[0]["epochs"] == 2 and rows[0]["best_psnr"] > 0
    assert rows[0]["run_dir"] == os.path.join("weights", "4061_cold_seed7")
    log = tmp_path / "runs" / "strawberry_4061_cold_seed7.jsonl"
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rows[0]
