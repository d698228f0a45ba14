"""The port's grid-study drivers against the JAX package's, on the CPU:
``tools/{grid_leaderboard,rerank_top,seed_panel,run_grid_demo,run_macaws}.py``.

The leaderboard's fold (``effective_key``) must split ids as JAX's does,
and its table, its counts and the rerank's pick must equal JAX's on the
committed screening manifest. For the training tools, each JAX script runs
as a script with the function it trains through (``run_grid_search``,
``fit_ensemble`` or ``fit``), its image loader and its logger swapped for
recorders in the JAX package's modules (the JAX files are untouched), and
the port's tool runs with the same swaps in its own module: the
``ExperimentConfig``s must be equal field for field (the JAX model
config's TPU gather-layout field aside), the other arguments equal, the
manifests and logs at the same paths, the summary lines with the same keys.
Real CPU runs at a 96 x 96 crop (3,072-row batches, more than the 1,156
shared vertices, so the dedup route runs as on the card) hold the panel's
members to their solo fits and the screening driver's ensembled rows to its
one-by-one rows.
"""

import dataclasses
import json
import os
import runpy
import sys
import types
from collections import defaultdict

import numpy as np
import pytest
import torch

import collision_handling_in_instantngp_tpu.config as jconfig
import collision_handling_in_instantngp_tpu.data as jdata
import collision_handling_in_instantngp_tpu.train.grid_search as jgrid_search
import collision_handling_in_instantngp_tpu.train.trainer as jtrainer
import collision_handling_in_instantngp_tpu.utils.logging as jlogging
from collision_handling_in_instantngp_tpu_torch.config import experiment_from_grid_id
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, load_image
from collision_handling_in_instantngp_tpu_torch.tools import (
    grid_leaderboard, rerank_top, run_grid_demo, run_macaws, seed_panel,
)
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCREEN = os.path.join(REPO, "evidence", "grid_demor4grid_manifest.jsonl")
RERANK = os.path.join(REPO, "evidence", "rerank_full_manifest.jsonl.gz")
JAX_GRID = jconfig.get_grid_search_configs()


def _jax_tool(name):
    """A JAX tool loaded by path (its own sys.path lines make its imports
    resolve)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "tools",
                                                                              f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_grid_once(monkeypatch):
    """The JAX ``effective_key`` rebuilds the 48,000 configurations on
    every call (``setdefault`` evaluates its default): hand it one grid."""
    monkeypatch.setattr(jconfig, "get_grid_search_configs", lambda axes=None: JAX_GRID)


def _partition(keys):
    groups = defaultdict(set)
    for gid, key in keys.items():
        groups[key].add(gid)
    return {frozenset(g) for g in groups.values()}


def test_effective_key_partition_matches_jax():
    with open(SCREEN) as f:
        ids = [json.loads(line)["grid_id"] for line in f]
    ids += [int(i) for i in np.random.default_rng(0).choice(48_000, size=4096, replace=False)]
    ids = sorted(set(ids))
    jmod = _jax_tool("grid_leaderboard")
    port = _partition({g: grid_leaderboard.effective_key(g) for g in ids})
    jax = _partition({g: jmod.effective_key(g, grid=JAX_GRID) for g in ids})
    assert port == jax
    assert len(port) < len(ids)          # the fold merges something


def test_leaderboard_matches_jax(jax_grid_once, capsys):
    jout = _jax_tool("grid_leaderboard").main(SCREEN, 15)
    jtext = capsys.readouterr().out
    tout = grid_leaderboard.main(SCREEN, 15)
    assert capsys.readouterr().out == jtext
    assert tout == jout
    assert (tout["better_raw"], tout["better_distinct"]) == (115, 34)


def test_pick_ids_matches_jax_and_the_committed_rerank(jax_grid_once, monkeypatch):
    import gzip

    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    jmod = _jax_tool("rerank_top")
    winners, ref = rerank_top.pick_ids(SCREEN, 20)
    assert (winners, ref) == jmod.pick_ids(SCREEN, 20)
    with gzip.open(RERANK, "rt") as f:
        rerun = [json.loads(line)["grid_id"] for line in f]
    assert sorted(winners) == sorted(g for g in rerun if g != 4061) and len(winners) == 20


# ---------------------------- recorder parity ---------------------------- #

def _rows_for(ids, start, end, shard_index, shard_count):
    ids = list(ids) if ids is not None else list(range(start, end))
    return [{"grid_id": g, "image": "x", "best_psnr": 10.0 + (g % 7) / 10, "final_psnr": 9.0,
             "final_loss": 0.5, "epochs_run": 3, "stopped_early": g % 3 == 0,
             "zero_collision_abort": False, "run_dir": f"weights/{g}"}
            for g in ids[shard_index::shard_count]]


def _result(exp, epochs):
    return types.SimpleNamespace(best_psnr=15.0 + exp.grid_id / 1e4 + exp.train.seed / 1e6,
                                 final_psnr=14.0, final_loss=0.25, epochs_run=epochs,
                                 stopped_early=False, run_dir=f"weights/{exp.grid_id}")


class Recorder:
    def __init__(self):
        self.calls, self.logs = [], []

    def grid(self, data, start_id=0, end_id=None, **kw):
        self.calls.append(("grid", data, dict(kw, start_id=start_id, end_id=end_id)))
        return _rows_for(kw.get("ids"), start_id, end_id, kw.get("shard_index", 0),
                         kw.get("shard_count", 1))

    def ensemble(self, exps, data, **kw):
        self.calls.append(("ensemble", data, dict(kw, exps=exps)))
        return [_result(e, kw["epochs"]) for e in exps]

    def fit(self, exp, data, **kw):
        self.calls.append(("fit", data, dict(kw, exp=exp)))
        return _result(exp, kw["epochs"])

    def logger(self, path, *a, **kw):
        self.logs.append(path)
        return types.SimpleNamespace(log=lambda *a, **k: None, finish=lambda: None)


def _load(path):
    return types.SimpleNamespace(name=os.path.basename(path), num_pixels=172_212)


CASES = [
    ("rerank_top", []),
    ("rerank_top", [SCREEN, "5", "300", "4"]),
    ("seed_panel", []),
    ("seed_panel", ["300", "--ids=3761,4061,3961", "--seeds=1,2,3"]),
    ("run_grid_demo", []),
    ("run_grid_demo", ["4048", "32", "300", "2", "8"]),
    ("run_grid_demo", ["0", "32", "300", "4", "1", "strat", "1500"]),
    ("run_macaws", []),
    ("run_macaws", ["5000"]),
]
PORT_TOOLS = {"rerank_top": rerank_top, "seed_panel": seed_panel,
              "run_grid_demo": run_grid_demo, "run_macaws": run_macaws}


def _jax_run(tool, argv, monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(jgrid_search, "run_grid_search", rec.grid)
    monkeypatch.setattr(jtrainer, "fit_ensemble", rec.ensemble)
    monkeypatch.setattr(jtrainer, "fit", rec.fit)
    monkeypatch.setattr(jdata, "load_image_dataset", _load)
    monkeypatch.setattr(jlogging, "JsonlLogger", rec.logger)
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    monkeypatch.setattr(sys, "argv", [f"{tool}.py", *argv])
    runpy.run_path(os.path.join(REPO, "tools", f"{tool}.py"), run_name="__main__")
    return rec


def _port_run(tool, argv, monkeypatch):
    rec = Recorder()
    mod = PORT_TOOLS[tool]
    for name, fn in (("run_grid_search", rec.grid), ("fit_ensemble", rec.ensemble),
                     ("fit", rec.fit), ("load_image_dataset", _load),
                     ("JsonlLogger", rec.logger), ("resolve_device", torch.device),
                     ("device_info", lambda dev: {"gpu": "a card, 700.00 W"})):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, fn)
    mod.main(**mod.parse_args(argv))
    return rec


def _norm(d):
    return {k: (v.value if hasattr(v, "value") else v) for k, v in d.items()}


def assert_same_experiment(t, j):
    t, j = dataclasses.asdict(t), dataclasses.asdict(j)
    for group in ("loss", "optimizer"):
        assert t[group] == j[group], group
    assert set(j["model"]) == set(t["model"])
    assert _norm(t["model"]) == _norm(j["model"])
    assert t["train"] == {k: v for k, v in j["train"].items() if k in t["train"]}
    assert t["grid_id"] == j["grid_id"]


def _image_stem(data):
    return os.path.splitext(data.name)[0]


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("tool,argv", CASES, ids=lambda a: a if isinstance(a, str) else
                         " ".join(os.path.basename(x) for x in a) or "defaults")
def test_tools_pass_what_jax_passes(tool, argv, jax_grid_once, monkeypatch, tmp_path, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jrec = _jax_run(tool, argv, monkeypatch)
    jlines = _json_lines(capsys.readouterr().out)
    monkeypatch.chdir(tmp_path / "port")
    trec = _port_run(tool, argv, monkeypatch)
    tlines = _json_lines(capsys.readouterr().out)

    assert len(trec.calls) == len(jrec.calls) >= 1
    for (tkind, tdata, tkw), (jkind, jdat, jkw) in zip(trec.calls, jrec.calls):
        assert tkind == jkind
        assert _image_stem(tdata) == _image_stem(jdat)
        assert tkw.pop("device") == "cuda"
        texps = tkw.pop("exps", None) or [tkw.pop("exp", None)]
        jexps = jkw.pop("exps", None) or [jkw.pop("exp", None)]
        assert len(texps) == len(jexps)
        for te, je in zip(texps, jexps):
            if je is not None:
                assert_same_experiment(te, je)
        # the loggers are the recorders' (their paths compared below)
        assert ("logger" in tkw) == ("logger" in jkw)
        tkw.pop("logger", None), jkw.pop("logger", None)
        assert tkw == jkw
    assert [os.path.normpath(p) for p in trec.logs] == [os.path.normpath(p) for p in jrec.logs]
    jruns, truns = tmp_path / "jax" / "runs", tmp_path / "port" / "runs"
    jfiles = sorted(os.listdir(jruns)) if jruns.exists() else []
    assert (sorted(os.listdir(truns)) if truns.exists() else []) == jfiles
    for name in jfiles:
        assert (truns / name).read_text() == (jruns / name).read_text()
    assert len(tlines) == len(jlines) >= 1
    extra = {"run_grid_demo": ["gpu"]}.get(tool, [])
    for t, j in zip(tlines, jlines):
        assert [k for k in t if k not in extra] == list(j)
        if "image" in j:
            assert (t.pop("image"), j.pop("image")) in {("macaw.npy", "macaw.jpg"),
                                                        ("macaw2.npy", "macaw2.jpg")}
        for key in ("wall_s", "configs_per_hour_per_chip", "elapsed_s"):
            t.pop(key, None), j.pop(key, None)
        assert {k: v for k, v in t.items() if k not in extra} == j
        if "configs" in j and "best" in j:
            assert t["gpu"] == "a card, 700.00 W"


def test_seed_panel_resumes_like_jax(jax_grid_once, monkeypatch, tmp_path, capsys):
    done = [{"grid_id": 3761, "seed": 7}, {"grid_id": 4061, "seed": 42},
            {"grid_id": 4061, "seed": 2026}]
    for side in ("jax", "port"):
        (tmp_path / side / "runs").mkdir(parents=True)
        (tmp_path / side / "runs" / "seed_panel_manifest.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in done))
    monkeypatch.chdir(tmp_path / "jax")
    jrec = _jax_run("seed_panel", ["10"], monkeypatch)
    monkeypatch.chdir(tmp_path / "port")
    trec = _port_run("seed_panel", ["10"], monkeypatch)
    capsys.readouterr()
    pairs = [(e.grid_id, e.train.seed) for e in trec.calls[0][2]["exps"]]
    assert pairs == [(e.grid_id, e.train.seed) for e in jrec.calls[0][2]["exps"]]
    assert len(pairs) == 7 and not {(r["grid_id"], r["seed"]) for r in done} & set(pairs)
    assert trec.calls[0][2]["run_names"] == [f"panel{g}s{s}" for g, s in pairs]
    # everything done: nothing trains
    trec = _port_run("seed_panel", ["10"], monkeypatch)
    assert trec.calls == []
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "panel": "all members already in manifest"}


@pytest.mark.parametrize("tool", sorted(PORT_TOOLS) + ["usage_stats"])
def test_tools_raise_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    from collision_handling_in_instantngp_tpu_torch.tools import usage_stats

    mod = dict(PORT_TOOLS, usage_stats=usage_stats)[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(**mod.parse_args(["no_such_run_dir"] if tool == "usage_stats" else []))


# ----------------------------- real CPU runs ----------------------------- #

@pytest.fixture(scope="module")
def crop_path(tmp_path_factory):
    img = load_image(os.path.join(REPO, "images", "strawberry.npy"))[200:296, 100:196]
    path = tmp_path_factory.mktemp("crop") / "crop.npy"
    np.save(path, np.ascontiguousarray(img))
    return str(path)


def test_panel_members_equal_solo_fits(crop_path, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    rows = seed_panel.main(2, ids=(3761, 4061), seeds=(7, 42), device="cpu", image=crop_path)
    assert [(r["grid_id"], r["seed"]) for r in rows] == [(3761, 7), (3761, 42), (4061, 7),
                                                          (4061, 42)]
    with open(tmp_path / "runs" / "seed_panel_manifest.jsonl") as f:
        assert [json.loads(line) for line in f] == rows
    data = image_dataset(np.load(crop_path), "crop.npy")
    for row in rows:
        exp = experiment_from_grid_id(row["grid_id"])
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, seed=row["seed"], save_params=False))
        solo = fit(exp, data, epochs=2, device="cpu", epoch_span=33, verbose=False)
        assert (row["best_psnr"], row["final_psnr"], row["epochs_run"], row["stopped_early"]) == (
            solo.best_psnr, solo.final_psnr, solo.epochs_run, solo.stopped_early)
        assert os.path.exists(tmp_path / "weights" / f"{row['grid_id']}_panel{row['grid_id']}"
                              f"s{row['seed']}" / "whole_model.pkl")
    assert rows[0]["best_psnr"] != rows[1]["best_psnr"]     # the seeds differ


def test_grid_demo_rows_do_not_depend_on_the_ensemble(crop_path, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    out = {}
    for ensemble in (1, 2):
        summary, rows = run_grid_demo.main(4050, 3, 2, 2, ensemble, f"e{ensemble}",
                                           device="cpu", image=crop_path)
        assert summary["configs"] == 3 and summary["gpu"] is None
        out[ensemble] = sorted(({k: v for k, v in r.items() if k != "run_dir"} for r in rows),
                               key=lambda r: r["grid_id"])
    assert [r["grid_id"] for r in out[1]] == [4050, 4051, 4052]
    assert out[1] == out[2]


# ------------------------- manifests against manifests -------------------- #

def test_spearman_matches_scipy():
    from scipy.stats import spearmanr

    rng = np.random.default_rng(3)
    a = rng.integers(0, 6, size=40).astype(float)          # ties
    b = a + rng.normal(size=40)
    assert grid_leaderboard.spearman(a, b) == pytest.approx(spearmanr(a, b).statistic, abs=1e-12)


def test_compare_panel_and_rerank(tmp_path, capsys):
    panel = os.path.join(REPO, "evidence", "seed_panel_manifest.jsonl.gz")
    out = grid_leaderboard.compare(panel, panel)
    assert (out["n"], out["unmatched"], out["mean_abs_delta_best"]) == (10, 0, 0.0)
    rows = grid_leaderboard.read_rows(panel)
    for g in (3761, 4061):
        best = [r["best_psnr"] for r in rows if r["grid_id"] == g]
        assert out["per_id"][g]["mean"] == pytest.approx(np.mean(best))
        assert out["per_id"][g]["std"] == pytest.approx(np.std(best, ddof=1))
    assert out["per_id"][3761]["mean"] == pytest.approx(19.984, abs=1e-3)
    assert out["per_id"][4061]["std"] == pytest.approx(0.527, abs=1e-3)
    by_seed = {(r["grid_id"], r["seed"]): r["best_psnr"] for r in rows}
    assert out["paired_delta_vs_4061"] == {
        f"3761/{s}": pytest.approx(by_seed[(3761, s)] - by_seed[(4061, s)])
        for s in (7, 42, 123, 2026, 31337)}
    # a screening manifest against the rerank: the 21 shared ids, one seedless row each
    out = grid_leaderboard.compare(SCREEN, RERANK)
    assert (out["n"], out["unmatched"]) == (21, 491) and out["paired_delta_vs_4061"] == {}
    shifted = tmp_path / "shifted.jsonl"
    shifted.write_text("".join(json.dumps(dict(r, best_psnr=r["best_psnr"] + 0.5)) + "\n"
                               for r in grid_leaderboard.read_rows(RERANK)))
    capsys.readouterr()
    out = grid_leaderboard.compare(str(shifted), RERANK)
    assert out["mean_abs_delta_best"] == pytest.approx(0.5) and out["spearman_best"] == pytest.approx(1.0)
    assert capsys.readouterr().out.count("\n| 3") == 20
