"""PSNR leaderboard of a grid-sweep manifest: where grid 4061 (the
reference's pick) ranks, and how many configurations beat it once the
repeats are folded. Several grid axes are no-ops in parts of the space (the
JS/KL shape with ``l_js_kl = 0``; ``l_collisions``, whose term carries no
gradient), so the raw count of winners counts one configuration several
times: ``effective_key`` folds them.

    python -m collision_handling_in_instantngp_tpu_torch.tools.grid_leaderboard \\
        [manifest.jsonl] [top_n] [--compare=REFERENCE.jsonl[.gz]]

The manifest defaults to the committed
``evidence/grid_demor4grid_manifest.jsonl`` (512 ids at 300 epochs).
``--compare`` instead holds a manifest (a sweep's, a rerank's or a seed
panel's) against a reference manifest of the same runs, for example the
JAX package's under ``evidence/``: row by row (joined on the grid id, and
the seed where the rows have one), the mean |Δ| and Spearman's ρ of the
best PSNRs, and per grid id the mean ± sample std over seeds with the
paired Δ against grid 4061 (``compare``). Reads JSON rows only: it needs
no card.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import experiment_from_grid_id, get_grid_search_configs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT = os.path.join(REPO, "evidence", "grid_demor4grid_manifest.jsonl")
# the study tools' image: the JAX package's decode of strawberry.jpeg
IMAGE = os.path.join(REPO, "images", "strawberry.npy")

_GRID: List[Dict[str, Any]] = []


def grid_configs() -> List[Dict[str, Any]]:
    """The 48,000 grid configurations, built once per process."""
    if not _GRID:
        _GRID.extend(get_grid_search_configs())
    return _GRID


def effective_key(grid_id: int, grid: Optional[Sequence[Dict[str, Any]]] = None) -> str:
    """A canonical string of the resolved configuration that decides the
    trajectory: two ids with one key train the same parameters. Folded:
    ``l_collisions`` (its term is a constant of the previous epoch's counts
    and moves no gradient, only the logged loss, so at most the early stop)
    and, with ``l_js_kl = 0``, ``gamma`` and ``epsilon`` (the JS/KL term is
    weighted to zero)."""
    exp = experiment_from_grid_id(grid_id, grid=grid if grid is not None else grid_configs())
    loss = dataclasses.replace(exp.loss, l_collisions=0.0)
    if loss.l_js_kl == 0:
        loss = dataclasses.replace(loss, gamma=0.0, epsilon=0.0)
    exp = dataclasses.replace(exp, loss=loss, grid_id=-1)
    return json.dumps(dataclasses.asdict(exp), sort_keys=True, default=str)


def read_rows(path: str) -> List[Dict[str, Any]]:
    """The manifest's rows (plain or gzipped JSONL), best PSNR first (a
    stable sort: ties keep the manifest's order)."""
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows.sort(key=lambda r: -r["best_psnr"])
    return rows


def distinct_winners(rows: List[Dict[str, Any]], ref: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """{effective key: its best row} over the rows that beat ``ref``, in
    ``rows``' order (best first)."""
    distinct: Dict[str, Any] = {}
    for r in rows:
        if ref is not None and r["best_psnr"] > ref["best_psnr"]:
            distinct.setdefault(effective_key(r["grid_id"]), r)
    return distinct


def main(path: str = DEFAULT, top_n: int = 15) -> Optional[Dict[str, Any]]:
    """Prints the table and the count; returns {better_raw,
    better_distinct, distinct_best_ids} (None without grid 4061)."""
    rows = read_rows(path)
    ref = next((r for r in rows if r["grid_id"] == 4061), None)
    ref_rank = rows.index(ref) + 1 if ref else None
    print(f"configs: {len(rows)}; ids {min(r['grid_id'] for r in rows)}.."
          f"{max(r['grid_id'] for r in rows)}")
    print("| rank | grid id | best PSNR @300ep | stopped early |")
    print("|---|---|---|---|")
    for i, r in enumerate(rows[:top_n], 1):
        mark = " **<- reference's pick**" if r["grid_id"] == 4061 else ""
        print(f"| {i} | {r['grid_id']}{mark} | {r['best_psnr']:.3f} | {r['stopped_early']} |")
    if ref and ref_rank > top_n:
        print(f"| {ref_rank} | 4061 **<- reference's pick** | {ref['best_psnr']:.3f} | "
              f"{ref['stopped_early']} |")
    if not ref:
        return None
    better = [r for r in rows if r["best_psnr"] > ref["best_psnr"]]
    distinct = distinct_winners(rows, ref)
    print(f"\n4061 rank {ref_rank}/{len(rows)}; {len(better)} configs ({len(distinct)} distinct "
          "effective configs) beat it at the sweep budget")
    return {"better_raw": len(better), "better_distinct": len(distinct),
            "distinct_best_ids": sorted(r["grid_id"] for r in distinct.values())}


def _ranks(x: np.ndarray) -> np.ndarray:
    """Ranks from 1, ties given their mean rank."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x))
    ranks[order] = np.arange(1, len(x) + 1)
    for v in np.unique(x):
        ranks[x == v] = ranks[x == v].mean()
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    ra, rb = _ranks(np.asarray(a, float)), _ranks(np.asarray(b, float))
    return float(np.corrcoef(ra, rb)[0, 1])


def compare(path: str, ref_path: str) -> Dict[str, Any]:
    """``path``'s rows against ``ref_path``'s, joined on (grid id[, seed]):
    prints one table row per run and the summary; returns {rows, n,
    mean_abs_delta_best, spearman_best, per_id: {id: {n, mean, std,
    ref_mean, ref_std}}, paired_delta_vs_4061: {seed: Δ}}. Rows on one side
    only are left out (and counted: ``unmatched``)."""
    def key(r):
        return (r["grid_id"], r.get("seed"))

    mine = {key(r): r for r in read_rows(path)}
    ref = {key(r): r for r in read_rows(ref_path)}
    keys = sorted(set(mine) & set(ref), key=lambda k: (k[0], -1 if k[1] is None else k[1]))
    print("| grid id | seed | best | ref best | Δ | final | ref final | epochs | ref epochs | "
          "stopped | ref stopped |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    table = []
    for k in keys:
        a, b = mine[k], ref[k]
        row = dict(grid_id=k[0], seed=k[1], best=a["best_psnr"], ref_best=b["best_psnr"],
                   delta=a["best_psnr"] - b["best_psnr"], final=a["final_psnr"],
                   ref_final=b["final_psnr"], epochs=a["epochs_run"], ref_epochs=b["epochs_run"],
                   stopped=a["stopped_early"], ref_stopped=b["stopped_early"])
        table.append(row)
        print(f"| {k[0]} | {'' if k[1] is None else k[1]} | {row['best']:.3f} | "
              f"{row['ref_best']:.3f} | {row['delta']:+.3f} | {row['final']:.3f} | "
              f"{row['ref_final']:.3f} | {row['epochs']} | {row['ref_epochs']} | "
              f"{row['stopped']} | {row['ref_stopped']} |")
    best = [r["best"] for r in table]
    ref_best = [r["ref_best"] for r in table]
    out: Dict[str, Any] = dict(
        rows=table, n=len(table), unmatched=len(set(mine) ^ set(ref)),
        mean_abs_delta_best=float(np.mean(np.abs(np.subtract(best, ref_best)))) if table else None,
        spearman_best=spearman(best, ref_best) if len(table) > 2 else None)
    groups = defaultdict(list)
    for r in table:
        groups[r["grid_id"]].append(r)
    out["per_id"] = {
        g: dict(n=len(rs), mean=float(np.mean([r["best"] for r in rs])),
                std=float(np.std([r["best"] for r in rs], ddof=1)) if len(rs) > 1 else None,
                ref_mean=float(np.mean([r["ref_best"] for r in rs])),
                ref_std=(float(np.std([r["ref_best"] for r in rs], ddof=1)) if len(rs) > 1
                         else None))
        for g, rs in sorted(groups.items())}
    anchor = {r["seed"]: r["best"] for r in groups.get(4061, [])}
    out["paired_delta_vs_4061"] = {
        f"{g}/{r['seed']}": r["best"] - anchor[r["seed"]]
        for g, rs in sorted(groups.items()) if g != 4061 for r in rs
        if r["seed"] is not None and r["seed"] in anchor}
    summary = {k: v for k, v in out.items() if k != "rows"}
    print(json.dumps(summary))
    return out


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--compare=")]
    refs = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--compare=")]
    if refs:
        compare(args[0], refs[0])
    else:
        main(args[0] if len(args) > 0 else DEFAULT, int(args[1]) if len(args) > 1 else 15)
