"""The early stopper replayed over epoch logs, and two logs compared epoch by
epoch.

The stopper decides only where a run ends, never what it trains, so a log
of a run with early stopping off (``run_cold``: tolerance 10^9) holds every
run with a smaller tolerance up to its stop. :func:`replay` feeds the logged
``train_loss`` to ``EarlyStopping`` as ``fit`` does (epoch 0 skipped; the
epoch after the one that trips it still runs), with ``fit``'s zero-collision
abort, and gives what ``fit`` at that tolerance would have returned
(``epochs_run``, ``stopped_early``, best and final PSNR), the last epoch whose
loss the stopper took as a new best, and its counter at a chosen epoch.
Logs of either package work: both write the same JSONL rows.

    python scripts/stop_replay.py \\
        --logs jax='runs_jax/*_cold_seed*.jsonl' --logs port='runs/*_cold_seed*.jsonl' \\
        [--tolerance 500] [--epochs 1000] [--counter-at 450] \\
        [--compare A.jsonl B.jsonl] [--at 20,50,100,200,450] [--json-out PATH]

``--logs LABEL=GLOB`` (two of them): a row per seed (read from ``seed<N>``
in the file name) with both labels' replays, the count of runs that
stopped before ``--epochs`` in each, and the one-sided Fisher exact p that
the second label stops early more often than the first. ``--compare``: for
each of the collision counts, ``mse_loss``, ``train_loss`` and
``train_psnr``, the first epoch at which the two logs differ and their gap
at the ``--at`` epochs, and each log's stopper state at ``--counter-at``.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from collision_handling_in_instantngp_tpu_torch.train.early_stopping import EarlyStopping  # noqa: E402

COMPARED = ("collisions_level0", "collisions_level1", "collisions_level2", "collisions_level3",
            "mse_loss", "train_loss", "train_psnr")


def read_log(path: str) -> List[Dict[str, Any]]:
    """The epoch rows of a JSONL log (gzipped where the name ends in .gz),
    in step order."""
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return sorted(rows, key=lambda r: r["step"])


def replay(rows: Sequence[Dict[str, Any]], tolerance: int = 500, epochs: Optional[int] = None,
           min_delta: float = 1e-6, counter_at: Optional[int] = None,
           zero_collision_abort: bool = True) -> Dict[str, Any]:
    """``fit``'s stop decision over ``rows`` (the first ``epochs`` of
    them)."""
    rows = list(rows)[:epochs]
    stopper = EarlyStopping(tolerance=tolerance, min_delta=min_delta)
    best, last_improvement, counter, check = -math.inf, None, None, []
    levels = sorted(int(k[len("collisions_level"):]) for k in rows[0]
                    if re.fullmatch(r"collisions_level\d+", k))
    epochs_run, final = 0, None
    for ep, r in enumerate(rows):
        epochs_run, final = ep + 1, r
        best = max(best, r["train_psnr"])
        if zero_collision_abort and ep != 0 and len(check) < 10:
            check.append(all(r[f"collisions_level{l}"] == 0 for l in levels[-2:]))
            if len(check) == 10 and all(check):
                stopper.early_stop = True
        if stopper.early_stop:
            break
        if ep != 0:
            stopper(r["train_loss"])
            if stopper.counter == 0:       # the stopper took this loss as its best
                last_improvement = ep
        if counter_at is not None and ep == counter_at:
            counter = stopper.counter
    return {"epochs_run": epochs_run, "stopped_early": stopper.early_stop,
            "best_psnr": best, "final_psnr": final["train_psnr"],
            "last_improvement": last_improvement, "counter": counter}


def first_difference(a: Sequence[Dict[str, Any]], b: Sequence[Dict[str, Any]], key: str):
    """The first epoch at which ``key`` differs, or None."""
    for ep, (ra, rb) in enumerate(zip(a, b)):
        if ra[key] != rb[key]:
            return ep
    return None


def compare(a: Sequence[Dict[str, Any]], b: Sequence[Dict[str, Any]],
            at: Sequence[int]) -> Dict[str, Any]:
    """Per compared key: the first differing epoch and ``b - a`` at ``at``."""
    out = {}
    for key in COMPARED:
        if key not in a[0]:
            continue
        out[key] = {"first_differs": first_difference(a, b, key),
                    "gap": {str(e): (b[e][key] - a[e][key]) if e < min(len(a), len(b)) else None
                            for e in at}}
    return out


def fisher_one_sided(stops_a: int, n_a: int, stops_b: int, n_b: int) -> float:
    """P(the second group holds at least ``stops_b`` of the stops | the
    margins): the one-sided Fisher exact test."""
    total = stops_a + stops_b
    denom = math.comb(n_a + n_b, total)
    return sum(math.comb(n_b, k) * math.comb(n_a, total - k)
               for k in range(stops_b, min(n_b, total) + 1)) / denom


def seed_of(path: str) -> Optional[int]:
    m = re.search(r"seed(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None


def paired_table(groups: Dict[str, List[str]], tolerance: int, epochs: int,
                 counter_at: Optional[int] = None) -> Dict[str, Any]:
    """Both groups' replays by seed, their early-stop counts and the
    one-sided Fisher p (the second group stopping more)."""
    labels = list(groups)
    by_seed: Dict[int, Dict[str, Any]] = {}
    for label in labels:
        for path in groups[label]:
            by_seed.setdefault(seed_of(path), {})[label] = replay(
                read_log(path), tolerance, epochs, counter_at=counter_at)
    rows = [{"seed": s, **by_seed[s]} for s in sorted(by_seed, key=lambda s: (s is None, s))]
    stops = {l: sum(1 for r in rows if l in r and r[l]["stopped_early"]) for l in labels}
    runs = {l: sum(1 for r in rows if l in r) for l in labels}
    out = {"tolerance": tolerance, "epochs": epochs, "rows": rows, "stops": stops, "runs": runs}
    if len(labels) == 2:
        a, b = labels
        out["fisher_one_sided_p"] = fisher_one_sided(stops[a], runs[a], stops[b], runs[b])
    return out


def _fmt(v) -> str:
    return "-" if v is None else (f"{v:.4f}" if isinstance(v, float) else str(v))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logs", action="append", default=[], metavar="LABEL=GLOB")
    ap.add_argument("--tolerance", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--counter-at", type=int, default=None)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--at", default="20,50,100,200,450")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    result: Dict[str, Any] = {}
    if args.logs:
        groups = {}
        for spec in args.logs:
            label, pattern = spec.split("=", 1)
            groups[label] = sorted(glob.glob(pattern))
            if not groups[label]:
                raise FileNotFoundError(f"no log matches {pattern}")
        table = paired_table(groups, args.tolerance, args.epochs, args.counter_at)
        result["paired"] = table
        labels = list(groups)
        print(f"tolerance {args.tolerance}, {args.epochs} epochs")
        print("seed".rjust(6) + "".join(
            f" | {l}: epochs_run stopped best last_impr" for l in labels))
        for r in table["rows"]:
            cells = []
            for l in labels:
                x = r.get(l)
                cells.append(" | -" if x is None else
                             f" | {x['epochs_run']} {x['stopped_early']} {_fmt(x['best_psnr'])} "
                             f"{_fmt(x['last_improvement'])}")
            print(f"{_fmt(r['seed']):>6}" + "".join(cells))
        print("early stops: " + ", ".join(f"{l} {table['stops'][l]} of {table['runs'][l]}"
                                          for l in labels))
        if "fisher_one_sided_p" in table:
            print(f"one-sided Fisher exact p ({labels[1]} stops more): "
                  f"{table['fisher_one_sided_p']:.4f}")
    if args.compare:
        at = [int(x) for x in args.at.split(",") if x]
        a, b = (read_log(p) for p in args.compare)
        cmp = compare(a, b, at)
        counter_at = args.counter_at if args.counter_at is not None else at[-1]
        states = [replay(rows, 10 ** 9, counter_at + 1, counter_at=counter_at)
                  for rows in (a, b)]
        result["compare"] = {"a": args.compare[0], "b": args.compare[1], "columns": cmp,
                             "stopper_a": states[0], "stopper_b": states[1],
                             "counter_at": counter_at}
        print(f"{'column':>18} first_differs " + " ".join(f"gap@{e:>5}" for e in at))
        for key, c in cmp.items():
            print(f"{key:>18} {_fmt(c['first_differs']):>13} "
                  + " ".join(f"{_fmt(c['gap'][str(e)]):>9}" for e in at))
        for name, s in zip("ab", states):
            print(f"stopper {name}: last improvement by epoch {counter_at} at "
                  f"{s['last_improvement']}, counter {s['counter']}")
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
