"""Run ``chip_smoke.py`` from several checkouts in one chip call, in a set
order, and set their kernel times and epochs side by side.

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.ab_smoke \\
        --run parent=_archive/parent --run change=_archive/change \\
        --order parent,change,change,parent --out chiprun_out/ab

Each run is ``python3 chip_smoke.py`` in its checkout, a process of its own
(its kernels built from that checkout's sources). Run i's standard output
and errors go to ``<out>/<i>_<label>.log``, its ``chiprun_out/chip_smoke.json``
is copied to ``<out>/<i>_<label>.json``. Then it prints, for every entry of
the runs' ``{"kernels": [...]}`` lines, the ms of each run in order, and the
epoch seconds and profiled idle share of each training phase (the wide
stack's ``--scaled`` fit where the smoke has one), and writes the same to
``<out>/ab.json``. With ``--digests``, after each run K2 and K6 of that
checkout also run on one set of seeded inputs (``tools/k2_phases.py``'s
AB_SHAPES): timed at each shape, their outputs hashed at H = 128
(DIGEST_SHAPES: ``--scaled``'s T = 2^14 and T = 2^16 at U_c = 161,792); it
prints each run's ms and sha256 and fails unless every run's digests at
H = 128 are equal (the wide shape, ``scaled256``, is timed only). Exits
non-zero if any run did (or printed no kernels line). Two versions are
compared only within one call: the card's power limit and clocks differ
between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

# chip_smoke.json: (phase, the key of its fit history, the key of its profile)
PHASES = (("dedup T=2^14", "fit", "profile"), ("split T=2^16", "split_fit", "split_profile"))
# the wide stack's --scaled fit (chip_smoke.py step 13), where the smoke has it
WIDE_PHASE = "wide --scaled H=256"


def kernels_line(stdout: str) -> dict:
    """{name: ms} from the last ``{"kernels": [...]}`` line of a smoke's output."""
    for line in reversed(stdout.splitlines()):
        if line.startswith('{"kernels"'):
            return {e["name"]: e["ms"] for e in json.loads(line)["kernels"]}
    raise RuntimeError("no kernels line in the smoke's output")


def phases(smoke: dict) -> dict:
    """{phase: {"epoch_s": [...], "idle_share": x}} of one chip_smoke.json,
    the per-row fits by route."""
    out = {}
    for name, fit_key, prof_key in PHASES:
        out[name] = dict(epoch_s=[r["seconds"] for r in smoke[fit_key]],
                         idle_share=smoke[prof_key]["idle_share"])
    for route, fit in smoke["per_row_fits"].items():
        out[f"per-row {route}"] = dict(epoch_s=[r["seconds"] for r in fit["history"]])
    out["per-row auto"]["idle_share"] = smoke["per_row_profile"]["idle_share"]
    wide = smoke.get("wide_fit", {}).get("dedup")
    if wide is not None:
        out[WIDE_PHASE] = dict(epoch_s=[r["seconds"] for r in wide["history"]])
        if "profile" in wide:
            out[WIDE_PHASE].update(idle_share=wide["profile"]["idle_share"],
                                   k2_ms=wide["profile"]["k2_ms"])
    for geometry, fit in smoke.get("vanilla", {}).items():
        if "history" in fit:
            out[f"vanilla {geometry}"] = dict(epoch_s=[r["seconds"] for r in fit["history"]],
                                              idle_share=fit["profile"]["idle_share"])
    return out


def digest_table(runs, compared) -> bool:
    """Prints each run's K2 / K6 output digests and ms by shape; True where
    every run's digests are equal at each shape of ``compared``."""
    same = True
    for shape in runs[0]["digests"]["shapes"]:
        for kname in ("K2", "K6"):
            cells = [r["digests"]["shapes"][shape][kname] for r in runs]
            verdict = ""
            if shape in compared:
                equal = len({c["sha256"] for c in cells}) == 1
                same &= equal
                verdict = "  (equal)" if equal else "  (DIFFER)"
            print(f"{kname} {shape:10s} sha256 " + " ".join(c["sha256"] for c in cells) + verdict)
            print(f"{'':14s}ms " + " ".join(f"{c['ms']:16.3f}" for c in cells))
    return same


def run_one(i: int, label: str, checkout: str, out_dir: str, timeout: float,
            inputs: str = "") -> dict:
    tag = f"{i}_{label}"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=checkout, capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{tag}.log"), "w") as f:
        f.write(proc.stdout + "\n== stderr\n" + proc.stderr)
    print(f"run {tag}: exit {proc.returncode}, {secs:.1f} s", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"run {tag} failed (exit {proc.returncode}); see {tag}.log")
    src = os.path.join(checkout, "chiprun_out", "chip_smoke.json")
    shutil.copy(src, os.path.join(out_dir, f"{tag}.json"))
    with open(src) as f:
        smoke = json.load(f)
    run = dict(run=tag, seconds=secs, gpu=smoke["gpu"], kernels=kernels_line(proc.stdout),
               phases=phases(smoke))
    if inputs:
        from . import k2_phases

        run["digests"] = k2_phases.run_worker(f"{tag}_digests", checkout, inputs, out_dir, 3,
                                              False, timeout)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", required=True, metavar="LABEL=DIR",
                    help="a checkout to run chip_smoke.py in, under a label")
    ap.add_argument("--order", required=True, help="labels in run order, comma separated")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab"))
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds for each run")
    ap.add_argument("--digests", action="store_true",
                    help="hash each run's K2 and K6 outputs at H = 128 on shared inputs")
    args = ap.parse_args(argv)
    checkouts = dict(r.split("=", 1) for r in args.run)
    order = args.order.split(",")
    unknown = [label for label in order if label not in checkouts]
    if unknown:
        ap.error(f"--order names {unknown}, not given by --run")
    os.makedirs(args.out, exist_ok=True)
    inputs = ""
    if args.digests:
        from . import k2_phases

        inputs = os.path.join(os.path.abspath(args.out), "k2_digest_inputs.pt")
        k2_phases.make_inputs(inputs, k2_phases.AB_SHAPES, seed=65535)
    try:
        runs = [run_one(i, label, checkouts[label], args.out, args.timeout, inputs)
                for i, label in enumerate(order)]
    finally:
        if inputs:
            os.remove(inputs)

    print(runs[0]["gpu"])
    names = list(dict.fromkeys(n for r in runs for n in r["kernels"]))
    print(f"{'kernel ms':34s}" + "".join(f"{r['run']:>14s}" for r in runs))
    for n in names:
        cells = [r["kernels"].get(n) for r in runs]
        print(f"{n:34s}" + "".join(f"{'-':>14s}" if c is None else f"{c:14.3f}" for c in cells))
    for phase in runs[0]["phases"]:
        print(f"{phase}:")
        for r in runs:
            p = r["phases"].get(phase, {})
            idle = "" if "idle_share" not in p else f", idle {p['idle_share']:.2%}"
            print(f"  {r['run']:14s} epoch s {p.get('epoch_s')}{idle}")
    same = True
    if inputs:
        from . import k2_phases

        same = digest_table(runs, k2_phases.DIGEST_SHAPES)
    with open(os.path.join(args.out, "ab.json"), "w") as f:
        json.dump(dict(order=order, checkouts=checkouts, runs=runs), f, indent=1)
    if not same:
        raise RuntimeError("K2 / K6 outputs at H = 128 differ between the runs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
