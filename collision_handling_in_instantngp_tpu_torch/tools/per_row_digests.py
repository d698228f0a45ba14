"""Hash and time the per-row kernels K10 (``hpd_full_fwd``), K11
(``hpd_full_bwd``) and K8 (``hpd_tail_fwd``) of one or more checkouts on
the same seeded inputs, in one chip call.

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.per_row_digests \\
        --run parent=_archive/parent --run change=. [--out chiprun_out/per_row_digests]

STACKS are the stacks K10 and K11 take, one of each kind of tile: the
per-row route's [2, 32, 64, 128, 256] at its size (L = 4, N = 229,616, a
64-row tile, K11's padded layout), (3, 16, 24, 40, 96, 512) (32 rows),
(3, 24, 37, 203) (widths that are not multiples of 8), (2, 256, 512, 256,
256) (past 128 wide, 16 rows) and (2, 13, 100, 512, 256) (K11's compact
layout, an odd width, past 128 wide, 32 rows). The inputs are numpy draws
from one seed, made in each run alike: integer vertices, each layer
N(0, (0.5 / sqrt(fan-in))^2) (the head N(0, 0.2^2)), biases N(0, 0.1^2),
and N(0, 1) cotangents. For each stack a run hashes (sha256) K10's marg,
vals, idx and its count of redone rows, and K11's dW and db of every layer
on K10's own idx; for K8, its marg, vals and idx on the per-row route's
own head input (``k11_phases.per_row_head_input``: batch 0 of grid 4061,
as ``chip_smoke.py`` step 6 takes it). Each kernel is also timed (CUDA
events). Each run is a process of its own that imports the package of its
checkout (PYTHONPATH), so its kernels build from that checkout's sources.
Prints the card's name and power limit, each run's digests and ms side by
side, and exits non-zero unless every run's digests are equal;
``tools/ab_smoke.py --digests`` runs the same worker after each smoke.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

# name: (widths [d, hidden..., T], K, L, N)
STACKS = {"route": ((2, 32, 64, 128, 256), 4, 4, 229_616),
          "rpt2": ((3, 16, 24, 40, 96, 512), 4, 2, 20_000),
          "odd": ((3, 24, 37, 203), 8, 2, 20_000),
          "wide": ((2, 256, 512, 256, 256), 4, 2, 20_000),
          "compact": ((2, 13, 100, 512, 256), 4, 2, 20_000)}
SEED = 65535


def sha256(tensors) -> str:
    digest = hashlib.sha256()
    for a in tensors:
        digest.update(a.detach().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def stack_inputs(name: str, dev):
    """Seeded vertices, layers and cotangents of STACKS[name]."""
    widths, k, l, n = STACKS[name]
    rng = np.random.default_rng((SEED, list(STACKS).index(name)))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    verts = f32(rng.integers(0, 512, size=(l, n, widths[0])))
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / math.sqrt(din) if i < len(widths) - 2 else 0.2
        layers.append((f32(rng.standard_normal((din, dout)) * scale),
                       f32(rng.standard_normal(dout) * 0.1)))
    g_marg = f32(rng.standard_normal((l, widths[-1])))
    g_vals = f32(rng.standard_normal((l, n, k)))
    return verts, layers, g_marg, g_vals, k


def worker(reps: int) -> dict:
    """Every stack through the K10 and K11, and K8, of the package on sys.path."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full, hpd_tail
    from collision_handling_in_instantngp_tpu_torch.tools import k11_phases
    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    out = dict(package=os.path.dirname(os.path.abspath(hpd_full.__file__)), stacks={})
    for name in STACKS:
        verts, layers, g_marg, g_vals, k = stack_inputs(name, dev)
        fwd = hpd_full.hpd_full_fwd(verts, layers, k)
        n_fix = hpd_full.hpd_full_fwd.fixup_rows.clone()
        bargs = (verts, layers, fwd[2], g_marg, g_vals, k)
        grads = [t for pair in hpd_full.hpd_full_bwd(*bargs) for t in pair]
        out["stacks"][name] = dict(
            K10=dict(sha256=sha256([*fwd, n_fix]), fixup_rows=int(n_fix.item()),
                     ms=profiling.cuda_ms(lambda: hpd_full.hpd_full_fwd(verts, layers, k), reps)),
            K11=dict(sha256=sha256(grads),
                     ms=profiling.cuda_ms(lambda: hpd_full.hpd_full_bwd(*bargs), reps)))
        del verts, layers, fwd, grads, bargs
        torch.cuda.empty_cache()
    h, (w, b) = k11_phases.per_row_head_input(dev, SEED)
    out["K8"] = dict(shape=list(h.shape), sha256=sha256(hpd_tail.hpd_tail_fwd(h, w, b, 4)),
                     ms=profiling.cuda_ms(lambda: hpd_tail.hpd_tail_fwd(h, w, b, 4), reps))
    return out


def run_worker(label: str, checkout: str, out_dir: str, reps: int, timeout: float) -> dict:
    """``worker`` in a process of its own on ``checkout``'s package."""
    result = os.path.join(os.path.abspath(out_dir), f"{label}.json")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", result, "--reps", str(reps)]
    proc = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True, text=True,
                          timeout=timeout)
    with open(os.path.join(out_dir, f"{label}.log"), "w") as f:
        f.write(proc.stdout + "\n== stderr\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"per_row_digests run {label} failed (exit {proc.returncode}); "
                           f"see {label}.log")
    with open(result) as f:
        return json.load(f)


def digest_table(runs) -> bool:
    """Prints each run's K10 / K11 digests and ms by stack and K8's; True
    where every run's digests are equal."""
    same = True
    cells = {f"{kname} {name}": [r["stacks"][name][kname] for r in runs]
             for name in runs[0]["stacks"] for kname in ("K10", "K11")}
    cells["K8 route h"] = [r["K8"] for r in runs]
    for what, row in cells.items():
        equal = len({c["sha256"] for c in row}) == 1
        same &= equal
        print(f"{what:12s} sha256 " + " ".join(c["sha256"] for c in row)
              + ("  (equal)" if equal else "  (DIFFER)"))
        print(f"{'':12s}     ms " + " ".join(f"{c['ms']:16.3f}" for c in row))
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", default=[], metavar="LABEL=DIR",
                    help="a checkout to hash, under a label (default: this one)")
    ap.add_argument("--order", help="labels in run order, comma separated (default: as given)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "per_row_digests"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds for each run")
    ap.add_argument("--worker", metavar="RESULT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: per_row_digests runs CUDA kernels and has no CPU mode")
    if args.worker:
        with open(args.worker, "w") as f:
            json.dump(worker(args.reps), f)
        return 0
    from ..utils import profiling

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    checkouts = dict(r.split("=", 1) for r in args.run) or {"this": root}
    order = args.order.split(",") if args.order else list(checkouts)
    os.makedirs(args.out, exist_ok=True)
    runs = [dict(run=f"{i}_{label}", **run_worker(f"{i}_{label}", checkouts[label], args.out,
                                                   args.reps, args.timeout))
            for i, label in enumerate(order)]
    print(f"card: {profiling.gpu_name_and_power_limit()}")
    print("runs: " + ", ".join(r["run"] for r in runs))
    same = digest_table(runs)
    with open(os.path.join(args.out, "per_row_digests.json"), "w") as f:
        json.dump(dict(order=order, checkouts=checkouts, runs=runs), f, indent=1)
    print(f"digests equal in every run: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
