"""Seed panel of grid configurations at the reference's protocol: N seeds x
M ids of one shape, trained side by side through ``fit_ensemble`` (at most
``ensemble_cap`` members a call), 5,000 epochs with the reference's early
stopping (tolerance 500), spans of 33 epochs. By default 3761 (the
full-budget rerank's best, JS mode, ``l_mse`` 500, ``l_js_kl`` 100, K = 4)
and 4061 (the reference's pick) over 5 fresh seeds.

    python -m collision_handling_in_instantngp_tpu_torch.tools.seed_panel \\
        [epochs] [--ids=3761,4061] [--seeds=7,42,123,2026,31337] \\
        [--device=cpu] [--image=PATH] [--out=DIR]

Appends one JSON row per (grid id, seed) to
``<out>/seed_panel_manifest.jsonl`` (``--out`` default ``runs``), the JAX
tool's keys, and skips the pairs already there. Each member writes its
best checkpoint to ``weights/<id>_panel<id>s<seed>`` under the working
directory. The image defaults to ``images/strawberry.npy``. It runs on the
card unless given ``--device=cpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Sequence

from ..config import experiment_from_grid_id
from ..data import load_image_dataset
from ..device import resolve_device
from ..train.trainer import fit_ensemble
from .grid_leaderboard import IMAGE, grid_configs
MANIFEST = "seed_panel_manifest.jsonl"


def main(epochs: int = 5000, ids: Sequence[int] = (3761, 4061),
         seeds: Sequence[int] = (7, 42, 123, 2026, 31337), ensemble_cap: int = 16,
         device: str = "cuda", image: str = IMAGE, out: str = "runs") -> List[Dict[str, Any]]:
    """Trains the pairs not yet in the manifest; returns their rows."""
    resolve_device(device)
    data = load_image_dataset(image)
    manifest = os.path.join(out, MANIFEST)
    done = set()
    if os.path.exists(manifest):
        with open(manifest) as f:
            for line in f:
                if line.strip():
                    row = json.loads(line)
                    done.add((row["grid_id"], row["seed"]))

    members = []
    for gid in ids:
        for seed in seeds:
            if (gid, seed) in done:
                continue
            exp = experiment_from_grid_id(gid, grid=grid_configs())
            exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, seed=seed))
            members.append((gid, seed, exp))
    if not members:
        print(json.dumps({"panel": "all members already in manifest"}))
        return []
    os.makedirs(out, exist_ok=True)
    rows = []
    for i in range(0, len(members), ensemble_cap):
        chunk = members[i:i + ensemble_cap]
        fits = fit_ensemble([e for _, _, e in chunk], data, epochs=epochs, epoch_span=33,
                            run_names=[f"panel{g}s{s}" for g, s, _ in chunk], verbose=False,
                            device=device)
        with open(manifest, "a") as f:
            for (gid, seed, _), res in zip(chunk, fits):
                row = {"grid_id": gid, "seed": seed, "best_psnr": res.best_psnr,
                       "final_psnr": res.final_psnr, "epochs_run": res.epochs_run,
                       "stopped_early": res.stopped_early}
                f.write(json.dumps(row) + "\n")
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def parse_args(argv: List[str]) -> Dict[str, Any]:
    """The JAX tool's ``epochs --ids= --seeds=``, and ``--device=``,
    ``--image=``, ``--out=``."""
    pos = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    kw: Dict[str, Any] = dict(epochs=int(pos[0]) if pos else 5000,
                              device=opts.get("device", "cuda"), image=opts.get("image", IMAGE),
                              out=opts.get("out", "runs"))
    for key in ("ids", "seeds"):
        if key in opts:
            kw[key] = tuple(int(v) for v in opts[key].split(","))
    return kw


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
