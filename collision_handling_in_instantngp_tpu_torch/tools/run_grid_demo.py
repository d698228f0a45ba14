"""A screening slice of the 48,000-id grid through the grid driver, with
configs/hour: ``count`` ids from ``start`` (or, with ``stride > 1``, the
ids ``start, start + stride, ...``), at a 300-epoch budget by default,
split over ``shards`` shards that run one after another in this process
(each owns ``ids[shard::shards]``, as a process of a multi-host sweep
would), spans of 33 epochs.

    python -m collision_handling_in_instantngp_tpu_torch.tools.run_grid_demo \\
        [start=4048] [count=32] [epochs=300] [shards=2] [ensemble=1] \\
        [manifest-tag] [stride=1] [--device=cpu] [--image=PATH] [--out=DIR]

``ensemble > 1`` trains that many same-shape ids at a time through
``fit_ensemble`` (the manifest rows are those of the one-by-one path). The
manifest is ``<out>/grid_demo<tag>_manifest.jsonl`` (``--out`` default
``runs``); ids already in it are skipped. Prints one JSON line a shard and
a summary line with ``configs_per_hour_per_chip`` and, beside it, the
card's name and power limit (``gpu``; None on the CPU). The image defaults
to ``images/strawberry.npy``. It runs on the card unless given
``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Tuple

from ..data import load_image_dataset
from ..device import resolve_device
from ..train.grid_search import run_grid_search
from ..utils.profiling import device_info
from .grid_leaderboard import IMAGE


def main(start: int = 4048, count: int = 32, epochs: int = 300, shards: int = 2,
         ensemble: int = 1, tag: str = "", stride: int = 1, device: str = "cuda",
         image: str = IMAGE, out: str = "runs") -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Returns (the summary, every shard's rows)."""
    gpu = device_info(resolve_device(device))["gpu"]
    data = load_image_dataset(image)
    manifest = os.path.join(out, f"grid_demo{tag}_manifest.jsonl")
    ids = None if stride == 1 else list(range(start, start + count * stride, stride))
    t0 = time.perf_counter()
    all_rows: List[Dict[str, Any]] = []
    for shard in range(shards):
        rows = run_grid_search(
            data, start_id=start, end_id=start + count, epochs=epochs, manifest_path=manifest,
            shard_index=shard, shard_count=shards, verbose=False, epoch_span=33,
            ensemble_size=ensemble, ids=ids, device=device,
        )
        all_rows.extend(rows)
        print(json.dumps({"shard": shard, "configs": len(rows),
                          "elapsed_s": round(time.perf_counter() - t0, 1)}), flush=True)
    dt = time.perf_counter() - t0

    best = max(all_rows, key=lambda r: r["best_psnr"])
    summary = {
        "configs": len(all_rows),
        "epochs_per_config": epochs,
        "wall_s": round(dt, 1),
        "configs_per_hour_per_chip": round(len(all_rows) / dt * 3600, 1),
        "gpu": gpu,
        "best": {"grid_id": best["grid_id"], "best_psnr": round(best["best_psnr"], 3)},
        "aborted_zero_collisions": sum(1 for r in all_rows if r["zero_collision_abort"]),
        "stopped_early": sum(1 for r in all_rows if r["stopped_early"]),
    }
    print(json.dumps(summary), flush=True)
    return summary, all_rows


def parse_args(argv: List[str]) -> Dict[str, Any]:
    """The JAX tool's positional arguments, and ``--device=``,
    ``--image=``, ``--out=``."""
    pos = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    kw: Dict[str, Any] = dict(device=opts.get("device", "cuda"), image=opts.get("image", IMAGE),
                              out=opts.get("out", "runs"))
    for i, (key, conv) in enumerate((("start", int), ("count", int), ("epochs", int),
                                     ("shards", int), ("ensemble", int), ("tag", str),
                                     ("stride", int))):
        if len(pos) > i:
            kw[key] = conv(pos[i])
    return kw


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
