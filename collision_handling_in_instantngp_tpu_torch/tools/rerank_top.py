"""Full-budget rerank of a screening sweep's winners: the ids that beat
grid 4061 in the screening manifest, folded by
``grid_leaderboard.effective_key`` (each effective configuration keeps its
best id), the top ``top_n`` of them and 4061 as the anchor, rerun at the
reference's protocol: a 5,000-epoch budget with its early stopping
(tolerance 500, ``TrainConfig``'s default), spans of 33 epochs. The run
appends to its own manifest, so a killed run resumes.

    python -m collision_handling_in_instantngp_tpu_torch.tools.rerank_top \\
        [screening_manifest] [top_n] [epochs] [ensemble_size] \\
        [--device=cpu] [--image=PATH] [--out=DIR]

``ensemble_size > 1`` trains same-shape winners through ``fit_ensemble``
(the manifest rows are those of the one-by-one path). The manifest is
``<out>/rerank_full_manifest.jsonl`` (``--out`` default ``runs``);
checkpoints go to ``weights/`` under the working directory, as ``fit``
writes them. The image defaults to ``images/strawberry.npy`` (the JAX
package's decode of ``strawberry.jpeg``). It runs on the card unless given
``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..data import load_image_dataset
from ..device import resolve_device
from ..train.grid_search import run_grid_search
from .grid_leaderboard import DEFAULT, IMAGE, distinct_winners, read_rows


def pick_ids(manifest_path: str, top_n: int) -> Tuple[List[int], Optional[Dict[str, Any]]]:
    """(the ``top_n`` best distinct winners over 4061, best first; 4061's
    screening row)."""
    rows = read_rows(manifest_path)
    ref = next((r for r in rows if r["grid_id"] == 4061), None)
    winners = [r["grid_id"] for r in list(distinct_winners(rows, ref).values())[:top_n]]
    return winners, ref


def main(manifest_path: str = DEFAULT, top_n: int = 20, epochs: int = 5000, ensemble: int = 1,
         device: str = "cuda", image: str = IMAGE, out: str = "runs") -> Dict[str, Any]:
    resolve_device(device)
    winners, _ = pick_ids(manifest_path, top_n)
    ids = winners + [4061]
    print(json.dumps({"rerank_ids": ids, "screening_manifest": manifest_path}), flush=True)
    data = load_image_dataset(image)
    rows = run_grid_search(
        data, ids=ids, epochs=epochs,
        manifest_path=os.path.join(out, "rerank_full_manifest.jsonl"),
        verbose=False, epoch_span=33, ensemble_size=ensemble, device=device,
    )
    rows.sort(key=lambda r: -r["best_psnr"])
    ref = next((r for r in rows if r["grid_id"] == 4061), None)
    summary = {
        "budget": epochs,
        "protocol": "reference early stopping (tolerance=500)",
        "n_rerun": len(rows),
        "best": {"grid_id": rows[0]["grid_id"], "best_psnr": round(rows[0]["best_psnr"], 4),
                 "epochs_run": rows[0]["epochs_run"]},
        "anchor_4061": ({"best_psnr": round(ref["best_psnr"], 4), "epochs_run": ref["epochs_run"]}
                        if ref else None),
        "beat_4061_full_budget": sorted(
            r["grid_id"] for r in rows if ref and r["best_psnr"] > ref["best_psnr"]),
    }
    print(json.dumps(summary), flush=True)
    return summary


def parse_args(argv: List[str]) -> Dict[str, Any]:
    """The JAX tool's positional arguments, and ``--device=``,
    ``--image=``, ``--out=``."""
    pos = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    return dict(manifest_path=pos[0] if len(pos) > 0 else DEFAULT,
                top_n=int(pos[1]) if len(pos) > 1 else 20,
                epochs=int(pos[2]) if len(pos) > 2 else 5000,
                ensemble=int(pos[3]) if len(pos) > 3 else 1,
                device=opts.get("device", "cuda"), image=opts.get("image", IMAGE),
                out=opts.get("out", "runs"))


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
