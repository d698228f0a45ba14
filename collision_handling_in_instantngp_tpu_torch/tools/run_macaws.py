"""Grid 4061's recipe on the two macaw images (does the strawberry's
configuration carry to other images?): one fit per image, early stopping
off (``tolerance = 10^9``), spans of 33 epochs, every epoch logged to
``<out>/<stem>_4061.jsonl``, and one summary line per image.

    python -m collision_handling_in_instantngp_tpu_torch.tools.run_macaws \\
        [epochs=1500] [--device=cpu] [--images=PATH,PATH] [--out=DIR]

The images default to ``images/macaw.npy`` and ``images/macaw2.npy`` (the
JAX package's decodes of ``macaw.jpg`` and ``macaw2.jpg``); ``--out``
defaults to ``runs``; checkpoints go to ``weights/`` under the working
directory, as ``fit`` writes them. The logs keep media only where
matplotlib is installed. It runs on the card unless given
``--device=cpu``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Sequence

from ..config import experiment_from_grid_id
from ..data import load_image_dataset
from ..device import resolve_device
from ..train.trainer import fit
from ..utils.logging import JsonlLogger
from .grid_leaderboard import REPO

IMAGES = tuple(os.path.join(REPO, "images", n) for n in ("macaw.npy", "macaw2.npy"))


def main(epochs: int = 1500, device: str = "cuda", images: Sequence[str] = IMAGES,
         out: str = "runs") -> List[Dict[str, Any]]:
    resolve_device(device)
    exp = experiment_from_grid_id(4061)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, tolerance=10**9))
    media = importlib.util.find_spec("matplotlib") is not None
    rows = []
    for path in images:
        data = load_image_dataset(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        res = fit(exp, data, epochs=epochs, device=device,
                  logger=JsonlLogger(os.path.join(out, f"{stem}_4061.jsonl"), save_media=media),
                  collect_history=False, verbose=True, epoch_span=33)
        row = {"image": os.path.basename(path), "pixels": data.num_pixels,
               "epochs": res.epochs_run, "best_psnr": round(res.best_psnr, 4),
               "final_loss": round(res.final_loss, 6), "run_dir": res.run_dir}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def parse_args(argv: List[str]) -> Dict[str, Any]:
    """The JAX tool's ``epochs``, and ``--device=``, ``--images=``,
    ``--out=``."""
    pos = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    return dict(epochs=int(pos[0]) if pos else 1500, device=opts.get("device", "cuda"),
                images=tuple(opts["images"].split(",")) if "images" in opts else IMAGES,
                out=opts.get("out", "runs"))


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
