"""The cold-start PSNR protocol: one from-scratch run per seed of grid 4061
on the strawberry image, early stopping off (``tolerance = 10^9``), a
5,000-epoch budget, spans of 33 epochs. Prints one JSON line per seed, in
the JAX package's keys, and logs every epoch to
``runs/<stem>_4061_cold_seed<seed><tag>.jsonl`` (relative to the working
directory; checkpoints go to ``weights/`` there, as ``fit`` writes them).

    python -m collision_handling_in_instantngp_tpu_torch.tools.run_cold \\
        [epochs] [seed ...] [--precision=P] [--scaled] [--encoding_lr=LR] \\
        [--l_js_kl=W] [--l_collisions=W] [--no_hist] [--image=NAME] [--device=cpu]

``--scaled`` trains ``instantngp_scaled_model()`` (T = 2^14, L = 16) with
the same recipe at 1/3 batches; ``--encoding_lr`` sets the tables' rate
(the recipe's 1e-4 was tuned for T = 2^8); ``--l_js_kl`` / ``--l_collisions``
set the regularizers' weights; ``--no_hist`` turns the counts epochs off
(``histograms_rate = 10^9``). The log's tag is the JAX tool's:
``_<precision>``, ``_scaled``, ``_elr<lr>``, ``_jskl<w>``, ``_lcoll<w>``.
The image is read from the repo's ``images/`` (default ``strawberry.npy``,
the JAX package's decode of ``strawberry.jpeg``); the JSONL log keeps media
only where matplotlib is installed. It runs on the card unless given
``--device=cpu``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import List, Optional

from ..config import ExperimentConfig, experiment_from_grid_id, instantngp_scaled_model
from ..data import load_image_dataset
from ..train.trainer import fit
from ..utils.logging import JsonlLogger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EPOCH_SPAN = 33   # 33 | 99 (= histograms_rate - 1)


def run_tag(precision=None, scaled=False, encoding_lr=None, l_js_kl=None,
            l_collisions=None) -> str:
    tag = "" if not precision else f"_{precision}"
    if scaled:
        tag += "_scaled"
    if encoding_lr is not None:
        tag += f"_elr{encoding_lr:g}"
    if l_js_kl is not None:
        tag += f"_jskl{l_js_kl:g}"
    if l_collisions is not None:
        tag += f"_lcoll{l_collisions:g}"
    return tag


def cold_experiment(seed: int, precision=None, scaled=False, encoding_lr=None, l_js_kl=None,
                    l_collisions=None, no_hist=False) -> ExperimentConfig:
    """Grid 4061 with early stopping off and ``seed``, and the flags'
    changes."""
    exp = experiment_from_grid_id(4061)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, tolerance=10**9, seed=seed))
    if scaled:
        exp = dataclasses.replace(exp, model=instantngp_scaled_model(),
                                  train=dataclasses.replace(exp.train, batch_fraction=1 / 3))
    if precision:
        exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, matmul_precision=precision))
    if encoding_lr is not None:
        exp = dataclasses.replace(
            exp, optimizer=dataclasses.replace(exp.optimizer, encoding_lr=encoding_lr))
    if l_js_kl is not None:
        exp = dataclasses.replace(exp, loss=dataclasses.replace(exp.loss, l_js_kl=l_js_kl))
    if l_collisions is not None:
        exp = dataclasses.replace(exp, loss=dataclasses.replace(exp.loss, l_collisions=l_collisions))
    if no_hist:
        exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, histograms_rate=10**9))
    return exp


def main(epochs: int, seeds: List[int], precision: Optional[str] = None, scaled: bool = False,
         encoding_lr: Optional[float] = None, l_js_kl: Optional[float] = None,
         l_collisions: Optional[float] = None, no_hist: bool = False,
         image: str = "strawberry.npy", device: str = "cuda") -> List[dict]:
    data = load_image_dataset(os.path.join(REPO, "images", image))
    stem = os.path.splitext(image)[0]
    tag = run_tag(precision, scaled, encoding_lr, l_js_kl, l_collisions)
    media = importlib.util.find_spec("matplotlib") is not None
    rows = []
    for seed in seeds:
        exp = cold_experiment(seed, precision, scaled, encoding_lr, l_js_kl, l_collisions, no_hist)
        logger = JsonlLogger(f"runs/{stem}_4061_cold_seed{seed}{tag}.jsonl", save_media=media)
        try:
            res = fit(exp, data, epochs=epochs, device=device, logger=logger,
                      collect_history=False, verbose=True,
                      run_name=(f"cold_{stem}_seed{seed}{tag}" if stem != "strawberry"
                                else f"cold_seed{seed}{tag}"),
                      epoch_span=EPOCH_SPAN)
        finally:
            logger.finish()
        row = {
            "image": image, "grid_id": 4061, "seed": seed,
            "precision": precision or "highest", "scaled": scaled,
            "epochs": res.epochs_run, "best_psnr": round(res.best_psnr, 4),
            "final_psnr": round(res.final_psnr, 4),
            "final_loss": round(res.final_loss, 6), "run_dir": res.run_dir,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def parse_args(argv: List[str]) -> dict:
    """The JAX tool's command line: positional ``epochs seed ...`` and
    ``--flag=value`` options (and ``--device=``)."""
    pos = [a for a in argv if not a.startswith("--")]
    kw = dict(precision=None, encoding_lr=None, l_js_kl=None, l_collisions=None,
              image="strawberry.npy", device="cuda")
    for a in argv:
        for flag, conv in (("precision", str), ("image", str), ("device", str),
                           ("encoding_lr", float), ("l_js_kl", float), ("l_collisions", float)):
            if a.startswith(f"--{flag}="):
                kw[flag] = conv(a.split("=", 1)[1])
    return dict(epochs=int(pos[0]) if pos else 5000,
                seeds=[int(s) for s in pos[1:]] or [65535],
                scaled="--scaled" in argv, no_hist="--no_hist" in argv, **kw)


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
