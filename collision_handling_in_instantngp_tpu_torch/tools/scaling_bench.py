"""Data-parallel scaling: pixels a second at each world size, and the
efficiency against linear scaling from the first (the port's counterpart of
the JAX package's repo-root ``tools/scaling_bench.py``).

For each ``--world`` n, n ranks are spawned (``parallel/launch.py: spawn``)
and run grid 4061's epochs on ``--pixels`` random points (seed 0), 1/3
batches, pixels split over the mesh's data axis: one warm-up epoch, then
``--epochs`` timed. ``--mode scaled`` runs ``instantngp_scaled_model()``
with the tables sharded by slot over a model axis of 2 where n is even (the
JAX tool's mesh). Prints one JSON line a world size: ``devices``,
``pixels_per_s`` (epochs x pixels over rank 0's epoch seconds) and
``efficiency_vs_linear`` (the rate over the first world size's rate times
n / that size).

On the card (``--device cuda``, the default) every rank has a card of its
own and NCCL; a world larger than the cards raises: ranks time-sliced on
one card would not measure scaling. ``--device cpu`` runs gloo ranks on
the host's cores, which checks the sharded program end to end; its
efficiency says nothing of cards.

    python -m collision_handling_in_instantngp_tpu_torch.tools.scaling_bench \\
        [--world 1 2 4 8] [--mode gngf|scaled] [--pixels 98304] [--epochs 5] \\
        [--device cuda|cpu] [--json-out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from ..config import TrainConfig, experiment_from_grid_id, instantngp_scaled_model
from ..data import ImageData
from ..device import resolve_device
from ..parallel import launch
from ..parallel.mesh import make_mesh
from ..parallel.train_parallel import train_epochs


def experiment(mode: str):
    """Grid 4061 (default geometry, or ``instantngp_scaled_model()`` at
    'scaled'), no checkpoint files."""
    exp = experiment_from_grid_id(4061, base_train=TrainConfig(save_params=False))
    if mode == "scaled":
        exp = dataclasses.replace(exp, model=instantngp_scaled_model())
    return exp


def random_points(pixels: int) -> ImageData:
    """``pixels`` uniform points in [0, 1)^2 with uniform targets (seed 0,
    the JAX tool's draws), as a (pixels x 1) image."""
    rng = np.random.default_rng(0)
    coords = rng.random((pixels, 2), dtype=np.float32)
    targets = rng.random((pixels, 3), dtype=np.float32)
    image = (targets * 255).astype(np.int64).reshape(pixels, 1, 3)
    return ImageData(coords=coords, targets=targets, height=pixels, width=1, image=image,
                     name="random")


def model_parallel(mode: str, world: int) -> int:
    return 2 if mode == "scaled" and world % 2 == 0 else 1


def scaling_worker(rank: int, world: int, spec: dict) -> dict:
    """One rank: the warm-up and timed epochs on its share of the pixels;
    its epoch seconds and losses."""
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    mp = model_parallel(spec["mode"], world)
    mesh = make_mesh(mp, device=device)
    out = train_epochs(spec["exp"], spec["data"], spec["epochs"] + 1, mesh, shard_tables=mp > 1)
    return dict(seconds=[h["seconds"] for h in out["history"]],
                loss=[h["loss"] for h in out["history"]], mesh=list(mesh.shape))


def run_world(world: int, mode: str, pixels: int, epochs: int, device: str,
              store_dir: str, timeout: float = 3600.0) -> dict:
    """Spawn ``world`` ranks and time their epochs: {"devices",
    "pixels_per_s", "epoch_s" (rank 0's timed epochs), "loss" (rank 0's,
    the warm-up's first), "mesh"}."""
    if device == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"--world {world} needs {world} cards, one a rank (NCCL); this "
                             f"machine has {cards}: ranks sharing a card would not measure "
                             "scaling")
    spec = dict(exp=experiment(mode), data=random_points(pixels), epochs=epochs, mode=mode,
                device=device)
    threads = max(1, (os.cpu_count() or 1) // world) if device == "cpu" else None
    results = launch.spawn(scaling_worker, world, (spec,), store_dir=store_dir,
                           backend="nccl" if device == "cuda" else "gloo", device=device,
                           timeout=timeout, threads=threads)
    timed = results[0]["seconds"][1:]
    return dict(devices=world, pixels_per_s=epochs * pixels / sum(timed), epoch_s=timed,
                loss=results[0]["loss"], mesh=results[0]["mesh"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Pixels a second at each world size.")
    ap.add_argument("--world", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--mode", default="gngf", choices=["gngf", "scaled"])
    ap.add_argument("--pixels", type=int, default=98304)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json-out", default="")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)             # raises without a card unless asked for the CPU
    rows, base = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.world:
            r = run_world(n, args.mode, args.pixels, args.epochs, args.device,
                          os.path.join(tmp, f"world{n}"))
            if base is None:
                base = (r["pixels_per_s"], n)
            r["efficiency_vs_linear"] = r["pixels_per_s"] / (base[0] * n / base[1])
            rows.append(r)
            print(json.dumps({k: r[k] for k in ("devices", "pixels_per_s",
                                                "efficiency_vs_linear")}), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump(dict(mode=args.mode, pixels=args.pixels, epochs=args.epochs,
                           device=args.device, rows=rows), fh, indent=1)
    return rows


if __name__ == "__main__":
    main()
