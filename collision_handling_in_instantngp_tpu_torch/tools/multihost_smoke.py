"""Two processes in one gloo group: a data-parallel run and the grid
driver's sharding across processes.

    python -m collision_handling_in_instantngp_tpu_torch.tools.multihost_smoke [--device cpu]

The port's counterpart of the JAX package's ``tools/multihost_smoke.py``:
two processes (``parallel.launch.spawn``, a ``FileStore`` in a temporary
directory) join one gloo group, both on the card (gloo, as NCCL takes one
rank a card) or, with ``--device cpu``, on the CPU; each trains 2 epochs
with the pixel rows split over both (``parallel.train_parallel.train_epochs``
on a (2, 1) mesh), whose losses must equal a single-process run's on the
same device within 1e-6, and runs ``run_grid_search(shard_index=None,
shard_count=None)`` over ids 4060-4063, which must give [4060, 4062] to
rank 0 and [4061, 4063] to rank 1 (the ranks read from the group). Prints
one "MULTIHOST SMOKE OK" line and exits 0; a failure of either rank exits
non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

NUM_PROCESSES = 2
EPOCHS = 2
GRID_IDS = (4060, 4061, 4062, 4063)


def tiny_setup():
    """The JAX smoke's 12 x 9 image and small grid-4061 configuration."""
    from ..config import experiment_from_grid_id
    from ..data import ImageData

    rng = np.random.default_rng(0)
    h, w = 12, 9
    img = rng.integers(0, 256, size=(h, w, 3))
    coords = (
        np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1)
        .reshape(-1, 2).astype(np.float32) / (max(h, w) - 1)
    )
    data = ImageData(coords=coords, targets=(img.reshape(-1, 3) / 255.0).astype(np.float32),
                     height=h, width=w, image=img.astype(np.int64), name="tiny.png")
    exp = experiment_from_grid_id(4061)
    exp = dataclasses.replace(
        exp,
        model=dataclasses.replace(exp.model, hash_table_size=32, hpd_hidden=(8, 16),
                                  mlp_hidden=(16,)),
        train=dataclasses.replace(exp.train, epochs=EPOCHS, save_params=False),
    )
    return data, exp


def rank_main(rank: int, world_size: int, manifest_dir: str, device: str) -> dict:
    from ..parallel.mesh import make_mesh
    from ..parallel.train_parallel import train_epochs
    from ..train.grid_search import run_grid_search

    data, exp = tiny_setup()
    run = train_epochs(exp, data, EPOCHS, make_mesh(device=device))
    rows = run_grid_search(
        data, GRID_IDS[0], GRID_IDS[-1] + 1, base_model=exp.model, base_train=exp.train,
        epochs=EPOCHS, manifest_path=os.path.join(manifest_dir, f"manifest_p{rank}.jsonl"),
        shard_index=None, shard_count=None, verbose=False, device=device,
    )
    return dict(rank=rank, world_size=world_size,
                losses=[h["loss"] for h in run["history"]],
                grid_ids_run=sorted(r["grid_id"] for r in rows))


def main(argv=None) -> int:
    from ..parallel.launch import spawn
    from ..parallel.train_parallel import train_epochs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where both ranks run: the card (default) or cpu")
    device = ap.parse_args(argv).device
    with tempfile.TemporaryDirectory() as td:
        results = spawn(rank_main, NUM_PROCESSES, (td, device), store_dir=os.path.join(td, "store"),
                        backend="gloo", device=device, timeout=600, threads=1)
    data, exp = tiny_setup()
    expected = [h["loss"] for h in train_epochs(exp, data, EPOCHS, device=device)["history"]]
    for r in results:
        assert r["world_size"] == NUM_PROCESSES, r
        for got, want in zip(r["losses"], expected):
            assert abs(got - want) < 1e-6, (r["losses"], expected)
    ids0, ids1 = results[0]["grid_ids_run"], results[1]["grid_ids_run"]
    assert ids0 == [GRID_IDS[0], GRID_IDS[2]], ids0
    assert ids1 == [GRID_IDS[1], GRID_IDS[3]], ids1
    print(f"MULTIHOST SMOKE OK: {NUM_PROCESSES} processes (gloo, {device}), DP losses "
          f"{results[0]['losses']} == single-process {expected}, grid shards {ids0} | {ids1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
