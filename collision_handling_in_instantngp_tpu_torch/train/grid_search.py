"""Grid-search driver: a sweep over the 48,000 reference configurations,
resumable and shardable, as the JAX package's driver runs it.

  * a completion MANIFEST (JSONL, one row per finished id) makes a sweep
    resumable: ids already in it are skipped and their rows replayed. The
    rows are the JAX package's, written the same way, so either package
    resumes the other's sweep;
  * sharding: a process owns ``ids[shard_index::shard_count]``; a ``None``
    shard reads the ``torch.distributed`` rank and world size where a
    process group is initialised (shard 0 of 1 otherwise);
  * ensembles: ``ensemble_size > 1`` trains the pending ids in groups of
    one shape, ``ensemble_size`` at a time (``trainer.fit_ensemble``), with
    the same manifest rows.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..config import (
    ExperimentConfig, ModelConfig, TrainConfig, experiment_from_grid_id,
    get_grid_search_configs,
)
from ..data import ImageData
from ..utils.logging import MetricLogger, NullLogger
from . import trainer


def load_manifest(path: str) -> Dict[int, Dict[str, Any]]:
    done: Dict[int, Dict[str, Any]] = {}
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    row = json.loads(line)
                    done[int(row["grid_id"])] = row
    return done


def append_manifest(path: str, row: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


def resolve_shard(shard_index: Optional[int], shard_count: Optional[int]) -> Tuple[int, int]:
    """(index, count); ``None`` in either means the ``torch.distributed``
    rank and world size of an initialised process group, else 0 of 1."""
    if shard_index is not None and shard_count is not None:
        return shard_index, shard_count
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_grid_search(
    data: ImageData,
    start_id: int = 0,
    end_id: Optional[int] = None,
    *,
    base_model: Optional[ModelConfig] = None,
    base_train: Optional[TrainConfig] = None,
    epochs: Optional[int] = None,
    manifest_path: Optional[str] = "runs/grid_manifest.jsonl",
    logger_factory: Optional[Callable[[ExperimentConfig], MetricLogger]] = None,
    hpd_weights_path: Optional[str] = None,
    encoding_weights_path: Optional[str] = None,
    shard_index: Optional[int] = 0,
    shard_count: Optional[int] = 1,
    verbose: bool = True,
    progress: bool = False,
    epoch_span: int = 1,
    compile_cache: bool = True,
    ensemble_size: int = 1,
    log_image_every: Optional[int] = None,
    ids: Optional[Sequence[int]] = None,
    device="cuda",
) -> List[Dict[str, Any]]:
    """Sweep the ids [start_id, end_id) (end exclusive; None: through the
    last id), or the explicit ``ids``, of which this shard takes
    ``ids[shard_index::shard_count]``. Returns one row per id of this
    shard: the manifest's row where the id is done, else that of a new
    ``fit`` on ``device``, appended to the manifest.

    ``compile_cache`` is accepted for the JAX package's signature and does
    nothing: eager PyTorch compiles no epoch program to share.
    ``epoch_span`` goes to ``fit``. ``ensemble_size > 1`` trains the pending
    ids with ``trainer.fit_ensemble`` (spans of ``max(1, epoch_span)``), as
    the JAX driver does: that path takes no logger factory, no
    ``hpd_weights_path`` or ``encoding_weights_path`` and no
    ``log_image_every``."""
    shard_index, shard_count = resolve_shard(shard_index, shard_count)
    grid = get_grid_search_configs()
    if ids is None:
        end_id = len(grid) if end_id is None else end_id
        if not (0 <= start_id <= len(grid)) or end_id > len(grid):
            raise ValueError(
                f"grid id range [{start_id}, {end_id}) out of bounds — the filtered grid "
                f"has {len(grid)} configs (ids 0..{len(grid) - 1})")
        ids = range(start_id, end_id)
    else:
        bad = [i for i in ids if not 0 <= i < len(grid)]
        if bad:
            raise ValueError(
                f"grid ids out of bounds: {bad[:5]} — the filtered grid has {len(grid)} "
                f"configs (ids 0..{len(grid) - 1})")
    ids = list(ids)[shard_index::shard_count]

    done = load_manifest(manifest_path) if manifest_path else {}
    results: List[Dict[str, Any]] = []
    if ensemble_size > 1:
        return _run_ensembled(data, ids, grid, done, results, base_model=base_model,
                              base_train=base_train, epochs=epochs, manifest_path=manifest_path,
                              verbose=verbose, epoch_span=epoch_span,
                              ensemble_size=ensemble_size, device=device)
    for grid_id in ids:
        if grid_id in done:
            if verbose:
                print(f"grid {grid_id}: already complete (manifest), skipping")
            results.append(done[grid_id])
            continue
        exp = experiment_from_grid_id(grid_id, base_model=base_model, base_train=base_train,
                                      grid=grid)
        if verbose:
            print(f"Grid search params: {grid_id}")
            print(grid[grid_id])
        logger = logger_factory(exp) if logger_factory else NullLogger()
        # through the module, so that a caller's replacement of trainer.fit
        # is the one that runs
        result = trainer.fit(
            exp, data, epochs=epochs, device=device, verbose=verbose, logger=logger,
            hpd_weights_path=hpd_weights_path, encoding_weights_path=encoding_weights_path,
            log_image_every=log_image_every, collect_history=False, progress=progress,
            epoch_span=epoch_span,
        )
        _record(results, manifest_path, grid_id, data, result)
    return results


def _record(results, manifest_path, grid_id, data, result) -> None:
    """The manifest row of one finished id, appended to the manifest and to
    ``results``."""
    row = {
        "grid_id": grid_id,
        "image": data.name,
        "best_psnr": result.best_psnr,
        "final_psnr": result.final_psnr,
        "final_loss": result.final_loss,
        "epochs_run": result.epochs_run,
        "stopped_early": result.stopped_early,
        "zero_collision_abort": result.zero_collision_abort,
        "run_dir": result.run_dir,
    }
    if manifest_path:
        append_manifest(manifest_path, row)
    results.append(row)


def _run_ensembled(data, ids, grid, done, results, *, base_model, base_train, epochs,
                   manifest_path, verbose, epoch_span, ensemble_size, device):
    """The ensembled sweep (JAX ``_run_ensembled``): ids in the manifest are
    skipped and replayed, the pending ones grouped by shape (``model``,
    ``batch_fraction``) in first-seen order and trained ``ensemble_size``
    at a time, each member's run named ``ens{id}``."""
    pending = []
    for grid_id in ids:
        if grid_id in done:
            if verbose:
                print(f"grid {grid_id}: already complete (manifest), skipping")
            results.append(done[grid_id])
            continue
        pending.append(grid_id)

    groups = defaultdict(list)
    for grid_id in pending:
        exp = experiment_from_grid_id(grid_id, base_model=base_model, base_train=base_train,
                                      grid=grid)
        groups[(exp.model, exp.train.batch_fraction)].append((grid_id, exp))

    for members in groups.values():
        for i in range(0, len(members), ensemble_size):
            chunk = members[i:i + ensemble_size]
            if verbose:
                print(f"ensemble ({len(chunk)} configs): {[g for g, _ in chunk]}")
            fits = trainer.fit_ensemble(
                [e for _, e in chunk], data, epochs=epochs, epoch_span=max(1, epoch_span),
                run_names=[f"ens{g}" for g, _ in chunk], verbose=verbose, device=device)
            for (grid_id, _), result in zip(chunk, fits):
                _record(results, manifest_path, grid_id, data, result)
    return results
