"""The parallel epoch, and a run of epochs on one rank of a mesh.

:func:`make_parallel_epoch` is the port of the JAX package's
``parallel/train_parallel.py``: it returns ``(init, place, mesh)``, where
``init(seed)`` makes the params and the optimizer with ``fit``'s seeds and
the epoch, and ``place`` puts params, optimizer and batches on the mesh
(``mesh.shard_params_and_batches``). The epoch is
``train_step.epoch_on_device`` given the mesh's data group: there is no
second epoch loop.

:func:`train_epochs` runs n epochs the way ``fit`` runs them (its batches,
its seeds), on a mesh or, without one, as a single process, and returns
what the tests, ``chip_smoke.py`` and ``tools/multihost_smoke.py`` compare:
the per-epoch scalars and seconds, the bytes and host seconds of the
collectives, the kernels' launches and the params gathered whole; a
caller's ``hook`` then gets the run's state (:class:`RunState`) to check
or time what it needs on it. :func:`rank_worker` is that run as one rank
of :func:`launch.spawn`.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import ImageData, make_shuffle_permutations
from ..device import resolve_device
from ..models import gngf
from ..ops import collectives
from ..ops.cuda import hidden, hpd_full, hpd_stream, hpd_tail, scatter
from ..train.optimizer import make_optimizer
from ..train.train_step import (
    EpochBatches, EpochTensors, build_epoch_batches, epoch_on_device, initial_collision_state,
)
from .mesh import Mesh, gather_params, make_mesh, shard_params_and_batches

# the kernels' wrappers, whose launch counts a run reports
WRAPPERS = {
    "hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
    "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd,
    "hpd_stream_select": hpd_stream.hpd_stream_select,
    "hpd_stream_marginal": hpd_stream.hpd_stream_marginal,
    "hpd_tail_unique_bwd": hpd_stream.hpd_tail_unique_bwd,
    "hidden_stack_fwd": hidden.hidden_stack_fwd,
    "hidden_stack_bwd": hidden.hidden_stack_bwd,
    "hpd_full_fwd": hpd_full.hpd_full_fwd,
    "hpd_full_bwd": hpd_full.hpd_full_bwd,
    "hpd_tail_fwd": hpd_tail.hpd_tail_fwd,
    "hpd_tail_bwd": hpd_tail.hpd_tail_bwd,
    "scatter_add_serial": scatter.scatter_add_serial,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    k12 = scatter.scatter_add_serial
    k12.variant_launches = dict.fromkeys(k12.variant_launches, 0)
    k12.range_launches = 0


def launches() -> dict:
    """Every wrapper's launches since :func:`reset_launches`, K12's by
    variant ("scatter_add_serial[ring]", "[narrow]") and with a slot range
    ("[range]") too."""
    out = {name: fn.launches for name, fn in WRAPPERS.items()}
    k12 = scatter.scatter_add_serial
    out.update({f"scatter_add_serial[{v}]": n for v, n in k12.variant_launches.items()})
    out["scatter_add_serial[range]"] = k12.range_launches
    return out


def make_parallel_epoch(exp: ExperimentConfig, statics: gngf.GNGFStatics, num_pixels: int,
                        mesh: Optional[Mesh] = None, shard_tables: bool = False):
    """(init, place, mesh). ``init(seed, params=None)`` -> (params,
    optimizer, epoch): fresh params from ``seed`` (or a copy of
    ``params``) on the mesh's device, the three-group Adam, and
    ``epoch(params, optimizer, batches, prev_collisions, min_possible)`` ->
    ``EpochTensors``. ``place(params, optimizer, batches)`` -> the same three
    on the mesh. ``mesh`` None: ``make_mesh()`` of the process group.
    ``num_pixels`` stands where the JAX package's signature has it and is
    not read: nothing is compiled for it."""
    mesh = mesh if mesh is not None else make_mesh()

    def init(seed: int, params: Optional[gngf.GNGFParams] = None):
        if params is None:
            params = gngf.init_params(exp.model, seed, mesh.device)
        else:
            params = copy.deepcopy(params).to(mesh.device)
        optimizer = make_optimizer(exp.optimizer, params)

        def epoch(params, optimizer, batches, prev_collisions, prev_min_possible):
            return epoch_on_device(params, optimizer, batches, exp, statics, prev_collisions,
                                   prev_min_possible, data_group=mesh.data_group)

        return params, optimizer, epoch

    def place(params, optimizer, batches):
        params, batches = shard_params_and_batches(
            params, batches, mesh, shard_tables, optimizer=optimizer, model_cfg=exp.model,
            statics=statics)
        return params, optimizer, batches

    return init, place, mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class RunState(NamedTuple):
    """A run of :func:`train_epochs` after its epochs, as its ``hook`` gets
    it: this rank's params, optimizer and batches (its share of the rows,
    its shard of the tables), and ``next_epoch()``, one more epoch of the
    run from where it stands (an ``EpochTensors``)."""

    exp: ExperimentConfig
    statics: gngf.GNGFStatics
    params: gngf.GNGFParams
    optimizer: torch.optim.Optimizer
    batches: EpochBatches
    mesh: Optional[Mesh]
    device: torch.device
    next_epoch: Callable[[], EpochTensors]


def train_epochs(exp: ExperimentConfig, data: ImageData, epochs: int, mesh: Optional[Mesh] = None,
                 shard_tables: bool = False, params: Optional[gngf.GNGFParams] = None,
                 device="cuda", hook: Optional[Callable[[RunState], Any]] = None) -> dict:
    """``epochs`` epochs of ``exp`` on ``data`` with ``fit``'s batches and
    seeds (``params``: the start, default ``exp.train.seed``'s init): on
    ``mesh`` (its device) or, without one, as a single process on
    ``device``. Returns {"history": per epoch {"loss", "mse", "collisions",
    "int_sq_err", "match_count", "seconds", "collective_calls",
    "collective_bytes", "collective_host_s"}, "launches" (the epochs' kernel
    launches), "grad_floats" (the floats of this rank's gradients, summed
    over the data group each step), "vertices" (each batch's U_c on the
    dedup route, else None), "params" (numpy, the tables whole),
    "bn_state"} and, with a ``hook``, "hook": what ``hook(RunState)``
    returns, called after everything else is read (on a mesh every rank
    calls it)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, dev)
    if mesh is None:
        params = (gngf.init_params(exp.model, exp.train.seed, dev) if params is None
                  else copy.deepcopy(params).to(dev))
        optimizer = make_optimizer(exp.optimizer, params)

        def epoch(params, optimizer, batches, prev, min_poss):
            return epoch_on_device(params, optimizer, batches, exp, statics, prev, min_poss)
    else:
        init, place, _ = make_parallel_epoch(exp, statics, data.num_pixels, mesh, shard_tables)
        params, optimizer, epoch = init(exp.train.seed, params)
        params, optimizer, batches = place(params, optimizer, batches)
    prev, min_poss = initial_collision_state(exp, statics, dev)
    reset_launches()
    history = []
    for _ in range(epochs):
        collectives.reset_stats()
        _sync(dev)
        t0 = time.perf_counter()
        m = epoch(params, optimizer, batches, prev, min_poss).to_host()
        seconds = time.perf_counter() - t0
        prev = m.collisions_device
        history.append(dict(
            loss=m.loss, mse=m.mse, collisions=np.asarray(m.collisions).tolist(),
            int_sq_err=m.int_sq_err, match_count=m.match_count, seconds=seconds,
            collective_calls=collectives.STATS["calls"],
            collective_bytes=collectives.STATS["bytes"],
            collective_host_s=collectives.STATS["host_s"]))
    out = dict(history=history, launches=launches(),
               grad_floats=sum(p.numel() for p in params.parameters() if p.requires_grad),
               vertices=[None if g is None else g.counts.shape[1] for g in batches.dedup])
    whole = gather_params(params)
    out["params"] = gngf.params_to_numpy(whole)
    out["bn_state"] = gngf.bn_state_to_numpy(whole)
    if hook is not None:
        out["hook"] = hook(RunState(exp, statics, params, optimizer, batches, mesh, dev,
                                    lambda: epoch(params, optimizer, batches, prev, min_poss)))
    return out


def rank_worker(rank: int, world_size: int, spec: dict) -> dict:
    """:func:`train_epochs` as one rank of ``launch.spawn``: ``spec`` holds
    "exp", "data", "epochs", "model_parallel" (default 1), "shard_tables",
    "device" (default: the card), "params" (a numpy tree in the JAX
    package's layout, optional, with "bn_state") and "hook" (optional,
    :func:`train_epochs`'). Adds the rank's place: its mesh coordinates and
    the ranks of its data and model groups."""
    mesh = make_mesh(spec.get("model_parallel", 1), device=spec.get("device", "cuda"))
    params = None
    if spec.get("params") is not None:
        params = gngf.params_from_jax(spec["params"], mesh.device, bn_state=spec.get("bn_state"))
    out = train_epochs(spec["exp"], spec["data"], spec["epochs"], mesh,
                       shard_tables=spec.get("shard_tables", False), params=params,
                       hook=spec.get("hook"))
    dist = torch.distributed
    out.update(rank=rank, world_size=world_size, mesh=list(mesh.shape),
               coords=[mesh.data_index, mesh.model_index], backend=dist.get_backend(),
               data_group_ranks=dist.get_process_group_ranks(mesh.data_group),
               model_group_ranks=dist.get_process_group_ranks(mesh.model_group))
    return out
