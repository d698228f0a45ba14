"""The (data, model) mesh of ``torch.distributed`` ranks and the placement
of params and batches on it.

The port of the JAX package's ``parallel/mesh.py``:

  * ``data`` axis: data parallelism over the pixel rows. Each rank holds
    its share of every batch's rows; the params are replicated and their
    gradients summed over the data group before each step
    (``train/train_step.py: epoch_on_device``), and the global reductions
    of the loss (MSE, marginal, BatchNorm statistics) run across it.
  * ``model`` axis: the tables sharded by slot. Each rank holds slots
    [lo, hi) of every level's table (and Adam's state of them); a gather
    sums the rows of the model group's shards (``models/encoding.py``).

Rank r sits at (r // model, r % model), as the JAX mesh places device r
(``np.array(devices).reshape(n // mp, mp)``). The data group of a rank is
the ranks that share its model coordinate, the model group those that
share its data coordinate. One process a rank: NCCL where each rank has a
card of its own, gloo on the CPU and where several ranks share one card
(NCCL refuses two ranks on one device). The backend is the caller's
choice; nothing switches it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..models import gngf
from ..models.encoding import TableShard
from ..ops import collectives
from ..train.train_step import EpochBatches, shard_batches


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           rank: Optional[int] = None, world_size: Optional[int] = None,
                           device="cuda") -> None:
    """Join the process group (idempotent: a no-op where one exists).
    ``backend`` None: "nccl" for a CUDA ``device``, "gloo" for the CPU;
    ``init_method`` None: "env://" (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kw = {k: v for k, v in (("rank", rank), ("world_size", world_size)) if v is not None}
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid."""

    rank: int
    world_size: int
    data: int                  # ranks along the data axis
    model: int                 # ranks along the model axis
    data_index: int            # this rank's coordinates
    model_index: int
    data_group: Any            # the ranks that share this rank's model coordinate
    model_group: Any           # the ranks that share this rank's data coordinate
    device: torch.device

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data, self.model


def mesh_coords(rank: int, model_parallel: int) -> Tuple[int, int]:
    """(data, model) coordinates of a rank: JAX's device layout."""
    return rank // model_parallel, rank % model_parallel


def make_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """The (world // model_parallel, model_parallel) mesh of the process
    group's ranks (initialized first: :func:`initialize_distributed`). Every
    rank must call it: it makes every subgroup, in one order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    n, rank = dist.get_world_size(), dist.get_rank()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    mp, d = model_parallel, n // model_parallel
    data_groups = [dist.new_group([i * mp + m for i in range(d)]) for m in range(mp)]
    model_groups = [dist.new_group([i * mp + m for m in range(mp)]) for i in range(d)]
    di, mi = mesh_coords(rank, mp)
    return Mesh(rank=rank, world_size=n, data=d, model=mp, data_index=di, model_index=mi,
                data_group=data_groups[mi], model_group=model_groups[di],
                device=resolve_device(device))


def _share(size: int, parts: int, index: int, what: str) -> Tuple[int, int]:
    if size % parts:
        raise ValueError(f"{what} of {size} does not divide over {parts} ranks")
    n = size // parts
    return index * n, (index + 1) * n


def batch_rows(b: int, mesh: Mesh) -> Tuple[int, int]:
    """Rows [lo, hi) of a batch of ``b`` rows that this rank holds (JAX's
    batch sharding over ``data``); raises where ``b`` does not divide."""
    return _share(b, mesh.data, mesh.data_index, "a batch's rows (data axis)")


def slot_range(t: int, mesh: Mesh) -> Tuple[int, int]:
    """Slots [lo, hi) of T that this rank holds (JAX's table sharding over
    ``model``); raises where T does not divide."""
    return _share(t, mesh.model, mesh.model_index, "a table's slots (model axis)")


def shard_params_and_batches(params: gngf.GNGFParams, batches: EpochBatches, mesh: Mesh,
                             shard_tables: bool = False, *, model_cfg, statics,
                             optimizer: Optional[torch.optim.Optimizer] = None):
    """Place params and batches on the mesh (JAX ``shard_state_and_batches``):
    every rank takes rank 0's params and buffers (replicated); with
    ``shard_tables`` and a model axis past 1 each rank keeps its slot range
    of the tables (``params.shard``, with the model group) and of
    ``optimizer``'s state of them, the optimizer then updating the shard; each rank keeps its rows of
    every batch, the dedup geometry rebuilt from them (``model_cfg``,
    ``statics``: the model's). ``params`` and ``optimizer`` change in place.
    Returns (params, batches)."""
    for v in params.state_dict().values():
        collectives.broadcast_(v, 0)
    if shard_tables and mesh.model > 1:
        lo, hi = slot_range(params.tables.shape[1], mesh)
        old = params.tables
        params.tables = nn.Parameter(old.detach()[:, lo:hi].contiguous())
        params.shard = TableShard(lo, hi, old.shape[1], mesh.model_group)
        if optimizer is not None:
            for group in optimizer.param_groups:
                group["params"] = [params.tables if p is old else p for p in group["params"]]
            state = optimizer.state.pop(old, None)
            if state:
                optimizer.state[params.tables] = {
                    k: (v[:, lo:hi].clone() if torch.is_tensor(v) and v.shape == old.shape else v)
                    for k, v in state.items()}
    lo, hi = batch_rows(batches.x.shape[1], mesh)
    return params, shard_batches(batches, lo, hi, model_cfg, statics)


def gather_params(params: gngf.GNGFParams) -> gngf.GNGFParams:
    """A copy of ``params`` with the whole tables, gathered from the shard's
    group where they are sharded (JAX ``device_get`` of a sharded array);
    every rank of the group gets the same."""
    out = copy.deepcopy(params)
    if params.shard is not None:
        parts = collectives.all_gather(params.tables.detach(), params.shard.group)
        out.tables = nn.Parameter(torch.cat(parts, dim=1))
        out.shard = None
    return out
