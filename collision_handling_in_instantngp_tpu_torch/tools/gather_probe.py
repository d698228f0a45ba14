"""The K-blend's gathers and scatters at the scaled geometry, timed side by
side (the port's counterpart of the JAX package's ``tools/gather_probe.py``,
its shapes and labelled rows in the port's formulations):

  take rows            ``index_select`` of the (U*K,) slot ids' rows from
                       the (T, L*F = 32) table view
  take + blend         that gather and the K-blend to (L, U, F)
  scatter-add [K12]    the table gradient, (U*K, 32) rows summed into
                       (T, 32) in row order by K12 (``ops/cuda/scatter.py:
                       scatter_add_serial``), held bitwise against its plain
                       version first; it replaces JAX's "VMEM serial
                       [pallas probe]" row
  scatter-add [index_add_]   the library's atomic scatter, the yardstick
  argsort + sorted scatter-add   the rows sorted by slot, then index_add_
  blend fwd / bwd today      ``models/encoding.py: blend_unique`` and its
                       backward (whose table gradient is K12)

U = 162,304, T = 16,384, L = 16, K = 4, F = 2; random data from numpy's
generator (seed 0). The scatter rows are formed once, outside the timed
calls. Times are CUDA-event means over ``--reps`` runs after one warm-up
run (host clock with ``--device cpu``, which only checks that the tool
runs).

    python -m collision_handling_in_instantngp_tpu_torch.tools.gather_probe \\
        [--reps N] [--json-out PATH] [--device cuda] [--u U --t T]

``--json-out`` writes the JAX tool's ``shape``, ``device_kind``, ``reps``
and ``ms`` ({label: ms}), with ``power_limit_w`` and ``gpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import encoding as enc
from ..ops.cuda import scatter
from ..utils import profiling

U, T, L, K, F = 162304, 16384, 16, 4, 2

TAKE = "take rows (U*K, 32)"
TAKE_BLEND = "take + blend -> (L, U, F)"
K12 = "scatter-add rows -> (T, 32) [K12 scatter_add_serial]"
INDEX_ADD = "scatter-add rows -> (T, 32) [index_add_]"
SORTED = "argsort + sorted scatter-add -> (T, 32)"
BLEND_FWD = "blend fwd today (blend_unique)"
BLEND_BWD = "blend bwd today (blend_unique backward)"


class Inputs(NamedTuple):
    tables: torch.Tensor    # (L, T, F)
    idx: torch.Tensor       # (U, K) int64
    w: torch.Tensor         # (U, K)
    g: torch.Tensor         # (L, U, F) cotangent of the blend
    tables2: torch.Tensor   # (T, L*F)
    flat: torch.Tensor      # (U*K,) int64
    rows: torch.Tensor      # (U*K, L*F) the table gradient's rows


def make_inputs(u: int, t: int, l: int, k: int, f: int, device) -> Inputs:
    rng = np.random.default_rng(0)
    on = lambda a: torch.as_tensor(a).to(device)
    tables = on(rng.normal(size=(l, t, f)).astype(np.float32) * np.float32(1e-4))
    idx = on(rng.integers(0, t, size=(u, k)).astype(np.int64))
    w = on(rng.uniform(size=(u, k)).astype(np.float32))
    g = on(rng.normal(size=(l, u, f)).astype(np.float32))
    tables2 = tables.permute(1, 0, 2).reshape(t, l * f).contiguous()
    rows = (w[:, :, None] * g.permute(1, 0, 2).reshape(u, 1, l * f)).reshape(u * k, l * f)
    return Inputs(tables, idx, w, g, tables2, idx.reshape(-1), rows.contiguous())


def take_rows(x: Inputs) -> torch.Tensor:
    return x.tables2.index_select(0, x.flat)


def take_blend(x: Inputs) -> torch.Tensor:
    u, k = x.idx.shape
    l, _, f = x.tables.shape
    rows = take_rows(x).reshape(u, k, l * f)
    return (rows * x.w[:, :, None]).sum(dim=1).reshape(u, l, f).permute(1, 0, 2)


def scatter_k12(x: Inputs) -> torch.Tensor:
    return scatter.scatter_add_serial(x.rows, x.flat, x.tables.shape[1], ids_checked=True)


def scatter_index_add(x: Inputs) -> torch.Tensor:
    out = torch.zeros(x.tables.shape[1], x.rows.shape[1], device=x.rows.device)
    return out.index_add_(0, x.flat, x.rows)


def scatter_sorted(x: Inputs) -> torch.Tensor:
    order = torch.argsort(x.flat)
    out = torch.zeros(x.tables.shape[1], x.rows.shape[1], device=x.rows.device)
    return out.index_add_(0, x.flat[order], x.rows[order])


def blend_config(x: Inputs) -> ModelConfig:
    l, t, f = x.tables.shape
    return ModelConfig(hash_table_size=t, num_levels=l, feature_dim=f, topk_k=x.idx.shape[1])


def blend_fwd(x: Inputs) -> torch.Tensor:
    return enc.blend_unique(x.tables, x.idx, x.w, blend_config(x))


def blend_bwd(x: Inputs):
    tables = x.tables.detach().requires_grad_(True)
    w = x.w.detach().requires_grad_(True)
    out = enc.blend_unique(tables, x.idx, w, blend_config(x))
    return torch.autograd.grad(out, (tables, w), x.g)


ROWS = ((TAKE, take_rows), (TAKE_BLEND, take_blend), (K12, scatter_k12),
        (INDEX_ADD, scatter_index_add), (SORTED, scatter_sorted), (BLEND_FWD, blend_fwd),
        (BLEND_BWD, blend_bwd))


def check_k12(x: Inputs) -> float:
    """K12 against its plain version, the serial row-order sum: raises
    unless bitwise; returns the largest difference (0.0)."""
    got = scatter_k12(x)
    plain = scatter.scatter_add_serial_plain(x.rows, x.flat, x.tables.shape[1])
    if not torch.equal(got, plain):
        raise AssertionError(f"K12 at the probe's shape differs from its plain version: "
                             f"{(got - plain).abs().max().item()}")
    return float((got - plain).abs().max())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The K-blend's gathers and scatters timed.")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json-out", default="", help="write {label: ms} to this path")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--u", type=int, default=U)
    ap.add_argument("--t", type=int, default=T)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    x = make_inputs(args.u, args.t, L, K, F, dev)
    err = check_k12(x)
    recorded = {}
    for name, fn in ROWS:
        recorded[name] = profiling.time_ms(lambda fn=fn: fn(x), args.reps, dev)
        print(f"{name:56s} {recorded[name]:9.3f} ms")
    info = profiling.device_info(dev)
    result = dict(shape=dict(U=args.u, T=args.t, L=L, K=K, F=F), device_kind=info["kind"],
                  reps=args.reps, ms=recorded, k12_max_abs_err=err,
                  power_limit_w=profiling.power_limit_w(info["gpu"]), gpu=info["gpu"])
    print(f"K12 bitwise its plain version; {info['kind']} ({info['gpu'] or 'host clock'})")
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
