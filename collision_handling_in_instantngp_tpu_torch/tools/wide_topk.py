"""The exact lowest-index top-K of the unique "jax" tail, timed on the card at
the tail's chunk shape (``ops/fused_hpd.py: unique_chunk_rows``: 1,024 rows
of T = 16,384 at ``--scaled``) for K = 20, 32, 128: ``topk_keyed`` (one
``torch.topk`` of int64 keys, the tail's routine) beside
``topk_lowest_index`` (K passes over the chunk), whose indices and values
it must give on the same p (a softmax of seeded logits, every 16th row
with planted ties at its K-th value). Prints the card's name and power
limit; writes ``--out``.

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.wide_topk \\
        [--rows 1024] [--t 16384] [--out chiprun_out/wide_topk.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..device import resolve_device
from ..ops.topk import topk_keyed, topk_lowest_index
from ..utils import profiling


ROUTINES = {"topk_lowest_index": topk_lowest_index, "topk_keyed": topk_keyed}


def planted_p(rows: int, t: int, k: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(65535)
    logits = torch.randn(rows, t, device=dev, generator=gen)
    p = torch.nan_to_num(torch.softmax(logits, dim=-1))
    # every 16th row: 2 K columns share the row's K-th value, so the lowest
    # indices must win
    kth = torch.topk(p[::16], k, dim=-1).values[:, -1:]
    p[::16, t // 3: t // 3 + 2 * k] = kth
    return p


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--t", type=int, default=16384)
    ap.add_argument("--ks", default="20,32,128")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "wide_topk.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gpu = profiling.gpu_name_and_power_limit() if dev.type == "cuda" else "cpu"
    print(gpu, flush=True)
    res = dict(gpu=gpu, rows=args.rows, t=args.t, k={})
    for k in (int(v) for v in args.ks.split(",")):
        p = planted_p(args.rows, args.t, k, dev)
        ref_v, ref_i = topk_lowest_index(p, k)
        row = {}
        for name, fn in ROUTINES.items():
            v, i = fn(p, k)
            same = bool(torch.equal(i, ref_i) and torch.equal(v, ref_v))
            ms = profiling.time_ms(lambda: fn(p, k), args.reps, dev)
            row[name] = dict(ms=ms, same_as_k_passes=same)
            print(f"K = {k:3d}  {name:18s} {ms:9.3f} ms  indices as K passes: {same}", flush=True)
        res["k"][k] = row
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
