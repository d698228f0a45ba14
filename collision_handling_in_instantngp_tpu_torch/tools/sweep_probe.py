"""The streamed tail's phase costs, measured in place: four rungs over the
same kernel structure, each with one more phase than the last.

  dots     K7 "dots": the logits product per column tile + a 1-pass sum
  softmax  K7 "softmax": + the online max / exp / sum-exp
  select   K4 ``hpd_stream_select``: + the top-K candidate lists, their fp32
           recompute and guard, and the fix-up of the rows it lists
  full     K1 ``hpd_stream_fused_fwd``: + the marginal (on this card K1 is
           K4's rows pass, then K5's columns pass)

The differences between rungs time exp/max, top-K and the marginal. Runs
at the scaled tail's shape (U = 161,792 unique vertices of the strawberry's
batch 0, H = 128, T = 2^14, K = 4, L = 16) at each precision, on the JAX
tool's numpy data. Times are CUDA-event times on the card (host-clock
times with ``--device cpu``, which only checks that the tool runs).

    python -m collision_handling_in_instantngp_tpu_torch.tools.sweep_probe \\
        [--reps N] [--json-out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda import hpd_stream as hs
from ..utils import profiling

PRECISIONS = ("highest", "high", "default")


def make_inputs(u: int, hd: int, t: int, l: int, device):
    """The JAX tool's data: h (U, H), w (H, T), b (1, T) zeros, counts (L, U)."""
    rng = np.random.default_rng(65535)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    h = f32(rng.normal(size=(u, hd)))
    w = f32(rng.normal(size=(hd, t), scale=0.1))
    b = torch.zeros(1, t, dtype=torch.float32, device=device)
    counts = f32(rng.integers(1, 5, size=(l, u)))
    return h, w, b, counts


def ladder(h, w, b, counts, k: int, precision: str, reps: int) -> dict:
    """The four rungs' times in ms (CUDA events on the card) and the three
    differences, under the JAX tool's keys."""
    def ms(fn):
        return profiling.time_ms(fn, reps, h.device)

    b1 = b.reshape(-1)
    rung = dict(
        dots_ms=ms(lambda: hs.hpd_stream_fused_probe(h, w, b, precision, "dots")),
        softmax_ms=ms(lambda: hs.hpd_stream_fused_probe(h, w, b, precision, "softmax")),
        select_ms=ms(lambda: hs.hpd_stream_select(h, w, b1, k, precision)),
        full_ms=ms(lambda: hs.hpd_stream_fused_fwd(h, w, b1, counts, k, precision)),
    )
    rung["exp_max_cost_ms"] = rung["softmax_ms"] - rung["dots_ms"]
    rung["topk_cache_cost_ms"] = rung["select_ms"] - rung["softmax_ms"]
    rung["marginal_cost_ms"] = rung["full_ms"] - rung["select_ms"]
    return rung


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Phase costs of the streamed tail (K7, K4, K1).")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json-out", default="")
    ap.add_argument("--u", type=int, default=161792)
    ap.add_argument("--hd", type=int, default=128)
    ap.add_argument("--t", type=int, default=2**14)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--l", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    h, w, b, counts = make_inputs(args.u, args.hd, args.t, args.l, dev)
    results = dict(shape=dict(u=args.u, hd=args.hd, t=args.t, k=args.k, l=args.l),
                   device=profiling.device_info(dev), reps=args.reps)
    for prec in PRECISIONS:
        results[prec] = ladder(h, w, b, counts, args.k, prec, args.reps)
        print(json.dumps({"precision": prec, **results[prec]}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
