"""Dot-rate and memory-rate probe at the scaled tail's shapes: the yardsticks
of the kernel redesigns.

  rowsum_dot (K13)   the (U, H) x (H, T) product tile by tile, only per-row
                     sums written (no (U, T) write), in four regimes: fp32
                     'highest' on the CUDA cores; 'default' and 'bf16' (one
                     function, one kernel: bf16 operands) and bf16x3
                     (hi/lo) on the tensor cores
  hbm_write (K14)    a pure write of a (U, T/4) fp32 array (2.66 GB)
  hbm_scale_copy (K15)  read + write of the same array
  K1 / K2            the fused tail forward / backward at the same shapes,
                     rated at their own FLOP counts (fwd 2UT(H + L), bwd
                     2UT(3H + 2L))

Writes the calibration (flop/s and bytes/s under the JAX tool's keys:
``highest``, ``default`` = the bf16 regime, ``high`` = bf16x3,
``hbm_stream``, ``hbm_rw``, ``fused_fwd_highest``, ``fused_bwd_highest``)
keyed by the card's name to ``chiprun_out/roofline_calibration.json`` by
default. Times are CUDA-event times on the card; ``--device cpu`` (with
small ``--u/--hd/--t``) only checks that the tool runs.

    python -m collision_handling_in_instantngp_tpu_torch.tools.mxu_probe \\
        [--reps N] [--json-out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..device import resolve_device
from ..ops.cuda import hpd_stream as hs
from ..ops.cuda import probe
from ..utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "chiprun_out", "roofline_calibration.json")
# 162,304 = 317 x 512: the TPU tool's row padding of U_c = 161,792
U, H, T, L, K = 162304, 128, 16384, 16, 4
# regime -> its key in the calibration (the JAX tool's keys; 'default',
# the same kernel as 'bf16', is printed only)
REGIME_KEYS = (("highest", "highest"), ("default", None), ("bf16", "default"), ("bf16x3", "high"))


def make_inputs(u: int, hd: int, t: int, l: int, device, seed: int = 0):
    """h (U, H) * 0.3, w (H, T) * 0.1, b (T,) * 0.1 normal, counts (L, U)
    uniform: made on the device from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    return (torch.randn(u, hd, **f32) * 0.3, torch.randn(hd, t, **f32) * 0.1,
            torch.randn(t, **f32) * 0.1, torch.rand(l, u, **f32))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Dot and memory rates of the card (K13-K15, K1, K2).")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json-out", default=DEFAULT_OUT,
                    help="calibration file (merged by device name; '' skips writing)")
    ap.add_argument("--u", type=int, default=U)
    ap.add_argument("--hd", type=int, default=H)
    ap.add_argument("--t", type=int, default=T)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    u, hd, t = args.u, args.hd, args.t
    h, w, b, counts = make_inputs(u, hd, t, L, dev)
    results = {}

    def timed(name, fn, work, unit, key=None):
        ms = profiling.time_ms(fn, args.reps, dev)
        rate = work / (ms / 1e3)
        scale, label = (1e12, "TF/s") if unit == "flop" else (1e9, "GB/s")
        print(f"{name:40s} {ms:9.3f} ms  {rate / scale:9.2f} {label}", flush=True)
        if key:
            results[key] = rate
        return ms

    flops = 2.0 * u * hd * t
    if dev.type != "cuda":
        print("device: cpu (host-clock times of the plain versions; no device measurement)")
    print(f"dot shape ({u}, {hd}) x ({hd}, {t}) = {flops / 1e9:.0f} GFLOP "
          "(rowsum kernels: no (U, T) write)", flush=True)
    for regime, key in REGIME_KEYS:
        timed(f"rowsum_dot [{regime}]", lambda: probe.rowsum_dot(h, w, regime), flops, "flop", key)

    wt = t // 4
    nbytes = 4.0 * u * wt
    timed(f"hbm_write ({nbytes / 1e9:.2f} GB)", lambda: probe.hbm_write((u, wt), dev),
          nbytes, "bytes", "hbm_stream")
    big = torch.ones(u, wt, dtype=torch.float32, device=dev)
    timed(f"hbm_scale_copy (2 x {nbytes / 1e9:.2f} GB)", lambda: probe.hbm_scale_copy(big),
          2 * nbytes, "bytes", "hbm_rw")
    del big

    timed("fused fwd K1 [highest]", lambda: hs.hpd_stream_fused_fwd(h, w, b, counts, K),
          2.0 * u * t * (hd + L), "flop", "fused_fwd_highest")
    _, vals, idx, m, s = hs.hpd_stream_fused_fwd(h, w, b, counts, K)
    gen = torch.Generator(device=dev).manual_seed(1)
    g_marg = torch.randn(L, t, dtype=torch.float32, device=dev, generator=gen)
    g_vals = torch.randn(u, K, dtype=torch.float32, device=dev, generator=gen)
    timed("fused bwd K2 [highest]",
          lambda: hs.hpd_stream_fused_bwd(h, w, b, counts, idx, vals, m, s, g_marg, g_vals, K),
          2.0 * u * t * (3 * hd + 2 * L), "flop", "fused_bwd_highest")

    if args.json_out:
        info = profiling.device_info(dev)
        cal = {}
        if os.path.exists(args.json_out):
            with open(args.json_out) as f:
                cal = json.load(f)
        cal[info["kind"]] = {
            **results, "probe_shape": [u, hd, t], "reps": args.reps, "gpu": info["gpu"],
            "timer": info["timer"], "stamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(cal, f, indent=1, sort_keys=True)
        print(f"calibration -> {args.json_out} [{info['kind']}]", flush=True)
    return results


if __name__ == "__main__":
    main()
