"""Split K3a (``hidden_stack_fwd``) and K3b (``hidden_stack_bwd``), the
dedup route's hidden stack, into their phases on the card. K3a: the x tile
load, then each layer. K3b: its backward kernel's phases (the tile loads,
the forward's recompute with the activations' store, the last layer's ReLU
mask of gh, g W^T with the gradients' store), then its dW kernel and the
ordered reduce of the partials (launches of their own, their shares from
the profiler).

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.k3_phases
    python3 -m collision_handling_in_instantngp_tpu_torch.tools.k3_phases --widths 2,256,512,256

Builds ``ops/cuda/hidden.cu`` a second time with ``-DHIDDEN_PHASES`` (into
``chiprun_out/k3_phases/``), under which thread 0 of each block sums the
clock64() ticks of each phase of its tiles; runs that build on seeded
inputs at the ``--scaled`` shapes (U_c = 161,792 unique vertices, HPD
hidden stack [2 -> 32 -> 64 -> 128]) by default; times the normal build
and the plain versions on the same inputs; and prints each phase's share of
the ticks and that share of the normal build's time, with the card's name
and power limit (also to ``<out>/k3_phases.json``). The instrumented
build's extra barriers make its time a little longer; its shares are what
it is for.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import numpy as np
import torch

from ..ops.cuda import build, hidden
from ..utils import profiling

K3B_PHASES = ("load", "recompute + act out", "gh mask", "g W^T + g out")
K3B_KERNELS = ("hidden_bwd_kernel", "hidden_dw_kernel", "hidden_reduce_kernel")


def build_phases(out_dir: str) -> ctypes.CDLL:
    """hidden.cu built with -DHIDDEN_PHASES, loaded and configured."""
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "hidden_phases.so")
    cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-DHIDDEN_PHASES",
           "-o", lib_path, os.path.join(build.HERE, "hidden.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for hidden.cu -DHIDDEN_PHASES:\n{proc.stdout}{proc.stderr}")
    lib = hidden._configure(ctypes.CDLL(lib_path))
    for fn in (lib.hidden_fwd_phases, lib.hidden_bwd_phases):
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.hidden_fwd_phase_count.restype = ctypes.c_int
    return lib


def split(lib, reader, n, run) -> tuple:
    """(ticks share of each of n phases, the run's ms) of one ``run()``."""
    ticks = (ctypes.c_ulonglong * n)()
    build.check(reader(ticks, 1), lib, "hidden_error_string", reader.__name__)
    ms = profiling.cuda_ms(run, 1)
    build.check(reader(ticks, 0), lib, "hidden_error_string", reader.__name__)
    total = sum(ticks) or 1
    return [t / total for t in ticks], ms


def kernel_shares(run) -> dict:
    """{kernel: share of one ``run()``'s device time} over K3B_KERNELS."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    times = dict.fromkeys(K3B_KERNELS, 0.0)
    for e in prof.events():
        for k in K3B_KERNELS:
            if k in e.name:
                times[k] += e.device_time_total
    total = sum(times.values())
    if not total:
        raise RuntimeError("the profile shows no device time of the hidden kernels")
    print("K3b device ms by kernel: " + ", ".join(f"{k} {v / 1e3:.4f}" for k, v in times.items()))
    return {k: v / total for k, v in times.items()}


def inputs(dev, u, widths, seed):
    """Seeded integer vertex coords in [0, 512), layers at the init's scale,
    a cotangent of h."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 512, size=(u, widths[0])).astype(np.float32), device=dev)
    layers = []
    for din, dout in zip(widths[:-1], widths[1:]):
        layers.append((torch.as_tensor((rng.standard_normal((din, dout)) / math.sqrt(din)).astype(np.float32), device=dev),
                       torch.as_tensor((rng.standard_normal(dout) * 0.1).astype(np.float32), device=dev)))
    gh = torch.as_tensor((rng.standard_normal((u, widths[-1])) * 1e-3).astype(np.float32), device=dev)
    return x, layers, gh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--u", type=int, default=161_792)
    ap.add_argument("--widths", default="2,32,64,128")
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--seed", type=int, default=65535)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k3_phases"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: k3_phases times a CUDA kernel and has no CPU mode")
    dev = torch.device("cuda", 0)
    widths = [int(w) for w in args.widths.split(",")]
    x, layers, gh = inputs(dev, args.u, widths, args.seed)
    prec = args.precision
    fwd = lambda: hidden.hidden_stack_fwd(x, layers, prec)
    bwd = lambda: hidden.hidden_stack_bwd(x, layers, gh, prec)
    result = dict(card=profiling.gpu_name_and_power_limit(),
                  shape=dict(u=args.u, widths=widths, precision=prec),
                  k3a_ms=profiling.cuda_ms(fwd, args.reps), k3b_ms=profiling.cuda_ms(bwd, args.reps),
                  plain_fwd_ms=profiling.cuda_ms(
                      lambda: hidden.hidden_stack_fwd_plain(x, layers, prec), args.reps),
                  plain_bwd_ms=profiling.cuda_ms(
                      lambda: hidden.hidden_stack_bwd_plain(x, layers, gh, prec), args.reps),
                  k3b_kernel_shares=kernel_shares(bwd))

    lib = build_phases(args.out)
    normal_lib = hidden._lib
    hidden._lib = lambda: lib
    try:
        names_a = ["x load"] + [f"layer {i}" for i in range(lib.hidden_fwd_phase_count() - 1)]
        share_a, ms_a = split(lib, lib.hidden_fwd_phases, len(names_a), fwd)
        share_b, ms_b = split(lib, lib.hidden_bwd_phases, len(K3B_PHASES), bwd)
    finally:
        hidden._lib = normal_lib
    shares = result["k3b_kernel_shares"]
    main_b = shares["hidden_bwd_kernel"] * result["k3b_ms"]
    result.update(
        k3a_instrumented_ms=ms_a, k3b_instrumented_ms=ms_b,
        k3a_phases={p: dict(share=s, ms=s * result["k3a_ms"]) for p, s in zip(names_a, share_a) if s},
        k3b_phases={**{p: dict(share=s * shares["hidden_bwd_kernel"], ms=s * main_b)
                       for p, s in zip(K3B_PHASES, share_b)},
                    "dW/db (hidden_dw_kernel)": dict(share=shares["hidden_dw_kernel"],
                                                     ms=shares["hidden_dw_kernel"] * result["k3b_ms"]),
                    "reduce": dict(share=shares["hidden_reduce_kernel"],
                                   ms=shares["hidden_reduce_kernel"] * result["k3b_ms"])},
    )
    print(f"card: {result['card']}")
    print(f"U={args.u}, widths {widths}, {prec}: K3a {result['k3a_ms']:.4f} ms (plain "
          f"{result['plain_fwd_ms']:.4f}), K3b {result['k3b_ms']:.4f} ms (plain {result['plain_bwd_ms']:.4f})")
    for name, ph in (("K3a", result["k3a_phases"]), ("K3b", result["k3b_phases"])):
        print(name)
        for p, v in ph.items():
            print(f"  {p:24s} {100 * v['share']:6.2f} %  {v['ms']:8.4f} ms")
    with open(os.path.join(args.out, "k3_phases.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
