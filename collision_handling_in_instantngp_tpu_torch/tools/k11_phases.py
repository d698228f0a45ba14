"""Split the per-row route's kernels into their phases on the card: K11
(``hpd_full_bwd``, the backward of "auto"), K10 (``hpd_full_fwd``, its
forward) and K8 (``hpd_tail_fwd``, the forward of "pallas"). K11: the
hidden stack's replay, the head's logits replay, softmax and dlogits,
dW_head, dh, the hidden layers' dW/db, and their dh. K10: the hidden layers, the
head's logits, softmax, the column sums, and the top-K: its candidates,
their fp32 recompute, and their ranking with the redo of the rows the
guard leaves. K8: the h tile's loads, the logits, softmax, the column sums
and the top-K (K8_PHASES: the names of the kernel's own marks).

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.k11_phases [--kernel k8]

Builds ``ops/cuda/hpd_full.cu`` a second time with ``-DHPD_FULL_PHASES``
(K10/K11) or ``ops/cuda/hpd_tail.cu`` with ``-DHPD_TAIL_PHASES`` (K8), into
``chiprun_out/k11_phases/``, under which thread 0 of each kernel sums the
clock64() ticks of each phase of its tiles (every phase ends at a block
barrier); runs that build on seeded inputs at the per-row route's shapes
(L = 4, N = 229,616, HPD [2 -> 32 -> 64 -> 128 -> 256], K = 4; K8 on the
route's own h: batch 0 of grid 4061 at the stack's init, as
``chip_smoke.py`` times it); times the normal build on the same
inputs; and prints each phase's share of the ticks and that share of the
normal build's time, with the card's name and power limit (also to
``<out>/k11_phases.json``). The instrumented build's own extra barriers
make its time a little longer; its shares are what it is for.
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

from ..ops.cuda import build, hpd_full, hpd_tail
from ..utils import profiling

PHASES = ("replay", "logits", "softmax+dl", "dW_head", "dh", "hidden dW", "hidden dh")
K10_PHASES = ("hidden layers", "logits", "softmax", "column sums", "top-K candidates",
              "top-K recompute", "top-K ranking")
K8_PHASES = ("loads", "logits", "softmax", "column sums", "top-K")


def build_phases(out_dir: str, source: str = "hpd_full", flags=("-DHPD_FULL_PHASES",),
                 readers=("hpd_full_phases", "hpd_full_fwd_phases")) -> ctypes.CDLL:
    """``source``.cu built with ``flags``, loaded, its phase readers typed."""
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"{source}_phases.so")
    cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, *flags,
           "-o", lib_path, os.path.join(build.HERE, f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}.cu {' '.join(flags)}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name in readers:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def split(lib, reader, names, run, err_fn="hpd_full_error_string") -> tuple:
    """Ticks by phase of one run of ``run()`` on the instrumented build:
    ({phase: share}, the run's ms)."""
    ticks = (ctypes.c_ulonglong * len(names))()
    build.check(reader(ticks, 1), lib, err_fn, reader.__name__)
    ms = profiling.cuda_ms(run, 1)
    build.check(reader(ticks, 0), lib, err_fn, reader.__name__)
    return {p: ticks[i] / sum(ticks) for i, p in enumerate(names)}, ms


def k8_split(out_dir, h, w, b, k, reps) -> dict:
    """K8's time and its split by phase on h (L, N, H), the head w, b: the
    normal build timed, the build with -DHPD_TAIL_PHASES split."""
    run = lambda: hpd_tail.hpd_tail_fwd(h, w, b, k)
    ms = profiling.cuda_ms(run, reps)
    lib = build_phases(out_dir, "hpd_tail", ("-DHPD_TAIL_PHASES",), ("hpd_tail_fwd_phases",))
    normal = hpd_tail._lib
    hpd_tail._lib = lambda: hpd_tail._configure(lib)
    try:
        share, ms_phases = split(lib, lib.hpd_tail_fwd_phases, K8_PHASES, run,
                                 "hpd_tail_error_string")
    finally:
        hpd_tail._lib = normal
    return dict(k8_ms=ms, k8_instrumented_ms=ms_phases,
                k8_phases={p: dict(share=share[p], ms=share[p] * ms) for p in K8_PHASES})


def inputs(dev, l, n, widths, k, seed):
    """Seeded vertices (integer grid coordinates), layers, the plain
    forward's top-K and random cotangents."""
    rng = np.random.default_rng(seed)
    verts = torch.as_tensor(rng.integers(0, 512, size=(l, n, widths[0])).astype(np.float32), device=dev)
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / math.sqrt(din) if i < len(widths) - 2 else 0.2
        layers.append((torch.as_tensor((rng.standard_normal((din, dout)) * scale).astype(np.float32), device=dev),
                       torch.as_tensor((rng.standard_normal(dout) * 0.1).astype(np.float32), device=dev)))
    idx = hpd_full.hpd_full_fwd_plain(verts, layers, k)[2].to(torch.int32).contiguous()
    g_marg = torch.as_tensor(rng.standard_normal((l, widths[-1])).astype(np.float32), device=dev)
    g_vals = torch.as_tensor(rng.standard_normal((l, n, k)).astype(np.float32), device=dev)
    return verts, layers, idx, g_marg, g_vals, k


def per_row_head_input(dev, seed):
    """The per-row route's K8 inputs on batch 0 of grid 4061 (default
    geometry, ``batchnorm_input``, the strawberry's raw coordinates), as
    ``chip_smoke.py`` step 6 takes them: the last hidden activation h (L, N,
    H) of the stack at its init from ``seed``, and the head (w, b)."""
    import torch.nn.functional as F
    from ..config import ModelConfig, experiment_from_grid_id
    from ..data import load_image_dataset, make_shuffle_permutations
    from ..models import gngf
    from ..ops.grid import scale_to_grid
    from ..train.train_step import build_epoch_batches

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    data = load_image_dataset(os.path.join(root, "images", "strawberry.npy"), normalize=False)
    exp = experiment_from_grid_id(4061, base_model=ModelConfig(batchnorm_input=True))
    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, dev)
    params = gngf.init_params(exp.model, seed, dev)
    with torch.no_grad():
        bn = params.batchnorm
        x, _ = gngf.batchnorm(bn, {"mean": bn.mean, "var": bn.var}, batches.x[0], True)
        _, corners = scale_to_grid(x, torch.as_tensor(statics.n_ls, device=dev),
                                   torch.as_tensor(statics.offsets, device=dev))
        p_b, l, v, d = corners.shape
        h = corners.permute(1, 0, 2, 3).reshape(l, p_b * v, d)
        layers = [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
        for w, b in layers[:-1]:
            h = F.relu(h @ w + b)
    return h.contiguous(), layers[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--l", type=int, default=4)
    ap.add_argument("--n", type=int, default=229_616)
    ap.add_argument("--widths", default="2,32,64,128,256")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=65535)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k11_phases"))
    ap.add_argument("--kernel", choices=("k10k11", "k8"), default="k10k11")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: k11_phases times a CUDA kernel and has no CPU mode")
    dev = torch.device("cuda", 0)
    widths = [int(w) for w in args.widths.split(",")]
    if args.kernel == "k8":
        h, (w, b) = per_row_head_input(dev, args.seed)
        result = dict(card=profiling.gpu_name_and_power_limit(),
                      shape=dict(h=list(h.shape), t=w.shape[1], k=args.k),
                      **k8_split(args.out, h, w, b, args.k, args.reps))
        print(f"card: {result['card']}")
        print(f"K8 {result['k8_ms']:.3f} ms (instrumented build {result['k8_instrumented_ms']:.3f} ms) "
              f"at (L, N, H) {tuple(h.shape)}, T={w.shape[1]}, K={args.k}")
        for p, v in result["k8_phases"].items():
            print(f"  {p:14s} {100 * v['share']:6.2f} %  {v['ms']:7.3f} ms")
        with open(os.path.join(args.out, "k8_phases.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result))
        return 0
    bargs = inputs(dev, args.l, args.n, widths, args.k, args.seed)
    fargs = bargs[:2] + (args.k,)
    ms = profiling.cuda_ms(lambda: hpd_full.hpd_full_bwd(*bargs), args.reps)
    fwd_ms = profiling.cuda_ms(lambda: hpd_full.hpd_full_fwd(*fargs), args.reps)

    lib = build_phases(args.out)
    normal_lib = hpd_full._lib
    hpd_full._lib = lambda: hpd_full._configure(lib)
    try:
        share, ms_phases = split(lib, lib.hpd_full_phases, PHASES,
                                 lambda: hpd_full.hpd_full_bwd(*bargs))
        fwd_share, fwd_ms_phases = split(lib, lib.hpd_full_fwd_phases, K10_PHASES,
                                         lambda: hpd_full.hpd_full_fwd(*fargs))
    finally:
        hpd_full._lib = normal_lib
    result = dict(card=profiling.gpu_name_and_power_limit(),
                  shape=dict(l=args.l, n=args.n, widths=widths, k=args.k), k11_ms=ms,
                  instrumented_ms=ms_phases,
                  phases={p: dict(share=share[p], ms=share[p] * ms) for p in PHASES},
                  k10_ms=fwd_ms, k10_instrumented_ms=fwd_ms_phases,
                  k10_phases={p: dict(share=fwd_share[p], ms=fwd_share[p] * fwd_ms)
                              for p in K10_PHASES})
    print(f"card: {result['card']}")
    for name, t, t_ph, names, sh in (("K11", ms, ms_phases, PHASES, share),
                                     ("K10", fwd_ms, fwd_ms_phases, K10_PHASES, fwd_share)):
        print(f"{name} {t:.3f} ms (instrumented build {t_ph:.3f} ms) at L={args.l}, N={args.n}, "
              f"widths {widths}, K={args.k}")
        for p in names:
            print(f"  {p:14s} {100 * sh[p]:6.2f} %  {sh[p] * t:7.3f} ms")
    with open(os.path.join(args.out, "k11_phases.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
