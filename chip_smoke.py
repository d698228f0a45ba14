#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from the sources in this checkout (one
   nvcc per source, all started together), and fails unless the SASS of
   ``hpd_stream.cu`` shows warpgroup MMAs (HGMMA) in every backward kernel
   of K2 and K6 and no tensor-core instruction in the forward passes;
2. holds every kernel of the dedup route against its plain PyTorch
   version on the same inputs at the path's shapes (scaled grid-4061
   geometry on the strawberry image: H=128, T=16384, L=16, K=4, the full
   U_c = 161,792 rows of the first batch, real h for the tail), checks
   that the deterministic outputs are bitwise equal run to run, and times
   kernel and plain version on the same inputs (K2 beside its time before
   the tensor-core redesign; step 5 prints its device time by launch);
3. trains a small streamed geometry on the card and on the CPU and
   compares the losses (kernels vs plain versions end to end);
4. runs ``fit`` on grid 4061 at scaled geometry for 3 epochs with the
   launch counts set to 0 just before, and fails unless every kernel
   launched and the loss is finite and falls;
5. profiles one more epoch of that training (device time by kernel, the
   device's idle share);
6. holds the per-row kernels K8-K11 against their plain versions on all
   918,464 rows (L * P_batch * V) of batch 0 of the per-row route (grid
   4061, default geometry, ``batchnorm_input=True`` on raw pixel coords:
   T=256, L=4, K=4, HPD [2->32->64->128->256]), real vertices for K10/K11
   and real last hidden activations for K8/K9, with the same checks and
   timings as step 2;
7. trains a small per-row geometry on the card and on the CPU, through
   K10/K11 and through K8/K9, and compares the losses;
8. runs ``fit`` on that per-row configuration for 3 epochs through
   K10/K11 (hpd_backend "auto"), then through K8/K9 ("pallas"), each with
   its launch counts set to 0 just before, and fails unless its kernels
   launched and the loss is finite and falls; then profiles one per-row
   epoch;
9. holds the split streamed tail K4, K5, K6 (noop both ways) against their
   plain versions on all U_c = 161,792 rows of batch 0 of grid 4061 at
   ``instantngp_scaled_model(hash_table_size=2**16)`` (T = 65,536, past the
   fused gate; real h from K3a), times K1/K2 at the same shapes, and holds
   the serial scatter K12 (N = U_c * K rows of C = L * F = 32, idx from
   K4's top-4) bitwise to its plain version, the serial row-order sum,
   times its wrapper's index preparation apart from its kernel and the
   hottest slot alone, and times ``index_add_`` on the same inputs;
10. trains a small geometry through the split route and K12 (gate and blend
   threshold forced) on the card and on the CPU and compares the losses;
11. runs ``fit`` at T = 2^16 for 3 epochs with the blend scatter backend
   "vmem_serial" (what ``BLEND_SCATTER_BACKEND=vmem_serial`` sets), the
   launch counts set to 0 just before, and fails unless K3a, K3b, K4, K5,
   K6 and K12 launched, K1 and K2 did not, and the loss is finite and
   falls; then profiles one epoch of it (and prints K6's device time by
   launch from that profile);
12. the measurement path, part 1: holds the probe K7 (both variants)
   against its plain version on all U_c = 161,792 rows of real h from K3a
   at T = 2^14 (the head of ``instantngp_scaled_model()``), bitwise run to
   run and timed; then, with K7's counts set to 0 just before, runs the
   sweep ladder of ``tools/sweep_probe.py`` (dots, softmax, K4, K1) at
   'highest', prints its four rungs and three differences, and fails
   unless both variants launched and the rungs telescope (each within 3 %);
13. the measurement path, part 2, at ``tools/mxu_probe.py``'s shapes
   (U = 162,304, H = 128, T = 16,384): holds K13 in its four regimes
   against their plain versions and K14, K15 exactly, bitwise run to run,
   each timed beside one PyTorch call that computes the same function;
   then, with their counts set to 0 just before, runs the tool's ``main``
   (its TF/s and GB/s lines; the calibration goes to
   ``chiprun_out/roofline_calibration.json``) and fails unless each
   launched;
14. prints the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``. Every number also goes to
   ``chiprun_out/chip_smoke.json``, with the allocated and peak device
   memory at the end of each route's and each measurement step's phase
   (``utils.memory``), and for the redesigned kernels (K2, K6, K12) their
   time before the redesign (``before_redesign_ms``) beside this run's.

Any failure raises, so the run exits non-zero without the last line. It
exits non-zero at once where CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from collision_handling_in_instantngp_tpu_torch.utils import memory  # noqa: E402
from collision_handling_in_instantngp_tpu_torch.utils.profiling import cuda_ms  # noqa: E402

OUT_DIR = os.path.join(HERE, "chiprun_out")
SEED = 65535
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 on the tensor cores, HBM3 bandwidth. 'highest' runs
# fp32 FMA on the CUDA cores; 'default' (bf16 products, exact in fp32,
# fp32 sums) is the bf16 tensor cores' function and takes their peak.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
# dense TF32 on the tensor cores: the tail backward (K2, K6) runs its
# products there as 3xTF32, three tf32 products per fp32 term
PEAK_TF32_TENSOR_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# normwise tolerances: max |kernel - plain| <= tol * max |plain| (fp32,
# different summation order; outputs sum up to 161,792 rows)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# K7 "dots": a sum of 2^14 mixed-sign logits per row (the JAX package's
# test of the probe uses rtol 1e-4)
DOTS_TOL = 1e-4
# K13 bf16x3: three tensor-core products per term into one fp32
# accumulator, against three fp32 products summed after them
BF16X3_TOL = 1e-4
# the redesigned kernels' times before their redesign (PERF.md §6 kernel
# table; NVIDIA H100 80GB HBM3, 700.00 W), written beside this run's
BEFORE_REDESIGN_MS = {"hpd_stream_fused_bwd": 340.15, "hpd_tail_unique_bwd": 1352.97,
          "scatter_add_serial": 13.11}
SRC = "collision_handling_in_instantngp_tpu_torch/ops/cuda/"
JAX_SRC = "collision_handling_in_instantngp_tpu/ops/pallas/"


def log(*parts) -> None:
    print(*parts, flush=True)


COMPARES = []   # (what, max abs error, normwise error) of every comparison, in order


def compare(name, got, ref, tol):
    """max abs error; raises if it exceeds tol * max |ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    log(f"  {name}: max_abs_err {err:.3e} max_rel_err {err / max(scale, 1e-30):.3e} (scale {scale:.3e})")
    COMPARES.append((name, err, err / max(scale, 1e-30)))
    if not torch.isfinite(got).all() or err > tol * scale:
        raise AssertionError(f"{name}: kernel disagrees with plain version ({err} > {tol} * {scale})")
    return err


def bitwise_same(name, a, b):
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: outputs differ between two identical runs")
    log(f"  {name}: bitwise equal run to run")


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_epoch(exp, statics, batches, dev) -> dict:
    """Device time by kernel over one training epoch (``run_epoch`` on the
    prepared batches, after one unprofiled warm-up epoch), from
    torch.profiler's device events (``utils.profiling.device_time_by_kernel``)."""
    from torch.profiler import ProfilerActivity, profile
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
    from collision_handling_in_instantngp_tpu_torch.train.train_step import (
        initial_collision_state, run_epoch,
    )
    from collision_handling_in_instantngp_tpu_torch.utils.profiling import device_time_by_kernel

    params = gngf.init_params(exp.model, exp.train.seed, dev)
    optimizer = make_optimizer(exp.optimizer, params)
    prev, min_poss = initial_collision_state(exp, statics, dev)
    run_epoch(params, optimizer, batches, exp, statics, prev, min_poss)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_epoch(params, optimizer, batches, exp, statics, prev, min_poss)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return device_time_by_kernel(prof, wall_ms)


def watermark(marks: dict, tag: str, dev) -> None:
    """Allocated and peak device memory of the phase that ends here (the
    measurement phases hold the 10.6 GB (U, T) products of the library
    calls); the peak restarts for the next phase."""
    marks[tag] = memory.print_allocated_memory(tag, log=True, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)


def kernel_entry(name, source, replaces, err, ms, plain, bound, library=None):
    b_ms, b_by = bound
    lib = "" if library is None else f", library {library:.3f} ms"
    log(f"  kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}){lib}")
    return dict(name=name, source=source, replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=library)


def per_row_kernel_phases(exp, batches, statics, dev, gen) -> dict:
    """K8-K11 against their plain versions on batch 0 of the per-row route:
    every (level, pixel, corner) row of the batch."""
    import torch.nn.functional as F
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full, hpd_tail
    from collision_handling_in_instantngp_tpu_torch.ops.grid import scale_to_grid

    mcfg = exp.model
    params = gngf.init_params(mcfg, SEED, dev)
    with torch.no_grad():
        x, _ = gngf.batchnorm(params.batchnorm, {"mean": params.batchnorm.mean,
                                                 "var": params.batchnorm.var}, batches.x[0], True)
        _, corners = scale_to_grid(x, torch.as_tensor(statics.n_ls, device=dev),
                                   torch.as_tensor(statics.offsets, device=dev))
        p_b, L, V, d = corners.shape
        verts = corners.permute(1, 0, 2, 3).reshape(L, p_b * V, d).contiguous()
        layers = [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
        h = verts
        for w, b in layers[:-1]:
            h = F.relu(h @ w + b)
        h = h.contiguous()
    n = verts.shape[1]
    rows = L * n
    k, T = mcfg.topk_k, mcfg.hash_table_size
    (w_head, b_head), H = layers[-1], layers[-1][0].shape[0]
    widths = [d] + [w.shape[1] for w, _ in layers]
    macs = sum(a * c for a, c in zip(widths[:-1], widths[1:]))
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    out_bytes = 4.0 * (L * T + 2 * rows * k)
    log(f"per-row route, batch 0: P={p_b}, L={L}, V={V}, rows={rows}, widths {widths}, K={k}")
    g_marg = torch.randn(L, T, device=dev, generator=gen)
    g_vals = torch.randn(L, n, k, device=dev, generator=gen)
    entries = {}

    def check_fwd(tag, out_k, out_p, again):
        same = (out_k[2] == out_p[2]).all(dim=2).double().mean().item()
        log(f"  idx: rows with identical top-{k}: {same:.6f}")
        if same != 1.0:
            raise AssertionError(f"{tag}: top-K indices differ from the plain version")
        err = max(compare("marg", out_k[0], out_p[0], FWD_TOL), compare("vals", out_k[1], out_p[1], FWD_TOL))
        bitwise_same("marg/vals/idx", out_k, again)
        return err

    log("K10 hpd_full_fwd, all rows of real vertices:")
    out_k = hpd_full.hpd_full_fwd(verts, layers, k)
    out_p = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    err = check_fwd("K10", out_k, out_p, hpd_full.hpd_full_fwd(verts, layers, k))
    idx_full = out_k[2]
    entries["hpd_full_fwd"] = kernel_entry(
        "hpd_full_fwd", SRC + "hpd_full.cu", JAX_SRC + "hpd_full.py:162", err,
        cuda_ms(lambda: hpd_full.hpd_full_fwd(verts, layers, k), 10),
        cuda_ms(lambda: hpd_full.hpd_full_fwd_plain(verts, layers, k), 3),
        bound_ms(2.0 * rows * macs, 4.0 * (rows * d + n_params) + out_bytes))
    del out_k, out_p

    log("K11 hpd_full_bwd, all rows of real vertices:")
    bargs = (verts, layers, idx_full, g_marg, g_vals, k)
    got = hpd_full.hpd_full_bwd(*bargs)
    want = hpd_full.hpd_full_bwd_plain(*bargs)
    err = max(compare(f"{nm}{i}", a, r, GRAD_TOL)
              for i, (ka, pa) in enumerate(zip(got, want)) for nm, a, r in zip(("dW", "db"), ka, pa))
    bitwise_same("dW/db", [t for pair in got for t in pair],
                 [t for pair in hpd_full.hpd_full_bwd(*bargs) for t in pair])
    dx_macs = sum(a * c for a, c in zip(widths[1:-1], widths[2:]))
    entries["hpd_full_bwd"] = kernel_entry(
        "hpd_full_bwd", SRC + "hpd_full.cu", JAX_SRC + "hpd_full.py:236", err,
        cuda_ms(lambda: hpd_full.hpd_full_bwd(*bargs), 5),
        cuda_ms(lambda: hpd_full.hpd_full_bwd_plain(*bargs), 2),
        bound_ms(2.0 * rows * (2 * macs + dx_macs),
                 4.0 * (rows * d + 2 * n_params + L * T + 2 * rows * k)))
    del got, want

    log("K8 hpd_tail_fwd, all rows of real h:")
    out_k = hpd_tail.hpd_tail_fwd(h, w_head, b_head, k)
    out_p = hpd_tail.hpd_tail_fwd_plain(h, w_head, b_head, k)
    err = check_fwd("K8", out_k, out_p, hpd_tail.hpd_tail_fwd(h, w_head, b_head, k))
    idx_tail = out_k[2]
    head_bytes = 4.0 * (H * T + T)
    entries["hpd_tail_fwd"] = kernel_entry(
        "hpd_tail_fwd", SRC + "hpd_tail.cu", JAX_SRC + "hpd_tail.py:87", err,
        cuda_ms(lambda: hpd_tail.hpd_tail_fwd(h, w_head, b_head, k), 10),
        cuda_ms(lambda: hpd_tail.hpd_tail_fwd_plain(h, w_head, b_head, k), 3),
        bound_ms(2.0 * rows * H * T, 4.0 * rows * H + head_bytes + out_bytes))
    del out_k, out_p

    log("K9 hpd_tail_bwd, all rows of real h:")
    bargs = (h, w_head, b_head, idx_tail, g_marg, g_vals, k)
    got = hpd_tail.hpd_tail_bwd(*bargs)
    want = hpd_tail.hpd_tail_bwd_plain(*bargs)
    err = max(compare(nm, a, r, GRAD_TOL) for nm, a, r in zip(("dh", "dw", "db"), got, want))
    bitwise_same("dh/dw/db", got, hpd_tail.hpd_tail_bwd(*bargs))
    entries["hpd_tail_bwd"] = kernel_entry(
        "hpd_tail_bwd", SRC + "hpd_tail.cu", JAX_SRC + "hpd_tail.py:182", err,
        cuda_ms(lambda: hpd_tail.hpd_tail_bwd(*bargs), 5),
        cuda_ms(lambda: hpd_tail.hpd_tail_bwd_plain(*bargs), 2),
        bound_ms(6.0 * rows * H * T,
                 4.0 * (2 * rows * H + 2 * H * T + 2 * T + L * T + 2 * rows * k)))
    del got, want, h
    torch.cuda.empty_cache()
    return entries


def tail_bwd_bound(u, H, T, L, k, tensor=True):
    """Bound of the tail backward, K2's and K6's (the same function): the
    logits, dh = dl w^T and dW = h^T dl (2 U H T flops each), G = p g_marg^T
    and g_p = counts^T g_marg (2 L U T each); each input read once (h, the
    head, counts, idx, vals, m, s, g_marg, g_vals), each output written once
    (dh, dW, db). The kernels run those products as 3xTF32 on the tensor
    cores (three tf32 products per term, at the TF32 peak); ``tensor=False``
    gives the bound of fp32 on the CUDA cores, the kernels' route before."""
    flops = 6.0 * u * H * T + 4.0 * L * u * T
    nbytes = 4.0 * (2 * u * H + 2 * H * T + 2 * T + L * u + 3 * u * k + 2 * u + L * T)
    if tensor:
        return bound_ms(3 * flops, nbytes, PEAK_TF32_TENSOR_FLOPS)
    return bound_ms(flops, nbytes)


def per_launch(name, profile, kernels) -> dict:
    """Device ms per call of each of a wrapper's launches (kernel names
    containing one of ``kernels``), from a training epoch's profile; printed.
    Raises unless every named launch is in the profile with a call."""
    rows = [r for r in profile["kernels"] if any(k in r["name"] for k in kernels)]
    missing = [k for k in kernels if not any(k in r["name"] and r["calls"] > 0 for r in rows)]
    if missing:
        raise RuntimeError(f"{name}: the profile holds no call of {missing}")
    log(f"  {name} per launch in training (device ms per call):")
    for r in rows:
        log(f"    {r['ms'] / r['calls']:10.3f} ms ({r['calls']} calls) {r['name'][:90]}")
    return {r["name"]: r["ms"] / r["calls"] for r in rows}


def redesigned(entry) -> None:
    """Add a redesigned kernel's time before its redesign to its entry and
    print both."""
    before = entry["before_redesign_ms"] = BEFORE_REDESIGN_MS[entry["name"]]
    log(f"  redesigned: {entry['ms']:.3f} ms, before {before:.2f} ms ({before / entry['ms']:.2f}x)")


def split_kernel_phases(exp, batches, dev, gen):
    """K4-K6 against their plain versions on batch 0 of the split route
    (every active vertex, real h from K3a), K1/K2 timed at the same shapes,
    and K12 on the blend's table-gradient shape with K4's indices. Returns
    (entries, fused-vs-split times)."""
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream, scatter

    mcfg = exp.model
    geom = batches.dedup[0]
    x = dedup.active_coords(geom.active, dedup.grid_side(mcfg.n_max))
    params = gngf.init_params(mcfg, SEED, dev)
    layers = [(w_.detach(), b_.detach()) for w_, b_ in params.hpd.layers()]
    h = hidden.hidden_stack_fwd(x, layers[:-1]).contiguous()
    w, b = layers[-1]
    counts = geom.counts.contiguous()
    u, H = h.shape
    k, L, T = mcfg.topk_k, mcfg.num_levels, mcfg.hash_table_size
    if hpd_stream.fused_supports(T, k, H) or not hpd_stream.supports(T, k):
        raise AssertionError(f"T={T}, K={k}, H={H} does not take the split route")
    log(f"split route, batch 0: U_c={u}, H={H}, T={T}, L={L}, K={k}")
    head_bytes = 4.0 * (H * T + T)
    entries = {}

    log("K4 hpd_stream_select, full U_c of real h:")
    out_k = hpd_stream.hpd_stream_select(h, w, b, k)
    out_p = hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest")
    same = (out_k[1] == out_p[1]).all(dim=1).double().mean().item()
    log(f"  idx: rows with identical top-{k}: {same:.6f}")
    if same != 1.0:
        raise AssertionError("K4: top-K indices differ from the plain version")
    err = max(compare(n, a, r, FWD_TOL)
              for n, a, r in zip(("vals", "m", "s"), (out_k[0], *out_k[2:]), (out_p[0], *out_p[2:])))
    bitwise_same("vals/idx/m/s", out_k, hpd_stream.hpd_stream_select(h, w, b, k))
    del out_p
    vals, idx, m, s = out_k
    entries["hpd_stream_select"] = kernel_entry(
        "hpd_stream_select", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:193", err,
        cuda_ms(lambda: hpd_stream.hpd_stream_select(h, w, b, k), 5),
        cuda_ms(lambda: hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest"), 2),
        bound_ms(2.0 * u * H * T, 4.0 * (u * H + 2 * u * k + 2 * u) + head_bytes))

    log("K5 hpd_stream_marginal, full U_c:")
    marg = hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)
    err = compare("marg", marg, hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"),
                  FWD_TOL)
    bitwise_same("marg", [marg], [hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)])
    entries["hpd_stream_marginal"] = kernel_entry(
        "hpd_stream_marginal", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:282", err,
        cuda_ms(lambda: hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s), 5),
        cuda_ms(lambda: hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"), 2),
        bound_ms(2.0 * u * H * T + 2.0 * L * u * T,
                 4.0 * (u * H + L * u + 2 * u + L * T) + head_bytes))

    log("K6 hpd_tail_unique_bwd (B1 + B2), full U_c:")
    g_marg = torch.randn(L, T, device=dev, generator=gen)
    g_vals = torch.randn(u, k, device=dev, generator=gen)
    args = (h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k)
    errs = []
    for noop in (False, True):
        got = hpd_stream.hpd_tail_unique_bwd(*args, noop_topk=noop)
        want = hpd_stream.hpd_tail_unique_bwd_plain(*args, "highest", noop)
        errs += [compare(f"{n} noop={noop}", a, r, GRAD_TOL)
                 for n, a, r in zip(("dh", "dw", "db"), got, want)]
        bitwise_same(f"dh/dw/db noop={noop}", got, hpd_stream.hpd_tail_unique_bwd(*args, noop_topk=noop))
        del got, want
    entries["hpd_tail_unique_bwd"] = kernel_entry(
        "hpd_tail_unique_bwd", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:921", max(errs),
        cuda_ms(lambda: hpd_stream.hpd_tail_unique_bwd(*args), 3),
        cuda_ms(lambda: hpd_stream.hpd_tail_unique_bwd_plain(*args, "highest", False), 2),
        tail_bwd_bound(u, H, T, L, k))
    entries["hpd_tail_unique_bwd"]["bound_fp32_ms"] = tail_bwd_bound(u, H, T, L, k, False)[0]
    redesigned(entries["hpd_tail_unique_bwd"])

    log("K1 / K2 at the same shapes (the fused pair, which the gate does not pick here):")
    fused = dict(
        K1_ms=cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k), 3),
        K2_ms=cuda_ms(lambda: hpd_stream.hpd_stream_fused_bwd(*args), 3),
        K4_K5_ms=entries["hpd_stream_select"]["ms"] + entries["hpd_stream_marginal"]["ms"],
        K6_ms=entries["hpd_tail_unique_bwd"]["ms"],
    )
    log(f"  K1 {fused['K1_ms']:.3f} ms vs K4+K5 {fused['K4_K5_ms']:.3f} ms; "
        f"K2 {fused['K2_ms']:.3f} ms vs K6 {fused['K6_ms']:.3f} ms")
    del args, g_marg, g_vals, marg

    c = L * mcfg.feature_dim
    flat = idx.reshape(-1)
    n = flat.numel()
    log(f"K12 scatter_add_serial, N={n} rows of C={c}, idx from K4's top-{k}, T={T}:")
    rows = torch.randn(n, c, device=dev, generator=gen)
    got = scatter.scatter_add_serial(rows, flat, T)
    bitwise_same("dt", [got], [scatter.scatter_add_serial(rows, flat, T)])
    plain = scatter.scatter_add_serial_plain(rows, flat, T)
    if not torch.equal(got, plain):
        raise AssertionError("K12 differs from its plain version, the serial row-order sum")
    err = (got - plain).abs().max().item()
    per_slot = torch.bincount(flat.long(), minlength=T)
    log(f"  dt: bitwise equal to the plain version (serial row-order sum); rows per slot max "
        f"{int(per_slot.max().item())}, slots used {int((per_slot > 0).sum().item())} of {T}")
    flat_long = flat.long()
    acc = torch.zeros(T, c, device=dev)
    entries["scatter_add_serial"] = kernel_entry(
        "scatter_add_serial", SRC + "scatter.cu", JAX_SRC + "scatter_probe.py:42", err,
        cuda_ms(lambda: scatter.scatter_add_serial(rows, flat, T), 20),
        cuda_ms(lambda: scatter.scatter_add_serial_plain(rows, flat, T), 2),
        bound_ms(1.0 * n * c, 4.0 * (n * c + n + T * c)))
    entries["scatter_add_serial"]["library_ms"] = cuda_ms(lambda: acc.index_add_(0, flat_long, rows), 20)
    log(f"  index_add_ alone {entries['scatter_add_serial']['library_ms']:.3f} ms")
    # the wrapper's share: sort, searchsorted and the range check (one host
    # sync), then the kernel alone on their output
    prep = scatter.prepare(flat, T)
    entries["scatter_add_serial"]["prepare_ms"] = cuda_ms(lambda: scatter.prepare(flat, T), 20)
    entries["scatter_add_serial"]["kernel_only_ms"] = cuda_ms(lambda: scatter.scatter_sorted(rows, *prep), 20)
    log(f"  wrapper share: prepare {entries['scatter_add_serial']['prepare_ms']:.3f} ms, kernel alone "
        f"{entries['scatter_add_serial']['kernel_only_ms']:.3f} ms")
    # the hottest slot's rows alone (one block's chain: the kernel's floor)
    hot = per_slot.argmax().item()
    hot_rows = rows[flat == hot].contiguous()
    hot_prep = scatter.prepare(torch.zeros(hot_rows.shape[0], dtype=torch.int32, device=dev), 8)
    entries["scatter_add_serial"]["hot_slot_ms"] = cuda_ms(
        lambda: scatter.scatter_sorted(hot_rows, *hot_prep), 20)
    log(f"  the hottest slot's {hot_rows.shape[0]} rows alone: kernel "
        f"{entries['scatter_add_serial']['hot_slot_ms']:.3f} ms")
    redesigned(entries["scatter_add_serial"])
    del prep, hot_rows, hot_prep
    del h, out_k, vals, idx, m, s, rows, got, plain, acc
    torch.cuda.empty_cache()
    return entries, fused


def probe_ladder_phase(h, w, b, counts, k):
    """K7 (both variants) against its plain version on all rows of h, then
    the sweep ladder at 'highest' through ``tools.sweep_probe.ladder`` with
    K7's counts set to 0 just before. Returns (entries, rungs)."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream
    from collision_handling_in_instantngp_tpu_torch.tools import sweep_probe

    u, H = h.shape
    T = w.shape[1]
    probe = hpd_stream.hpd_stream_fused_probe
    entries = {}
    for variant, tol in (("dots", DOTS_TOL), ("softmax", FWD_TOL)):
        log(f"K7 hpd_stream_fused_probe [{variant}], U_c = {u} rows of real h, H = {H}, T = {T}:")
        got = probe(h, w, b, "highest", variant)
        ref = hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", variant)
        err = max(compare(n, a, r, tol) for n, a, r in zip(("m", "s"), got, ref))
        bitwise_same("m/s", got, probe(h, w, b, "highest", variant))
        name = f"hpd_stream_fused_probe[{variant}]"
        # dots: the row sum of h w + b is one addmm (TF32 off; it writes the
        # (U, T) logits, 10.6 GB) and a sum; no one call returns softmax's m and s
        library = cuda_ms(lambda: torch.addmm(b, h, w).sum(-1), 3) if variant == "dots" else None
        torch.cuda.empty_cache()
        entries[name] = kernel_entry(
            name, SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:1081", err,
            cuda_ms(lambda: probe(h, w, b, "highest", variant), 10),
            cuda_ms(lambda: hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", variant), 3),
            bound_ms(2.0 * u * H * T, 4.0 * (u * H + H * T + T + 2 * u)), library)
        del got, ref

    log("sweep ladder (tools/sweep_probe.py: ladder) at 'highest', same inputs:")
    probe.launches = 0
    probe.variant_launches = dict.fromkeys(probe.variant_launches, 0)
    rung = sweep_probe.ladder(h, w, b[None], counts, k, "highest", reps=5)
    launches = dict(probe.variant_launches)
    for key, v in rung.items():
        log(f"  {key:20s} {v:10.3f} ms")
    for variant, n in launches.items():
        if n == 0:
            raise AssertionError(f"K7 [{variant}] never launched in the sweep ladder")
        entries[f"hpd_stream_fused_probe[{variant}]"].update(launches=n, route="cuda")
    order = ("dots_ms", "softmax_ms", "select_ms", "full_ms")
    for lo, hi in zip(order[:-1], order[1:]):
        if rung[lo] > 1.03 * rung[hi]:
            raise AssertionError(f"the ladder does not telescope: {lo} {rung[lo]} > {hi} {rung[hi]}")
    return entries, rung


def mxu_probe_phase(dev):
    """K13 (four regimes), K14 and K15 against their plain versions at
    ``tools/mxu_probe.py``'s shapes, each timed beside one PyTorch call of
    the same function; then the tool's ``main`` with their counts set to 0
    just before. Returns (entries, the tool's rates)."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import probe
    from collision_handling_in_instantngp_tpu_torch.ops.precision import bf16_round
    from collision_handling_in_instantngp_tpu_torch.tools import mxu_probe

    U, H, T = mxu_probe.U, mxu_probe.H, mxu_probe.T
    h, w, _, _ = mxu_probe.make_inputs(U, H, T, mxu_probe.L, dev)
    flops = 2.0 * U * H * T
    entries = {}
    for regime in probe.REGIMES:
        log(f"K13 rowsum_dot [{regime}], ({U}, {H}) x ({H}, {T}):")
        got = probe.rowsum_dot(h, w, regime)
        err = compare("rowsum", got, probe.rowsum_dot_plain(h, w, regime),
                      BF16X3_TOL if regime == "bf16x3" else FWD_TOL)
        bitwise_same("rowsum", [got], [probe.rowsum_dot(h, w, regime)])
        if regime == "highest":
            bound = bound_ms(flops, 4.0 * (U * H + H * T + U))
        else:   # bf16 products (on the CUDA cores for 'default', the same
            # function as 'bf16'); bf16x3 runs three products per term
            bound = bound_ms((3 if regime == "bf16x3" else 1) * flops, 4.0 * (U * H + H * T + U),
                             PEAK_BF16_TENSOR_FLOPS)
        library = None
        if regime != "bf16x3":
            # fp32 operands (rounded to bf16 first for default/bf16), TF32
            # off; writes the (U, T) product, 10.6 GB
            a, c = (h, w) if regime == "highest" else (bf16_round(h), bf16_round(w))
            library = cuda_ms(lambda: torch.matmul(a, c).sum(-1), 3)
            del a, c
            torch.cuda.empty_cache()
        entries[f"rowsum_dot[{regime}]"] = kernel_entry(
            f"rowsum_dot[{regime}]", SRC + "probe.cu", "tools/mxu_probe.py:119", err,
            cuda_ms(lambda: probe.rowsum_dot(h, w, regime), 5),
            cuda_ms(lambda: probe.rowsum_dot_plain(h, w, regime), 2), bound, library)

    shape = (U, T // 4)
    nbytes = 4.0 * U * (T // 4)
    log(f"K14 hbm_write {shape} fp32 ({nbytes / 1e9:.2f} GB):")
    got = probe.hbm_write(shape, dev)
    if not torch.equal(got, probe.hbm_write_plain(shape, dev)):
        raise AssertionError("K14 differs from its plain version")
    log("  ones: exactly equal to the plain version")
    buf = torch.empty(shape, device=dev)
    entries["hbm_write"] = kernel_entry(
        "hbm_write", SRC + "probe.cu", "tools/mxu_probe.py:157", 0.0,
        cuda_ms(lambda: probe.hbm_write(shape, dev), 10),
        cuda_ms(lambda: probe.hbm_write_plain(shape, dev), 10), bound_ms(0.0, nbytes),
        cuda_ms(lambda: buf.fill_(1.0), 10))
    del got, buf
    torch.cuda.empty_cache()

    log(f"K15 hbm_scale_copy {shape} fp32 (2 x {nbytes / 1e9:.2f} GB):")
    x = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    got = probe.hbm_scale_copy(x)
    if not (torch.equal(got, probe.hbm_scale_copy_plain(x)) and torch.equal(got, probe.hbm_scale_copy(x))):
        raise AssertionError("K15 differs from its plain version or between two runs")
    log("  2x: exactly equal to the plain version, bitwise run to run")
    del got
    y = torch.empty_like(x)
    entries["hbm_scale_copy"] = kernel_entry(
        "hbm_scale_copy", SRC + "probe.cu", "tools/mxu_probe.py:183", 0.0,
        cuda_ms(lambda: probe.hbm_scale_copy(x), 10),
        cuda_ms(lambda: probe.hbm_scale_copy_plain(x), 10), bound_ms(0.0, 2 * nbytes),
        cuda_ms(lambda: torch.mul(x, 2.0, out=y), 10))
    del x, y, h, w
    torch.cuda.empty_cache()

    log("tools/mxu_probe.py main at its shapes:")
    for fn in (probe.rowsum_dot, probe.hbm_write, probe.hbm_scale_copy):
        fn.launches = 0
    probe.rowsum_dot.regime_launches = dict.fromkeys(probe.REGIMES, 0)
    rates = mxu_probe.main(["--reps", "3"])
    launches = {"hbm_write": probe.hbm_write.launches,
                "hbm_scale_copy": probe.hbm_scale_copy.launches,
                **{f"rowsum_dot[{r}]": n for r, n in probe.rowsum_dot.regime_launches.items()}}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched in tools/mxu_probe.py")
        entries[name].update(launches=n, route="cuda")
    torch.cuda.empty_cache()
    return entries, rates


def fit_checked(fit, exp, data, dev, wrappers, what, absent=()):
    """fit for 3 epochs with the wrappers' counts (and those of ``absent``)
    set to 0 just before; fails unless each wrapper launched, no ``absent``
    one did, and the loss is finite and falls. Returns (launches, history,
    seconds)."""
    for fn in (*wrappers.values(), *absent):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(exp, data, epochs=3, device=dev, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for row in res.history:
        log(f"  epoch {row['epoch']}: loss {row['train_loss']:.6f} mse {row['mse_loss']:.6f} "
            f"psnr {row['train_psnr']:.4f} {row['seconds']:.3f} s {row['pixels_per_s']:.0f} px/s")
    log(f"  fit total {fit_s:.2f} s, launches {launches}")
    losses = [row["train_loss"] for row in res.history]
    mses = [row["mse_loss"] for row in res.history]
    # epoch 0 carries no collision term (no previous epoch); it enters at epoch 1
    if not all(math.isfinite(v) for v in losses) or not (losses[-1] < losses[1] and mses[-1] < mses[0]):
        raise AssertionError(f"{what}: loss not finite and falling: {losses}, mse {mses}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on {what}")
    for fn in absent:
        if fn.launches:
            raise AssertionError(f"{fn.__name__} launched {fn.launches} times on {what}")
    return launches, res.history, fit_s


def log_profile(profile) -> None:
    for row in profile["kernels"][:14]:
        log(f"  {row['ms']:10.3f} ms {row['share']:7.2%} x{row['calls']:<4d} {row['name'][:90]}")
    log(f"  epoch wall {profile['wall_ms']:.1f} ms, device busy {profile['busy_ms']:.1f} ms, "
        f"idle share {profile['idle_share']:.2%}")


def tensor_core_sass(build) -> dict:
    """Tensor-core instructions (HGMMA, HMMA) per kernel of the built
    hpd_stream library, from ``cuobjdump -sass``; printed. Raises unless
    every instance of the four backward kernels holds HGMMA (warpgroup MMA)
    and the forward passes hold none."""
    import re
    import subprocess
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build._library_path("hpd_stream")],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"\d+(hpd_\w+?_kernel)ILi(\d)", line)
            name = f"{found.group(1)}<{found.group(2)}>" if found else None
            if name:
                counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name and ("HGMMA" in line or "HMMA" in line):
            counts[name]["HGMMA" if "HGMMA" in line else "HMMA"] += 1
    log("  SASS tensor-core instructions (hpd_stream.cu):")
    for k_, c in sorted(counts.items()):
        log(f"    {k_:34s} HGMMA {c['HGMMA']:4d}  HMMA {c['HMMA']:4d}")
    bwd = ("hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel", "hpd_b1_kernel", "hpd_b2_rows_kernel")
    for p in range(3):
        for k_ in bwd:
            if counts.get(f"{k_}<{p}>", {}).get("HGMMA", 0) == 0:
                raise RuntimeError(f"{k_}<{p}>: no HGMMA in the SASS")
    for k_, c in counts.items():
        if "fwd" in k_ and c["HGMMA"] + c["HMMA"]:
            raise RuntimeError(f"{k_}: tensor-core instructions in a forward pass")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.data import (
        image_dataset, load_image_dataset, make_shuffle_permutations,
    )
    from collision_handling_in_instantngp_tpu_torch.models import encoding, gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import (
        build, hidden, hpd_full, hpd_stream, hpd_tail, scatter,
    )
    from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches
    from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = profiling.gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ------------------------------ build --------------------------------- #
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s ({', '.join(build.SOURCES)})")
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")
    sass = tensor_core_sass(build)

    # ---------------------- inputs of the training path -------------------- #
    data = load_image_dataset(os.path.join(HERE, "images", "strawberry.npy"))
    exp = experiment_from_grid_id(4061, base_model=instantngp_scaled_model())
    mcfg = exp.model
    statics = gngf.make_statics(mcfg)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction,
                                  shuffled, data.image, mcfg, statics, dev)
    geom = batches.dedup[0]
    x = dedup.active_coords(geom.active, dedup.grid_side(mcfg.n_max))
    params = gngf.init_params(mcfg, SEED, dev)
    layers = [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
    hidden_layers, (w_head, b_head) = layers[:-1], layers[-1]
    u_c = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    log(f"image {data.height}x{data.width}, {len(batches.dedup)} batches, U_c={u_c}, "
        f"H={w_head.shape[0]}, T={mcfg.hash_table_size}, L={mcfg.num_levels}, K={mcfg.topk_k}")

    entries = {}
    n_params = sum(w.numel() + b.numel() for w, b in hidden_layers)
    widths = [x.shape[1]] + [w.shape[1] for w, _ in hidden_layers]
    mac_row = sum(a * b for a, b in zip(widths[:-1], widths[1:]))

    # --------------------------- K3a / K3b --------------------------------- #
    log("K3a hidden_stack forward, full U_c:")
    h_k = hidden.hidden_stack_fwd(x, hidden_layers)
    h_p = hidden.hidden_stack_fwd_plain(x, hidden_layers, "highest")
    err = compare("h", h_k, h_p, FWD_TOL)
    bitwise_same("h", [h_k], [hidden.hidden_stack_fwd(x, hidden_layers)])
    ms = cuda_ms(lambda: hidden.hidden_stack_fwd(x, hidden_layers), 20)
    plain = cuda_ms(lambda: hidden.hidden_stack_fwd_plain(x, hidden_layers, "highest"), 20)
    b_ms, b_by = bound_ms(2.0 * u_c * mac_row, 4.0 * (u_c * widths[0] + u_c * widths[-1] + n_params))
    entries["hidden_stack_fwd"] = dict(
        name="hidden_stack_fwd", source="collision_handling_in_instantngp_tpu_torch/ops/cuda/hidden.cu",
        replaces="collision_handling_in_instantngp_tpu/ops/pallas/hidden.py:126",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    log("K3b hidden_stack backward, full U_c:")
    gh = torch.randn(u_c, widths[-1], device=dev, generator=gen) * 1e-3
    g_k = hidden.hidden_stack_bwd(x, hidden_layers, gh)
    g_p = hidden.hidden_stack_bwd_plain(x, hidden_layers, gh, "highest")
    err = max(compare(f"{n}{i}", a, r, GRAD_TOL)
              for i, (ka, pa) in enumerate(zip(g_k, g_p)) for n, a, r in zip("dW db".split(), ka, pa))
    g_k2 = hidden.hidden_stack_bwd(x, hidden_layers, gh)
    bitwise_same("dW/db", [t for pair in g_k for t in pair], [t for pair in g_k2 for t in pair])
    ms = cuda_ms(lambda: hidden.hidden_stack_bwd(x, hidden_layers, gh), 10)
    plain = cuda_ms(lambda: hidden.hidden_stack_bwd_plain(x, hidden_layers, gh, "highest"), 10)
    da_mac = sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
    b_ms, b_by = bound_ms(2.0 * u_c * (2 * mac_row + da_mac),
                          4.0 * (u_c * widths[0] + u_c * widths[-1] + 2 * n_params))
    entries["hidden_stack_bwd"] = dict(
        name="hidden_stack_bwd", source="collision_handling_in_instantngp_tpu_torch/ops/cuda/hidden.cu",
        replaces="collision_handling_in_instantngp_tpu/ops/pallas/hidden.py:161",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    # ------------------------------ K1 / K2 -------------------------------- #
    k, L, T, H = mcfg.topk_k, mcfg.num_levels, mcfg.hash_table_size, w_head.shape[0]
    h_full = h_k.contiguous()
    counts_full = geom.counts.contiguous()

    log("K1 hpd_stream_fused_fwd, full U_c of real h:")
    out_k = hpd_stream.hpd_stream_fused_fwd(h_full, w_head, b_head, counts_full, k)
    out_p = hpd_stream.hpd_stream_fused_fwd_plain(h_full, w_head, b_head, counts_full, k, "highest")
    same_idx = (out_k[2] == out_p[2]).all(dim=1).double().mean().item()
    log(f"  idx: rows with identical top-{k}: {same_idx:.6f}")
    if same_idx != 1.0:
        raise AssertionError("K1: top-K indices differ from the plain version")
    err = max(compare(n, a, r, FWD_TOL)
              for n, a, r in zip(("marg", "vals", "m", "s"),
                                 (out_k[0], out_k[1], out_k[3], out_k[4]),
                                 (out_p[0], out_p[1], out_p[3], out_p[4])))
    bitwise_same("marg/vals/idx/m/s", out_k,
                 hpd_stream.hpd_stream_fused_fwd(h_full, w_head, b_head, counts_full, k))
    del out_p
    ms = cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd(h_full, w_head, b_head, counts_full, k), 5)
    plain = cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd_plain(
        h_full, w_head, b_head, counts_full, k, "highest"), 2)
    b_ms, b_by = bound_ms(
        2.0 * u_c * H * T + 2.0 * L * u_c * T,
        4.0 * (u_c * H + H * T + T + L * u_c + L * T + 2 * u_c * k + 2 * u_c),
    )
    log(f"  kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    entries["hpd_stream_fused_fwd"] = dict(
        name="hpd_stream_fused_fwd", source="collision_handling_in_instantngp_tpu_torch/ops/cuda/hpd_stream.cu",
        replaces="collision_handling_in_instantngp_tpu/ops/pallas/hpd_stream.py:570",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    log("K2 hpd_stream_fused_bwd, full U_c of real h:")
    g_marg = torch.randn(L, T, device=dev, generator=gen)
    g_vals = torch.randn(u_c, k, device=dev, generator=gen)
    _, vals, idx, m, s = out_k
    args = (h_full, w_head, b_head, counts_full, idx, vals, m, s, g_marg, g_vals, k)
    errs = []
    for noop in (False, True):
        res_k = hpd_stream.hpd_stream_fused_bwd(*args, noop_topk=noop)
        res_p = hpd_stream.hpd_stream_fused_bwd_plain(*args, "highest", noop)
        errs += [compare(f"{n} noop={noop}", a, r, GRAD_TOL)
                 for n, a, r in zip(("dh", "dw", "db"), res_k, res_p)]
        bitwise_same(f"dh/dw/db noop={noop}", res_k,
                     hpd_stream.hpd_stream_fused_bwd(*args, noop_topk=noop))
        del res_k, res_p
    ms = cuda_ms(lambda: hpd_stream.hpd_stream_fused_bwd(*args), 3)
    plain = cuda_ms(lambda: hpd_stream.hpd_stream_fused_bwd_plain(*args, "highest", False), 2)
    b_ms, b_by = tail_bwd_bound(u_c, H, T, L, k)
    log(f"  kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    entries["hpd_stream_fused_bwd"] = dict(
        name="hpd_stream_fused_bwd", source="collision_handling_in_instantngp_tpu_torch/ops/cuda/hpd_stream.cu",
        replaces="collision_handling_in_instantngp_tpu/ops/pallas/hpd_stream.py:722",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bound_fp32_ms=tail_bwd_bound(u_c, H, T, L, k, False)[0],
    )
    redesigned(entries["hpd_stream_fused_bwd"])

    # --------------- kernels vs plain versions end to end ------------------ #
    log("small streamed geometry, 2 epochs, card (kernels) vs CPU (plain versions):")
    small = experiment_from_grid_id(4061, base_model=ModelConfig(
        hash_table_size=2048, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream"))
    img = torch.randint(0, 256, (24, 20, 3), generator=torch.Generator().manual_seed(SEED))
    small_data = image_dataset(img.numpy().astype("uint8"), "synthetic")
    start = gngf.init_params(small.model, SEED, "cpu")
    r_gpu = fit(small, small_data, epochs=2, device=dev, params=start, verbose=False)
    r_cpu = fit(small, small_data, epochs=2, device="cpu", params=start, verbose=False)
    for hg, hc in zip(r_gpu.history, r_cpu.history):
        log(f"  epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
        if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
            raise AssertionError("training on the card disagrees with the plain versions on the CPU")

    # ------------------------- the main path ------------------------------- #
    wrappers = {
        "hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
        "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd,
        "hidden_stack_fwd": hidden.hidden_stack_fwd,
        "hidden_stack_bwd": hidden.hidden_stack_bwd,
    }
    log("fit: grid 4061, scaled geometry, strawberry, 3 epochs:")
    launches, history, fit_s = fit_checked(fit, exp, data, dev, wrappers, "the dedup route")
    for name, n in launches.items():
        entries[name]["launches"] = n
        entries[name]["route"] = "cuda"

    # ------------------ where one epoch's device time goes ------------------ #
    log("profile: one epoch of the same training, device time by kernel:")
    profile = profile_epoch(exp, statics, batches, dev)
    log_profile(profile)
    entries["hpd_stream_fused_bwd"]["per_launch_ms"] = per_launch(
        "K2", profile, ("hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel"))
    del batches, geom, h_k, h_full, args, out_k       # x, counts_full: step 12
    torch.cuda.empty_cache()
    marks = {}
    watermark(marks, "dedup route (steps 2-5)", dev)

    # ------------------- the per-row route: K8-K11 ------------------------- #
    data_raw = load_image_dataset(os.path.join(HERE, "images", "strawberry.npy"), normalize=False)
    pr_exp = experiment_from_grid_id(4061, base_model=ModelConfig(batchnorm_input=True))
    pr_statics = gngf.make_statics(pr_exp.model)
    shuffled, _ = make_shuffle_permutations(data_raw.num_pixels, pr_exp.train.seed,
                                            pr_exp.train.shuffle_pixels)
    pr_batches = build_epoch_batches(data_raw.coords, data_raw.targets, pr_exp.train.batch_fraction,
                                     shuffled, data_raw.image, pr_exp.model, pr_statics, dev)
    entries.update(per_row_kernel_phases(pr_exp, pr_batches, pr_statics, dev, gen))

    routes = {
        "auto": ({"hpd_full_fwd": hpd_full.hpd_full_fwd, "hpd_full_bwd": hpd_full.hpd_full_bwd}, "auto"),
        "pallas": ({"hpd_tail_fwd": hpd_tail.hpd_tail_fwd, "hpd_tail_bwd": hpd_tail.hpd_tail_bwd}, "pallas"),
    }
    log("small per-row geometry, 2 epochs, card (kernels) vs CPU (plain versions):")
    small_img = image_dataset(img.numpy().astype("uint8"), "synthetic", normalize=False)
    for route, (_, backend) in routes.items():
        small = experiment_from_grid_id(4061, base_model=ModelConfig(
            batchnorm_input=True, hpd_backend=backend))
        start = gngf.init_params(small.model, SEED, "cpu")
        r_gpu = fit(small, small_img, epochs=2, device=dev, params=start, verbose=False)
        r_cpu = fit(small, small_img, epochs=2, device="cpu", params=start, verbose=False)
        for hg, hc in zip(r_gpu.history, r_cpu.history):
            log(f"  {route} epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
            if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
                raise AssertionError(f"per-row training ({route}) on the card disagrees with the CPU")

    per_row_fits = {}
    for route, (route_wrappers, backend) in routes.items():
        run_exp = dataclasses.replace(pr_exp, model=dataclasses.replace(pr_exp.model, hpd_backend=backend))
        log(f"fit: grid 4061, default geometry, batchnorm_input, hpd_backend {backend!r}, "
            "strawberry raw coords, 3 epochs:")
        launches, pr_history, pr_fit_s = fit_checked(fit, run_exp, data_raw, dev, route_wrappers,
                                                     f"the per-row route ({backend})")
        per_row_fits[route] = dict(history=pr_history, fit_s=pr_fit_s, launches=launches)
        for name, n in launches.items():
            entries[name]["launches"] = n
            entries[name]["route"] = "cuda"

    log("profile: one per-row epoch (hpd_backend 'auto'), device time by kernel:")
    pr_profile = profile_epoch(pr_exp, pr_statics, pr_batches, dev)
    log_profile(pr_profile)
    watermark(marks, "per-row route (steps 6-8)", dev)

    # ----------- the split route at T = 2^16: K4-K6 and K12 ---------------- #
    exp16 = experiment_from_grid_id(4061, base_model=instantngp_scaled_model(hash_table_size=2**16))
    statics16 = gngf.make_statics(exp16.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp16.train.seed, exp16.train.shuffle_pixels)
    batches16 = build_epoch_batches(data.coords, data.targets, exp16.train.batch_fraction,
                                    shuffled, data.image, exp16.model, statics16, dev)
    split_entries, fused_vs_split = split_kernel_phases(exp16, batches16, dev, gen)
    entries.update(split_entries)

    split_wrappers = {
        "hidden_stack_fwd": hidden.hidden_stack_fwd,
        "hidden_stack_bwd": hidden.hidden_stack_bwd,
        "hpd_stream_select": hpd_stream.hpd_stream_select,
        "hpd_stream_marginal": hpd_stream.hpd_stream_marginal,
        "hpd_tail_unique_bwd": hpd_stream.hpd_tail_unique_bwd,
        "scatter_add_serial": scatter.scatter_add_serial,
    }
    fused_pair = (hpd_stream.hpd_stream_fused_fwd, hpd_stream.hpd_stream_fused_bwd)
    log("small split geometry (fused gate and blend threshold forced), 2 epochs, "
        "card (kernels) vs CPU (plain versions):")
    saved = (hpd_stream.FUSED_W_MAX_BYTES, encoding._BLEND_SMATRIX_MIN_ELEMENTS,
             encoding.BLEND_SCATTER_BACKEND)
    hpd_stream.FUSED_W_MAX_BYTES, encoding._BLEND_SMATRIX_MIN_ELEMENTS = 0, 0
    encoding.BLEND_SCATTER_BACKEND = "vmem_serial"
    small = experiment_from_grid_id(4061, base_model=ModelConfig(
        hash_table_size=4096, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream"))
    start = gngf.init_params(small.model, SEED, "cpu")
    for fn in (*split_wrappers.values(), *fused_pair):
        fn.launches = 0
    r_gpu = fit(small, small_data, epochs=2, device=dev, params=start, verbose=False)
    small_launches = {name: fn.launches for name, fn in split_wrappers.items()}
    if min(small_launches.values()) == 0 or any(fn.launches for fn in fused_pair):
        raise AssertionError(f"small split geometry did not run the split kernels: {small_launches}")
    r_cpu = fit(small, small_data, epochs=2, device="cpu", params=start, verbose=False)
    for hg, hc in zip(r_gpu.history, r_cpu.history):
        log(f"  epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
        if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
            raise AssertionError("split training on the card disagrees with the plain versions on the CPU")
    hpd_stream.FUSED_W_MAX_BYTES, encoding._BLEND_SMATRIX_MIN_ELEMENTS = saved[:2]

    log("fit: grid 4061, instantngp_scaled_model(hash_table_size=2**16), "
        "BLEND_SCATTER_BACKEND=vmem_serial, strawberry, 3 epochs:")
    launches16, history16, fit16_s = fit_checked(fit, exp16, data, dev, split_wrappers,
                                                 "the split route", absent=fused_pair)
    for name in ("hpd_stream_select", "hpd_stream_marginal", "hpd_tail_unique_bwd", "scatter_add_serial"):
        entries[name]["launches"] = launches16[name]
        entries[name]["route"] = "cuda"
    log("profile: one epoch of the T = 2^16 training, device time by kernel:")
    profile16 = profile_epoch(exp16, statics16, batches16, dev)
    log_profile(profile16)
    entries["hpd_tail_unique_bwd"]["per_launch_ms"] = per_launch(
        "K6", profile16, ("hpd_b1_kernel", "hpd_b2_rows_kernel", "hpd_bwd_cols_kernel"))
    encoding.BLEND_SCATTER_BACKEND = saved[2]
    del batches16
    torch.cuda.empty_cache()
    watermark(marks, "split route (steps 9-11)", dev)

    # ------ the measurement path: the K7 ladder, then the mxu probe --------- #
    h_c = hidden.hidden_stack_fwd(x, hidden_layers).contiguous()
    ladder_entries, ladder = probe_ladder_phase(h_c, w_head, b_head, counts_full, k)
    entries.update(ladder_entries)
    del h_c, x, counts_full
    torch.cuda.empty_cache()
    watermark(marks, "K7 ladder (step 12)", dev)
    mxu_entries, mxu_rates = mxu_probe_phase(dev)
    entries.update(mxu_entries)
    watermark(marks, "mxu probe (step 13)", dev)

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, build_s=build_s, kernels=list(entries.values()),
                       fit=history, fit_s=fit_s, profile=profile, per_row_fits=per_row_fits,
                       per_row_profile=pr_profile, fused_vs_split=fused_vs_split,
                       split_fit=history16, split_fit_s=fit16_s, split_launches=launches16,
                       split_profile=profile16, sweep_ladder_highest=ladder,
                       mxu_probe_rates=mxu_rates, memory_gb=marks, compares=COMPARES,
                       sass_tensor_ops=sass), f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k_: e[k_] for k_ in keys} for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
