#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from the sources in this checkout (one
   nvcc per source, all started together);
2. holds every kernel of the training path against its plain PyTorch
   version on the same inputs at the path's shapes (scaled grid-4061
   geometry on the strawberry image: H=128, T=16384, L=16, K=4, the full
   U_c = 161,792 rows of the first batch, real h for the tail), checks
   that the deterministic outputs are bitwise equal run to run, and times
   kernel and plain version on the same inputs;
3. trains a small streamed geometry on the card and on the CPU and
   compares the losses (kernels vs plain versions end to end);
4. runs ``fit`` on grid 4061 at scaled geometry for 3 epochs with the
   launch counts set to 0 just before, and fails unless every kernel
   launched and the loss is finite and falls;
5. profiles one more epoch of that training (device time by kernel, the
   device's idle share);
6. prints the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``. Every number also goes to
   ``chiprun_out/chip_smoke.json``.

Any failure raises, so the run exits non-zero without the last line. It
exits non-zero at once where CUDA is not available.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
SEED = 65535
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth. 'highest' runs fp32 FMA on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# normwise tolerances: max |kernel - plain| <= tol * max |plain| (fp32,
# different summation order; outputs sum up to 161,792 rows)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, ref, tol):
    """max abs error; raises if it exceeds tol * max |ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    log(f"  {name}: max_abs_err {err:.3e} max_rel_err {err / max(scale, 1e-30):.3e} (scale {scale:.3e})")
    if not torch.isfinite(got).all() or err > tol * scale:
        raise AssertionError(f"{name}: kernel disagrees with plain version ({err} > {tol} * {scale})")
    return err


def bitwise_same(name, a, b):
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: outputs differ between two identical runs")
    log(f"  {name}: bitwise equal run to run")


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_epoch(exp, statics, batches, dev) -> dict:
    """Device time by kernel over one training epoch (``run_epoch`` on the
    prepared batches, after one unprofiled warm-up epoch), from
    torch.profiler's device events. Everything runs on one stream, so the
    busy time is the sum of the device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
    from collision_handling_in_instantngp_tpu_torch.train.train_step import (
        initial_collision_state, run_epoch,
    )

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
    by_name = {}
    for e in prof.events():
        # user annotations (e.g. Optimizer.step) span kernels already counted
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            row = by_name.setdefault(e.name, dict(name=e.name, ms=0.0, calls=0))
            row["ms"] += e.device_time_total / 1e3
            row["calls"] += 1
    busy = sum(r["ms"] for r in by_name.values())
    rows = sorted(by_name.values(), key=lambda r: -r["ms"])
    for r in rows:
        r["share"] = r["ms"] / busy if busy else 0.0
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall_ms),
                kernels=rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.data import (
        image_dataset, load_image_dataset, make_shuffle_permutations,
    )
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import build, hidden, hpd_stream
    from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches
    from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ------------------------------ build --------------------------------- #
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s ({', '.join(build.SOURCES)})")
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")

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
    b_ms, b_by = bound_ms(
        6.0 * u_c * H * T + 4.0 * L * u_c * T,
        4.0 * (2 * u_c * H + 2 * H * T + 2 * T + L * u_c + 3 * u_c * k + 2 * u_c + L * T),
    )
    log(f"  kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    entries["hpd_stream_fused_bwd"] = dict(
        name="hpd_stream_fused_bwd", source="collision_handling_in_instantngp_tpu_torch/ops/cuda/hpd_stream.cu",
        replaces="collision_handling_in_instantngp_tpu/ops/pallas/hpd_stream.py:722",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

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
    for fn in wrappers.values():
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
        raise AssertionError(f"fit: loss not finite and falling: {losses}, mse {mses}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")
        entries[name]["launches"] = n
        entries[name]["route"] = "cuda"

    # ------------------ where one epoch's device time goes ------------------ #
    log("profile: one epoch of the same training, device time by kernel:")
    profile = profile_epoch(exp, statics, batches, dev)
    for row in profile["kernels"][:12]:
        log(f"  {row['ms']:10.3f} ms {row['share']:7.2%} x{row['calls']:<4d} {row['name'][:90]}")
    log(f"  epoch wall {profile['wall_ms']:.1f} ms, device busy {profile['busy_ms']:.1f} ms, "
        f"idle share {profile['idle_share']:.2%}")

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, build_s=build_s, kernels=list(entries.values()),
                       fit=res.history, fit_s=fit_s, profile=profile), f, indent=1)
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
