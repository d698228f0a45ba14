"""K13 (four regimes), K14 and K15 on the card at ``tools/mxu_probe.py``'s
shapes, each call split into its kernels.

For each K13 regime: the normwise error against the plain version, bitwise
equality run to run, the call's time (CUDA events), the device time of each
of its kernels from the profiler (the tensor-core regimes launch a prep
kernel, w^T in bf16, then the main kernel), the rate and the share of the
bound (operations at the card's peak for the regime's type), and one
PyTorch call of the same function (``matmul(h, w).sum(-1)``,
which writes the (U, T) product). For K14 and K15: time, GB/s, share of the
bytes bound, exactness, and the library call (``fill_``, ``mul(out=)``);
K14 also by launch. Also the SM clock and board power that ``nvidia-smi``
reads while each of 'highest', 'bf16', 'bf16x3', K14 and ``fill_`` runs
back to back (the rate a kernel can reach scales with the clock the card
holds under it). Prints the card's
name and power limit; writes everything to ``--out``.

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.probe_phases \\
        [--out chiprun_out/probe_phases.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..device import resolve_device
from ..ops.cuda import probe
from ..ops.precision import bf16_round
from ..utils import profiling
from . import mxu_probe
from .roofline import kernel_work

TOL = {"bf16x3": 1e-4}   # else 1e-5 (normwise; the smoke's limits)
REPS = 5


def kernel_ms(fn, reps: int) -> dict:
    """{kernel name: device ms a call} over ``reps`` profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = profiling.device_time_by_kernel(prof, 1.0)["kernels"]
    return {r["name"]: r["ms"] / reps for r in rows}


def clocks_during(fn, seconds: float = 1.5) -> dict:
    """The SM clock (MHz) and board power (W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs back to back for about ``seconds``; the
    samples of the middle half."""
    import subprocess
    import time

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")] for line in out.strip().splitlines() if line.strip()]
    mid = rows[len(rows) // 4: max(len(rows) // 4 + 1, 3 * len(rows) // 4)]
    return dict(sm_mhz=[r[0] for r in mid], power_w=[r[1] for r in mid])


def print_launches(row) -> None:
    for name, k_ms in row["kernels"].items():
        print(f"    {k_ms:9.3f} ms  {name[:90]}", flush=True)
    for key in ("clocks", "library_clocks"):
        if key in row:
            c = row[key]
            print(f"    {'fill_' if key == 'library_clocks' else 'kernel'}: SM clock "
                  f"{min(c['sm_mhz']):.0f}-{max(c['sm_mhz']):.0f} MHz, power "
                  f"{min(c['power_w']):.0f}-{max(c['power_w']):.0f} W while it runs", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "probe_phases.json"))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = profiling.gpu_name_and_power_limit()
    print(gpu, flush=True)
    u, hd, t = mxu_probe.U, mxu_probe.H, mxu_probe.T
    h, w, _, _ = mxu_probe.make_inputs(u, hd, t, mxu_probe.L, dev)
    flops = 2.0 * u * hd * t
    res = dict(gpu=gpu, shape=[u, hd, t], reps=REPS, rowsum={})
    for regime in probe.REGIMES:
        got = probe.rowsum_dot(h, w, regime)
        ref = probe.rowsum_dot_plain(h, w, regime)
        err = ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()
        same = torch.equal(got, probe.rowsum_dot(h, w, regime))
        del got, ref
        ms = profiling.cuda_ms(lambda: probe.rowsum_dot(h, w, regime), REPS)
        parts = kernel_ms(lambda: probe.rowsum_dot(h, w, regime), REPS)
        bound = kernel_work("K13", u=u, h=hd, t=t, regime=regime)["bound_ms"]
        row = dict(ms=ms, kernels=parts, normwise_err=err, bitwise_stable=same,
                   tflops=flops / ms / 1e9, bound_ms=bound, share_of_bound=bound / ms)
        if regime != "bf16x3":
            a, c = (h, w) if regime == "highest" else (bf16_round(h), bf16_round(w))
            row["library_ms"] = profiling.cuda_ms(lambda: torch.matmul(a, c).sum(-1), 3)
            del a, c
            torch.cuda.empty_cache()
        if regime != "default":   # 'default' runs the kernel of 'bf16'
            row["clocks"] = clocks_during(lambda: probe.rowsum_dot(h, w, regime))
        res["rowsum"][regime] = row
        ok = err <= TOL.get(regime, 1e-5) and same
        print(f"K13 [{regime:7s}] {ms:9.3f} ms  {row['tflops']:7.2f} TF/s  bound {bound:.3f} ms "
              f"({row['share_of_bound']:.1%})  err {err:.2e}  stable {same}  "
              f"library {row.get('library_ms', float('nan')):.3f} ms  {'ok' if ok else 'FAIL'}",
              flush=True)
        for name, k_ms in parts.items():
            print(f"    {k_ms:9.3f} ms  {name[:90]}", flush=True)
        if "clocks" in row:
            c = row["clocks"]
            print(f"    SM clock {min(c['sm_mhz']):.0f}-{max(c['sm_mhz']):.0f} MHz, power "
                  f"{min(c['power_w']):.0f}-{max(c['power_w']):.0f} W while it runs", flush=True)

    shape = (u, t // 4)
    mem = 4.0 * u * (t // 4)
    x = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    y = torch.empty_like(x)
    copy_ok = torch.equal(probe.hbm_scale_copy(x), x * 2)
    ones_ok = torch.equal(probe.hbm_write(shape, dev), torch.ones(shape, device=dev))
    for name, kernel, fn, lib_fn, moved, ok in (
            ("hbm_write", "K14", lambda: probe.hbm_write(shape, dev), lambda: y.fill_(1.0), mem,
             ones_ok),
            ("hbm_scale_copy", "K15", lambda: probe.hbm_scale_copy(x),
             lambda: torch.mul(x, 2.0, out=y), 2 * mem, copy_ok)):
        ms = profiling.cuda_ms(fn, 10)
        lib_ms = profiling.cuda_ms(lib_fn, 10)
        bound = kernel_work(kernel, nbytes=mem)["bound_ms"]
        res[name] = dict(ms=ms, gbps=moved / ms / 1e6, bound_ms=bound, library_ms=lib_ms, exact=ok)
        print(f"{name:15s} {ms:9.3f} ms  {moved / ms / 1e6:7.1f} GB/s  bound {bound:.3f} ms "
              f"({bound / ms:.1%})  library {lib_ms:.3f} ms  {'exact' if ok else 'FAIL'}", flush=True)
        if name == "hbm_write":
            res[name].update(kernels=kernel_ms(fn, REPS), clocks=clocks_during(fn),
                             library_clocks=clocks_during(lib_fn))
            print_launches(res[name])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
