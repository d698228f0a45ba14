"""Split the streamed tail's backward (K2 ``hpd_stream_fused_bwd``, K6
``hpd_tail_unique_bwd``) into its launches and phases on the card, for one
or more checkouts in one chip call.

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.k2_phases \\
        --run parent=_archive/parent --run change=. \\
        [--shapes smoke256,scaled256,scaled128] [--out chiprun_out/k2_phases]

Shapes (U, T, L, K, H) in SHAPES: ``smoke256`` the wide stack's tail as
``chip_smoke.py`` step 13 times it (``smoke128`` at H = 128),
``scaled256`` the wide ``--scaled`` fit's batch 0 (U_c = 161,792, T =
2^14, L = 16), ``scaled128`` and
``t16_128`` the main path's head at T = 2^14 and 2^16. The inputs are
seeded numpy draws at step 13's scales (h uniform in [0, 0.1), w N(0,
0.2^2), b N(0, 0.1^2), counts integers 0-4, g_marg and g_vals N(0, 1)) with
the residuals idx, vals, m, s of the plain forward on the card, each
shape's from its own stream of the seed; made once, saved under the
package's build directory and removed at the end, so that every run reads
the same bits.

Each run is a process of its own that imports the package of its checkout
(PYTHONPATH), so its kernels build from that checkout's sources. For K2
and K6 at each shape it records: the ms of a call (CUDA events), each
launch's device ms from the profiler (the split by launch: for the older
CUDA-core wide passes, G, dh and dW), the normwise error of dh, dw and db
against the plain version, the outputs' sha256 (equal digests, equal bits),
and the plain version's ms and the bound (``roofline.kernel_work``: 3xTF32
at the TF32 peak, or the bytes); and the ms and output sha256 of the forward passes built from the
same source (K1, K4, K5 on the plain version's m and s, K7's two
variants) on the same inputs, beside their plain versions' ms. Where the checkout's ``hpd_stream.cu`` has the phase marks, the run
also builds it with ``-DHPD_STREAM_PHASES`` (into ``<out>/<label>/``, beside
the normal build) and splits each backward kernel's clock64() ticks into
PHASES: the ring's waits, the B tiles' restaging per chunk, the logits
(the chunks' MMAs, the halves' exchange, p), G (and dot), dl (g_p, the
top-K scatter, dl's tiles, db), the dh or dW product, and the rest; and
K1's two passes likewise (wait, restage, logits, select/marg: the rows
pass's selection or the columns pass's p and marginal, rest), where the
source marks them. A phase's ms is its share of the kernel's ticks times
the kernel's profiled ms. The instrumented build's extra barriers make it a little slower; its
shares are what it is for. Prints the card's name and power limit, a
table, and the digests side by side, equal or not across the runs at
DIGEST_SHAPES; writes everything to ``<out>/k2_phases.json``. Compare two
checkouts only within one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

SHAPES = {"smoke256": (20_000, 4096, 4, 4, 256), "smoke128": (20_000, 4096, 4, 4, 128),
          "scaled256": (161_792, 16_384, 16, 4, 256),
          "scaled128": (161_792, 16_384, 16, 4, 128), "t16_128": (161_792, 65_536, 16, 4, 128)}
# the kernels and phases of hpd_stream.cu's PK_* and PH_* marks; a
# checkout's own enums give their order (phase_layout)
PHASE_KERNELS = {"PK_ROWS": "hpd_bwd_rows_kernel", "PK_B1": "hpd_b1_kernel",
                 "PK_B2": "hpd_b2_rows_kernel", "PK_COLS": "hpd_bwd_cols_kernel",
                 "PK_FWD_ROWS": "hpd_fwd_rows_kernel", "PK_FWD_COLS": "hpd_fwd_cols_kernel"}
PHASES = {"PH_WAIT": "wait", "PH_RESTAGE": "restage", "PH_LOGITS": "logits", "PH_G": "G",
          "PH_DL": "dl", "PH_PRODUCT": "dh/dW", "PH_REST": "rest", "PH_SELECT": "select/marg"}
# the shapes tools/ab_smoke.py times in each run; the H = 128 ones whose
# output digests it compares across runs
AB_SHAPES = ("scaled128", "t16_128", "scaled256")
DIGEST_SHAPES = ("scaled128", "t16_128")
ARGS = ("h", "w", "b", "counts", "idx", "vals", "m", "s", "g_marg", "g_vals")


def make_inputs(path: str, shapes, seed: int) -> None:
    """The inputs of every shape (module doc) to ``path``."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream
    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    out = dict(card=profiling.gpu_name_and_power_limit(), shapes={})
    for name in shapes:
        u, t, l, k, hd = SHAPES[name]
        rng = np.random.default_rng((seed, list(SHAPES).index(name)))   # whatever the list
        x = dict(h=rng.random((u, hd), dtype=np.float32) * 0.1,
                 w=rng.standard_normal((hd, t), dtype=np.float32) * 0.2,
                 b=rng.standard_normal(t, dtype=np.float32) * 0.1,
                 counts=rng.integers(0, 5, size=(l, u)).astype(np.float32),
                 g_marg=rng.standard_normal((l, t), dtype=np.float32),
                 g_vals=rng.standard_normal((u, k), dtype=np.float32))
        x = {n: torch.from_numpy(a) for n, a in x.items()}
        on = {n: a.to(dev) for n, a in x.items()}
        _, vals, idx, m, s = hpd_stream.hpd_stream_fused_fwd_plain(
            on["h"], on["w"], on["b"], on["counts"], k, "highest")
        x.update(vals=vals.cpu(), idx=idx.cpu(), m=m.cpu(), s=s.cpu())
        out["shapes"][name] = dict(shape=(u, t, l, k, hd), tensors=x)
        del on
    torch.save(out, path)
    torch.cuda.empty_cache()   # the caller may run other processes on the card next


def kernel_ms(fn, reps: int) -> dict:
    """{kernel name: device ms a call} over ``reps`` profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = profiling.device_time_by_kernel(prof, 1.0)["kernels"]
    return {r["name"]: r["ms"] / reps for r in rows}


def sha256(tensors) -> str:
    digest = hashlib.sha256()
    for a in tensors:
        digest.update(a.cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def normwise(got, ref) -> float:
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max().clamp_min(1e-30)).item()


def start_phase_build(out_dir: str):
    """nvcc of hpd_stream.cu with -DHPD_STREAM_PHASES, started: (process,
    library path), or None where this checkout's source has no marks."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import build, hpd_stream

    src = os.path.join(build.HERE, "hpd_stream.cu")
    with open(src) as f:
        if "HPD_STREAM_PHASES" not in f.read() or not hasattr(hpd_stream, "_configure"):
            return None
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "hpd_stream_phases.so")
    cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-DHPD_STREAM_PHASES",
           "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def phase_layout(src: str) -> tuple:
    """(kernels, phases) in the order of an hpd_stream.cu source's PK_* and
    PH_* enums, named as in PHASE_KERNELS and PHASES."""
    import re

    kernels = re.search(r"enum \{ (PK_[^}]*), NPK \};", src).group(1).split(", ")
    phases = re.search(r"enum \{ (PH_[^}]*), NPH \};", src).group(1).split(", ")
    return [PHASE_KERNELS[k] for k in kernels], [PHASES[p] for p in phases]


def phase_split(lib_path: str, fn) -> dict:
    """{kernel: {phase: share of its ticks}} of one call of ``fn`` on the
    instrumented build (kernels without ticks left out)."""
    import ctypes

    from collision_handling_in_instantngp_tpu_torch.ops.cuda import build, hpd_stream

    with open(os.path.join(build.HERE, "hpd_stream.cu")) as f:
        kernels, phases = phase_layout(f.read())
    lib = hpd_stream._configure(ctypes.CDLL(lib_path))
    reader = lib.hpd_stream_bwd_phases
    reader.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    reader.restype = ctypes.c_int
    ticks = (ctypes.c_ulonglong * (len(kernels) * len(phases)))()
    normal = hpd_stream._lib
    hpd_stream._lib = lambda: lib
    try:
        build.check(reader(ticks, 1), lib, "hpd_stream_error_string", "phase reset")
        fn()
        torch.cuda.synchronize()
        build.check(reader(ticks, 0), lib, "hpd_stream_error_string", "phase read")
    finally:
        hpd_stream._lib = normal
    out = {}
    for i, kernel in enumerate(kernels):
        row = list(ticks[i * len(phases):(i + 1) * len(phases)])
        if sum(row):
            out[kernel] = {p: v / sum(row) for p, v in zip(phases, row)}
    return out


def phases_ms(lib_path: str, call, launches: dict) -> dict:
    """{kernel: {phase: {share, ms}}} of one call: each kernel's share of
    its ticks times its profiled ms (``launches``)."""
    return {kern: {p: dict(share=sh, ms=sh * sum(v for n, v in launches.items() if kern in n))
                   for p, sh in shares.items()}
            for kern, shares in phase_split(lib_path, call).items()}


def worker(inputs: str, reps: int, out_dir: str, phases: bool) -> dict:
    """Every shape of ``inputs`` through the K2 and K6 of the package on
    sys.path (module doc)."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import build, hpd_stream
    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    started = start_phase_build(out_dir) if phases else None
    build.build_all(["hpd_stream"])
    lib_path = None
    if started is not None:
        proc, lib_path = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -DHPD_STREAM_PHASES failed:\n{log}")
    dev = torch.device("cuda", 0)
    x = torch.load(inputs)
    out = dict(package=os.path.dirname(os.path.abspath(hpd_stream.__file__)),
               phase_marks=lib_path is not None, shapes={})
    wrappers = (("K2", hpd_stream.hpd_stream_fused_bwd), ("K6", hpd_stream.hpd_tail_unique_bwd))
    for name, entry in x["shapes"].items():
        u, t, l, k, hd = entry["shape"]
        args = tuple(entry["tensors"][a].to(dev) for a in ARGS) + (k,)
        want = hpd_stream.hpd_stream_fused_bwd_plain(*args, "highest", False)
        res = out["shapes"][name] = dict(
            shape=dict(u=u, t=t, l=l, k=k, h=hd),
            plain_ms=profiling.cuda_ms(
                lambda: hpd_stream.hpd_stream_fused_bwd_plain(*args, "highest", False), 2))
        for kname, fn in wrappers:
            got = fn(*args)
            call = lambda: fn(*args)
            row = res[kname] = dict(
                sha256=sha256(got), err={n: normwise(a, r) for n, a, r in zip(("dh", "dw", "db"), got, want)},
                ms=profiling.cuda_ms(call, reps), launches=kernel_ms(call, 2))
            if lib_path is not None:
                row["phases"] = phases_ms(lib_path, call, row["launches"])
            del got
        # the forward passes built from the same source (K1, K4, K5, K7), timed,
        # their outputs hashed
        h, w, b, counts = args[:4]
        m, s = entry["tensors"]["m"].to(dev), entry["tensors"]["s"].to(dev)
        fwd = {"K1": lambda: hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k),
               "K4": lambda: hpd_stream.hpd_stream_select(h, w, b, k),
               "K5": lambda: (hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s),),
               "K7 dots": lambda: hpd_stream.hpd_stream_fused_probe(h, w, b, variant="dots"),
               "K7 softmax": lambda: hpd_stream.hpd_stream_fused_probe(h, w, b)}
        res["fwd_ms"] = {n: profiling.cuda_ms(fn, reps) for n, fn in fwd.items()}
        res["fwd_sha256"] = {n: sha256(fn()) for n, fn in fwd.items()}
        plain = {"K1": lambda: hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, "highest"),
                 "K4": lambda: hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest"),
                 "K5": lambda: hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"),
                 "K7 dots": lambda: hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", "dots"),
                 "K7 softmax": lambda: hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest",
                                                                              "softmax")}
        res["fwd_plain_ms"] = {n: profiling.cuda_ms(fn, 2) for n, fn in plain.items()}
        res["K1"] = dict(launches=kernel_ms(fwd["K1"], 2))
        if lib_path is not None:
            res["K1"]["phases"] = phases_ms(lib_path, fwd["K1"], res["K1"]["launches"])
        del args, want, h, w, b, counts, m, s
        torch.cuda.empty_cache()
    return out


def run_worker(label: str, checkout: str, inputs: str, out_dir: str, reps: int, phases: bool,
               timeout: float) -> dict:
    """``worker`` in a process of its own on ``checkout``'s package."""
    result = os.path.join(out_dir, f"{label}.json")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", inputs, "--reps", str(reps),
           "--out", os.path.join(os.path.abspath(out_dir), label)]
    if not phases:
        cmd.append("--no-phases")
    proc = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True, text=True, timeout=timeout)
    with open(os.path.join(out_dir, f"{label}.log"), "w") as f:
        f.write(proc.stdout + "\n== stderr\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"k2_phases run {label} failed (exit {proc.returncode}); see {label}.log")
    with open(result) as f:
        res = json.load(f)
    # the bound from this checkout's count, whatever package the run imported
    from .roofline import kernel_work

    for shape in res["shapes"].values():
        shape["bound_ms"] = kernel_work("K2", **shape["shape"])["bound_ms"]
    return res


def print_runs(card: str, runs: dict) -> None:
    print(f"card: {card}")
    for label, r in runs.items():
        for name, res in r["shapes"].items():
            sh = res["shape"]
            print(f"[{label}] {name} (U={sh['u']}, T={sh['t']}, L={sh['l']}, K={sh['k']}, H={sh['h']}): "
                  f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms")
            for kname in ("K2", "K6"):
                row = res[kname]
                err = max(row["err"].values())
                print(f"  {kname} {row['ms']:9.3f} ms  err {err:.2e}  sha256 {row['sha256']}")
                for n, ms in row["launches"].items():
                    print(f"      {ms:9.3f} ms  {n[:80]}")
                for kern, ph in row.get("phases", {}).items():
                    cells = "  ".join(f"{p} {v['ms']:.3f}" for p, v in ph.items())
                    print(f"    {kern}: {cells}")
            print("  forward " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in res.get("fwd_ms", {}).items()))
            print("  plain " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in res.get("fwd_plain_ms", {}).items()))
            for n, ms in res.get("K1", {}).get("launches", {}).items():
                print(f"      {ms:9.3f} ms  {n[:80]}")
            for kern, ph in res.get("K1", {}).get("phases", {}).items():
                print(f"    {kern}: " + "  ".join(f"{p} {v['ms']:.3f}" for p, v in ph.items()))
            print("  forward sha256 " + ", ".join(f"{n} {d}" for n, d in res.get("fwd_sha256", {}).items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", default=[], metavar="LABEL=DIR",
                    help="a checkout whose K2 and K6 to split, under a label (default: this one)")
    ap.add_argument("--shapes", default="smoke256,scaled256,scaled128")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k2_phases"))
    ap.add_argument("--seed", type=int, default=65535)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds for each run")
    ap.add_argument("--no-phases", action="store_true", help="launch times and digests only")
    ap.add_argument("--worker", metavar="INPUTS", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: k2_phases times CUDA kernels and has no CPU mode")
    if args.worker:
        res = worker(args.worker, args.reps, args.out, not args.no_phases)
        with open(args.out + ".json", "w") as f:
            json.dump(res, f)
        return 0
    from ..ops.cuda import build

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    checkouts = dict(r.split("=", 1) for r in args.run) or {"this": root}
    shapes = args.shapes.split(",")
    unknown = [s for s in shapes if s not in SHAPES]
    if unknown:
        ap.error(f"unknown shapes {unknown}; expected some of {list(SHAPES)}")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    inputs = os.path.join(build.BUILD_DIR, "k2_phases_inputs.pt")
    make_inputs(inputs, shapes, args.seed)
    try:
        card = torch.load(inputs)["card"]
        runs = {label: run_worker(label, d, inputs, args.out, args.reps, not args.no_phases,
                                  args.timeout) for label, d in checkouts.items()}
    finally:
        os.remove(inputs)
    print_runs(card, runs)
    from .ab_smoke import digest_table

    same = digest_table([dict(digests=r) for r in runs.values()], DIGEST_SHAPES)
    print(f"digests at {', '.join(DIGEST_SHAPES)} equal in every run: {same}")
    with open(os.path.join(args.out, "k2_phases.json"), "w") as f:
        json.dump(dict(card=card, checkouts=checkouts, runs=runs, digests_equal=same), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
