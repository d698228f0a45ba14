"""Time K8 (``hpd_tail_fwd``, the per-row tail's forward) from several
checkouts on the same inputs in one chip call, at several (T, K).

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.k8_ab \\
        --run parent=_archive/parent --run change=_archive/change \\
        --order parent,change,change,parent --out chiprun_out/k8_ab

The inputs are made once: h is the per-row route's own last hidden
activation (batch 0 of grid 4061 at the stack's init from ``--seed``, L = 4,
N = 229,616, H = 128, as ``chip_smoke.py`` step 6 takes it) with its head
(T = 256); for T = 2048 a head drawn from the same seed at the T = 256
head's scale. They are saved once under the package's build directory
(``_build/k8_ab_inputs.pt``, removed at the end). Each run is a process
of its own that imports the package of its checkout (its kernels built from
that checkout's sources), times K8 at every shape with CUDA events (``--reps``
calls after one warm-up) and hashes its outputs, so that runs whose K8s
compute the same bits show the same hashes. Prints a table of ms by run and
shape with the card's name and power limit, and writes it to
``<out>/k8_ab.json``. Two versions are compared only within one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch

SHAPES = ((256, 4), (256, 32), (256, 128), (2048, 4), (2048, 32), (2048, 128))


def make_inputs(path: str, seed: int) -> None:
    """The per-row route's h and head, and a T = 2048 head, to ``path``."""
    from ..utils import profiling
    from .k11_phases import per_row_head_input

    dev = torch.device("cuda", 0)
    h, (w, b) = per_row_head_input(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    w2 = torch.randn(w.shape[0], 2048, generator=g, device=dev) * w.std()
    b2 = torch.randn(2048, generator=g, device=dev) * b.std()
    torch.save(dict(h=h.cpu(), heads={256: (w.cpu(), b.cpu()), 2048: (w2.cpu(), b2.cpu())},
                    card=profiling.gpu_name_and_power_limit()), path)


def worker(inputs: str, reps: int) -> dict:
    """K8's ms and output hashes at every shape, from the package on sys.path."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_tail
    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    x = torch.load(inputs)
    h = x["h"].to(dev)
    out = dict(package=os.path.dirname(os.path.abspath(hpd_tail.__file__)), shapes={})
    for t, k in SHAPES:
        w, b = (a.to(dev) for a in x["heads"][t])
        run = lambda: hpd_tail.hpd_tail_fwd(h, w, b, k)
        ms = profiling.cuda_ms(run, reps)
        digest = hashlib.sha256()
        for a in run():
            digest.update(a.cpu().numpy().tobytes())
        out["shapes"][f"T={t},K={k}"] = dict(ms=ms, sha256=digest.hexdigest()[:16])
    return out


def run_one(i: int, label: str, checkout: str, args) -> dict:
    tag = f"{i}_{label}"
    result = os.path.join(args.out, f"{tag}.json")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                           args.inputs, "--reps", str(args.reps),
                           "--out", os.path.abspath(result)],
                          cwd=checkout, env=env, capture_output=True, text=True, timeout=args.timeout)
    with open(os.path.join(args.out, f"{tag}.log"), "w") as f:
        f.write(proc.stdout + "\n== stderr\n" + proc.stderr)
    print(f"run {tag}: exit {proc.returncode}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"run {tag} failed (exit {proc.returncode}); see {tag}.log")
    with open(result) as f:
        return dict(run=tag, **json.load(f))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", default=[], metavar="LABEL=DIR",
                    help="a checkout whose K8 to time, under a label")
    ap.add_argument("--order", help="labels in run order, comma separated")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k8_ab"))
    ap.add_argument("--seed", type=int, default=65535)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds for each run")
    ap.add_argument("--worker", metavar="INPUTS", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: k8_ab times a CUDA kernel and has no CPU mode")
    if args.worker:
        with open(args.out, "w") as f:
            json.dump(worker(args.worker, args.reps), f)
        return 0
    from ..ops.cuda import build

    checkouts = dict(r.split("=", 1) for r in args.run)
    order = (args.order or "").split(",")
    unknown = [label for label in order if label not in checkouts]
    if unknown:
        ap.error(f"--order names {unknown}, not given by --run")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    args.inputs = os.path.join(build.BUILD_DIR, "k8_ab_inputs.pt")
    make_inputs(args.inputs, args.seed)
    try:
        card = torch.load(args.inputs)["card"]
        runs = [run_one(i, label, checkouts[label], args) for i, label in enumerate(order)]
    finally:
        os.remove(args.inputs)
    print(f"card: {card}")
    print(f"{'K8 ms (L=4, N=229,616, H=128)':34s}" + "".join(f"{r['run']:>18s}" for r in runs))
    for shape in runs[0]["shapes"]:
        print(f"{shape:34s}" + "".join(f"{r['shapes'][shape]['ms']:18.3f}" for r in runs))
        print(f"{'  outputs sha256':34s}" + "".join(f"{r['shapes'][shape]['sha256']:>18s}"
                                                    for r in runs))
    with open(os.path.join(args.out, "k8_ab.json"), "w") as f:
        json.dump(dict(card=card, order=order, checkouts=checkouts, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
