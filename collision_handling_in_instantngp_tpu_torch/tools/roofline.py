"""The work of one training epoch and of each kernel against the card's
bound (the port's counterpart of the JAX package's ``tools/roofline.py``).

    python -m collision_handling_in_instantngp_tpu_torch.tools.roofline \\
        [--mode gngf|scaled] [--precision highest|high|default] \\
        [--calibration nominal|measured] [--measure --span N --epochs M] [--device cuda]

:func:`epoch_ledger` counts one epoch's work on the port's execution plan:
the HPD stack and head on the U unique vertices, the count-weighted
marginal, the decoder on every pixel row (products counted forward and
backward, dW and dX), the top-K compares, the blend and bilinear
interpolation, and the table gradient. Every term is the JAX tool's count
but the table gradient: JAX counts it as a one-hot product (L U T F
multiply-adds), which neither package runs at the scaled geometry (JAX takes
``segment_sum``, the port K12). Here it is counted as K12 runs it: the U K L F
gathered rows read once and added (vector flops), the (L, T, F) table
written once. A share read from work the port never runs could pass 100 %.
``u_compact`` is the row count of the port's own compaction
(``train_step.build_epoch_batches``), not a second copy of its rule. Each
term's products are split by the unit that runs them
(``kernel_matmul_flops``: the hand-written kernels' share, K3 and the
streamed tail K1/K2 on the dedup route; the rest, the dense HPD, the
plain hidden stack, the chunked tail and the decoder, runs in cuBLAS).

:func:`kernel_work` gives a kernel's operations by unit, its bytes (each
input read once, each output written once) and the bound: the larger of
the operations at the card's peak for their unit and the bytes at its
memory rate. The same formulas give the ``bound_ms`` of every entry that
``chip_smoke.py`` prints.

Peaks are NVIDIA's data sheet for the H100 SXM, keyed by
``torch.cuda.get_device_name()``: 67 TFLOP/s fp32 outside the tensor cores,
495 TF32 and 989 bf16 on them, 3.35 TB/s HBM3. The products' rate follows
the precision and the unit: at 'highest' the kernels' products run as
3xTF32 (three tf32 products a term), so 495 / 3, and cuBLAS's as fp32 SGEMM
(TF32 off) at the fp32 rate, 67; at 'high' both run bf16x3, 989 / 3; at
'default' one bf16 product, 989. Vector flops take the fp32 rate.
``--calibration measured`` reads ``tools/mxu_probe.py``'s calibration for
the card: its rate for the precision (at 'highest' K13's fp32 SGEMM, about
46 TFLOP/s) replaces cuBLAS's products' rate and its stream rate the
memory's; the kernels' products keep the nominal 3xTF32 rate, which the
calibration does not measure (against its SGEMM rate the tail, at 115-138
TFLOP/s of tf32 products, would pass 100 %). It is not the default.

``--measure`` times ``--epochs`` epochs (after two warm-up calls) through
the port's epoch at ``--span`` (``run_epoch`` at span 1, ``run_span`` past
it, as ``fit`` runs them), synchronised on the card, and adds
``measured_epoch_ms``, ``measured_pixels_per_s`` and
``fraction_of_roofline`` (the bound's epoch time over the measured one).
One JSON line, with the card's name and power limit. ``--device cpu`` runs
the plain versions and reports no bound (the peaks are the card's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CALIBRATION_PATH = os.path.join(REPO, "chiprun_out", "roofline_calibration.json")

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 on the tensor cores, HBM3 bandwidth. 'highest' runs
# fp32 FMA on the CUDA cores; 'default' (bf16 products, exact in fp32,
# fp32 sums) is the bf16 tensor cores' function and takes their peak.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
# dense TF32 on the tensor cores: the dedup route's tail (K1, K2, K4-K6),
# K7, the per-row heads (K9-K11) and K11's hidden dW and dh run their
# products there as 3xTF32, three tf32 products per fp32 term
PEAK_TF32_TENSOR_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(fp32=PEAK_FP32_FLOPS, tf32=PEAK_TF32_TENSOR_FLOPS,
                                  bf16=PEAK_BF16_TENSOR_FLOPS, hbm=PEAK_BYTES_PER_S),
}
# the products' (unit, products a term) by matmul precision, for the
# hand-written kernels and for cuBLAS: at 'highest' 3xTF32 in the kernels,
# fp32 SGEMM in cuBLAS; bf16x3 and bf16 in both
MATMUL_RATE = {"highest": {"kernels": ("tf32", 3.0), "library": ("fp32", 1.0)},
               "high": {"kernels": ("bf16", 3.0), "library": ("bf16", 3.0)},
               "default": {"kernels": ("bf16", 1.0), "library": ("bf16", 1.0)}}


def _bound(parts, nbytes: float):
    """(bound_ms, bound_by) of work whose parts [(flops, peak), ...] run one
    after the other (their times added), against its bytes at the memory
    rate."""
    t_ops, t_bytes = sum(f / p for f, p in parts), nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _counts_exact(counts) -> bool:
    """Every count an integer up to 2^11 (exact in tf32: the marginal's
    kernels skip the product with the counts' zero lo part)."""
    return counts is not None and bool(((counts == counts.round()) & (counts.abs() <= 2048)).all())


_UNIT_PEAK = {"tf32": PEAK_TF32_TENSOR_FLOPS, "bf16": PEAK_BF16_TENSOR_FLOPS, "fp32": PEAK_FP32_FLOPS}


def _work(ops: Dict[str, float], nbytes: float, fp32_flops: Optional[float] = None) -> dict:
    """The count and its bound: the operations of each unit at its peak,
    added, against the bytes; ``fp32_flops`` gives ``bound_fp32_ms``, the
    same work as fp32 on the CUDA cores."""
    b_ms, b_by = _bound([(f, _UNIT_PEAK[n]) for n, f in ops.items()], nbytes)
    out = dict(ops=ops, bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
               unit=(max(ops, key=lambda n: ops[n] / _UNIT_PEAK[n]) if b_by == "operations"
                     else "hbm"))
    if fp32_flops is not None:
        out["bound_fp32_ms"] = _bound([(fp32_flops, PEAK_FP32_FLOPS)], nbytes)[0]
    return out


def kernel_work(kernel: str, **s) -> dict:
    """Operations by unit ({'tf32' | 'bf16' | 'fp32': flops}, a 3xTF32 term
    counted as three tf32 products), bytes (each input read once, each
    output written once), ``bound_ms``, ``bound_by`` ('operations' or
    'bytes'), the unit that bounds it ('hbm' for bytes) and, for the
    tensor-core kernels, ``bound_fp32_ms`` (the same work as fp32 on the
    CUDA cores, their route before). Shapes by kernel:

    - K1 (fused forward), K5 (marginal): u, h, t, l, k[, counts]: 2UHT +
      2LUT as 3xTF32 (the marginal's products as two tf32 products where
      ``counts`` are integers up to 2^11, else three);
    - K2, K6 (the tail backward, one function): u, h, t, l, k: the logits,
      dh = dl w^T and dW = h^T dl (2UHT each), G = p g_marg^T and g_p =
      counts^T g_marg (2LUT each), as 3xTF32;
    - K4 (select), K7 (probe): u, h, t[, k]: 2UHT as 3xTF32;
    - K3a / K3b (hidden stack, forward / backward): u, widths, as 3xTF32;
    - K8 / K9 (per-row tail, forward / backward): rows, h, t, l, k; K8's
      head as fp32 on the CUDA cores, K9's three products as 3xTF32;
      K10 / K11 (per-row network): rows, widths, l, k (widths from the
      input to T): the hidden stack (K10's, and K11's replay of it) as fp32
      on the CUDA cores, every other product (K10's head; K11's head and
      its hidden layers' dW and dh) as 3xTF32 (``hpd_full.cu``);
    - K12 (serial scatter): n rows of c columns added into t slots[,
      idx_bytes a row id, ids read (default n: under a slot range every id
      is read, only the n rows in range)]; ``blend`` (the top-K gather of
      the tables and its weighted sum, no kernel): u, k, l, f, t;
    - K13 (row-sum dot): u, h, t, regime;
    - K14 (write), K15 (scale copy): nbytes (of the array)."""
    if kernel in ("K1", "K5"):
        u, h, t, l, k = s["u"], s["h"], s["t"], s["l"], s["k"]
        flops, cflops = 2.0 * u * h * t, 2.0 * l * u * t
        if kernel == "K1":
            nbytes = 4.0 * (u * h + h * t + t + l * u + l * t + 2 * u * k + 2 * u)
        else:
            nbytes = 4.0 * (u * h + l * u + 2 * u + l * t) + 4.0 * (h * t + t)
        n_count = 2 if _counts_exact(s.get("counts")) else 3
        return _work({"tf32": 3 * flops + n_count * cflops}, nbytes, flops + cflops)
    if kernel in ("K2", "K6"):
        u, h, t, l, k = s["u"], s["h"], s["t"], s["l"], s["k"]
        flops = 6.0 * u * h * t + 4.0 * l * u * t
        nbytes = 4.0 * (2 * u * h + 2 * h * t + 2 * t + l * u + 3 * u * k + 2 * u + l * t)
        return _work({"tf32": 3 * flops}, nbytes, flops)
    if kernel in ("K4", "K7"):
        u, h, t = s["u"], s["h"], s["t"]
        flops = 2.0 * u * h * t
        if kernel == "K4":
            nbytes = 4.0 * (u * h + 2 * u * s["k"] + 2 * u) + 4.0 * (h * t + t)
        else:
            nbytes = 4.0 * (u * h + h * t + t + 2 * u)
        return _work({"tf32": 3 * flops}, nbytes, flops)
    if kernel in ("K3a", "K3b"):
        u, widths = s["u"], list(s["widths"])
        mac_row = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        n_params = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
        if kernel == "K3a":
            flops = 2.0 * u * mac_row
            nbytes = 4.0 * (u * widths[0] + u * widths[-1] + n_params)
        else:
            da_mac = sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
            flops = 2.0 * u * (2 * mac_row + da_mac)
            nbytes = 4.0 * (u * widths[0] + u * widths[-1] + 2 * n_params)
        return _work({"tf32": 3 * flops}, nbytes, flops)
    if kernel in ("K8", "K9"):
        rows, h, t, l, k = s["rows"], s["h"], s["t"], s["l"], s["k"]
        head_flops = 2.0 * rows * h * t
        if kernel == "K8":
            nbytes = 4.0 * rows * h + 4.0 * (h * t + t) + 4.0 * (l * t + 2 * rows * k)
            return _work({"fp32": head_flops}, nbytes)
        nbytes = 4.0 * (2 * rows * h + 2 * h * t + 2 * t + l * t + 2 * rows * k)
        return _work({"tf32": 9 * head_flops}, nbytes, 3 * head_flops)
    if kernel in ("K10", "K11"):
        rows, widths, l, k = s["rows"], list(s["widths"]), s["l"], s["k"]
        d, h, t = widths[0], widths[-2], widths[-1]
        macs = sum(a * c for a, c in zip(widths[:-1], widths[1:]))
        n_params = sum(a * c + c for a, c in zip(widths[:-1], widths[1:]))
        head_flops = 2.0 * rows * h * t
        if kernel == "K10":
            nbytes = 4.0 * (rows * d + n_params) + 4.0 * (l * t + 2 * rows * k)
            rest = 2.0 * rows * macs - head_flops
            return _work({"tf32": 3 * head_flops, "fp32": rest}, nbytes, 2.0 * rows * macs)
        dx_macs = sum(a * c for a, c in zip(widths[1:-1], widths[2:]))
        flops = 2.0 * rows * (2 * macs + dx_macs)
        replay = 2.0 * rows * macs - head_flops
        nbytes = 4.0 * (rows * d + 2 * n_params + l * t + 2 * rows * k)
        return _work({"tf32": 3 * (flops - replay), "fp32": replay}, nbytes, flops)
    if kernel == "blend":   # the top-K gather and weighted sum (no kernel)
        u, k, l, f, t = s["u"], s["k"], s["l"], s["f"], s["t"]
        return _work({"fp32": 2.0 * u * k * l * f}, 4.0 * (l * t * f + 2 * u * k + l * u * f))
    if kernel == "K12":
        n, c, t = s["n"], s["c"], s["t"]
        nbytes = 4.0 * (n * c + t * c) + s.get("idx_bytes", 8) * s.get("ids", n)
        return _work({"fp32": 1.0 * n * c}, nbytes)
    if kernel == "K13":
        u, h, t, regime = s["u"], s["h"], s["t"], s["regime"]
        flops, nbytes = 2.0 * u * h * t, 4.0 * (u * h + h * t + u)
        if regime == "highest":
            return _work({"fp32": flops}, nbytes)
        return _work({"bf16": (3 if regime == "bf16x3" else 1) * flops}, nbytes)
    if kernel in ("K14", "K15"):
        return _work({}, (1.0 if kernel == "K14" else 2.0) * s["nbytes"])
    raise ValueError(f"kernel_work: unknown kernel {kernel!r}")


def epoch_ledger(exp, num_pixels: int, u_compact: Optional[int] = None) -> dict:
    """One epoch's work: ``matmul_flops``, ``vpu_flops`` (vector work),
    ``hbm_bytes``, ``unique_vertices``, ``rows_per_batch``, ``num_batches``
    (the JAX tool's keys), ``kernel_matmul_flops`` (the products the
    hand-written kernels run) and ``terms``, each term's share of them
    apart."""
    from ..models import gngf
    from ..models.hpd import unique_tail_backend, use_stream
    from ..ops.cuda import hidden

    m = exp.model
    statics = gngf.make_statics(m)
    num_batches = int(np.ceil(1.0 / exp.train.batch_fraction))
    p = -(-num_pixels // num_batches)
    l, v, k, t, f = m.num_levels, m.num_corners, m.topk_k, m.hash_table_size, m.feature_dim
    u = statics.unique_coords.shape[0] if statics.unique_coords is not None else p * v * l
    if u_compact is not None:
        u = min(u, u_compact)
    widths = (m.input_dim, *m.hpd_hidden, t)
    n_hpd = sum(a * b for a, b in zip(widths, widths[1:]))
    # which products the kernels run (models/hpd.py: apply_hpd_unique): the
    # streamed route's hidden stack on K3 where it fits, its head and
    # marginal on K1/K2 unless the chunked PyTorch tail takes them
    stream = use_stream(m, u)
    tail_k = stream and unique_tail_backend(m, t, k, widths[-2]) != "jax"
    stack_k = stream and len(widths) > 2 and hidden.supports(widths[:-1])
    n_hpd_k = (widths[-2] * t if tail_k else 0) + (n_hpd - widths[-2] * t if stack_k else 0)
    dec_widths = (l * f, *m.mlp_hidden, m.out_channels)
    dec_macs = p * sum(a * b for a, b in zip(dec_widths, dec_widths[1:]))
    blend_macs = u * l * k * f + p * l * v * f
    grad_rows = u * k * l * f
    terms = {
        # fwd + bwd (dW, dX) of the products
        "hpd": {"matmul_flops": 6 * u * n_hpd, "kernel_matmul_flops": 6 * u * n_hpd_k},
        "marginal": {"matmul_flops": 2 * l * u * t,
                     "kernel_matmul_flops": 2 * l * u * t if tail_k else 0},
        "decoder": {"matmul_flops": 6 * dec_macs, "kernel_matmul_flops": 0},
        "topk": {"vpu_flops": u * t * k},
        "blend_interp": {"vpu_flops": 4 * blend_macs},
        "table_grad": {"vpu_flops": grad_rows, "hbm_bytes": 4 * (grad_rows + l * t * f)},
        "io": {"hbm_bytes": 4 * (
            p * (m.input_dim + m.out_channels)     # batch coords + targets
            + u * (l * k * f + 2 * k)              # gathers + top-k outputs
            + p * (l * f)                          # per-pixel feature gather
            + p * m.out_channels * 2               # prediction + assembly
            + 3 * n_hpd                            # HPD params, grads, Adam state
            + 3 * l * t * f)},                     # tables, grads, Adam state
    }
    per_batch = {key: sum(term.get(key, 0) for term in terms.values())
                 for key in ("matmul_flops", "kernel_matmul_flops", "vpu_flops", "hbm_bytes")}
    return {
        "matmul_flops": num_batches * per_batch["matmul_flops"],
        "kernel_matmul_flops": num_batches * per_batch["kernel_matmul_flops"],
        "vpu_flops": num_batches * per_batch["vpu_flops"],
        "hbm_bytes": num_batches * per_batch["hbm_bytes"] + 4 * num_pixels * m.out_channels * 2,
        "unique_vertices": u,
        "rows_per_batch": p,
        "num_batches": num_batches,
        "terms": {name: {key: num_batches * val for key, val in term.items()}
                  for name, term in terms.items()},
    }


def compacted_rows(exp, data, compact_dedup: bool = True) -> Optional[int]:
    """U_c of the epoch's compacted dedup geometry, as
    ``train_step.build_epoch_batches`` builds it (None where it does not
    compact, or on the per-row route)."""
    from ..data import make_shuffle_permutations
    from ..models import gngf
    from ..train.train_step import build_epoch_batches

    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, "cpu", compact_dedup=compact_dedup)
    geom = batches.dedup[0]
    if geom is None or geom.active is None:
        return None
    return int(geom.active.shape[0])


def load_measured(name: str, path: str = CALIBRATION_PATH):
    """``tools/mxu_probe.py``'s rates for the card ``name``, or None."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh).get(name)


def sol(ledger: dict, precision: str, peaks: dict, measured: Optional[dict] = None) -> dict:
    """The bound's epoch time: the kernels' products at their rate for the
    precision and cuBLAS's at theirs (MATMUL_RATE), plus the vector flops
    at the fp32 rate, or the bytes at the memory rate, whichever is longer
    (the JAX tool's model). ``measured``: the calibration's rate for the
    precision in place of cuBLAS's products' rate, its stream rate in
    place of the memory's."""
    rates = {route: peaks[unit] / n for route, (unit, n) in MATMUL_RATE[precision].items()}
    bw = peaks["hbm"]
    if measured:
        rates["library"] = measured.get(precision, measured["highest"])
        bw = measured["hbm_stream"]
    kernel_flops = ledger["kernel_matmul_flops"]
    t_mm = (kernel_flops / rates["kernels"]
            + (ledger["matmul_flops"] - kernel_flops) / rates["library"])
    t_vec = ledger["vpu_flops"] / peaks["fp32"]
    t_bw = ledger["hbm_bytes"] / bw
    sol_s = max(t_mm + t_vec, t_bw)
    return dict(kernel_matmul_rate=rates["kernels"], library_matmul_rate=rates["library"],
                sol_epoch_ms=1e3 * sol_s,
                sol_bound="compute" if t_mm + t_vec > t_bw else "bandwidth",
                sol_matmul_ms=1e3 * t_mm, sol_vector_ms=1e3 * t_vec, sol_bytes_ms=1e3 * t_bw)


def experiment(mode: str, precision: Optional[str] = None):
    """Grid 4061 at the default geometry ('gngf') or at
    ``instantngp_scaled_model()`` ('scaled'), both at 1/3 batches, as
    ``tools/profile_epoch.py`` traces them."""
    from .profile_epoch import experiment as traced_experiment

    exp = traced_experiment(mode)
    if precision:
        exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, matmul_precision=precision))
    return exp


def measure_epochs(exp, data, dev, span: int, epochs: int, compact_dedup: bool = True) -> float:
    """Seconds an epoch over ``max(1, epochs // span)`` calls of ``span``
    epochs after two warm-up calls, the port's epoch as ``fit`` runs it,
    each call ending in its scalars' transfer to the host."""
    from ..data import make_shuffle_permutations
    from ..models import gngf
    from ..train.optimizer import make_optimizer
    from ..train.train_step import (
        BestTracker, build_epoch_batches, initial_collision_state, run_epoch, run_span,
    )

    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, dev, compact_dedup)
    params = gngf.init_params(exp.model, exp.train.seed, dev)
    optimizer = make_optimizer(exp.optimizer, params)
    prev, min_poss = initial_collision_state(exp, statics, dev)
    tracker = BestTracker(params) if span > 1 else None

    def call(prev):
        if span <= 1:
            m = run_epoch(params, optimizer, batches, exp, statics, prev, min_poss)
            return m.collisions_device
        tracker.reset()
        sm, last = run_span(params, optimizer, batches, exp, statics, prev, min_poss, span, tracker)
        sm.to_host()
        return last.collisions

    for _ in range(2):
        prev = call(prev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    calls = max(1, epochs // span)
    t0 = time.perf_counter()
    for _ in range(calls):
        prev = call(prev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / (calls * max(1, span))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The epoch's work against the card's bound.")
    ap.add_argument("--mode", default="gngf", choices=["gngf", "scaled"])
    ap.add_argument("--precision", default=None, choices=["default", "high", "highest"])
    ap.add_argument("--calibration", default="nominal", choices=["nominal", "measured"])
    ap.add_argument("--measure", action="store_true", help="also time real epochs")
    ap.add_argument("--span", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--no-compact", dest="compact_dedup", action="store_false",
                    help="count and time the whole shared grid, as fit(compact_dedup=False)")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions, no bound")
    return ap


def main(argv=None) -> dict:
    from ..data import load_image_dataset
    from ..device import resolve_device
    from ..utils.profiling import gpu_name_and_power_limit, power_limit_w

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    exp = experiment(args.mode, args.precision)
    data = load_image_dataset(os.path.join(REPO, "images", "strawberry.npy"))
    ledger = epoch_ledger(exp, data.num_pixels, compacted_rows(exp, data, args.compact_dedup))
    precision = exp.model.matmul_precision
    out = {"mode": args.mode, "precision": precision, **ledger}
    peaks = None
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        smi = gpu_name_and_power_limit()
        out.update(device_kind=name, gpu_name=smi.split(",")[0].strip(),
                   power_limit_w=power_limit_w(smi))
        peaks = PEAKS.get(name)
    else:
        out.update(device_kind="cpu", gpu_name=None, power_limit_w=None)
    if peaks:
        measured = load_measured(out["device_kind"]) if args.calibration == "measured" else None
        if args.calibration == "measured" and measured is None:
            raise FileNotFoundError(f"no calibration for {out['device_kind']} in {CALIBRATION_PATH} "
                                    "(run tools/mxu_probe.py first)")
        out.update(sol(ledger, precision, peaks, measured),
                   calibration="measured" if measured else "nominal")
        out["sol_pixels_per_s"] = data.num_pixels / (out["sol_epoch_ms"] / 1e3)
    if args.measure:
        dt = measure_epochs(exp, data, dev, args.span, args.epochs, args.compact_dedup)
        out.update(span=args.span, measured_epoch_ms=1e3 * dt,
                   measured_pixels_per_s=data.num_pixels / dt)
        if peaks:
            out["fraction_of_roofline"] = out["sol_epoch_ms"] / 1e3 / dt
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
