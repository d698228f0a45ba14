"""Each kernel of the scaled geometry's training step timed alone at one
batch's shapes, beside its bound (the port's counterpart of the JAX
package's ``tools/time_kernels.py``).

    python -m collision_handling_in_instantngp_tpu_torch.tools.time_kernels \\
        [--reps N] [--precision highest|high|default] [--device cuda] \\
        [--u 264196 --hd 128 --t 16384 --l 16 --k 4 --u-compact 162304]

The shapes are the JAX tool's: U = (512 + 2)^2 = 264,196 unique vertices
of ``instantngp_scaled_model()``, H = 128, T = 2^14, L = 16, K = 4, and the
compacted U = 162,304. Inputs are made on the device from a seed, at the
JAX tool's scales (h normal x 0.3, w x 0.1, b x 0.1, counts uniform, tables
x 1e-4, the gradients normal). Rows: K4 (select), K5 (marginal), K6 (the
split backward, B1 + B2), K1 (fused forward), K2 (fused backward), K1 and K2
at the compacted U, the blend's forward (the gather of the top-K rows,
``models/encoding.blend_unique``) and backward (its table gradient on K12,
the ring), and K3a (the hidden stack 2 -> 32 -> 64 -> H). Each row is the
median of ``--reps`` CUDA-event times, with the bound, its unit and the
share of the bound from ``roofline.kernel_work``, and the launches of its
kernel's wrapper. Before it is timed, each kernel's output is held against
its plain version on the same inputs (normwise: max |kernel - plain| <=
tol * max |plain|; tol 1e-5 for forward outputs, the marginal's by
precision as ``chip_smoke.py`` holds it, 1e-4 for gradients); the top-K
indices must be the plain version's, or else a near-tie: the plain p at the
kernel's indices equal to the plain values within the same tolerance (the
kernel's and cuBLAS's fp32 sums differ in order, and random inputs at these
shapes can hold a few rows whose K-th and (K + 1)-th logits differ by less
than that). The tool raises where a kernel disagrees; each row keeps its
``max_abs_err`` and its ``near_ties``. ``--device cpu`` with small shapes
runs the plain versions on the host clock and reports no bound share (the
peaks are the card's).
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, List

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import encoding
from ..ops.cuda import hidden, hpd_stream, scatter
from ..ops.precision import pdot
from ..utils.profiling import device_info
from .roofline import kernel_work

U, H, T, L, K, U_COMPACT = 264196, 128, 16384, 16, 4, 162304
JAX = "collision_handling_in_instantngp_tpu/"
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
MARG_TOL = {"highest": FWD_TOL, "high": 1e-3, "default": 1e-2}


def agree(what: str, got, want, tol: float) -> float:
    """The largest max abs error of ``got`` against ``want`` (tensors in
    pairs); raises unless each is finite and within tol * max |want|."""
    worst = 0.0
    for i, (a, r) in enumerate(zip(got, want)):
        err = (a.double() - r.double()).abs().max().item()
        scale = r.double().abs().max().item()
        if not torch.isfinite(a).all() or err > tol * scale:
            raise AssertionError(f"{what}: output {i} disagrees with the plain version "
                                 f"({err} > {tol} * {scale})")
        worst = max(worst, err)
    return worst


def near_ties(what: str, h, w, b, idx, plain, precision: str) -> int:
    """Rows whose top-K indices ``idx`` differ from the plain version's
    (``plain``: vals, idx, m, s); raises unless the plain p at ``idx`` equals
    the plain vals there within FWD_TOL of their largest."""
    vals_p, idx_p, m_p, s_p = plain
    rows = (idx != idx_p).any(dim=1).nonzero().flatten()
    if rows.numel():
        logits = pdot(h[rows], w, precision) + b
        p_at = torch.exp(logits.gather(1, idx[rows].long()) - m_p[rows]) / s_p[rows]
        agree(f"{what} (top-K rows that differ)", [p_at], [vals_p[rows]], FWD_TOL)
    return int(rows.numel())


def median_ms(fn: Callable[[], object], reps: int, dev: torch.device) -> float:
    """Median time of one call over ``reps`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def make_inputs(u, hd, t, l, k, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    return dict(h=torch.randn(u, hd, **f32) * 0.3, w=torch.randn(hd, t, **f32) * 0.1,
                b=torch.randn(t, **f32) * 0.1, counts=torch.rand(l, u, **f32),
                tables=torch.randn(l, t, 2, **f32) * 1e-4, g_marg=torch.randn(l, t, **f32),
                g_vals=torch.randn(u, k, **f32), g_feat=torch.randn(l, u, 2, **f32),
                coords=torch.rand(u, 2, **f32) * 513)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Each kernel of the scaled step timed alone.")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--precision", default="highest", choices=["highest", "high", "default"])
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--u", type=int, default=U)
    ap.add_argument("--hd", type=int, default=H)
    ap.add_argument("--t", type=int, default=T)
    ap.add_argument("--l", type=int, default=L)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--u-compact", type=int, default=U_COMPACT)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    u, hd, t, l, k, u_c, prec = args.u, args.hd, args.t, args.l, args.k, args.u_compact, args.precision
    x = make_inputs(u, hd, t, l, k, dev)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    rows: List[dict] = []

    def row(name, replaces, wrapper, fn, work, check=None):
        """Times ``fn``; ``check()`` first holds its output against the plain
        version, returning (max abs error, near-tie rows)."""
        err, ties = check() if check is not None else (None, None)
        before = getattr(wrapper, "launches", 0)
        ms = median_ms(fn, args.reps, dev)
        launched = getattr(wrapper, "launches", 0) - before
        if dev.type == "cuda" and wrapper is not None and launched == 0:
            raise AssertionError(f"{name}: its kernel did not launch")
        r = dict(name=name, replaces=replaces, ms=ms, bound_ms=work["bound_ms"],
                 bound_by=work["bound_by"], unit=work["unit"], launches=launched,
                 max_abs_err=err, near_ties=ties)
        if dev.type == "cuda":
            r["share_of_bound"] = work["bound_ms"] / ms
        print(f"{name:28s} {ms:10.3f} ms  bound {work['bound_ms']:9.3f} ms ({work['unit']})"
              + (f"  {r['share_of_bound']:7.2%} of it" if "share_of_bound" in r else "")
              + ("" if err is None else f"  max_abs_err {err:.2e}, near-ties {ties}"), flush=True)
        rows.append(r)

    shapes = dict(h=hd, t=t, l=l, k=k)
    sel = hpd_stream.hpd_stream_select(h, w, b, k, prec)
    vals, idx, m, s = sel
    sel_p = hpd_stream.hpd_stream_select_plain(h, w, b, k, prec)

    def check_select():
        ties = near_ties("K4", h, w, b, idx, sel_p, prec)
        return agree("K4", (vals, m, s), (sel_p[0], *sel_p[2:]), FWD_TOL), ties

    row("select kernel (K4)", JAX + "ops/pallas/hpd_stream.py:193", hpd_stream.hpd_stream_select,
        lambda: hpd_stream.hpd_stream_select(h, w, b, k, prec), kernel_work("K4", u=u, **shapes),
        check_select)
    del sel_p
    row("marginal kernel (K5)", JAX + "ops/pallas/hpd_stream.py:282", hpd_stream.hpd_stream_marginal,
        lambda: hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s, prec),
        kernel_work("K5", u=u, counts=counts, **shapes),
        lambda: (agree("K5", [hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s, prec)],
                       [hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, prec)],
                       MARG_TOL[prec]), None))

    def check_bwd(what, fn, bargs):
        want = hpd_stream.hpd_stream_fused_bwd_plain(*bargs, prec, False)
        return agree(what, fn(*bargs, prec), want, GRAD_TOL), None

    bargs = (h, w, b, counts, idx, vals, m, s, x["g_marg"], x["g_vals"], k)
    row("bwd kernels B1+B2 (K6)", JAX + "ops/pallas/hpd_stream.py:921", hpd_stream.hpd_tail_unique_bwd,
        lambda: hpd_stream.hpd_tail_unique_bwd(*bargs, prec), kernel_work("K6", u=u, **shapes),
        lambda: check_bwd("K6", hpd_stream.hpd_tail_unique_bwd, bargs))

    def check_fwd(what, hh, cc):
        got = hpd_stream.hpd_stream_fused_fwd(hh, w, b, cc, k, prec)
        want = hpd_stream.hpd_stream_fused_fwd_plain(hh, w, b, cc, k, prec)
        ties = near_ties(what, hh, w, b, got[2], want[1:], prec)
        err = max(agree(what, [got[0]], [want[0]], MARG_TOL[prec]),
                  agree(what, (got[1], *got[3:]), (want[1], *want[3:]), FWD_TOL))
        return err, ties

    row("fused fwd kernel (K1)", JAX + "ops/pallas/hpd_stream.py:570", hpd_stream.hpd_stream_fused_fwd,
        lambda: hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, prec),
        kernel_work("K1", u=u, counts=counts, **shapes), lambda: check_fwd("K1", h, counts))
    row("fused bwd kernel (K2)", JAX + "ops/pallas/hpd_stream.py:722", hpd_stream.hpd_stream_fused_bwd,
        lambda: hpd_stream.hpd_stream_fused_bwd(*bargs, prec), kernel_work("K2", u=u, **shapes),
        lambda: check_bwd("K2", hpd_stream.hpd_stream_fused_bwd, bargs))

    hc, cc = h[:u_c].contiguous(), counts[:, :u_c].contiguous()
    row("fused fwd @ compacted U (K1)", JAX + "ops/pallas/hpd_stream.py:570",
        hpd_stream.hpd_stream_fused_fwd, lambda: hpd_stream.hpd_stream_fused_fwd(hc, w, b, cc, k, prec),
        kernel_work("K1", u=u_c, counts=cc, **shapes), lambda: check_fwd("K1 @ compacted U", hc, cc))
    cargs = (hc, w, b, cc, idx[:u_c].contiguous(), vals[:u_c].contiguous(), m[:u_c].contiguous(),
             s[:u_c].contiguous(), x["g_marg"], x["g_vals"][:u_c].contiguous(), k)
    row("fused bwd @ compacted U (K2)", JAX + "ops/pallas/hpd_stream.py:722",
        hpd_stream.hpd_stream_fused_bwd, lambda: hpd_stream.hpd_stream_fused_bwd(*cargs, prec),
        kernel_work("K2", u=u_c, **shapes),
        lambda: check_bwd("K2 @ compacted U", hpd_stream.hpd_stream_fused_bwd, cargs))

    cfg = ModelConfig()
    tables = x["tables"].clone().requires_grad_(True)
    wv = vals.clone().requires_grad_(True)
    row("blend fwd (gather)", JAX + "models/encoding.py:_blend_core", None,
        lambda: encoding.blend_unique(x["tables"], idx, vals, cfg),
        kernel_work("blend", u=u, k=k, l=l, f=2, t=t))
    with torch.enable_grad():
        out = encoding.blend_unique(tables, idx, wv, cfg)

    def check_blend_bwd():
        # the table gradient in plain code: each (vertex, k) row's weighted
        # output gradient, added into its slot in row order
        d_tables = torch.autograd.grad(out, tables, x["g_feat"], retain_graph=True)[0]
        g_out = x["g_feat"].permute(1, 0, 2).reshape(u, l * 2)
        d_rows = (g_out[:, None, :] * encoding.blend_weights(vals, cfg)[:, :, None]).reshape(-1, l * 2)
        want = scatter.scatter_add_serial_plain(d_rows, idx.reshape(-1).long(), t)
        return agree("blend bwd (K12)", [d_tables], [want.reshape(t, l, 2).permute(1, 0, 2)],
                     FWD_TOL), None

    row("blend bwd (K12 ring)", JAX + "ops/pallas/scatter_probe.py:42", scatter.scatter_add_serial,
        lambda: torch.autograd.grad(out, (tables, wv), x["g_feat"], retain_graph=True),
        kernel_work("K12", n=u * k, c=l * 2, t=t), check_blend_bwd)
    del out

    widths = (2, 32, 64, hd)
    gen = torch.Generator(device=dev).manual_seed(1)
    layers = [(torch.randn(a, c, device=dev, generator=gen), torch.zeros(c, device=dev))
              for a, c in zip(widths[:-1], widths[1:])]
    row("hidden stack fwd (K3a)", JAX + "ops/pallas/hidden.py:126", hidden.hidden_stack_fwd,
        lambda: hidden.hidden_stack_fwd(x["coords"], layers, prec), kernel_work("K3a", u=u, widths=widths),
        lambda: (agree("K3a", [hidden.hidden_stack_fwd(x["coords"], layers, prec)],
                       [hidden.hidden_stack_fwd_plain(x["coords"], layers, prec)], FWD_TOL), None))

    return dict(device=device_info(dev), precision=prec, reps=args.reps,
                shapes=dict(u=u, h=hd, t=t, l=l, k=k, u_compact=u_c), rows=rows)


if __name__ == "__main__":
    main()
