"""The stage split of ``tools/attribution.py`` beside a floor for each stage's
products (the port's counterpart of the JAX package's
``tools/floor_table.py``): a table whose measured rows sum to the step, and
the room each stage leaves above its floor.

Floor model (per batch; U unique vertex rows, P pixel rows, H =
hpd_hidden[-1], T slots, L levels, F features), the JAX tool's:

  hidden   fwd 2 U sum(w_i w_i+1) over the input..hpd_hidden chain;
           fwd+bwd 4x fwd (recompute, dW, dX)
  tail     fwd 2 U T (H + L) (logits and the count marginal);
           bwd 2 U T (3H + 2L)
  decoder  fwd 2 P sum(mlp chain); fwd+bwd 3x fwd
  blend, geometry, loss, optimizer: gathers and vector work, no product
           floor: ``gather_probe`` and ``sweep_probe`` measure them.

Rates are the card's, by the unit that runs each stage's products: at
'highest' the hand-written kernels (K3 for the hidden stack, K1 / K2 for the
tail on the streamed route) take them as 3xTF32 and cuBLAS (the decoder,
and the dense HPD at ``--mode gngf``) as fp32 SGEMM, as ``roofline.sol``
prices them (``roofline.MATMUL_RATE``, nominal ``roofline.PEAKS``).
``--calibration measured`` puts ``tools/mxu_probe.py``'s measured rate for
the precision (``roofline.load_measured``) in place of cuBLAS's. An
artifact whose ``device_kind`` has no peaks (a CPU run, or a TPU's) is
skipped with a message, as one without ``dims``.

The measured-floor lines read the port's own ``sweep_probe`` and
``gather_probe`` JSON (default ``chiprun_out/``), never
``evidence/roofline_calibration.json``, which holds a TPU's rates.

    python -m collision_handling_in_instantngp_tpu_torch.tools.floor_table \\
        ATTRIBUTION.json [...] [--calibration nominal|measured] \\
        [--sweep-probe PATH] [--gather-probe PATH]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Union

from ..models.hpd import DEDUP_DENSE_MAX_ELEMENTS
from ..ops.cuda import hidden
from ..ops.cuda.hpd_stream import MAX_K
from . import roofline

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP_PROBE = os.path.join(REPO, "chiprun_out", "sweep_probe.json")
GATHER_PROBE = os.path.join(REPO, "chiprun_out", "gather_probe.json")
PRODUCT_STAGES = ("hidden", "tail", "decoder")


def chain_macs(widths):
    return sum(a * b for a, b in zip(widths, widths[1:]))


def floors_ms(att: dict, rate: Union[float, Dict[str, float]]) -> dict:
    """{stage: (fwd ms, fwd+bwd ms)} at ``rate`` flop/s, one for every
    stage or {stage: rate}."""
    d = att["dims"]
    u, p = att["unique_rows"], att["batch_rows"]
    h, t, l, f = d["H"], d["T"], d["L"], d["F"]
    hidden_macs = u * chain_macs([d["input_dim"]] + d["hpd_hidden"][:-1] + [h])
    dec_macs = p * chain_macs([l * f] + d["mlp_hidden"] + [3])
    rates = rate if isinstance(rate, dict) else dict.fromkeys(PRODUCT_STAGES, rate)
    ms = lambda stage, flops: 1e3 * flops / rates[stage]
    return {
        "hidden": (ms("hidden", 2 * hidden_macs), ms("hidden", 2 * hidden_macs * 4)),
        "tail": (ms("tail", 2 * u * t * (h + l)),
                 ms("tail", 2 * u * t * (h + l)) + ms("tail", 2 * u * t * (3 * h + 2 * l))),
        "decoder": (ms("decoder", 2 * dec_macs), ms("decoder", 2 * dec_macs * 3)),
    }


def stage_routes(att: dict) -> Dict[str, str]:
    """Which unit runs each stage's products: "kernels" or "library"
    (cuBLAS), by the port's gates on the artifact's shapes."""
    d = att["dims"]
    stream = att["unique_rows"] * d["T"] > DEDUP_DENSE_MAX_ELEMENTS
    widths = [d["input_dim"]] + d["hpd_hidden"]
    k3 = stream and len(d["hpd_hidden"]) > 0 and hidden.supports(widths)
    return {"hidden": "kernels" if k3 else "library",
            "tail": "kernels" if stream and d["K"] <= MAX_K else "library",
            "decoder": "library"}


def stage_rates(att: dict, measured: Optional[dict] = None) -> Optional[Dict[str, float]]:
    """{stage: flop/s} on the artifact's card, or None without its peaks."""
    peaks = roofline.PEAKS.get(att["device_kind"])
    if peaks is None:
        return None
    rates = {route: peaks[unit] / n
             for route, (unit, n) in roofline.MATMUL_RATE[att["precision"]].items()}
    if measured:
        rates["library"] = measured.get(att["precision"], measured["highest"])
    return {stage: rates[route] for stage, route in stage_routes(att).items()}


def _f(v) -> str:
    return "—" if v is None else f"{v:.3f}"


def table(att: dict, rates: Dict[str, float]) -> str:
    """The markdown table of one artifact."""
    fl = floors_ms(att, rates)
    lines = [f"| stage | Δfwd ms | Δ(f+b) ms | floor fwd | floor f+b |", "|---|---|---|---|---|"]
    tot_f = tot_b = fl_f = fl_b = 0.0
    for row in att["rows"]:
        s, df, db = row["stage"], row.get("d_fwd_ms"), row["d_fwdbwd_ms"]
        ff, fb = fl.get(s, (None, None))
        lines.append(f"| {s} | {_f(df)} | {_f(db)} | {_f(ff)} | {_f(fb)} |")
        tot_f += df or 0.0
        tot_b += db
        fl_f += ff or 0.0
        fl_b += fb or 0.0
    lines.append(f"| **sum** | {tot_f:.3f} | {tot_b:.3f} | {fl_f:.3f} | {fl_b:.3f} |")
    lines.append(f"floor share of step: {fl_b / att['step_ms']:.4f}; room above the floors: "
                 f"{att['step_ms'] - fl_b:.3f} ms")
    return "\n".join(lines)


def measured_floor_account(att: dict, sweep_path: str = SWEEP_PROBE,
                           gather_path: str = GATHER_PROBE) -> list:
    """The tail forward's phases from ``sweep_probe`` at the artifact's
    precision and the blend's gathers and scatters from ``gather_probe``:
    measurements, not arithmetic."""
    lines = []
    prec = att["precision"]
    if os.path.exists(sweep_path):
        with open(sweep_path) as fh:
            sp = json.load(fh).get(prec)
        if sp:
            lines.append(
                f"tail fwd measured decomposition ({prec}): dots {sp['dots_ms']:.3f} + exp/max "
                f"{sp['exp_max_cost_ms']:.3f} + top-k {sp['topk_cache_cost_ms']:.3f} + marginal "
                f"{sp['marginal_cost_ms']:.3f} = {sp['full_ms']:.3f} ms")
    if os.path.exists(gather_path):
        with open(gather_path) as fh:
            gp = json.load(fh)["ms"]
        from .gather_probe import K12, TAKE

        g, ss = gp.get(TAKE), gp.get(K12)
        if g is not None and ss is not None:
            alts = {k: v for k, v in gp.items() if "scatter" in k and k != K12}
            alt = "; ".join(f"{k} {v:.3f}" for k, v in sorted(alts.items(), key=lambda kv: kv[1]))
            lines.append(f"blend floors (precision-invariant): row gather {g:.3f} ms fwd "
                         f"(+{g:.3f} ms dw bwd), table gradient (K12) {ss:.3f} ms bwd "
                         f"(measured alternatives: {alt or 'none'})")
    return lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The stage split beside each stage's floor.")
    ap.add_argument("paths", nargs="+", help="attribution --json-out files")
    ap.add_argument("--calibration", default="nominal", choices=["nominal", "measured"])
    ap.add_argument("--sweep-probe", default=SWEEP_PROBE)
    ap.add_argument("--gather-probe", default=GATHER_PROBE)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = {}
    for path in args.paths:
        with open(path) as fh:
            att = json.load(fh)
        name = os.path.basename(path)
        if "dims" not in att:
            print(f"{path}: no dims recorded, skipping")
            continue
        measured = (roofline.load_measured(att["device_kind"])
                    if args.calibration == "measured" else None)
        rates = stage_rates(att, measured)
        if rates is None:
            print(f"{path}: no peaks for device_kind {att['device_kind']!r}, skipping")
            continue
        print(f"\n## {name} — {att['mode']}, precision {att['precision']}, step "
              f"{att['step_ms']:.3f} ms/batch ({att.get('gpu') or att['device_kind']})")
        print(table(att, rates))
        account = measured_floor_account(att, args.sweep_probe, args.gather_probe)
        for line in account:
            print(f"  * {line}")
        out[name] = dict(floors_ms=floors_ms(att, rates), rates=rates,
                         routes=stage_routes(att), account=account)
    return out


if __name__ == "__main__":
    main()
