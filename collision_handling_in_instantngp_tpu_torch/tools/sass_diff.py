"""Compare the SASS of the kernels' narrow instances (heads up to 128)
between a parent checkout and this one, on the card: the per-row K9, K10
and K11 (K8's forward has no instance of that form) and the streamed
tail's one-chunk passes (K1 / K4's rows pass, K1 / K5's columns pass, K7,
and the backward's four kernels).

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.sass_diff \\
        --parent _archive/parent

Builds ``hpd_full.cu``, ``hpd_tail.cu`` and ``hpd_stream.cu`` from both
checkouts with the port's nvcc flags (into ``--out``), disassembles them
with ``cuobjdump -sass`` and, for every narrow instance (``kernel<RPT,
false>`` of the per-row kernels; the streamed tail's ``<P, ..., false>``,
which a parent without the chunked forward names ``<P, ...>``), prints the
instruction count, ptxas's register and spill lines, and whether the two
listings are identical once addresses and constants are normalised (the
kernels' parameter offsets differ); the first differing lines otherwise.
Exits 1 if an instance differs.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess

from ..ops.cuda import build

LIBS = {"hpd_full": ("full_fwd_kernel", "full_bwd_kernel"), "hpd_tail": ("tail_bwd_kernel",)}
# the streamed tail's one-chunk instances: (kernel, template arguments before
# CH) by precision P; a parent before the chunked forward has no CH argument
# on the forward's kernels
STREAM_FWD = ("hpd_fwd_rows_kernel", "hpd_fwd_cols_kernel")
STREAM_BWD = ("hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel", "hpd_b1_kernel", "hpd_b2_rows_kernel")


def instances(lib: str, parent_funcs) -> list:
    """[(label, the parent's mangled key, this checkout's)] of ``lib``."""
    if lib != "hpd_stream":
        return [(f"{kern}<{rpt}, false>", f"{kern}ILi{rpt}ELb0EE", f"{kern}ILi{rpt}ELb0EE")
                for kern in LIBS[lib] for rpt in (4, 2, 1)]
    # does the parent's forward carry CH?
    chunked = any("hpd_fwd_rows_kernelILi0ELb0EE" in k for k in parent_funcs)
    out = []
    for p in range(3):
        for kern, extra in ([(k, "") for k in STREAM_FWD + STREAM_BWD]
                            + [("hpd_probe_kernel", f"ELb{d}") for d in (0, 1)]):
            mine = f"{kern}ILi{p}{extra}ELb0EE"
            fwd = kern not in STREAM_BWD
            out.append((f"{kern}<{p}{', ' + extra[-1] if extra else ''}, false>",
                        f"{kern}ILi{p}{extra}EE" if fwd and not chunked else mine, mine))
    return out


def disassemble(src_dir: str, lib: str, out: str):
    """({function: ptxas lines}, {function: [instructions]}) of one build."""
    cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", out,
           os.path.join(src_dir, lib + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src_dir}/{lib}.cu:\n{proc.stderr}")
    regs, cur = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            cur = found.group(1)
        elif cur and ("Used" in line or "spill" in line):
            regs.setdefault(cur, []).append(line.replace("ptxas info    :", "").strip())
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", out], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name:
            found = re.match(r"\s+/\*[0-9a-f]+\*/\s+(.*?);", line)
            if found:
                funcs[name].append(re.sub(r"0x[0-9a-f]+", "X", found.group(1)))
    return regs, funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sass_diff"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    parent_src = os.path.join(args.parent, os.path.relpath(build.HERE, os.getcwd()))
    differ = 0
    for lib in (*LIBS, "hpd_stream"):
        pr, pf = disassemble(parent_src, lib, os.path.join(args.out, f"parent_{lib}.so"))
        cr, cf = disassemble(build.HERE, lib, os.path.join(args.out, f"change_{lib}.so"))
        for label, pkey, ckey in instances(lib, pf):
            pk = [k for k in pf if pkey in k]
            ck = [k for k in cf if ckey in k]
            if not pk or not ck:
                print(f"{label}: instance missing (parent {pk}, this {ck})")
                differ = 1
                continue
            a, b = pf[pk[0]], cf[ck[0]]
            diff = list(difflib.unified_diff(a, b, lineterm="", n=0))
            print(f"{label}: {len(a)} / {len(b)} instructions (parent / this), "
                  f"identical: {not diff}; ptxas {pr.get(pk[0])} / {cr.get(ck[0])}")
            if diff:
                differ = 1
                print("\n".join(diff[:40]))
    return differ


if __name__ == "__main__":
    raise SystemExit(main())
