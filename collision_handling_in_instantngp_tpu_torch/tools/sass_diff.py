"""Compare the SASS of the per-row kernels' narrow instances (heads up to
128) between a parent checkout and this one, on the card: K9, K10 and K11
(K8's forward has no instance of that form).

    python3 -m collision_handling_in_instantngp_tpu_torch.tools.sass_diff \\
        --parent _archive/parent

Builds ``hpd_full.cu`` and ``hpd_tail.cu`` from both checkouts with the
port's nvcc flags (into ``--out``), disassembles them with ``cuobjdump
-sass`` and, for every narrow instance (``kernel<RPT, false>`` in both),
prints the instruction
count, ptxas's register and spill lines, and whether the two listings are
identical once addresses and constants are normalised (the kernels'
parameter offsets differ); the first differing lines otherwise. Exits 1
if an instance differs.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess

from ..ops.cuda import build

LIBS = {"hpd_full": ("full_fwd_kernel", "full_bwd_kernel"), "hpd_tail": ("tail_bwd_kernel",)}


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
    for lib, kernels in LIBS.items():
        pr, pf = disassemble(parent_src, lib, os.path.join(args.out, f"parent_{lib}.so"))
        cr, cf = disassemble(build.HERE, lib, os.path.join(args.out, f"change_{lib}.so"))
        for kern in kernels:
            for rpt in (4, 2, 1):
                pk = [k for k in pf if f"{kern}ILi{rpt}ELb0EE" in k]
                ck = [k for k in cf if f"{kern}ILi{rpt}ELb0EE" in k]
                if not pk or not ck:
                    print(f"{kern}<{rpt}>: instance missing (parent {pk}, this {ck})")
                    differ = 1
                    continue
                a, b = pf[pk[0]], cf[ck[0]]
                diff = list(difflib.unified_diff(a, b, lineterm="", n=0))
                print(f"{kern}<{rpt}, false>: {len(a)} / {len(b)} instructions (parent / this), "
                      f"identical: {not diff}; ptxas {pr.get(pk[0])} / {cr.get(ck[0])}")
                if diff:
                    differ = 1
                    print("\n".join(diff[:40]))
    return differ


if __name__ == "__main__":
    raise SystemExit(main())
