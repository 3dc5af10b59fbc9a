"""What nvcc made of the Walsh-Hadamard kernels K1-K4: per instance, the
ptxas report and counts of the SASS instructions that show the design.

Builds the kernels' library (``fwht_cuda.build_kernels``, ``-Xptxas -v``)
and disassembles it with ``cuobjdump -sass``. One JSON row per instance of
``whvi_fused_kernel`` (K1-K3: ``L`` = log2 D, ``residuals``, ``bf16``) and
``fwht_kernel`` (K4) at the widths asked for: ``registers``, ``stack``
bytes, ``spill_stores`` / ``spill_loads`` bytes, and the counts of
``BAR.SYNC`` (block barriers: one an exchange of the row through shared
memory), ``LDG.E.128`` / ``STG.E.128`` (16-byte device-memory accesses),
``LDS`` / ``STS`` (shared memory) and ``LDL`` / ``STL`` (local memory:
spills). Needs ``nvcc`` and ``cuobjdump``, no card.

Run: python -m whvi_tpu_torch.bench.kernel_sass [--log2d 4 7 12 13 14]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess

from whvi_tpu_torch.bench.common import emit
from whvi_tpu_torch.ops import fwht_cuda as fc

OPS = ("BAR.SYNC", "LDG.E.128", "STG.E.128", "LDS", "STS", "LDL", "STL")
_KERNEL = re.compile(r"_ZN4whvi(?:17whvi_fused_kernel|11fwht_kernel)ILi(\d+)E(?:Lb(\d)ELb(\d)E)?")


def _instance(symbol: str) -> dict | None:
    """``{"kernel", "L", "residuals", "bf16"}`` of a K1-K4 symbol, else None."""
    m = _KERNEL.search(symbol)
    if m is None:
        return None
    if m.group(2) is None:
        return {"kernel": "fwht", "L": int(m.group(1))}
    return {"kernel": "whvi_fused", "L": int(m.group(1)),
            "residuals": m.group(2) == "1", "bf16": m.group(3) == "1"}


def ptxas(report: str) -> dict:
    """Registers, stack and spill bytes per kernel symbol."""
    rows, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'|Function properties for (\S+)", line)
        if m:
            fn = m.group(1) or m.group(2)
            rows.setdefault(fn, {})
            continue
        if fn is None:
            continue
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
            rows[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        if m := re.search(r"Used (\d+) registers", line):
            rows[fn]["registers"] = int(m.group(1))
    return rows


def sass_counts(sass: str) -> dict:
    """Counts of OPS per kernel symbol in ``cuobjdump -sass`` output."""
    counts, fn = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            continue
        if fn is not None:
            for op in OPS:
                if re.search(rf"\b{re.escape(op)}(?=[\s.;])", line):
                    counts[fn][op] += 1
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2d", type=int, nargs="+", default=[4, 7, 12, 13, 14])
    args = ap.parse_args(argv)
    report = fc.build_kernels()
    regs = ptxas(report)
    counts = sass_counts(subprocess.run(
        ["cuobjdump", "-sass", fc.LIB_PATH], capture_output=True, text=True, check=True, timeout=600,
    ).stdout)
    print(f"nvcc {fc._nvcc()}; library {os.path.basename(fc.LIB_PATH)}", flush=True)
    for symbol in sorted(counts.keys() | regs.keys()):
        inst = _instance(symbol)
        if inst is None or inst["L"] not in args.log2d:
            continue
        emit({**inst, **regs.get(symbol, {}), **{op: counts[symbol][op] for op in OPS}})


if __name__ == "__main__":
    main()
