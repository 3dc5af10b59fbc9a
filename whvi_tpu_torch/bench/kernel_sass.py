"""What nvcc made of the Walsh-Hadamard kernels K1-K4 and of the large-D
copies, scale and row kernels: per instance, the ptxas report and counts
of the SASS instructions that show the design.

Builds the kernels' library (``fwht_cuda.build_kernels``, ``-Xptxas -v``)
and disassembles it with ``cuobjdump -sass``. One JSON row per instance of
``whvi_fused_kernel`` (K1-K3: ``L`` = log2 D, ``residuals``, ``bf16``),
``fwht_kernel`` (K4), ``kron_swap_kernel`` (``k_swap``) and
``kron_cur_kernel`` (``k_cur``, which ``k_onecast`` launches too; the
last two from ``L`` = 7) at the widths asked for, and one each for
``kron_kernel<kCopy>`` (``k_copy``), ``kron_kernel<kScale>``
(``k_scale``), ``kron_full_kernel<1>`` and ``<2>`` (``k_mm1``,
``k_mm2``; ``kron_whole_kernel<1>`` and ``<2>`` too where a build turns
its switch on, with ``"whole_group": true``), ``kron_full_kernel<4>``
(named ``k_full``, which ``k_flat`` and ``emit_full`` launch too), ``emit_copy_kernel``
(``emit_copy``) and ``copy_2d_kernel`` (named ``hbm_copy``, which runs
the whole array through it; ``copy_2d`` runs it in tiles): ``registers``, ``stack`` bytes, ``spill_stores`` /
``spill_loads`` bytes, and the counts of ``HGMMA`` (warpgroup matrix
products, ``wgmma``: the contractions of ``k_mm1``, ``k_mm2`` and ``k_full``), ``BAR.SYNC`` (block and named
barriers: in K1-K4 one an exchange of the row through shared memory),
``SHFL.BFLY`` (warp shuffles by lane XOR: ``k_cur``'s lane stages),
``LDG.E.128`` / ``STG.E.128`` (16-byte device-memory accesses; the
``.EF`` forms are the streaming ones, ``ld``/``st.global.cs``), ``LDS`` /
``STS`` (shared memory), ``LDL`` / ``STL`` (local memory: spills),
``LDGSTS`` (``cp.async``), ``UBLKCP.S.G`` / ``UBLKCP.G.S`` (TMA bulk
copies into and out of shared memory), ``SYNCS.ARRIVE.TRANS64`` (mbarrier
arrivals, with or without expected bytes) and
``SYNCS.PHASECHK.TRANS64.TRYWAIT`` (mbarrier waits). Needs ``nvcc`` and
``cuobjdump``, no card.

Run: python -m whvi_tpu_torch.bench.kernel_sass [--log2d 4 7 12 13 14]
(--log2d picks the K1-K4, k_swap and k_cur widths; the other large-D
rows are always printed)
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess

from whvi_tpu_torch.bench.common import emit
from whvi_tpu_torch.ops import fwht_cuda as fc

OPS = ("HGMMA", "BAR.SYNC", "SHFL.BFLY", "LDG.E.128", "LDG.E.EF.128", "STG.E.128", "STG.E.EF.128", "LDS", "STS",
       "LDL", "STL", "LDGSTS", "UBLKCP.S.G", "UBLKCP.G.S", "SYNCS.ARRIVE.TRANS64",
       "SYNCS.PHASECHK.TRANS64.TRYWAIT")
_KERNEL = re.compile(r"_ZN4whvi(?:17whvi_fused_kernel|11fwht_kernel)ILi(\d+)E(?:Lb(\d)ELb(\d)E)?")
# kron_kernel<stage> of the copy (0) and the scale (1); kron_full_kernel<n>
# after n contractions (1 k_mm1, 2 k_mm2, 4 the whole product: k_full,
# k_flat, emit_full) and kron_whole_kernel<n>; emit_copy_kernel
_KRON = re.compile(r"_ZN4kron(?:11kron_kernelILi([01])EE|16kron_full_kernelILi([124])EE"
                   r"|17kron_whole_kernelILi([12])EE|16emit_copy_kernelE)")
_CONTRACTIONS = {"1": "k_mm1", "2": "k_mm2", "4": "k_full"}
# the row kernels: kron_swap_kernel<L> (k_swap), kron_cur_kernel<L> (k_cur)
_ROW = re.compile(r"_ZN4kron(?:16kron_swap_kernel|15kron_cur_kernel)ILi(\d+)EE")
_RING = "_ZN9kron_copy14copy_2d_kernelE"  # hbm_copy and copy_2d


def _instance(symbol: str) -> dict | None:
    """``{"kernel", "L", "residuals", "bf16"}`` of a K1-K4 symbol,
    ``{"kernel", "L"}`` of ``k_swap`` or ``k_cur``, ``{"kernel"}`` (the
    wrapper's name) of a large-D copy or scale, else None."""
    if m := _ROW.search(symbol):
        return {"kernel": "k_cur" if "kron_cur" in symbol else "k_swap", "L": int(m.group(1))}
    if _RING in symbol:
        return {"kernel": "hbm_copy"}
    if m := _KRON.search(symbol):
        if m.group(1) is not None:
            return {"kernel": ("k_copy", "k_scale")[int(m.group(1))]}
        if m.group(2) is not None:
            return {"kernel": _CONTRACTIONS[m.group(2)]}
        if m.group(3) is not None:
            return {"kernel": _CONTRACTIONS[m.group(3)], "whole_group": True}
        return {"kernel": "emit_copy"}
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
        if inst is None or ("L" in inst and inst["L"] not in args.log2d):
            continue
        emit({**inst, **regs.get(symbol, {}), **{op: counts[symbol][op] for op in OPS}})


if __name__ == "__main__":
    main()
