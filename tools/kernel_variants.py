"""K1-K4 built from variants of their CUDA sources and timed side by side
on one card: what each choice of the butterfly design is worth.

A variant is a copy of ``whvi_tpu_torch/csrc/`` with named edits
(``VARIANTS``: a constant changed, or a step of the kernels cut out). Each
edit is a piece of source text that must occur exactly once in its file,
so a variant never times the sources unchanged by mistake; the edits match
the sources of K1-K4 as first written for Hopper, and a later change to
those lines needs its variant edited before it runs again. This is a
design tool, kept outside the package and its tests.

Every variant is built into its own library, one ``nvcc`` a source, all
started together, then loaded in turn. The diagnostic variants
(``DIAGNOSTIC``) compute wrong results on purpose: their time is what the
kernels take without the step they cut out. Every other variant is first
held against the plain versions (fp32 and bf16 storage bit for bit, the
bf16 precision within ``fwht_cuda.bf16_tol``).

JSON rows: first the card and its power limit; then per variant the
ptxas report of the fused kernel at D = 4096, 8192, 16384 (registers and
spill bytes, fp32 and bf16, with residuals and without, in both
storages); then per variant and kernel the device ms a call
(``time_us``: 20 calls in a CUDA graph, median of 5 replays) of K1-K3 in
both precisions and on bf16 storage at the scaling path's shape (u
(8,1,D), x (256,D) expanded to 2048 rows) at D = 4096 and 8192, of K1 at
D=16384, B=512 and of K4 at (2048, 4096) in both storages, with the
bound (bytes read once and written once over 3.35 TB/s) and its share. ``base`` runs first and last,
so that drift of the card's clock shows.

Run from the repository root: python -m tools.kernel_variants [base large_r16 ...]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil

import torch

from whvi_tpu_torch.bench.common import bound_ms, emit, header, time_us
from whvi_tpu_torch.bench.kernel_sass import _instance, ptxas
from whvi_tpu_torch.ops import fwht_cuda as fc

CORE = "fwht_core.cuh"
# name -> [(file, text, replacement)]; each text occurs once in its file
VARIANTS = {
    "base": [],
    # diagnostic: the row never leaves the registers
    "no_exchange": [
        (CORE, "      ex.template move<kW, nw>(v);\n", ""),
        (CORE, "  if constexpr (kW != kSplit) ex.template move<kW, kSplit>(v);\n", ""),
    ],
    # diagnostic: the exchanges without their barriers
    "no_barrier": [
        (CORE, "    if constexpr (S::kTpr <= 32) __syncwarp();\n    else __syncthreads();\n", ""),
    ],
    # the exchanges' slots unswizzled: bank conflicts
    "no_swizzle": [(CORE, "    return e ^ (((e >> kSwizzleShift) & 7) << 2);", "    return e;")],
    # 64 elements a thread from D = 4096 (2 exchanges a transform), one
    # row a block (64 threads at D = 4096), registers uncapped
    "r64_row": [
        (CORE, "kLargeLog2Regs = 5;", "kLargeLog2Regs = 6;"),
        (CORE, "kLargeFromLog2D = 13;", "kLargeFromLog2D = 12;"),
        (CORE, "kMinBlockThreads = 256;", "kMinBlockThreads = 64;"),
        (CORE, "kRegCap = 128;", "kRegCap = 255;"),
    ],
    # 16 elements a thread at every D >= 32: 512 threads a row at D = 8192
    # and 1024 at D = 16384, where a thread may take 64 registers
    "large_r16": [(CORE, "kLargeFromLog2D = 13;", "kLargeFromLog2D = 15;")],
}
DIAGNOSTIC = ("no_exchange", "no_barrier")
PTXAS_LOG2D = (12, 13, 14)
SCALING_WIDTHS = (4096, 8192)  # run_scaling's u (8,1,D) over x (256,D) expanded


def make_sources(name: str, root: str) -> str:
    """``root/name/csrc``: a copy of the kernels' sources with the
    variant's edits; raises if an edit does not match exactly once."""
    d = os.path.join(root, name, "csrc")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(fc.CSRC, d)
    for f, old, new in VARIANTS[name]:
        path = os.path.join(d, f)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {text.count(old)} times in {f}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return d


def build(names, root: str) -> tuple[dict, dict]:
    """Library path and ptxas report of each variant, all compiled at once."""
    nvcc = fc._nvcc()

    def one(name):
        src = make_sources(name, root)
        objs = [os.path.join(root, name, s + ".o") for s in fc.SOURCES]
        report = fc._run_all([[nvcc, *fc.NVCC_FLAGS, "-c", "-o", o, os.path.join(src, s)]
                              for s, o in zip(fc.SOURCES, objs)])
        lib = os.path.join(root, name, "lib.so")
        fc._run_all([[nvcc, *fc._ARCH, "-shared", "-o", lib, *objs]])
        return lib, report

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(one, names)))
    return {n: b[0] for n, b in built.items()}, {n: b[1] for n, b in built.items()}


def use_library(path: str) -> None:
    """Make the wrappers launch the kernels of ``path``."""
    with fc._lock:
        fc._lib = None
        fc.LIB_PATH = path
    fc.load_library()


def check(name: str, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    for D, lead in ((4096, (8, 256)), (8192, (4,)), (16384, (4,)), (128, (4, 64))):
        s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
        u = torch.randn(*lead[:-1], 1, D, device=dev, generator=gen)
        x = torch.randn(*lead, D, device=dev, generator=gen)
        for prec in fc.PRECISIONS:
            got = fc.fused_raw(s1, u, s2, x, True, prec)
            want = fc.fused_plain(s1, u, s2, x, True, prec)
            for t, (a, b) in enumerate(zip(got, want)):
                if prec == "fp32":
                    ok = torch.equal(a, b)
                else:
                    tol = fc.bf16_tol(D, 1 if t == 1 else 2)  # (y, i1, i2)
                    ok = ((a - b).abs().max() / b.abs().max()).item() <= tol
                if not ok:
                    raise AssertionError(f"variant {name}: D={D} {prec} output {t} is wrong")
        if not torch.equal(fc.fwht_raw(x), fc.fwht_plain(x)):
            raise AssertionError(f"variant {name}: fwht D={D} is wrong")
        h = [t.to(torch.bfloat16) for t in (s1, u, s2, x)]  # bf16 storage: bit for bit
        if not all(torch.equal(a, b) for a, b in zip(fc.fused_raw(*h, True), fc.fused_plain(*h, True))):
            raise AssertionError(f"variant {name}: D={D} bf16 storage is wrong")
        if not torch.equal(fc.fwht_raw(h[3]), fc.fwht_plain(h[3])):
            raise AssertionError(f"variant {name}: fwht D={D} bf16 storage is wrong")


def cases(dev):
    """(kernel, label, call, inputs, outputs) timed for every variant."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for D in SCALING_WIDTHS:
        s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
        u = torch.randn(8, 1, D, device=dev, generator=gen)
        x = torch.randn(256, D, device=dev, generator=gen).expand(8, 256, D)
        g = torch.randn(8, 256, D, device=dev, generator=gen)
        label = f"D={D} 2048 rows"
        for prec in fc.PRECISIONS:
            sfx = "" if prec == "fp32" else "_bf16"
            out += [
                ("fused_y" + sfx, label, lambda p=prec, a=(s1, u, s2, x): fc.fused_raw(*a, False, p),
                 (x, u, s1, s2), (g,)),
                ("fused_res" + sfx, label, lambda p=prec, a=(s1, u, s2, x): fc.fused_raw(*a, True, p),
                 (x, u, s1, s2), (g, g, g)),
                ("fused_bwd" + sfx, label, lambda p=prec, a=(s1, u, s2, g): fc.fused_bwd_raw(*a, p),
                 (g, u, s1, s2), (g, g, g)),
            ]
    D = 4096
    d1, du, d2 = (torch.randn(16384, device=dev, generator=gen) for _ in range(3))
    xl = torch.randn(512, 16384, device=dev, generator=gen)
    for prec in fc.PRECISIONS:
        sfx = "" if prec == "fp32" else "_bf16"
        out.append(("fused_y" + sfx, "D=16384 512 rows",
                    lambda p=prec: fc.fused_raw(d1, du, d2, xl, False, p), (xl, du, d1, d2), (xl,)))
    xb = torch.randn(2048, D, device=dev, generator=gen)
    out.append(("fwht", "D=4096 2048 rows", lambda: fc.fwht_raw(xb), (xb,), (xb,)))
    for D in SCALING_WIDTHS:  # bf16 storage
        bf = torch.bfloat16
        s1, s2 = (torch.randn(D, device=dev, generator=gen).to(bf) for _ in range(2))
        u = torch.randn(8, 1, D, device=dev, generator=gen).to(bf)
        x = torch.randn(256, D, device=dev, generator=gen).to(bf).expand(8, 256, D)
        g = torch.randn(8, 256, D, device=dev, generator=gen).to(bf)
        label = f"D={D} 2048 rows"
        out += [
            ("fused_y_bf16s", label, lambda a=(s1, u, s2, x): fc.fused_raw(*a, False),
             (x, u, s1, s2), (g,)),
            ("fused_res_bf16s", label, lambda a=(s1, u, s2, x): fc.fused_raw(*a, True),
             (x, u, s1, s2), (g, g, g)),
            ("fused_bwd_bf16s", label, lambda a=(s1, u, s2, g): fc.fused_bwd_raw(*a),
             (g, u, s1, s2), (g, g, g)),
        ]
    xh = xb.to(torch.bfloat16)
    out.append(("fwht_bf16s", "D=4096 2048 rows", lambda: fc.fwht_raw(xh), (xh,), (xh,)))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--root", default=os.path.join(fc.BUILD_DIR, "variants"))
    args = ap.parse_args(argv)
    if unknown := set(args.variants) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(unknown)}")
    header("kernel_variants")
    names = list(dict.fromkeys(["base", *(args.variants or VARIANTS)]))
    libs, reports = build(names, args.root)
    for name in names:
        for symbol, row in sorted(ptxas(reports[name]).items()):
            inst = _instance(symbol)
            if inst and inst["kernel"] == "whvi_fused" and inst["L"] in PTXAS_LOG2D:
                emit({"variant": name, "ptxas": True, **inst, **row})
    dev = torch.device("cuda")
    runs = cases(dev)
    for name in [*names, "base"] if len(names) > 1 else names:
        use_library(libs[name])
        if name not in DIAGNOSTIC:
            check(name, dev)
        for kernel, label, call, ins, outs in runs:
            ms = time_us(call, 20) / 1e3
            bound, _ = bound_ms(ins, outs, 0.0, 1.0)
            emit({"variant": name, "kernel": kernel, "shape": label, "ms": ms,
                  "bound_ms": bound, "share": bound / ms})


if __name__ == "__main__":
    main()
