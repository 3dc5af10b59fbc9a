"""K1-K4 built from variants of their CUDA sources and timed side by side
on one card: what each choice of the butterfly design is worth.

A variant is a copy of ``whvi_tpu_torch/csrc/`` with named edits
(``VARIANTS``: a constant changed, or a step of the kernels cut out). Each
edit is a piece of source text that must occur exactly once in its file,
so a variant never times the sources unchanged by mistake; a change to
those lines needs its variant edited too (``tests/test_torch_bench.py``
applies every edit to the shipped sources). ``--parent DIR`` adds the
sources of another checkout (``DIR/whvi_tpu_torch/csrc``, for example the
parent commit unpacked by ``git archive``) as the variant ``parent``; a
parent from before the column kernel times and checks the rest.

Every variant is built into its own library, one ``nvcc`` a source, all
started together, then loaded in turn. The diagnostic variants
(``DIAGNOSTIC``) compute wrong results on purpose: their time is what the
kernels take without the step they cut out. Every other variant is first
held against the plain versions (fp32 and bf16 storage bit for bit, the
bf16 precision within ``fwht_cuda.bf16_tol``).

JSON rows: first the card and its power limit; then per variant the
ptxas report of the fused kernels and of the column kernel at D = 4096,
8192, 16384 (registers and spill bytes, fp32 and bf16, with residuals and
without, in both storages; the column kernel's three modes; K3's reduce
mode, square and stacked), and whether the instances a design change
elsewhere must leave as they are (K1-K3 in both storages and precisions,
K4 in both storages, the square form of K3's reduce mode and its second
pass; every D) have the ptxas report and the SASS (``cuobjdump``) of
``base``'s; then
per variant and kernel the device ms
a call (``time_us``: 20 calls in a CUDA graph, median of 5 replays) of
K1-K3 in both precisions and on bf16 storage at the scaling path's shape
(u (8,1,D), x (256,D) expanded to 2048 rows) at D = 4096 and 8192, of K3's
reduce mode at (64,256,8192) and (8,256,4096) with x shared across the
samples and with x its own (dx stored), of its stacked form at
(4,1024,7,2048) and (4,1024,8,512), of K1
at D=16384, B=512 in every mode, and of K4 at (2048, 4096) and at the
column head (8,1,1,4096) in both storages, and of the column kernel's
three modes at the column head (8,1,D), D = 4096 and 8192, and at the
column LRT's rows (8,256,4096) beside the launch floor on the same grid
(``column_floor``), with the bound (bytes read once and written once over
3.35 TB/s) and its share. ``base`` runs first
and last (``parent`` around it), so that drift of the card's clock shows;
``--rounds N`` runs that order N times.

Run from the repository root: python -m tools.kernel_variants [base large_r16 ...]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import re
import shutil
import subprocess

import torch

from whvi_tpu_torch.bench.common import bound_ms, emit, header, time_us
from whvi_tpu_torch.bench.kernel_sass import _instance, ptxas
from whvi_tpu_torch.ops import fwht_cuda as fc

CORE = "fwht_core.cuh"
BF16S = "whvi_bf16s.cu"  # K1-K3 on bf16 storage
_SYNC = "    if constexpr (S::kTpr <= 32) __syncwarp();\n    else __syncthreads();\n"
_IO, _W0 = "kBf16sIoSchedule = true;", "kBf16sIoSchedule = false;"
_CAP = "kBf16sRegCap = 64;"
# name -> [(file, text, replacement)]; each text occurs once in its file
VARIANTS = {
    "base": [],
    # diagnostic: the row never leaves the registers
    "no_exchange": [
        (CORE, "      ex.template move<kW, nw>(v);\n", ""),
        (CORE, "  if constexpr (kW != kSplit) ex.template move<kW, kSplit>(v);\n", ""),
        (BF16S, "    char* const p = smem + kBuf * S::kBuf32;\n",
         "    return;\n    char* const p = smem + kBuf * S::kBuf32;\n"),
        (BF16S, "    char* const p = smem + S::kBuf16;\n", "    return;\n    char* const p = smem + S::kBuf16;\n"),
    ],
    # diagnostic: the exchanges without their barriers
    "no_barrier": [(CORE, _SYNC, ""), (BF16S, _SYNC, "")],
    # the exchanges' slots unswizzled: bank conflicts
    "no_swizzle": [
        (CORE, "    return e ^ (((e >> kSwizzleShift) & 7) << 2);", "    return e;"),
        (BF16S, "    return kIoSchedule ? e + 4 * (e >> 5) + 4 * (e >> (kLog2R + 2)) : e ^ (((e >> kLog2R) & 7) << 2);",
         "    return e;"),
        (BF16S, "    return e ^ (((e >> kLog2R) & 7) << 3);", "    return e;"),
    ],
    # bf16 storage, the window-0 schedule: each transform from [0, r) to
    # [L - r, L), one bf16 exchange between them and one into the I/O
    # window for i2, s1, y (bf16s_w0_store_last: none; bf16s_w0_load_io:
    # x and s2 through one more); bf16s_w0_r16 with 16 elements a thread
    # (32 from D = 8192) in 256-thread blocks, 3 windows a transform at
    # D = 4096
    "bf16s_w0": [(BF16S, _IO, _W0)],
    "bf16s_w0_store_last": [(BF16S, _IO, _W0),
                            (BF16S, "kBf16sStoreViaIo = true;", "kBf16sStoreViaIo = false;")],
    "bf16s_w0_load_io": [(BF16S, _IO, _W0),
                         (BF16S, "kBf16sLoadViaIo = false;", "kBf16sLoadViaIo = true;")],
    "bf16s_w0_r16": [
        (BF16S, _IO, _W0),
        (BF16S, "kBf16sLog2Regs = 5;", "kBf16sLog2Regs = 4;"),
        (BF16S, "kBf16sLargeLog2Regs = 6;", "kBf16sLargeLog2Regs = 5;"),
        (BF16S, "kBf16sMinBlock = 64;", "kBf16sMinBlock = 256;"),
    ],
    # the I/O schedule: u and s1 copied into shared memory at the start
    # (cp.async), not read where they are used; two fp32 buffers (one
    # barrier less an exchange but the first); other register caps; 64 or
    # 16 elements a thread up to D = 4096, 32 or 128 from D = 8192; blocks
    # of at least 128 or 256 threads
    "bf16s_prefetch": [(BF16S, "kBf16sPrefetch = false;", "kBf16sPrefetch = true;")],
    "bf16s_two_buffers": [(BF16S, "kBf16sFp32Buffers = 1;", "kBf16sFp32Buffers = 2;")],
    "bf16s_cap168": [(BF16S, _CAP, "kBf16sRegCap = 168;")],
    "bf16s_cap255": [(BF16S, _CAP, "kBf16sRegCap = 255;")],
    "bf16s_large_cap168": [(BF16S, "kBf16sLargeRegCap = 255;", "kBf16sLargeRegCap = 168;")],
    "bf16s_large_r32": [(BF16S, "kBf16sLargeLog2Regs = 6;", "kBf16sLargeLog2Regs = 5;")],
    "bf16s_small_r64": [(BF16S, "kBf16sLog2Regs = 5;", "kBf16sLog2Regs = 6;")],
    "bf16s_small_r16": [(BF16S, "kBf16sLog2Regs = 5;", "kBf16sLog2Regs = 4;")],
    "bf16s_cap128": [(BF16S, _CAP, "kBf16sRegCap = 128;")],
    "bf16s_large_r128": [(BF16S, "kBf16sLargeLog2Regs = 6;", "kBf16sLargeLog2Regs = 7;")],
    "bf16s_block128": [(BF16S, "kBf16sMinBlock = 64;", "kBf16sMinBlock = 128;")],
    "bf16s_block256": [(BF16S, "kBf16sMinBlock = 64;", "kBf16sMinBlock = 256;")],
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
_SAME = ("registers", "stack", "spill_stores", "spill_loads")
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


def build(names, root: str, parent: str | None = None) -> tuple[dict, dict]:
    """Library path and ptxas report of each variant (and of ``parent``'s
    sources), all compiled at once."""
    nvcc = fc._nvcc()

    def one(name):
        if name == "parent":
            src = os.path.join(parent, "whvi_tpu_torch", "csrc")
        else:
            src = make_sources(name, root)
        os.makedirs(os.path.join(root, name), exist_ok=True)
        sources = sorted(f for f in os.listdir(src) if f.endswith(".cu"))
        objs = [os.path.join(root, name, s + ".o") for s in sources]
        report = fc._run_all([[nvcc, *fc.NVCC_FLAGS, "-c", "-o", o, os.path.join(src, s)]
                              for s, o in zip(sources, objs)])
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
        if hasattr(fc.load_library(), "whvi_bwd_sums_f32") and fc.sums_group(s1, u, s2, x):
            _, i1, i2 = fc.fused_raw(s1, u, s2, x, True)
            g = torch.randn(x.shape, device=dev, generator=gen)
            got = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
            want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, True)
            if not (torch.equal(got[0], want[0]) and all(
                    ((a - b).abs().max() / b.abs().max()).item() <= 1e-5 for a, b in zip(got[1:], want[1:]))):
                raise AssertionError(f"variant {name}: K3's reduce mode at D={D} is wrong")
        if not hasattr(fc.load_library(), "column_bf16s"):  # a parent from before the column kernel
            continue
        s1h, s2h, gh = h[0], h[2], x.to(torch.bfloat16)  # the column head's rows: bit for bit
        y, t = fc.column_plain(s1h, gh, s2h, True)
        got_y, got_t = fc.column_raw(s1h, gh, s2h, True)
        gy = torch.randn(y.shape, device=dev, generator=gen).to(torch.bfloat16)
        bwd = fc.column_bwd_raw(s1h, s2h, gy, t)
        ok = torch.equal(fc.column_raw(s1h, gh, s2h, False)[0], y) and torch.equal(got_y, y)
        ok = ok and torch.equal(got_t, t)
        if not (ok and all(torch.equal(a, b) for a, b in zip(bwd, fc.column_bwd_plain(s1h, s2h, gy, t)))):
            raise AssertionError(f"variant {name}: the column kernel at D={D} is wrong")


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
    # K3's reduce mode at the c5-largeD cell's two layers (x shared across
    # the samples, no dx; x its own, dx stored) and at the scaling shape
    for D, S, B in ((8192, 64, 256), (4096, 8, 256)):
        s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
        u = torch.randn(S, 1, D, device=dev, generator=gen)
        g = torch.randn(S, B, D, device=dev, generator=gen)
        for x, want_dx in ((torch.randn(B, D, device=dev, generator=gen).expand(S, B, D), False),
                          (torch.randn(S, B, D, device=dev, generator=gen), True)):
            _, i1, i2 = fc.fused_raw(s1, u, s2, x, True)
            out += [("fused_bwd_sums", f"({S},{B},{D}) {'dx' if want_dx else 'x shared'}",
                     lambda a=(s1, u, s2, x, g, i1, i2, want_dx): fc.fused_bwd_sums_raw(*a),
                     (g, i1, i2, x, u, s1, s2), (g,) if want_dx else ())]
    # its stacked form at the DeepSeek-V2-Lite cell's lm_head and kv_b_proj
    # (u one a sample, x broadcast over the stack axis, dx stored), N = 1024
    for D, stack in ((2048, 7), (512, 8)):
        s1, s2 = (torch.randn(stack, D, device=dev, generator=gen) for _ in range(2))
        u = torch.randn(4, 1, stack, D, device=dev, generator=gen)
        x = torch.randn(4, 1024, 1, D, device=dev, generator=gen)
        _, i1, i2 = fc.fused_raw(s1, u, s2, x, True)
        g = torch.randn(i1.shape, device=dev, generator=gen)
        out.append(("fused_bwd_sums_stacked", f"(4,1024,{stack},{D}) dx",
                    lambda a=(s1, u, s2, x, g, i1, i2, True): fc.fused_bwd_sums_raw(*a),
                    (g, i1, i2, x, u, s1, s2), (g,)))
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
    dh = [t.to(torch.bfloat16) for t in (d1, du, d2, xl)]
    out.append(("fused_y_bf16s", "D=16384 512 rows", lambda: fc.fused_raw(*dh, False),
                (dh[3], dh[1], dh[0], dh[2]), (dh[3],)))
    xc = torch.randn(8, 1, 1, 4096, device=dev, generator=gen)  # K4 at the column head
    xch = xc.to(torch.bfloat16)
    out.append(("fwht", "(8,1,1,4096)", lambda: fc.fwht_raw(xc), (xc,), (xc,)))
    out.append(("fwht_bf16s", "(8,1,1,4096)", lambda: fc.fwht_raw(xch), (xch,), (xch,)))
    for lead, D in (((8, 1), 4096), ((8, 1), 8192), ((8, 256), 4096)):  # the column kernel
        s1, s2 = (torch.randn(D, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
        g, gy = (torch.randn(*lead, D, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
        t = fc.column_raw(s1, g, s2, True)[1]
        label, rows = f"({lead[0]},{lead[1]},{D})", g.numel() // D
        out += [
            ("column_y_bf16s", label, lambda a=(s1, g, s2): fc.column_raw(*a, False),
             (g, s2, s1[:1]), (g,)),
            ("column_res_bf16s", label, lambda a=(s1, g, s2): fc.column_raw(*a, True),
             (g, s2, s1[:1]), (g, g)),
            ("column_bwd_bf16s", label, lambda a=(s1, s2, gy, t): fc.column_bwd_raw(*a),
             (gy, t, s2, s1[:1]), (g, g, g)),
            ("column_floor", label, lambda r=rows, D=D: fc.column_floor(r, D, dev), (), ()),
        ]
    return out


def _held(symbol: str):
    """The instance key of a kernel a design change elsewhere must leave as
    it is (K1-K3 in both storages and precisions, K4 in both storages, the
    square form of K3's reduce mode and its second pass), else None."""
    inst = _instance(symbol)
    if inst and (inst["kernel"] in ("fwht", "whvi_fused")
                 or inst["kernel"] in ("whvi_bwd_sums", "whvi_sum_runs") and "stacked" not in inst):
        return tuple(sorted(inst.items()))
    return None


def held_ptxas(report: str) -> dict:
    """The ptxas rows of the held instances, by instance."""
    return {key: {k: row.get(k) for k in _SAME}
            for symbol, row in ptxas(report).items() if (key := _held(symbol))}


def held_sass(lib: str) -> dict:
    """The SASS text of the held instances in ``lib`` (``cuobjdump``), by
    instance: equal text is the same machine code."""
    sass = subprocess.run(["cuobjdump", "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    out, key = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            key = _held(m.group(1))
            if key:
                out[key] = []
        elif key and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[key].append(" ".join(line.split()))  # cuobjdump pads columns to the library's widest
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--root", default=os.path.join(fc.BUILD_DIR, "variants"))
    ap.add_argument("--parent", help="a checkout whose sources run as the variant 'parent'")
    ap.add_argument("--rounds", type=int, default=1, help="times the order of variants is run")
    args = ap.parse_args(argv)
    if unknown := set(args.variants) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(unknown)}")
    header("kernel_variants")
    names = list(dict.fromkeys(["base", *(args.variants or VARIANTS)]))
    if args.parent:
        names.append("parent")
    libs, reports = build(names, args.root, args.parent)
    base_ptxas, base_sass = held_ptxas(reports["base"]), held_sass(libs["base"])
    for name in names:
        for symbol, row in sorted(ptxas(reports[name]).items()):
            inst = _instance(symbol)
            if inst and inst["kernel"] in ("whvi_fused", "whvi_bwd_sums", "column") and inst["L"] in PTXAS_LOG2D:
                emit({"variant": name, "ptxas": True, **inst, **row})
        own, sass = held_ptxas(reports[name]), held_sass(libs[name])
        emit({"variant": name, "held_ptxas_as_base": own == base_ptxas,
              "held_sass_as_base": sass == base_sass, "held_instances": len(own),
              "differ": [dict(k) for k in base_ptxas
                         if own.get(k) != base_ptxas[k] or sass.get(k) != base_sass.get(k)]})
    dev = torch.device("cuda")
    runs = cases(dev)
    order = [n for n in names if n != "parent"]
    order = [*order, "base"] if len(order) > 1 else order
    if args.parent:
        order = ["parent", *order, "parent"]
    for name in order * args.rounds:
        use_library(libs[name])
        if name not in DIAGNOSTIC:
            check(name, dev)
        has_column = hasattr(fc.load_library(), "column_bf16s")
        has_sums = hasattr(fc.load_library(), "whvi_bwd_sums_f32")
        has_stacked = hasattr(fc.load_library(), "whvi_bwd_sums_stacked_f32")
        for kernel, label, call, ins, outs in runs:
            if (kernel.startswith("column") and not has_column) or (
                    kernel == "fused_bwd_sums" and not has_sums) or (
                    kernel == "fused_bwd_sums_stacked" and not has_stacked):
                continue
            ms = time_us(call, 20) / 1e3
            bound, _ = bound_ms(ins, outs, 0.0, 1.0)
            emit({"variant": name, "kernel": kernel, "shape": label, "ms": ms,
                  "bound_ms": bound, "share": bound / ms})


if __name__ == "__main__":
    main()
