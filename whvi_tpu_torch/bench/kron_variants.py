"""``k_scale``, ``emit_copy``, ``hbm_copy``, ``k_swap``, ``k_cur``,
``k_full``, ``k_mm1`` and ``k_mm2`` built from variants of their CUDA
sources and timed side by side on one card: what each choice of their
designs is worth.

A variant is a copy of ``whvi_tpu_torch/csrc/`` with named edits
(``VARIANTS``): a ring's shape changed, another body put in, or a design
switch turned over. Each edit is a piece of source text that must occur
exactly once in its file, so a variant never times the shipped source by
mistake; a change to those lines needs the variant edited too. A variant
without edits (``SHIPPED``) names the shipped design.

Each variant's edited source alone is compiled into its own library, all
at once, and called through its C entry (``kron_stage_f32``,
``kron_full_f32``, ``kron_pipe_f32`` or ``copy_hbm_f32``) with ``ctypes``.
Every variant is first held against its plain version at D=16384, B=512
and at the ring's edges (``EDGES``): bit for bit (``x * s1``, ``x``), or
the products within ``kron_cuda.tol`` of their plain version; a
``k_cur``, ``k_full``, ``k_mm1`` or ``k_mm2`` variant also bit for bit
against the package's kernel (every form does the same arithmetic).

JSON rows: first the card and its power limit; then per variant the
ptxas report of its kernels (registers, spill bytes); then the device ms
a call (``time_us``: 20 calls in a CUDA graph, median of 5 replays) at
D=16384, B=512, with the bound (x read once, the diagonals it reads once,
y written once, over 3.35 TB/s) and its share: the scale variants at
TB=4, ``hbm_copy``'s untiled, the others at TB = 4, 64, 128, 256. The
yardsticks, one PyTorch call (``x * s1``, ``x.clone()``), the package's
``k_copy``, ``copy_2d``, ``emit_copy``, ``k_swap`` and ``k_cur``, and K1's
bf16 mode (the same rounding schedule from D = 2048), run first and last,
so that drift of the card's clock shows.

Run from the repository root on the card:
python -m whvi_tpu_torch.bench.kron_variants [k_mm1 mm1_s2_smem k_full ...]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import shutil

import torch

from whvi_tpu_torch.bench.common import bound_ms, emit, header, rel_err, time_us
from whvi_tpu_torch.bench.kernel_sass import _instance, ptxas
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import kron_cuda as kc

KRON, FULL, PIPE, COPY = "whvi_kron.cu", "whvi_full.cu", "whvi_pipe.cu", "copy_floor.cu"
# each kind of variant: (its file, the wrapper whose kernel it edits, the
# tiles it is timed at)
KINDS = {
    "scale": (KRON, "k_scale", (4,)),
    "copy": (PIPE, "emit_copy", (4, 64, 128, 256)),
    "hbm": (COPY, "hbm_copy", (None,)),  # untiled
    "swap": (KRON, "k_swap", (4, 64, 128, 256)),
    "cur": (KRON, "k_cur", (4, 64, 128, 256)),
    "full": (FULL, "k_full", (4, 64, 128, 256)),
    "mm1": (FULL, "k_mm1", (4, 64, 128, 256)),
    "mm2": (FULL, "k_mm2", (4, 64, 128, 256)),
}
PRODUCTS = ("swap", "cur", "full", "mm1", "mm2")  # the kinds that compute a product
CONTRACTIONS = {"full": 4, "mm1": 1, "mm2": 2}  # the kinds of kron_full_f32
BIT_EQUAL = ("cur", "full", "mm1", "mm2")  # kinds whose variants equal the package's kernel
D, B = 16384, 512
COPY_TBS = KINDS["copy"][2]
# (D, B, tb) checked bit for bit beside (D, B, 4): one-row tiles, far
# more chunks than the grid; tiles of less than a stage; a full chunk and
# a short one; every block around its ring more than once; two tiles
EDGES = [(128, 4096, 1), (1024, 96, 3), (2048, 48, 3), (1024, 8192, 8), (16384, 512, 256)]

# s1 staged in shared memory once a block, then read from there
_SMEM_S1 = [
    ("    const int dmask4 = (D >> 2) - 1;\n    for (int64_t q0",
     "    const int dmask4 = (D >> 2) - 1;\n"
     "    extern __shared__ __align__(16) float4 s_tile[];\n"
     "    for (int q = threadIdx.x; q <= dmask4; q += kThreads) s_tile[q] = __ldg(ss + q);\n"
     "    __syncthreads();\n"
     "    for (int64_t q0"),
    ("if (q < n4) s[k] = __ldg(ss + (q & dmask4));", "if (q < n4) s[k] = s_tile[q & dmask4];"),
    ("  kron_kernel<kStage><<<(unsigned)(B / tb), kThreads, 0, stream>>>(x, s1, y, log2d, tb);\n",
     "  const size_t smem = kStage == kScale ? sizeof(float) << log2d : 0;\n"
     "  if (smem > 48 * 1024) {\n"
     "    const cudaError_t err = cudaFuncSetAttribute(\n"
     "        kron_kernel<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n"
     "    if (err != cudaSuccess) return err;\n"
     "  }\n"
     "  kron_kernel<kStage><<<(unsigned)(B / tb), kThreads, smem, stream>>>(x, s1, y, log2d, tb);\n"),
]

# emit_copy's consumers copying each stage into a second ring in shared
# memory (kCopyOutStages stages after the in-ring), which thread 0
# bulk-stores once the consumers have met on a named barrier: the skeleton
# a compute body would fit into. It replaces the shipped consumers' body,
# from the first marker through the second.
_OUT_RING = [
    ("constexpr size_t kCopyRingBytes = (size_t)kCopyInStages * kCopyStageBytes;",
     "constexpr int kCopyOutStages = 2;\n"
     "constexpr size_t kCopyRingBytes = (size_t)(kCopyInStages + kCopyOutStages) * kCopyStageBytes;"),
    (("  // the consumers: chunk j from stage j % kCopyInStages\n",
            "    if (lane == 0) tma::barrier_arrive(&empty[s]);\n  }\n"),
     """  // the consumers: chunk j from in-stage j % kCopyInStages through
  // out-stage j % kCopyOutStages
  static_assert(kCopyOutStages >= 2, "a store drains while the next chunk is copied");
  unsigned char* out = smem + (size_t)kCopyInStages * kCopyStageBytes;
  for (int64_t j = 0; j < mine; ++j) {
    const int s = (int)(j % kCopyInStages);
    uint32_t bytes;
    const int64_t off = chunk(j, bytes);
    const float4* src = reinterpret_cast<const float4*>(in + (size_t)s * kCopyStageBytes);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)(j % kCopyOutStages) * kCopyStageBytes);
    tma::wait_parity(&full[s], (uint32_t)((j / kCopyInStages) & 1));
    for (int q = threadIdx.x; q < (int)(bytes / 16); q += kCopyConsumers) dst[q] = src[q];
    __syncwarp();
    if (lane == 0) tma::barrier_arrive(&empty[s]);
    tma::fence_proxy_async();
    // the store of chunk j + 1 - kCopyOutStages has read chunk j + 1's out-stage
    if (threadIdx.x == 0) tma::bulk_wait_read<kCopyOutStages - 2>();
    asm volatile("bar.sync 1, %0;\\n" ::"n"(kCopyConsumers) : "memory");  // consumers only
    if (threadIdx.x == 0) {
      tma::bulk_store(y + off, dst, bytes);
      tma::bulk_commit();
    }
  }
  if (threadIdx.x == 0) tma::bulk_wait_all();
"""),
]


def _hbm_regs(per_sm: int) -> list:
    """hbm_copy as k_copy's register loop (8 streaming float4 loads a
    thread before their stores) over a persistent grid-stride of per_sm
    blocks of 256 threads an SM, in place of the ring."""
    return [
        ("cudaError_t sm_count(int* sms) {\n",
         """constexpr int kRegThreads = 256, kRegUnroll = 8;

__global__ void __launch_bounds__(kRegThreads)
    hbm_copy_regs(const float4* __restrict__ x, float4* __restrict__ y, int64_t n4) {
  const int64_t step = (int64_t)gridDim.x * kRegThreads * kRegUnroll;
  for (int64_t q0 = (int64_t)blockIdx.x * kRegThreads * kRegUnroll + threadIdx.x; q0 < n4;
       q0 += step) {
    float4 v[kRegUnroll];
#pragma unroll
    for (int k = 0; k < kRegUnroll; ++k) {
      const int64_t q = q0 + k * kRegThreads;
      if (q < n4) v[k] = __ldcs(x + q);
    }
#pragma unroll
    for (int k = 0; k < kRegUnroll; ++k) {
      const int64_t q = q0 + k * kRegThreads;
      if (q < n4) __stcs(y + q, v[k]);
    }
  }
}

cudaError_t sm_count(int* sms) {
"""),
        ("  return (int)launch_ring(x, y, 1, n * (int64_t)sizeof(float), "
         "static_cast<cudaStream_t>(stream));\n",
         f"""  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t n4 = n / 4, per_block = (int64_t)kRegThreads * kRegUnroll;
  const int64_t need = (n4 + per_block - 1) / per_block, cap = (int64_t)sms * {per_sm};
  hbm_copy_regs<<<(unsigned)(need < cap ? need : cap), kRegThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return (int)cudaGetLastError();
"""),
    ]


def _ring(stage_kb=None, ins=None, outs=None, per_sm=None, warps=None) -> list:
    """Edits of emit_copy's ring constants (``outs`` after ``_OUT_RING``)."""
    out = []
    for name, value, shipped in (
        ("kCopyStageBytes", stage_kb and f"{stage_kb} * 1024", "16 * 1024"),
        ("kCopyInStages", ins, 6),
        ("kCopyOutStages", outs, 2),
        ("kCopyBlocksPerSm", per_sm, 2),
        ("kCopyConsumerWarps", warps, 4),
    ):
        if value is not None:
            out.append((f"constexpr int {name} = {shipped};", f"constexpr int {name} = {value};"))
    return out


# the row kernels (k_swap, k_cur) without the TMA prefetch of the next row
# block's x; a variant builds and times one kind, so one switch serves both
_NO_ROW_PREFETCH = [("constexpr bool kRowPrefetch = true;",
                     "constexpr bool kRowPrefetch = false;")]

# k_full's design switches: u and s1 loaded from L2 every group (under the
# product before their epilogue) instead of held in registers for the
# whole kernel; y through the operand tile and TMA bulk stores instead of
# st.global.cs from registers
_DIAG_L2 = [("constexpr bool kFullDiagRegs = true;", "constexpr bool kFullDiagRegs = false;")]
_TMA_STORE = [("constexpr bool kFullTmaStore = false;", "constexpr bool kFullTmaStore = true;")]

# k_mm1's and k_mm2's design switches: s2 in shared memory (as at 4
# contractions) or in registers at either count; the ring's slots beside
# s2 in registers; y through the tile and TMA bulk stores; whole groups a
# warpgroup (kron_whole_kernel)
def _s2_regs(up_to: int) -> list:
    return [("constexpr int kMmS2Regs = 1;", f"constexpr int kMmS2Regs = {up_to};")]


def _mm_slots(n: int) -> list:
    return [("constexpr int kMmSlots = 3;", f"constexpr int kMmSlots = {n};")]


_MM_TMA_STORE = [("constexpr bool kMmTmaStore = false;", "constexpr bool kMmTmaStore = true;")]
_WHOLE_GROUP = [("constexpr bool kMmWholeGroup = false;", "constexpr bool kMmWholeGroup = true;")]

# name -> (kind, edits of its file, KINDS); the shipped emit_copy: 6
# stages of 16 KB, two blocks an SM, 4 consumer warps storing from the
# ring; the shipped hbm_copy: copy_2d's ring over one tile; the shipped
# k_swap and k_cur: the next row block's x prefetched by TMA; the shipped
# k_full: u and s1 in registers, y stored from registers; the shipped
# k_mm1: s2 in registers, 3 slots; k_mm2: s2 in shared memory, 3 slots;
# both storing y from registers, the warpgroups splitting each group's rows
VARIANTS = {
    "k_scale": ("scale", []),
    "scale_smem_s1": ("scale", _SMEM_S1),
    "emit_copy": ("copy", []),
    "direct_4in_x2": ("copy", _ring(ins=4)),
    "direct_4in_x3": ("copy", _ring(ins=4, per_sm=3)),
    "direct_12in_x1": ("copy", _ring(ins=12, per_sm=1)),
    "direct_32k_3in_x2": ("copy", _ring(stage_kb=32, ins=3)),
    "direct_8k_12in_x2": ("copy", _ring(stage_kb=8, ins=12)),
    "direct_2warps": ("copy", _ring(warps=2)),
    "out_ring_x2": ("copy", _OUT_RING + _ring(ins=4)),
    "out_ring_6in_3out_x1": ("copy", _OUT_RING + _ring(outs=3, per_sm=1)),
    "out_ring_8in_4out_x1": ("copy", _OUT_RING + _ring(ins=8, outs=4, per_sm=1)),
    "out_ring_32k_x1": ("copy", _OUT_RING + _ring(stage_kb=32, ins=4, per_sm=1)),
    "out_ring_8k_x2": ("copy", _OUT_RING + _ring(stage_kb=8, ins=8, outs=4)),
    "hbm_copy": ("hbm", []),
    "hbm_regs_x4": ("hbm", _hbm_regs(4)),
    "hbm_regs_x8": ("hbm", _hbm_regs(8)),
    "k_swap": ("swap", []),
    "swap_no_prefetch": ("swap", _NO_ROW_PREFETCH),
    "k_cur": ("cur", []),
    "cur_no_prefetch": ("cur", _NO_ROW_PREFETCH),
    "k_full": ("full", []),
    "full_diag_l2": ("full", _DIAG_L2),
    "full_tma_store": ("full", _TMA_STORE),
    "k_mm1": ("mm1", []),
    "mm1_s2_smem": ("mm1", _s2_regs(0)),
    "mm1_slots2": ("mm1", _mm_slots(2)),
    "mm1_slots4": ("mm1", _mm_slots(4)),
    "mm1_tma_store": ("mm1", _MM_TMA_STORE),
    "mm1_whole_group": ("mm1", _WHOLE_GROUP),
    "k_mm2": ("mm2", []),
    "mm2_s2_regs": ("mm2", _s2_regs(2)),
    "mm2_s2_regs_slots2": ("mm2", _s2_regs(2) + _mm_slots(2)),
    "mm2_tma_store": ("mm2", _MM_TMA_STORE),
    "mm2_whole_group": ("mm2", _WHOLE_GROUP),
}
SHIPPED = tuple(name for name, (_, edits) in VARIANTS.items() if not edits)


def _edit(text: str, old, new: str, name: str, f: str) -> str:
    """``old`` replaced by ``new``; ``old`` a (first, last) pair of
    markers stands for the text from the first through the last."""
    for marker in old if isinstance(old, tuple) else (old,):
        if text.count(marker) != 1:
            raise ValueError(f"variant {name}: {marker!r} occurs {text.count(marker)} times in {f}")
    if isinstance(old, tuple):
        start, end = text.index(old[0]), text.index(old[1]) + len(old[1])
        if end <= start:
            raise ValueError(f"variant {name}: the markers of {f} are out of order")
        return text[:start] + new + text[end:]
    return text.replace(old, new)


def make_source(name: str, root: str) -> str:
    """``root/name/csrc/<file>``, the variant's edited source beside copies
    of the headers; raises if an edit does not match exactly once."""
    kind, edits = VARIANTS[name]
    f = KINDS[kind][0]
    d = os.path.join(root, name, "csrc")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(fc.CSRC, d)
    path = os.path.join(d, f)
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        text = _edit(text, old, new, name, f)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def build(names, root: str) -> tuple[dict, dict]:
    """Each variant's library and nvcc's report, all compiled at once."""
    nvcc = fc._nvcc()
    libs = {n: os.path.join(root, n, "lib.so") for n in names}
    cmds = {n: [nvcc, *fc.NVCC_FLAGS, "-shared", "-o", libs[n], make_source(n, root)] for n in names}
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(lambda n: fc._run_all([cmds[n]]), names)))
    return libs, reports


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn, args in (
        ("kron_stage_f32", [vp] * 5 + [i64, i32, i32, i32, i32, vp]),
        ("kron_full_f32", [vp] * 5 + [i64, i32, i32, i32, vp]),
        ("kron_pipe_f32", [vp, vp, i64, i32, i32, vp]),
        ("copy_hbm_f32", [vp, vp, i64, vp]),
    ):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def caller(lib, kind: str, diagonals, x, y, tb):
    """A call of the variant's kernel on the current stream: y = x * s1
    (``scale``), y = x (``copy``, ``hbm``), the whole product (``swap``,
    ``cur``, ``full``) or its first one or two contractions (``mm1``,
    ``mm2``); ``diagonals`` is (s1, u, s2)."""
    log2d = x.shape[1].bit_length() - 1
    s1, u, s2 = (d.data_ptr() for d in diagonals)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if kind in CONTRACTIONS:
            err = lib.kron_full_f32(x.data_ptr(), s1, u, s2, y.data_ptr(), x.shape[0], log2d, tb,
                                    CONTRACTIONS[kind], stream)
        elif kind in ("scale", "swap", "cur"):
            stage, layout = ("scale", "flat") if kind == "scale" else ("full", kind)
            err = lib.kron_stage_f32(x.data_ptr(), s1, u, s2, y.data_ptr(), x.shape[0], log2d, tb,
                                     kc._STAGES[stage], kc._LAYOUTS[layout], stream)
        elif kind == "hbm":
            err = lib.copy_hbm_f32(x.data_ptr(), y.data_ptr(), x.numel(), stream)
        else:
            err = lib.kron_pipe_f32(x.data_ptr(), y.data_ptr(), x.shape[0], log2d, tb, stream)
        if err:
            raise RuntimeError(f"{kind} variant launch failed: cudaError_t {err}")
        return y

    return call


def _diagonals(d: int, gen):
    return [torch.randn(d, device=gen.device, generator=gen) for _ in range(3)]


def check(name: str, lib, dev) -> None:
    kind = VARIANTS[name][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    for d, b, tb in [(D, B, 4), *EDGES]:
        diagonals = _diagonals(d, gen)
        x = torch.randn(b, d, device=dev, generator=gen)
        y = torch.full_like(x, float("nan"))
        caller(lib, kind, diagonals, x, y, tb)()
        if kind in PRODUCTS:
            wrapper = KINDS[kind][1]
            want = kc.plain(wrapper, *diagonals, x)
            ok = bool(torch.isfinite(y).all()) and rel_err(y, want) <= kc.tol(wrapper, d)
            if kind in BIT_EQUAL:
                ok = ok and torch.equal(y, kc.VARIANTS[wrapper](*diagonals, x, tb))
        else:
            ok = torch.equal(y, x * diagonals[0] if kind == "scale" else x)
        if not ok:
            raise AssertionError(f"variant {name}: D={d} B={b} tb={tb} is wrong")


def _row(label, tb, ms, bound) -> dict:
    return emit({"variant": label, "D": D, "B": B, "TB": tb, "ms": ms,
                 "bound_ms": bound, "share": bound / ms})


def _bound(kind: str, diagonals, x) -> float:
    """Bytes over 3.35 TB/s: x, the diagonals the kind reads, y."""
    reads = {"scale": diagonals[:1], "mm1": diagonals[2:], "mm2": diagonals[2:]}.get(
        kind, diagonals if kind in PRODUCTS else ())
    return bound_ms((x, *reads), (x,), 0.0, 1.0)[0]


def yardsticks(diagonals, x) -> None:
    s1, u, s2 = diagonals
    copy_bound, swap_bound = _bound("copy", diagonals, x), _bound("swap", diagonals, x)
    _row("x * s1", None, time_us(lambda: x * s1, 20) / 1e3, _bound("scale", diagonals, x))
    _row("x.clone()", None, time_us(x.clone, 20) / 1e3, copy_bound)
    _row("k_copy (package)", 4, time_us(lambda: kc.k_copy(s1, s1, s1, x, 4), 20) / 1e3, copy_bound)
    for tb in COPY_TBS:
        ms = time_us(lambda: kc.copy_2d(s1, s1, s1, x, tb), 20) / 1e3
        _row("copy_2d (package)", tb, ms, copy_bound)
    _row("emit_copy (package)", 4, time_us(lambda: kc.emit_copy(s1, s1, s1, x, 4), 20) / 1e3, copy_bound)
    _row("k_swap (package)", 4, time_us(lambda: kc.k_swap(s1, u, s2, x, 4), 20) / 1e3, swap_bound)
    _row("k_cur (package)", 4, time_us(lambda: kc.k_cur(s1, u, s2, x, 4), 20) / 1e3, swap_bound)
    ms = time_us(lambda: fc.fused_raw(s1, u, s2, x, False, "bf16"), 20) / 1e3
    _row("K1 bf16 (fused_y_bf16)", None, ms, swap_bound)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--root", default=os.path.join(fc.BUILD_DIR, "kron_variants"))
    args = ap.parse_args(argv)
    if unknown := set(args.variants) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(unknown)}")
    header("kron_variants")
    names = args.variants or list(VARIANTS)
    libs, reports = build(names, args.root)
    for name in names:
        for symbol, row in sorted(ptxas(reports[name]).items()):
            inst = _instance(symbol)
            if inst and inst["kernel"] == KINDS[VARIANTS[name][0]][1]:
                emit({"variant": name, "ptxas": True, **inst, **row})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    diagonals = _diagonals(D, gen)
    x = torch.randn(B, D, device=dev, generator=gen)
    y = torch.empty_like(x)
    yardsticks(diagonals, x)
    for name in names:
        lib = load(libs[name])
        check(name, lib, dev)
        kind = VARIANTS[name][0]
        bound = _bound(kind, diagonals, x)
        for tb in KINDS[kind][2]:
            _row(name, tb, time_us(caller(lib, kind, diagonals, x, y, tb), 20) / 1e3, bound)
    yardsticks(diagonals, x)


if __name__ == "__main__":
    main()
