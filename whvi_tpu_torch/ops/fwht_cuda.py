"""Hand-written CUDA kernels for the WHVI product and the FWHT.

Counterpart of :mod:`whvi_tpu.ops.fwht_pallas`. Four kernels live in
``whvi_tpu_torch/csrc/`` (the fused product in fp32 storage,
``whvi_fused.cu``, and in bf16 storage, ``whvi_bf16s.cu``; the bare
transform, ``fwht.cu``; the column head in bf16 storage,
``whvi_column.cu``) and are used sixteen ways:

=======================  ====================================  ==================================
launch counter           wrapper                               replaces (whvi_tpu/ops/fwht_pallas.py)
=======================  ====================================  ==================================
``fused_y``              ``fused_raw(.., False)``              ``_kernel_1f_y`` / ``_kernel_2f_y``
``fused_res``            ``fused_raw(.., True)``               ``_kernel_1f`` / ``_kernel_2f``
``fused_bwd``            ``fused_bwd_raw``                     the transform half of ``_bwd``
``fused_bwd_sums``       ``fused_bwd_sums_raw``                all of ``_bwd``
``fwht``                 ``fwht_raw``                          ``_kernel_1f_t`` / ``_kernel_2f_t``
``fused_y_bf16``         ``fused_raw(.., False, "bf16")``      ``_kernel_1f_y`` / ``_kernel_2f_y``
``fused_res_bf16``       ``fused_raw(.., True, "bf16")``       ``_kernel_1f`` / ``_kernel_2f``
``fused_bwd_bf16``       ``fused_bwd_raw(.., "bf16")``         the transform half of ``_bwd``
``fused_bwd_sums_bf16``  ``fused_bwd_sums_raw(.., "bf16")``    all of ``_bwd``
``fused_y_bf16s``        ``fused_raw(.., False)`` on bf16      ``_kernel_1f_y`` / ``_kernel_2f_y``
``fused_res_bf16s``      ``fused_raw(.., True)`` on bf16       ``_kernel_1f`` / ``_kernel_2f``
``fused_bwd_bf16s``      ``fused_bwd_raw`` on bf16             the transform half of ``_bwd``
``fwht_bf16s``           ``fwht_raw`` on bf16                  ``_kernel_1f_t`` / ``_kernel_2f_t``
``column_y_bf16s``       ``column_raw(.., False)``             ``_kernel_1f_t`` / ``_kernel_2f_t``
``column_res_bf16s``     ``column_raw(.., True)``              ``_kernel_1f_t`` / ``_kernel_2f_t``
``column_bwd_bf16s``     ``column_bwd_raw``                    ``_kernel_1f_t`` / ``_kernel_2f_t``
=======================  ====================================  ==================================

The grouped product (:mod:`whvi_tpu_torch.ops.grouped`, ``whvi_grouped.cu``:
a WHVI matrix a segment of rows, the expert layer's) counts here too:
``fused_grouped_y``, ``fused_grouped_res`` and ``fused_grouped_bwd_sums``
(K1, K2 and K3 with its sums), ``_bf16`` after each in the bf16 mode.

K3's reduce mode (``fused_bwd_sums``) is the backward of a square product
whose ``s1`` and ``s2`` are one ``(D,)`` row and whose ``u`` is one row, or
one a sample (:func:`sums_group`): it sums ``ds1``, ``du`` and ``ds2`` from
its registers and stores neither ``w1``, ``t2`` nor any product.
:class:`WhviMulFunction` takes it for such operands on a card, and K3 with
PyTorch's reductions for every other product.

Precision. The Pallas product takes ``precision="fp32" | "bf16"``, and
``"bf16"`` is its default (``_fused_raw``, ``whvi_mul_pallas``) and the
only mode the JAX main path reaches. The fused wrappers take the same
argument (default ``"fp32"``):

- ``"fp32"`` reproduces ``precision="fp32"`` (H stored fp32, the MXU at
  ``Precision.HIGHEST``): the butterflies round nothing below fp32.
- ``"bf16"`` reproduces ``precision="bf16"``: the operand of each factor
  contraction is rounded to bf16 (round to nearest even) and the sums
  stay fp32, at the Pallas bodies' points and in their order of factors
  (:func:`fused_plain`). It takes ``4 <= D <= 16384``
  (``pallas_supported``) and raises outside it, on every device.

The bare FWHT (``fwht``) reproduces ``fwht_pallas``'s default,
``precision="fp32"``.

Storage. Every tensor of a call is float32 or every one bfloat16 (the
JAX package's ``dtype=bfloat16``); the ``_bf16s`` counters count the
bf16-storage launches. On bf16 leaves the JAX package computes the XLA
expression ``s1 * fwht(u * fwht(s2 * x))``, each op rounding to bf16 (R,
to nearest even) and each transform summing in fp32::

    t0 = R(s2 x), i1 = R(H t0), t1 = R(u i1), i2 = R(H t1), y = R(s1 i2)

and the bare transform ``R(H x)``; the column head's rows ``s1_0 * H(g)
* s2`` as ``y = R(R(s1_0 t) s2)``, ``t = R(H g)`` (:func:`column_plain`).
The plain versions compute exactly that (PyTorch's bf16 ops round where
XLA's do; :func:`fwht_plain` transforms in fp32 and rounds once), and the
kernels do too, bit for bit.
Only the ``"fp32"`` precision has a bf16-storage form: the Pallas
kernels cannot store bf16 (their output stores raise on bf16 refs,
``whvi_tpu/ops/fwht_pallas.py:121-204``), so ``"bf16"`` on bf16 storage
raises here, on every device.

Each wrapper dispatches on the device of its tensors alone: CPU tensors
go to the plain PyTorch version beside it (:func:`fused_plain`,
:func:`fwht_plain`); CUDA tensors launch the kernel or raise. There is
no fallback from one to the other.

Alignment. The kernels hold a row in registers and move it to and from
device memory in vectors: ``float4``s in fp32, 8 or 16 bytes of bf16
(``csrc/fwht_core.cuh``, ``csrc/whvi_bf16s.cu``). Rows must start on :func:`vector_bytes`
(16 bytes, less only where a whole row is shorter), which the bf16
C entries also check. Before a launch every operand is checked
(:func:`vector_aligned`): its base pointer and every leading stride it
is read through must be multiples of that width. An operand that is not
is copied into a fresh allocation (PyTorch's are 512-byte aligned),
stride-0 axes kept, and :data:`REALIGNED` counts the copy. The main
path's operands never need one.

Build: at the first launch, ``nvcc`` compiles each of ``SOURCES`` for
``sm_90a``, all at once, and links them into one shared library with a
plain C interface under ``build/whvi_tpu_torch/`` beside the package,
which ``ctypes`` loads. The library also holds the kernels of the
large-D diagnosis path (:mod:`whvi_tpu_torch.ops.kron_cuda`). Nothing
here is imported or built while the module is imported.

The autograd Functions are device-agnostic: their forward and backward
call the raw wrappers, so on the CPU the backward algebra (the s1/s2 swap,
the residuals, the ``sum_to_size`` reductions) runs through the plain
versions.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from whvi_tpu_torch.ops.hadamard import PRECISIONS, factor_H, is_pow_of_2, round_bf16
from whvi_tpu_torch.ops.hadamard import fwht as fwht_plain
from whvi_tpu_torch.utils.profiling import span

__all__ = [
    "ColumnFunction",
    "FwhtFunction",
    "LAUNCHES",
    "MAX_D",
    "MIN_D_BF16",
    "PRECISIONS",
    "REALIGNED",
    "WhviMulFunction",
    "bf16_tol",
    "build_kernels",
    "check_kernel_args",
    "check_precision",
    "check_storage",
    "column_bwd_plain",
    "column_bwd_raw",
    "column_floor",
    "column_head",
    "column_plain",
    "column_raw",
    "fused_bwd_raw",
    "fused_bwd_sums_plain",
    "fused_bwd_sums_raw",
    "fused_plain",
    "fused_raw",
    "fwht_cuda",
    "fwht_plain",
    "fwht_raw",
    "load_library",
    "reset_launches",
    "sums_group",
    "vector_aligned",
    "vector_bytes",
    "vjp_plain",
]

MAX_D = 16384
MIN_D_BF16 = 4  # pallas_supported: 4 <= D <= 16384
LANE = 128  # H_128, the last Kronecker factor of the two-factor bodies
ONE_FACTOR_MAX = 1024  # D <= 1024: one factor H_D (_factor_pair)
SUMS_MAX_D = 8192  # K3's reduce mode (csrc/whvi_fused.cu, kSumsMaxLog2D)
SUMS_BLOCKS = 256  # the reduce mode's least grid: about two blocks for each of 132 SMs

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = (
    "whvi_fused.cu", "whvi_bf16s.cu", "fwht.cu", "whvi_column.cu", "whvi_kron.cu", "whvi_full.cu",
    "whvi_pipe.cu", "copy_floor.cu", "whvi_grouped.cu",
)
_HEADERS = ("fwht_core.cuh", "whvi_fused.cuh", "kron_core.cuh", "tma.cuh", "wgmma.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "whvi_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libwhvi_kernels.so")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {
    "fused_y": 0, "fused_res": 0, "fused_bwd": 0, "fused_bwd_sums": 0, "fwht": 0,
    "fused_y_bf16": 0, "fused_res_bf16": 0, "fused_bwd_bf16": 0, "fused_bwd_sums_bf16": 0,
    "fused_y_bf16s": 0, "fused_res_bf16s": 0, "fused_bwd_bf16s": 0, "fwht_bf16s": 0,
    "column_y_bf16s": 0, "column_res_bf16s": 0, "column_bwd_bf16s": 0,
    "fused_grouped_y": 0, "fused_grouped_res": 0, "fused_grouped_bwd_sums": 0,
    "fused_grouped_y_bf16": 0, "fused_grouped_res_bf16": 0, "fused_grouped_bwd_sums_bf16": 0,
}
# The Kernel layer's span of each launch: ``whvi.kernel.<counter>``.
KERNEL_SPANS = {name: "whvi.kernel." + name for name in LAUNCHES}
STORAGE = (torch.float32, torch.bfloat16)  # the kernels' element types

# Operands copied to an aligned allocation before a launch, since the
# last reset_launches(); not a kernel launch.
REALIGNED = 0


def reset_launches() -> None:
    global REALIGNED
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    REALIGNED = 0


class _Geometry(ctypes.Structure):
    """``whvi::Geometry`` of ``csrc/fwht_core.cuh``."""

    _fields_ = [
        ("size", ctypes.c_int64 * 4),
        ("stride", ctypes.c_int64 * 16),  # [operand][dim], row-major
    ]


_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; return their output, or raise with the
    output of those that failed. Every process has ended on return."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [
        f"exit code {p.returncode}: {' '.join(c)}\n{out}"
        for c, p, out in zip(cmds, procs, outs)
        if p.returncode != 0
    ]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def build_kernels() -> str:
    """Compile ``SOURCES`` (one nvcc each, all started together) and link
    them into :data:`LIB_PATH`; return nvcc's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    tmp = os.path.join(BUILD_DIR, f".libwhvi_kernels.{tag}.so")
    try:
        report = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs)
        ])
        report += _run_all([[nvcc, *_ARCH, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, LIB_PATH)  # atomic: no process loads a half-written file
    return report


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > built
        for f in SOURCES + _HEADERS
    )


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build_kernels()
            lib = ctypes.CDLL(LIB_PATH)
            vp = ctypes.c_void_p
            i32, i64 = ctypes.c_int, ctypes.c_int64
            for name in ("whvi_fused_f32", "whvi_fused_bf16s"):
                getattr(lib, name).argtypes = [vp] * 7 + [
                    i32, i32, i64, i32, ctypes.POINTER(_Geometry), vp,
                ]
                getattr(lib, name).restype = ctypes.c_int
            if hasattr(lib, "whvi_bwd_sums_f32"):  # not in a build of older sources (a parent's)
                lib.whvi_bwd_sums_f32.argtypes = [vp] * 9 + [
                    i64, i32, i32, i32, ctypes.POINTER(_Geometry), vp,
                ]
                lib.whvi_sum_runs_f32.argtypes = [vp] * 4 + [i64, i64, i32, vp]
                for name in ("whvi_bwd_sums_f32", "whvi_sum_runs_f32"):
                    getattr(lib, name).restype = ctypes.c_int
            for name in ("fwht_f32", "fwht_bf16s"):
                getattr(lib, name).argtypes = [vp, vp, i64, i32, vp]
                getattr(lib, name).restype = ctypes.c_int
            if hasattr(lib, "column_bf16s"):  # not in a build of older sources (a parent's)
                lib.column_bf16s.argtypes = [i32] + [vp] * 7 + [
                    i64, i32, ctypes.POINTER(_Geometry), vp,
                ]
                lib.column_nop.argtypes = [i64, i32, vp]
                for name in ("column_bf16s", "column_nop"):
                    getattr(lib, name).restype = ctypes.c_int
            if hasattr(lib, "whvi_grouped_f32"):  # not in a build of older sources (a parent's)
                from whvi_tpu_torch.ops.grouped import _argtypes

                _argtypes(lib)
            # the kernels of ops/kron_cuda.py
            for name, args in (
                ("kron_stage_f32", [vp] * 5 + [i64, i32, i32, i32, i32, vp]),
                ("kron_full_f32", [vp] * 5 + [i64, i32, i32, i32, vp]),
                ("kron_pipe_f32", [vp, vp, i64, i32, i32, vp]),
                ("copy_hbm_f32", [vp, vp, i64, vp]),
                ("copy_2d_f32", [vp, vp, i64, i32, i32, vp]),
            ):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = ctypes.c_int
            _lib = lib
        return _lib


# ------------------------------------------------------------ plain versions


def check_storage(precision: str, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for the ``"bf16"`` precision on bf16 storage:
    the Pallas kernels it reproduces cannot store bf16 (in interpret mode
    ``whvi_mul_pallas`` raises "Invalid dtype for swap" at its output
    stores, ``whvi_tpu/ops/fwht_pallas.py:121-204``), so the JAX package
    has no such product to port."""
    if precision == "bf16" and dtype == torch.bfloat16:
        raise ValueError(
            "the bf16 precision takes float32 storage: the JAX Pallas kernels "
            "it reproduces cannot store bf16 (their output stores raise on "
            "bf16 refs); bf16 storage computes the fp32 precision's XLA "
            "expression, rounding each op to bf16"
        )


def check_precision(D: int, precision: str, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``precision`` is a mode of the fused product and, for
    ``"bf16"``, ``D`` a power of two in ``[4, 16384]`` (the range of
    ``pallas_supported``, ``whvi_tpu/ops/fwht_pallas.py:71-72``) and the
    storage ``dtype`` float32 (:func:`check_storage`)."""
    check_storage(precision, dtype)
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "bf16" and not (is_pow_of_2(D) and MIN_D_BF16 <= D <= MAX_D):
        raise ValueError(
            f"the bf16 mode takes a power-of-two D in [{MIN_D_BF16}, {MAX_D}], got {D}"
        )


def bf16_tol(D: int, transform: int = 2) -> float:
    """max |kernel - plain| / max |plain| of a bf16-mode output at width D,
    kernel and plain version on the same inputs.

    The kernel sums in butterfly order, the plain version in matmul order:
    the same fp32 values in another order, so a sum can land on the other
    side of a bf16 rounding boundary. One such flip moves that operand by
    at most 2^-7 of it, and the contraction after it adds it into outputs
    about sqrt(f) times larger, f its size; twice that is the tolerance,
    2^-6 / sqrt(f) (``kron_cuda.tol``'s derivation). f is the last
    contraction after the last rounding that can flip: H_D for D <= 1024;
    for D >= 2048, H_128 in outputs of the second transform (``y``,
    ``i2``; ``dx`` and the ``s1``/``s2`` gradients), H_a (``a = D / 128``)
    in those of the first (``transform=1``: ``i1``, ``w1`` and the ``u``
    gradient, which sums their products).
    """
    if D <= ONE_FACTOR_MAX:
        f = D
    else:
        f = LANE if transform == 2 else D // LANE
    return 2.0**-6 / math.sqrt(f)


def _bf16_transform(t, high_first: bool):
    """``H_D`` along the last axis with the Pallas bodies' bf16 roundings
    (R, to nearest even; fp32 sums): ``H_D R(t)`` for ``D <= 1024``; for
    ``D >= 2048`` two factor contractions, each of a rounded operand, over
    ``t`` viewed as ``(..., a, 128)``: ``H_128`` (the low index bits) then
    ``H_a`` (``_kernel_2f``'s first transform), or ``H_a`` first when
    ``high_first`` (its second)."""
    D = t.shape[-1]
    if D <= ONE_FACTOR_MAX:
        return round_bf16(t) @ factor_H(D, t.dtype, t.device)
    lead, a = t.shape[:-1], D // LANE
    Ha = factor_H(a, t.dtype, t.device)
    Hb = factor_H(LANE, t.dtype, t.device)
    t = t.reshape(*lead, a, LANE)
    if high_first:
        t = round_bf16(Ha @ round_bf16(t)) @ Hb
    else:
        t = Ha @ round_bf16(round_bf16(t) @ Hb)
    return t.reshape(*lead, D)


def fused_plain(s1, u, s2, x, want_residuals: bool, precision: str = "fp32"):
    """``(y, i1, i2)`` with ``i1 = H(s2*x)``, ``i2 = H(u*i1)``,
    ``y = s1*i2`` (``i1``/``i2`` None unless ``want_residuals``), all of
    the broadcast output shape, as the kernel writes them (``i1`` is an
    expanded view where ``u`` or ``s1`` carry axes that ``s2*x`` lacks).

    ``"fp32"``: radix-2 butterflies, the kernel's own adds in its order;
    on bf16 storage each op rounds to bf16 and each transform sums in fp32
    (see the module docstring).
    ``"bf16"``: the Pallas bodies' factor contractions of rounded operands
    (:func:`_bf16_transform`), the second transform ``H_a`` first; ``i1``
    and ``i2`` are the unrounded fp32 sums, in natural layout.
    """
    check_precision(x.shape[-1], precision, x.dtype)
    if precision == "fp32":
        i1 = fwht_plain(s2 * x)
        i2 = fwht_plain(u * i1)
    else:
        i1 = _bf16_transform(s2 * x, high_first=False)
        i2 = _bf16_transform(u * i1, high_first=True)
    y = s1 * i2
    if not want_residuals:
        return y, None, None
    return y, i1.expand(y.shape), i2.expand(y.shape)


def vjp_plain(s1, u, s2, x, g, precision: str = "fp32"):
    """``(ds1, du, ds2, dx)`` of ``y = s1 * H(u * H(s2 * x))`` for the
    cotangent ``g``, each of its operand's shape: the backward of
    :class:`WhviMulFunction` (and of the Pallas ``_bwd``) with the plain
    product in place of the kernels. In ``"bf16"`` it rounds where the
    kernels do, which autograd through :func:`fused_plain` does not."""
    _, i1, i2 = fused_plain(s1, u, s2, x, True, precision)
    dx, w1, t2 = fused_plain(s2, u, s1, g, True, precision)
    return _input_grads((True,) * 4, s1, u, s2, x, g, i1, i2, dx, w1, t2)


def fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, want_dx: bool, precision: str = "fp32"):
    """``(dx, ds1, du, ds2)`` of K3's reduce mode (``dx`` None unless
    ``want_dx``): for the cotangent ``g`` of ``y = s1*H(u*H(s2*x))`` and
    the forward's residuals ``i1``, ``i2``, the swapped product ``dx =
    s2*t2`` of the broadcast shape and the batch reductions ``ds1 =
    sum(g*i2)``, ``du = sum(w1*i1)``, ``ds2 = sum(x*t2)``, each summed to
    its operand's shape (``w1 = H(s1*g)``, ``t2 = H(u*w1)``, rounded as the
    forward in ``precision``)."""
    dx, w1, t2 = fused_plain(s2, u, s1, g, True, precision)
    ds1, du, ds2, _ = _input_grads((True, True, True, False), s1, u, s2, x, g, i1, i2, dx, w1, t2)
    return (dx if want_dx else None), ds1, du, ds2


def column_plain(s1, g, s2, residual: bool):
    """``(y, t)`` of the column head's rows (``ColumnMatrix.column_given_g``,
    ``H_rows`` one row of ones) from ``g (..., D)`` and the diagonals
    ``s1, s2 (..., D)``, which broadcast over ``g``'s leading axes:
    ``t = H g``, ``y = (s1_0 * t) * s2`` with ``s1_0 = s1[..., :1]``, of
    the broadcast shape. On bf16 storage each op rounds, ``t = R(H g)``
    and ``y = R(R(s1_0 t) s2)``, as the chain it replaces does. ``t``
    (expanded to ``y``'s shape, as the kernel writes it) is None unless
    ``residual``."""
    t = fwht_plain(g)
    y = s1[..., :1] * t * s2
    return y, (t.expand(y.shape) if residual else None)


def column_bwd_plain(s1, s2, gy, t):
    """``(dg, p1, p2)`` for the cotangent ``gy`` of :func:`column_plain`'s
    ``y`` and its residual ``t``: ``dg = H((gy * s2) * s1_0)`` (H is
    self-adjoint), ``p1 = (gy * s2) * t`` and ``p2 = gy * (s1_0 * t)``,
    the products autograd takes over the chain (each rounded on bf16
    storage), before the reductions to ``s1_0``'s and ``s2``'s shapes."""
    s = s1[..., :1]
    da = gy * s2
    return fwht_plain(da * s), da * t, gy * (s * t)


# ----------------------------------------------------------------- dispatch


def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        "operands must all be CPU tensors or all lie on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}"
    )


def check_kernel_args(D: int, dtype: torch.dtype) -> None:
    """Raise unless the kernels take rows of ``D`` elements of ``dtype``
    (float32 or bfloat16 storage)."""
    if dtype not in STORAGE:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 tensors, got {dtype}")
    if not (is_pow_of_2(D) and 2 <= D <= MAX_D):
        raise ValueError(
            f"the CUDA kernels take a power-of-two D in [2, {MAX_D}], got {D}"
        )


def vector_bytes(D: int, element_size: int = 4) -> int:
    """The alignment, in bytes, of a row of ``D`` elements of
    ``element_size`` bytes that the kernels take: 16 (a ``float4``; in bf16
    the widest access, of a whole row at ``D = 8, 16``), less only where a
    whole row is shorter (``D = 2`` in fp32; ``D = 2, 4`` in bf16)."""
    return min(D * element_size, 16)


def vector_aligned(t: torch.Tensor, width: int) -> bool:
    """Whether every row of ``t`` starts on a ``width``-byte boundary: the
    base pointer and each leading stride the kernel reads through (axes
    of size 1 and stride-0 broadcast axes are not) are multiples of it."""
    if t.data_ptr() % width:
        return False
    return all(
        (s * t.element_size()) % width == 0
        for n, s in zip(t.shape[:-1], t.stride()[:-1])
        if n > 1 and s != 0
    )


def _aligned(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` itself, or a copy in a fresh allocation whose rows start on a
    ``width``-byte boundary (stride-0 axes stay broadcast), counted in
    :data:`REALIGNED`."""
    global REALIGNED
    if vector_aligned(t, width):
        return t
    REALIGNED += 1
    base = t[tuple(slice(0, 1) if s == 0 else slice(None) for s in t.stride())]
    return base.clone(memory_format=torch.contiguous_format).expand(t.shape)


def _geometry(lead: torch.Size, operands) -> _Geometry:
    """Leading sizes and per-operand element strides over ``lead``,
    size-1 dims dropped and mergeable neighbours merged, left-padded to
    the kernel's four dims."""
    strides = [t.expand(*lead, t.shape[-1]).stride()[:-1] for t in operands]
    dims: list[tuple[int, list[int]]] = []
    for i, n in enumerate(lead):
        if n == 1:
            continue
        st = [s[i] for s in strides]
        if dims and all(p == q * n for p, q in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 4:
        raise ValueError(
            f"broadcast of leading shape {tuple(lead)} needs {len(dims)} "
            "strided dims; the fused kernel takes at most 4"
        )
    dims = [(1, [0, 0, 0, 0])] * (4 - len(dims)) + dims
    geom = _Geometry()
    for d, (n, st) in enumerate(dims):
        geom.size[d] = n
        for k in range(4):
            geom.stride[4 * k + d] = st[k]
    return geom


def _storage(*tensors) -> torch.dtype:
    """The one dtype of the operands; ``TypeError`` if they differ."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(
            f"operands must share one dtype (the storage), got {sorted(map(str, dtypes))}"
        )
    return dtypes.pop()


def _launch_fused(s1, u, s2, x, want_residuals: bool, precision: str, counter: str):
    D = x.shape[-1]
    half = x.dtype == torch.bfloat16  # one dtype: the callers' _storage
    for t in (s1, u, s2, x):
        check_kernel_args(t.shape[-1], t.dtype)
        if t.shape[-1] != D:
            raise ValueError(
                f"diagonals and x must share the last axis D={D}, got "
                f"{tuple(t.shape)}"
            )
        if t.stride(-1) != 1:
            raise ValueError("the last axis of every operand must be contiguous")
    width = vector_bytes(D, x.element_size())
    s1, u, s2, x = (_aligned(t, width) for t in (s1, u, s2, x))
    lead = torch.broadcast_shapes(
        x.shape[:-1], s1.shape[:-1], u.shape[:-1], s2.shape[:-1]
    )
    geom = _geometry(lead, (x, s1, u, s2))
    y = torch.empty(*lead, D, dtype=x.dtype, device=x.device)
    i1 = torch.empty_like(y) if want_residuals else None
    i2 = torch.empty_like(y) if want_residuals else None
    n_rows = y.numel() // D
    lib = load_library()
    entry = "whvi_fused_bf16s" if half else "whvi_fused_f32"
    with torch.cuda.device(x.device), span(KERNEL_SPANS[counter]):
        err = getattr(lib, entry)(
            x.data_ptr(),
            s1.data_ptr(),
            u.data_ptr(),
            s2.data_ptr(),
            y.data_ptr(),
            None if i1 is None else i1.data_ptr(),
            None if i2 is None else i2.data_ptr(),
            int(want_residuals),
            int(precision == "bf16"),
            n_rows,
            int(math.log2(D)),
            ctypes.byref(geom),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    LAUNCHES[counter] += 1
    return y, i1, i2


def _counter(name: str, precision: str, dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return name + "_bf16s"
    return name + "_bf16" if precision == "bf16" else name


def fused_raw(s1, u, s2, x, want_residuals: bool, precision: str = "fp32"):
    """``(y, i1, i2)`` of ``y = s1 * H(u * H(s2 * x))``, no autograd.

    ``x (..., D)`` and the diagonals ``s1, u, s2 (..., D)`` broadcast over
    their leading axes; the outputs have the broadcast shape. K1
    (``want_residuals=False``: ``i1``, ``i2`` are None) or K2 on CUDA
    tensors, in ``precision`` and the operands' storage, float32 or
    bfloat16 (see the module docstring); :func:`fused_plain` on CPU tensors.
    """
    dtype = _storage(s1, u, s2, x)
    check_precision(x.shape[-1], precision, dtype)
    if _on_cpu(s1, u, s2, x):
        return fused_plain(s1, u, s2, x, want_residuals, precision)
    name = "fused_res" if want_residuals else "fused_y"
    return _launch_fused(
        s1, u, s2, x, want_residuals, precision, _counter(name, precision, dtype)
    )


def fused_bwd_raw(s1, u, s2, g, precision: str = "fp32"):
    """``(dx, w1, t2)`` for the cotangent ``g`` of ``y = s1*H(u*H(s2*x))``:
    the fused product with ``s1`` and ``s2`` swapped, ``dx = s2*H(u*w1)``,
    ``w1 = H(s1*g)``, ``t2 = H(u*w1)`` (H is self-adjoint), rounded as the
    forward in ``precision`` (as ``_bwd`` runs ``_fused_raw``). K3 on CUDA
    tensors; :func:`fused_plain` on CPU tensors."""
    dtype = _storage(s1, u, s2, g)
    check_precision(g.shape[-1], precision, dtype)
    if _on_cpu(s1, u, s2, g):
        return fused_plain(s2, u, s1, g, True, precision)
    return _launch_fused(
        s2, u, s1, g, True, precision, _counter("fused_bwd", precision, dtype)
    )


def sums_group(s1, u, s2, x) -> int | None:
    """The output rows that share one row of ``u`` where K3's reduce mode
    takes the backward of ``y = s1*H(u*H(s2*x))``, else None.

    It takes fp32 storage, ``2 <= D <= SUMS_MAX_D``, ``s1`` and ``s2`` of
    one ``(D,)`` row each (leading axes all 1), and a ``u`` that is one row
    for all outputs, or one row for each row of the outputs' innermost
    leading axis (``u (S, 1, D)`` over outputs ``(S, B, D)``, ``B > 1``):
    then every sum runs over consecutive output rows. Stacked or replicated
    diagonals, per-example ``u`` (``B = 1`` included, where it looks like
    a shared one) and bf16 storage are refused. Shapes alone decide."""
    D = x.shape[-1]
    if {t.dtype for t in (s1, u, s2, x)} != {torch.float32}:
        return None
    if not (is_pow_of_2(D) and 2 <= D <= SUMS_MAX_D) or s1.numel() != D or s2.numel() != D:
        return None
    lead = torch.broadcast_shapes(x.shape[:-1], s1.shape[:-1], u.shape[:-1], s2.shape[:-1])
    rows = math.prod(lead)
    u_lead = (1,) * (len(lead) - u.dim() + 1) + tuple(u.shape[:-1])
    if rows == 0:
        return None
    if all(n == 1 for n in u_lead):
        return rows
    if lead[-1] > 1 and u_lead[-1] == 1 and u_lead[:-1] == tuple(lead[:-1]):
        return lead[-1]
    return None


def _sums_run(rows: int, group: int, D: int) -> int:
    """The rows a thread of K3's reduce mode sums before it stores its
    partial sums: the largest divisor of ``group`` that still leaves
    :data:`SUMS_BLOCKS` blocks of ``csrc/fwht_core.cuh``'s row shape (one
    row slot a thread group, 256 threads or one row a block), or 1."""
    L = int(math.log2(D))
    tpr = 1 << (L - (L if L <= 4 else 4 if L < 13 else 5))
    most = max(1, rows // (max(tpr, 256) // tpr * SUMS_BLOCKS))
    return max(r for r in range(1, min(group, most) + 1) if group % r == 0)


def _launch_bwd_sums(s1, u, s2, x, g, i1, i2, want_dx: bool, precision: str, group: int):
    """K3's reduce mode on CUDA tensors (``group`` from :func:`sums_group`):
    ``(dx, finish)``, ``dx`` of ``g``'s shape or None, ``finish()`` the
    second pass, which returns ``(ds1, du, ds2)`` of the operands' shapes.

    Each run of rows (:func:`_sums_run`) stores its partial sums in
    scratch, and the second pass adds them in fixed order."""
    D = g.shape[-1]
    for t in (s1, u, s2, x, g, i1, i2):
        check_kernel_args(t.shape[-1], t.dtype)
        if t.shape[-1] != D or t.stride(-1) != 1:
            raise ValueError(
                f"operands must share a contiguous last axis D={D}, got {tuple(t.shape)}"
            )
    width = vector_bytes(D)
    s1, u, s2, x = (_aligned(t, width) for t in (s1, u, s2, x))
    g, i1, i2 = (_aligned(t.contiguous(), width) for t in (g, i1, i2))
    lead = g.shape[:-1]
    if i1.shape != g.shape or i2.shape != g.shape:
        raise ValueError(
            f"residuals {tuple(i1.shape)}, {tuple(i2.shape)} for a cotangent {tuple(g.shape)}"
        )
    rows = math.prod(lead)
    n_runs = rows // _sums_run(rows, group, D)
    geom = _geometry(lead, (x, s1, u, s2))
    dx = torch.empty_like(g) if want_dx else None
    part = torch.empty(3, n_runs, D, dtype=g.dtype, device=g.device)
    lib = load_library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    counter = _counter("fused_bwd_sums", precision, g.dtype)
    with torch.cuda.device(g.device), span(KERNEL_SPANS[counter]):
        err = lib.whvi_bwd_sums_f32(
            g.data_ptr(), x.data_ptr(), s1.data_ptr(), u.data_ptr(), s2.data_ptr(),
            i1.data_ptr(), i2.data_ptr(), None if dx is None else dx.data_ptr(), part.data_ptr(),
            n_runs, rows // n_runs, int(precision == "bf16"), int(math.log2(D)),
            ctypes.byref(geom), stream,
        )
    if err != 0:
        raise RuntimeError(f"whvi_bwd_sums_f32 launch failed: cudaError_t {err}")
    LAUNCHES[counter] += 1

    def finish():
        ds1, du, ds2 = (torch.empty(t.shape, dtype=g.dtype, device=g.device) for t in (s1, u, s2))
        with torch.cuda.device(g.device):
            err = lib.whvi_sum_runs_f32(
                part.data_ptr(), ds1.data_ptr(), du.data_ptr(), ds2.data_ptr(), n_runs,
                rows // group, int(math.log2(D)), stream,
            )
        if err != 0:
            raise RuntimeError(f"whvi_sum_runs_f32 launch failed: cudaError_t {err}")
        return ds1, du, ds2

    return dx, finish


def fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, want_dx: bool, precision: str = "fp32"):
    """``(dx, ds1, du, ds2)`` of :func:`fused_bwd_sums_plain`, no autograd:
    K3's reduce mode and its second pass, one counted launch, on CUDA
    tensors whose shapes :func:`sums_group` takes (else ``ValueError``);
    the plain version on CPU tensors."""
    dtype = _storage(s1, u, s2, x, g, i1, i2)
    check_precision(g.shape[-1], precision, dtype)
    if _on_cpu(s1, u, s2, x, g, i1, i2):
        return fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, want_dx, precision)
    group = sums_group(s1, u, s2, x)
    if group is None:
        raise ValueError(
            f"K3's reduce mode takes fp32 storage, D <= {SUMS_MAX_D}, (D,) diagonals s1 and s2 "
            f"and a u shared or one a sample; got s1 {tuple(s1.shape)}, u {tuple(u.shape)}, "
            f"s2 {tuple(s2.shape)}, x {tuple(x.shape)} of {dtype}"
        )
    dx, finish = _launch_bwd_sums(s1, u, s2, x, g, i1, i2, want_dx, precision, group)
    return (dx, *finish())


def fwht_raw(x):
    """FWHT along the last axis, no autograd. K4 on a CUDA tensor (which
    must be contiguous; copied first if it starts off the kernel's vector
    width), in its storage: float32, or bfloat16 summed in fp32 and
    rounded once; :func:`fwht_plain` on a CPU tensor."""
    if _on_cpu(x):
        return fwht_plain(x)
    D = x.shape[-1]
    check_kernel_args(D, x.dtype)
    if not x.is_contiguous():
        raise ValueError("fwht_raw takes a contiguous CUDA tensor")
    x = _aligned(x, vector_bytes(D, x.element_size()))
    y = torch.empty_like(x)
    lib = load_library()
    half = x.dtype == torch.bfloat16
    entry, counter = ("fwht_bf16s", "fwht_bf16s") if half else ("fwht_f32", "fwht")
    with torch.cuda.device(x.device), span(KERNEL_SPANS[counter]):
        err = getattr(lib, entry)(
            x.data_ptr(),
            y.data_ptr(),
            x.numel() // D,
            int(math.log2(D)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    LAUNCHES[counter] += 1
    return y


_COLUMN_MODES = ("column_y_bf16s", "column_res_bf16s", "column_bwd_bf16s")  # by mode


def _launch_column(mode: int, x, s1, s2, res=None):
    """``column_bf16s`` in ``mode`` (0: y; 1: y, t; 2: the backward, x the
    cotangent and ``res`` t): its outputs, contiguous of the broadcast
    shape. ``s1`` is read one element a row, ``s1[..., 0]``, through its
    own strides."""
    D = x.shape[-1]
    operands = (x, s1, s2) if res is None else (x, s1, s2, res)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the column kernel takes bf16 storage, got {x.dtype}")
    for t in operands:
        check_kernel_args(t.shape[-1], t.dtype)
        if t.shape[-1] != D:
            raise ValueError(f"operands must share the last axis D={D}, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError("the last axis of every operand must be contiguous")
    width = vector_bytes(D, x.element_size())
    x, s2 = _aligned(x, width), _aligned(s2, width)
    res = None if res is None else _aligned(res, width)
    lead = torch.broadcast_shapes(*(t.shape[:-1] for t in operands))
    geom = _geometry(lead, (x, s1, s2, x if res is None else res))
    outs = [torch.empty(*lead, D, dtype=x.dtype, device=x.device) for _ in range(mode + 1)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (2 - mode)
    lib = load_library()
    counter = _COLUMN_MODES[mode]
    with torch.cuda.device(x.device), span(KERNEL_SPANS[counter]):
        err = lib.column_bf16s(
            mode,
            x.data_ptr(),
            s1.data_ptr(),
            s2.data_ptr(),
            None if res is None else res.data_ptr(),
            *ptrs,
            math.prod(lead),
            int(math.log2(D)),
            ctypes.byref(geom),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"column_bf16s launch failed: cudaError_t {err}")
    LAUNCHES[counter] += 1
    return outs


def column_raw(s1, g, s2, residual: bool):
    """``(y, t)`` of the column head's rows, no autograd (see
    :func:`column_plain`; ``t`` None unless ``residual``): one launch of
    the column kernel on CUDA tensors, which must be bf16 (the fp32 head
    runs K4 and PyTorch's ops); :func:`column_plain` on CPU tensors."""
    _storage(s1, g, s2)
    if _on_cpu(s1, g, s2):
        return column_plain(s1, g, s2, residual)
    outs = _launch_column(int(residual), g, s1, s2)
    return outs[0], (outs[1] if residual else None)


def column_bwd_raw(s1, s2, gy, t):
    """``(dg, p1, p2)`` of :func:`column_bwd_plain`, no autograd: one
    launch of the column kernel on CUDA tensors (bf16 only);
    :func:`column_bwd_plain` on CPU tensors."""
    _storage(s1, s2, gy, t)
    if _on_cpu(s1, s2, gy, t):
        return column_bwd_plain(s1, s2, gy, t)
    return tuple(_launch_column(2, gy, s1, s2, t))


def column_floor(n_rows: int, D: int, device) -> None:
    """Launch a kernel that does nothing on the column kernel's grid, block
    and shared memory at ``n_rows`` rows of ``D``: the launch floor under
    its times. Counted nowhere; needs a card."""
    device = torch.device(device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.column_nop(n_rows, int(math.log2(D)), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"column_nop launch failed: cudaError_t {err}")


# ----------------------------------------------------------------- autograd


def _input_grads(need, s1, u, s2, x, g, i1, i2, dx, w1, t2):
    """``_bwd``'s batch reductions, each summed back to its operand's shape."""
    return (
        (g * i2).sum_to_size(s1.shape) if need[0] else None,
        (w1 * i1).sum_to_size(u.shape) if need[1] else None,
        (x * t2).sum_to_size(s2.shape) if need[2] else None,
        dx.sum_to_size(x.shape) if need[3] else None,
    )


class WhviMulFunction(torch.autograd.Function):
    """``y = s1 * H(u * H(s2 * x))`` with broadcast operands, in
    ``precision`` (``apply(s1, u, s2, x[, precision])``, default fp32).

    Forward: the fused product with residuals (K2). Backward
    (``whvi_tpu/ops/fwht_pallas.py:_bwd``): the product with ``s1`` and
    ``s2`` swapped on the cotangent (K3), in the same precision, then the
    batch reductions ``du = sum(w1*i1)``, ``ds1 = sum(g*i2)``,
    ``ds2 = sum(x*t2)`` and ``dx`` summed back to each operand's shape.
    ``x`` usually broadcasts over the stack axis, so its gradient is summed
    over it too. On a card, where :func:`sums_group` takes the operands,
    K3's reduce mode sums the three reductions itself (``fused_bwd_sums``);
    on the CPU the plain versions run.
    """

    @staticmethod
    def forward(ctx, s1, u, s2, x, precision="fp32"):
        y, i1, i2 = fused_raw(s1, u, s2, x, True, precision)
        ctx.save_for_backward(s1, u, s2, x, i1, i2)
        ctx.precision = precision
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with span("whvi.op.whvi_mul_bwd"):
            s1, u, s2, x, i1, i2 = ctx.saved_tensors
            g = g.contiguous()
            group = None if g.device.type == "cpu" else sums_group(s1, u, s2, x)
            if group is None:
                dx, w1, t2 = fused_bwd_raw(s1, u, s2, g, ctx.precision)
            else:
                dx, finish = _launch_bwd_sums(
                    s1, u, s2, x, g, i1, i2, need[3], ctx.precision, group
                )
        with span("whvi.op.input_grads"):
            if group is None:
                grads = _input_grads(need, s1, u, s2, x, g, i1, i2, dx, w1, t2)
            else:
                sums = finish()
                grads = (*(t if n else None for t, n in zip(sums, need)),
                         dx.sum_to_size(x.shape) if need[3] else None)
        return (*grads, None)


class FwhtFunction(torch.autograd.Function):
    """FWHT along the last axis; the backward is the same transform
    (``H = H^T``, ``whvi_tpu/ops/fwht_pallas.py:446-447``)."""

    @staticmethod
    def forward(ctx, x):
        return fwht_raw(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return fwht_raw(g.contiguous())


class ColumnFunction(torch.autograd.Function):
    """The column head's rows ``y = (s1_0 * H g) * s2``
    (``apply(s1, g, s2)``; :func:`column_plain`), ``s1`` and ``s2`` the
    full ``(.., D)`` diagonals. Forward: one launch with the residual
    ``t``; backward: one launch for ``dg``, ``p1``, ``p2``, then the
    reductions autograd takes over the chain, at its shapes (so the
    gradients equal its bit for bit): ``ds1`` is ``p1`` summed, at element
    0 of a zero ``(.., D)`` row; ``ds2`` is ``p2`` summed; ``dg`` is summed
    over the axes ``g`` broadcasts along."""

    @staticmethod
    def forward(ctx, s1, g, s2):
        y, t = column_raw(s1, g, s2, True)
        ctx.save_for_backward(s1, s2, t)
        ctx.g_shape = g.shape
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        s1, s2, t = ctx.saved_tensors
        need = ctx.needs_input_grad
        dg, p1, p2 = column_bwd_raw(s1, s2, gy.contiguous(), t)
        D = gy.shape[-1]
        ds1 = ds2 = None
        if need[0]:  # the chain's s1[..., :1, None] view, one row of (.., 1, D)
            ds1 = p1.unsqueeze(-2).sum_to_size(s1.shape[:-1] + (1, 1))
            ds1 = F.pad(ds1.reshape(s1.shape[:-1] + (1,)), (0, D - 1))
        if need[2]:
            rows = s2.shape if s2.dim() == 1 else s2.shape[:-1] + (1, D)
            ds2 = p2.unsqueeze(-2).sum_to_size(rows).reshape(s2.shape)
        if need[1] and tuple(ctx.g_shape) != tuple(dg.shape):
            g_shape = ctx.g_shape
            dg = dg.unsqueeze(-2).sum_to_size(g_shape[:-1] + (1, D)).reshape(g_shape)
        return ds1, (dg if need[1] else None), ds2


def column_head(s1, g, s2):
    """The column head's rows (:class:`ColumnFunction`): the autograd
    Function only when a gradient is recorded, the y-only launch
    otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (s1, g, s2)):
        return ColumnFunction.apply(s1, g, s2)
    return column_raw(s1, g, s2, False)[0]


def fwht_cuda(x):
    """Differentiable FWHT along the last axis through :func:`fwht_raw`
    (counterpart of ``fwht_pallas``): the autograd Function only when a
    gradient is recorded, the bare launch otherwise."""
    if torch.is_grad_enabled() and x.requires_grad:
        return FwhtFunction.apply(x)
    return fwht_raw(x)
