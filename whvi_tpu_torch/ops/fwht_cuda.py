"""Hand-written CUDA kernels for the WHVI product and the FWHT.

Counterpart of :mod:`whvi_tpu.ops.fwht_pallas`. Two kernels live in
``whvi_tpu_torch/csrc/`` and are used four ways:

==============  ==========================  ==================================
launch counter  wrapper                     replaces (whvi_tpu/ops/fwht_pallas.py)
==============  ==========================  ==================================
``fused_y``     ``fused_raw(.., False)``    ``_kernel_1f_y`` / ``_kernel_2f_y``
``fused_res``   ``fused_raw(.., True)``     ``_kernel_1f`` / ``_kernel_2f``
``fused_bwd``   ``fused_bwd_raw``           the transform half of ``_bwd``
``fwht``        ``fwht_raw``                ``_kernel_1f_t`` / ``_kernel_2f_t``
==============  ==========================  ==================================

Each wrapper dispatches on the device of its tensors alone: CPU tensors
go to the plain PyTorch version beside it (:func:`fused_plain`,
:func:`fwht_plain`); CUDA tensors launch the kernel or raise. There is
no fallback from one to the other.

Build: at the first launch, ``nvcc`` compiles ``csrc/*.cu`` for
``sm_90a`` into a shared library with a plain C interface under
``build/whvi_tpu_torch/`` beside the package, and ``ctypes`` loads it.
Nothing here is imported or built while the module is imported.

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
from torch.autograd.function import once_differentiable

from whvi_tpu_torch.ops.hadamard import fwht as fwht_plain
from whvi_tpu_torch.ops.hadamard import is_pow_of_2

__all__ = [
    "FwhtFunction",
    "LAUNCHES",
    "MAX_D",
    "WhviMulFunction",
    "build_kernels",
    "check_kernel_args",
    "fused_bwd_raw",
    "fused_plain",
    "fused_raw",
    "fwht_cuda",
    "fwht_plain",
    "fwht_raw",
    "load_library",
    "reset_launches",
]

MAX_D = 16384

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("whvi_fused.cu", "fwht.cu")
_HEADERS = ("fwht_core.cuh",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "whvi_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libwhvi_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"fused_y": 0, "fused_res": 0, "fused_bwd": 0, "fwht": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def build_kernels() -> str:
    """Compile ``csrc/*.cu`` into :data:`LIB_PATH`; return nvcc's report
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f".libwhvi_kernels.{os.getpid()}.so")
    cmd = [
        _nvcc(),
        *NVCC_FLAGS,
        "-o",
        tmp,
        *(os.path.join(CSRC, s) for s in SOURCES),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)  # atomic: no process loads a half-written file
    return proc.stdout + proc.stderr


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
            lib.whvi_fused_f32.argtypes = [vp] * 7 + [
                ctypes.c_int,
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.POINTER(_Geometry),
                vp,
            ]
            lib.whvi_fused_f32.restype = ctypes.c_int
            lib.fwht_f32.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_int, vp]
            lib.fwht_f32.restype = ctypes.c_int
            _lib = lib
        return _lib


# ------------------------------------------------------------ plain versions


def fused_plain(s1, u, s2, x, want_residuals: bool):
    """``(y, i1, i2)`` with ``i1 = H(s2*x)``, ``i2 = H(u*i1)``,
    ``y = s1*i2`` (``i1``/``i2`` None unless ``want_residuals``), all of
    the broadcast output shape, as the kernel writes them (``i1`` is an
    expanded view where ``u`` or ``s1`` carry axes that ``s2*x`` lacks)."""
    i1 = fwht_plain(s2 * x)
    i2 = fwht_plain(u * i1)
    y = s1 * i2
    if not want_residuals:
        return y, None, None
    return y, i1.expand(y.shape), i2.expand(y.shape)


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
    """Raise unless the kernels take rows of ``D`` elements of ``dtype``."""
    if dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32 tensors, got {dtype}")
    if not (is_pow_of_2(D) and 2 <= D <= MAX_D):
        raise ValueError(
            f"the CUDA kernels take a power-of-two D in [2, {MAX_D}], got {D}"
        )


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


def _launch_fused(s1, u, s2, x, want_residuals: bool, counter: str):
    D = x.shape[-1]
    for t in (s1, u, s2, x):
        check_kernel_args(t.shape[-1], t.dtype)
        if t.shape[-1] != D:
            raise ValueError(
                f"diagonals and x must share the last axis D={D}, got "
                f"{tuple(t.shape)}"
            )
        if t.stride(-1) != 1:
            raise ValueError("the last axis of every operand must be contiguous")
    lead = torch.broadcast_shapes(
        x.shape[:-1], s1.shape[:-1], u.shape[:-1], s2.shape[:-1]
    )
    geom = _geometry(lead, (x, s1, u, s2))
    y = torch.empty(*lead, D, dtype=x.dtype, device=x.device)
    i1 = torch.empty_like(y) if want_residuals else None
    i2 = torch.empty_like(y) if want_residuals else None
    n_rows = y.numel() // D
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.whvi_fused_f32(
            x.data_ptr(),
            s1.data_ptr(),
            u.data_ptr(),
            s2.data_ptr(),
            y.data_ptr(),
            None if i1 is None else i1.data_ptr(),
            None if i2 is None else i2.data_ptr(),
            int(want_residuals),
            n_rows,
            int(math.log2(D)),
            ctypes.byref(geom),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"whvi_fused_f32 launch failed: cudaError_t {err}")
    LAUNCHES[counter] += 1
    return y, i1, i2


def fused_raw(s1, u, s2, x, want_residuals: bool):
    """``(y, i1, i2)`` of ``y = s1 * H(u * H(s2 * x))``, no autograd.

    ``x (..., D)`` and the diagonals ``s1, u, s2 (..., D)`` broadcast over
    their leading axes; the outputs have the broadcast shape. K1
    (``want_residuals=False``: ``i1``, ``i2`` are None) or K2 on CUDA
    tensors; :func:`fused_plain` on CPU tensors.
    """
    if _on_cpu(s1, u, s2, x):
        return fused_plain(s1, u, s2, x, want_residuals)
    return _launch_fused(
        s1, u, s2, x, want_residuals, "fused_res" if want_residuals else "fused_y"
    )


def fused_bwd_raw(s1, u, s2, g):
    """``(dx, w1, t2)`` for the cotangent ``g`` of ``y = s1*H(u*H(s2*x))``:
    the fused product with ``s1`` and ``s2`` swapped, ``dx = s2*H(u*w1)``,
    ``w1 = H(s1*g)``, ``t2 = H(u*w1)`` (H is self-adjoint). K3 on CUDA
    tensors; :func:`fused_plain` on CPU tensors."""
    if _on_cpu(s1, u, s2, g):
        return fused_plain(s2, u, s1, g, True)
    return _launch_fused(s2, u, s1, g, True, "fused_bwd")


def fwht_raw(x):
    """FWHT along the last axis, no autograd. K4 on a CUDA tensor (which
    must be contiguous); :func:`fwht_plain` on a CPU tensor."""
    if _on_cpu(x):
        return fwht_plain(x)
    D = x.shape[-1]
    check_kernel_args(D, x.dtype)
    if not x.is_contiguous():
        raise ValueError("fwht_raw takes a contiguous CUDA tensor")
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.fwht_f32(
            x.data_ptr(),
            y.data_ptr(),
            x.numel() // D,
            int(math.log2(D)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fwht_f32 launch failed: cudaError_t {err}")
    LAUNCHES["fwht"] += 1
    return y


# ----------------------------------------------------------------- autograd


class WhviMulFunction(torch.autograd.Function):
    """``y = s1 * H(u * H(s2 * x))`` with broadcast operands.

    Forward: the fused product with residuals (K2). Backward
    (``whvi_tpu/ops/fwht_pallas.py:_bwd``): the product with ``s1`` and
    ``s2`` swapped on the cotangent (K3), then the batch reductions
    ``du = sum(w1*i1)``, ``ds1 = sum(g*i2)``, ``ds2 = sum(x*t2)`` and
    ``dx`` summed back to each operand's shape. ``x`` usually broadcasts
    over the stack axis, so its gradient is summed over it too.
    """

    @staticmethod
    def forward(ctx, s1, u, s2, x):
        y, i1, i2 = fused_raw(s1, u, s2, x, want_residuals=True)
        ctx.save_for_backward(s1, u, s2, x, i1, i2)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s1, u, s2, x, i1, i2 = ctx.saved_tensors
        dx, w1, t2 = fused_bwd_raw(s1, u, s2, g.contiguous())
        need = ctx.needs_input_grad
        return (
            (g * i2).sum_to_size(s1.shape) if need[0] else None,
            (w1 * i1).sum_to_size(u.shape) if need[1] else None,
            (x * t2).sum_to_size(s2.shape) if need[2] else None,
            dx.sum_to_size(x.shape) if need[3] else None,
        )


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


def fwht_cuda(x):
    """Differentiable FWHT along the last axis through :func:`fwht_raw`
    (counterpart of ``fwht_pallas``): the autograd Function only when a
    gradient is recorded, the bare launch otherwise."""
    if torch.is_grad_enabled() and x.requires_grad:
        return FwhtFunction.apply(x)
    return fwht_raw(x)
