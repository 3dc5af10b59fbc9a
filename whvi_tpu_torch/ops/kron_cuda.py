"""Hand-written CUDA kernels of the large-D kernel-diagnosis path.

Counterparts of the TPU harness kernels in ``benchmarks/pallas_diag.py``
and ``benchmarks/pallas_tune.py``: the fused product
``y = s1 * H(u * H(s2 * x))`` built up stage by stage in the Kronecker
formulation ``H_D = H_a (x) H_128`` (``a = D / 128``), with every factor
contraction taking bf16 operands and accumulating in fp32, plus the copy
floors it is measured against. Each wrapper is named after the TPU
function it replaces and counts its launches under that name:

=============  ======================  =================================
wrapper        kernel (csrc/)          replaces
=============  ======================  =================================
``k_copy``     ``whvi_kron.cu`` copy   ``pallas_diag.py`` ``k_copy``
``k_scale``    ``whvi_kron.cu`` scale  ``pallas_diag.py`` ``k_scale``
``k_mm1``      ``whvi_kron.cu`` flat   ``pallas_diag.py`` ``k_mm1``
``k_mm2``      ``whvi_kron.cu`` flat   ``pallas_diag.py`` ``k_mm2``
``k_full``     ``whvi_kron.cu`` flat   ``pallas_diag.py`` ``k_full``
``emit_full``  ``whvi_pipe.cu``        ``pallas_diag.py`` ``make_emit_full``
``hbm_copy``   ``copy_floor.cu``       ``pallas_diag.py`` ``make_hbm_copy``
``copy_2d``    ``copy_floor.cu``       ``pallas_diag.py`` ``make_copy_2d``
``emit_copy``  ``whvi_pipe.cu``        ``pallas_diag.py`` ``make_emit_copy``
``k_cur``      ``whvi_kron.cu`` cur    ``pallas_tune.py`` ``k_cur``
``k_swap``     ``whvi_kron.cu`` swap   ``pallas_tune.py`` ``k_swap``
``k_flat``     ``whvi_kron.cu`` flat   ``pallas_tune.py`` ``k_flat``
``k_onecast``  ``whvi_kron.cu`` cur    ``pallas_tune.py`` ``k_onecast``
=============  ======================  =================================

Every wrapper takes ``(s1, u, s2, x, tb)`` like the TPU harness's
``fn(s1, u, s2, x)`` built for a tile of ``tb`` rows: ``x`` is a
contiguous ``(B, D)`` float32 matrix with ``D`` a power of two in
``[128, 16384]`` and ``B % tb == 0``; the diagonals are ``(D,)``
float32. The copies ignore the diagonals (the TPU functions ``del``
them), and ``hbm_copy`` ignores ``tb`` as well. The wrappers check their
arguments on every device; then CPU tensors go to the plain PyTorch
version (:func:`kron_plain`, or a copy) and CUDA tensors launch the
kernel or raise.

Where the rounding happens is part of what is computed. The TPU bodies
contract ``H_128`` (the last axis) first and ``H_a`` second in the first
transform, ``H_a`` then ``H_128`` in the second, and round the operand to
bf16 before each of the four contractions; :func:`kron_plain` does the
same, so it is not ``fwht_kron(.., "bf16")`` (which contracts the
most-significant factor first).
"""

from __future__ import annotations

import math

import torch

from whvi_tpu_torch.ops.fwht_cuda import LANE, _on_cpu, load_library
from whvi_tpu_torch.ops.hadamard import factor_H, is_pow_of_2, round_bf16

__all__ = [
    "BF16_TOL",
    "FULL_PRODUCT",
    "LANE",
    "LAUNCHES",
    "MAX_D",
    "MIN_D",
    "VARIANTS",
    "check_kron_args",
    "copy_2d",
    "emit_copy",
    "emit_full",
    "hbm_copy",
    "k_copy",
    "k_cur",
    "k_flat",
    "k_full",
    "k_mm1",
    "k_mm2",
    "k_onecast",
    "k_scale",
    "k_swap",
    "kron_plain",
    "plain",
    "reset_launches",
    "tol",
]

MIN_D = LANE  # H_128, the last Kronecker factor
MAX_D = 16384

# stage and layout codes of csrc/whvi_kron.cu
_STAGES = {"copy": 0, "scale": 1, "mm1": 2, "mm2": 3, "full": 4}
_LAYOUTS = {"cur": 0, "swap": 1, "flat": 2, "onecast": 3}

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = dict.fromkeys(
    (
        "k_copy", "k_scale", "k_mm1", "k_mm2", "k_full", "emit_full",
        "hbm_copy", "copy_2d", "emit_copy",
        "k_cur", "k_swap", "k_flat", "k_onecast",
    ),
    0,
)

# the wrappers that compute the whole product (the others are a prefix
# of it or a copy)
FULL_PRODUCT = ("k_full", "emit_full", "k_cur", "k_swap", "k_flat", "k_onecast")

_EXACT = ("k_copy", "k_scale", "hbm_copy", "copy_2d", "emit_copy")


def tol(name: str, D: int) -> float:
    """max |kernel - plain| / max |plain| for wrapper ``name`` at width D,
    kernel and plain version on the same inputs.

    The copies and the scale are exact. ``k_mm1`` rounds the same fp32
    value once, then sums in another order (fp32): 1e-5. The others round
    again after a sum, and a sum that lands on the other side of a bf16
    rounding boundary moves that operand by one bf16 ulp, at most 2^-7 of
    it. The last contraction after the last rounding adds it into outputs
    about sqrt(f) times larger (f = a for ``k_mm2``, 128 for the full
    product), so one flip moves the result by about 2^-7 / sqrt(f); twice
    that is the tolerance. Measured on the H100 at B=512: up to 8.0e-4 for
    ``k_mm2`` at D=1024 (tolerance 5.5e-3) and 2.5e-4 for the full
    product (1.4e-3); placing the roundings in another order moves the
    full product by about 3e-3.
    """
    if name in _EXACT:
        return 0.0
    if name == "k_mm1":
        return 1e-5
    f = D // LANE if name == "k_mm2" else LANE
    return 2.0**-6 / math.sqrt(f)


# max |product - whvi_mul| / max |whvi_mul| for the full-product variants
# against the fp32 product: four bf16 roundings of 2^-9 relative each,
# measured at 2.7e-3 to 4.1e-3 (D = 128 to 16384).
BF16_TOL = 2.0**-7


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def kron_plain(s1, u, s2, x, stage: str = "full"):
    """The Pallas bodies' product of ``x (B, D)`` in their own order.

    ``mm1``: ``R(s2*x) @ H_128`` on each lane-row; ``mm2``: then ``H_a``
    over the other axis (``H_D(s2*x)``); ``full``: then ``* u``, ``H_a``,
    ``H_128`` and ``* s1``. ``R`` rounds to bf16 before every contraction;
    the contractions accumulate in fp32.
    """
    B, D = x.shape
    a = D // LANE
    Ha = factor_H(a, torch.float32, x.device)
    Hb = factor_H(LANE, torch.float32, x.device)
    t = (x * s2).reshape(B, a, LANE)
    t = round_bf16(t) @ Hb
    if stage == "mm1":
        return t.reshape(B, D)
    t = Ha @ round_bf16(t)
    if stage == "mm2":
        return t.reshape(B, D)
    t = Ha @ round_bf16(t * u.reshape(a, LANE))
    t = round_bf16(t) @ Hb
    return (t * s1.reshape(a, LANE)).reshape(B, D)


def plain(name: str, s1, u, s2, x):
    """The plain PyTorch version of the kernel behind wrapper ``name``."""
    if name in FULL_PRODUCT:
        return kron_plain(s1, u, s2, x, "full")
    if name in ("k_mm1", "k_mm2"):
        return kron_plain(s1, u, s2, x, name[2:])
    if name == "k_scale":
        return x * s1
    if name in ("k_copy", "hbm_copy", "copy_2d", "emit_copy"):
        return x.clone()
    raise KeyError(name)


# ----------------------------------------------------------------- checks


def check_kron_args(x, tb, *diagonals) -> None:
    """Raise unless the kernels take ``x`` in tiles of ``tb`` rows (``tb``
    None: untiled) with the given ``(D,)`` diagonals."""
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32 tensors, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous (B, D) matrix, got shape {tuple(x.shape)}"
        )
    B, D = x.shape
    if not (is_pow_of_2(D) and MIN_D <= D <= MAX_D):
        raise ValueError(
            f"the kernels take a power-of-two D in [{MIN_D}, {MAX_D}], got {D}"
        )
    if tb is not None and not (isinstance(tb, int) and tb >= 1 and B % tb == 0):
        raise ValueError(f"B={B} must be a multiple of the row tile tb={tb}")
    for d in diagonals:
        if d.dtype != torch.float32:
            raise TypeError(f"the kernels take float32 diagonals, got {d.dtype}")
        if d.shape != (D,) or not d.is_contiguous():
            raise ValueError(
                f"diagonals must be contiguous ({D},), got {tuple(d.shape)}"
            )


# ----------------------------------------------------------------- launches


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def _product(name: str, stage: str, layout: str, s1, u, s2, x, tb):
    check_kron_args(x, tb, s1, u, s2)
    if _on_cpu(s1, u, s2, x):
        return plain(name, s1, u, s2, x)
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.kron_stage_f32(
            x.data_ptr(), s1.data_ptr(), u.data_ptr(), s2.data_ptr(),
            y.data_ptr(), x.shape[0], int(math.log2(x.shape[1])), tb,
            _STAGES[stage], _LAYOUTS[layout], _stream(x),
        )
    _raise_on(err, f"kron_stage_f32 ({name})")
    LAUNCHES[name] += 1
    return y


def _pipe(name: str, compute: bool, s1, u, s2, x, tb):
    if compute:
        check_kron_args(x, tb, s1, u, s2)
        on_cpu = _on_cpu(s1, u, s2, x)
    else:
        check_kron_args(x, tb)
        on_cpu = _on_cpu(x)
    if on_cpu:
        return plain(name, s1, u, s2, x)
    y = torch.empty_like(x)
    lib = load_library()
    ptr = lambda d: d.data_ptr() if compute else None  # noqa: E731
    with torch.cuda.device(x.device):
        err = lib.kron_pipe_f32(
            x.data_ptr(), ptr(s1), ptr(u), ptr(s2), y.data_ptr(),
            x.shape[0], int(math.log2(x.shape[1])), tb, int(compute),
            _stream(x),
        )
    _raise_on(err, f"kron_pipe_f32 ({name})")
    LAUNCHES[name] += 1
    return y


def k_copy(s1, u, s2, x, tb):
    """``y = x`` in tiles of ``tb`` rows: the tiling's streaming floor."""
    return _product("k_copy", "copy", "flat", s1, u, s2, x, tb)


def k_scale(s1, u, s2, x, tb):
    """``y = x * s1`` in tiles of ``tb`` rows."""
    return _product("k_scale", "scale", "flat", s1, u, s2, x, tb)


def k_mm1(s1, u, s2, x, tb):
    """``R(s2*x) @ H_128`` on each lane-row, on the tensor cores."""
    return _product("k_mm1", "mm1", "flat", s1, u, s2, x, tb)


def k_mm2(s1, u, s2, x, tb):
    """``k_mm1`` then ``H_a`` over the other axis: ``H_D(s2*x)``."""
    return _product("k_mm2", "mm2", "flat", s1, u, s2, x, tb)


def k_full(s1, u, s2, x, tb):
    """The whole product, four tensor-core contractions (flat layout)."""
    return _product("k_full", "full", "flat", s1, u, s2, x, tb)


def k_cur(s1, u, s2, x, tb):
    """The whole product on the CUDA cores, each factor contracted in
    place (the ``H_a`` factor over the strided middle axis)."""
    return _product("k_cur", "full", "cur", s1, u, s2, x, tb)


def k_swap(s1, u, s2, x, tb):
    """The whole product on the CUDA cores, transposed through shared
    memory so that every contraction runs over the contiguous axis."""
    return _product("k_swap", "full", "swap", s1, u, s2, x, tb)


def k_flat(s1, u, s2, x, tb):
    """The whole product with the tile's rows merged into the matmul rows,
    on the tensor cores (the same body as ``k_full``, as on the TPU)."""
    return _product("k_flat", "full", "flat", s1, u, s2, x, tb)


def k_onecast(s1, u, s2, x, tb):
    """``k_cur`` with each scaled activation cast to bf16 in the pass that
    scales it."""
    return _product("k_onecast", "full", "onecast", s1, u, s2, x, tb)


def emit_full(s1, u, s2, x, tb):
    """The whole product in a persistent kernel that streams row tiles
    through a two-stage ``cp.async`` ring in shared memory."""
    return _pipe("emit_full", True, s1, u, s2, x, tb)


def emit_copy(s1, u, s2, x, tb):
    """``y = x`` through ``emit_full``'s ring with the compute taken out."""
    return _pipe("emit_copy", False, s1, u, s2, x, tb)


def hbm_copy(s1, u, s2, x, tb=None):
    """``y = x`` as one grid-stride copy of 16 bytes a thread: the card's
    streaming floor. ``tb`` is ignored."""
    del tb
    check_kron_args(x, None)
    if _on_cpu(x):
        return plain("hbm_copy", s1, u, s2, x)
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.copy_hbm_f32(x.data_ptr(), y.data_ptr(), x.numel(), _stream(x))
    _raise_on(err, "copy_hbm_f32")
    LAUNCHES["hbm_copy"] += 1
    return y


def copy_2d(s1, u, s2, x, tb):
    """``y = x`` in ``(tb, D)`` tiles staged through shared memory."""
    check_kron_args(x, tb)
    if _on_cpu(x):
        return plain("copy_2d", s1, u, s2, x)
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.copy_2d_f32(
            x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], tb, _stream(x)
        )
    _raise_on(err, "copy_2d_f32")
    LAUNCHES["copy_2d"] += 1
    return y


# name -> wrapper, in the order of the table above
VARIANTS = {
    "k_copy": k_copy,
    "k_scale": k_scale,
    "k_mm1": k_mm1,
    "k_mm2": k_mm2,
    "k_full": k_full,
    "emit_full": emit_full,
    "hbm_copy": hbm_copy,
    "copy_2d": copy_2d,
    "emit_copy": emit_copy,
    "k_cur": k_cur,
    "k_swap": k_swap,
    "k_flat": k_flat,
    "k_onecast": k_onecast,
}
