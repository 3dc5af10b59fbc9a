"""The grouped WHVI product: one WHVI matrix a segment of rows.

For rows sorted by segment, with the segment table ``offsets`` (``G + 1``
int64 on the rows' device, nondecreasing, ``offsets[0] = 0``)::

    y[r] = s1[e] * H(u[g] * H(s2[e] * x[src(r)])),   offsets[g] <= r < offsets[g + 1],

``e = g // (G // E)`` the segment's matrix (``s1, s2 (E, D)``), ``u (G,
D)`` the segment's noise row, and ``src(r) = index[r]`` where an ``index``
is given (a gather of ``x``'s rows, never copied), else ``r``. Rows at or
past ``offsets[G]`` lie outside every segment and give 0. It is the expert
layer's product (:mod:`whvi_tpu_torch.models.deepseek_v2`): a segment is one
(expert, MC sample), every expert has its own ``s1`` and ``s2``, every
segment its own ``u``; the rows are the routed (token, sample) rows, their
number known on the device only. So the outputs have the static number of
rows the caller gives (``index``'s length, or ``x``'s), the kernels read the
table themselves, and nothing is copied to the host.

On CUDA tensors (fp32 storage, ``4 <= D <= 4096``) it launches
``csrc/whvi_grouped.cu``: K1 (``fused_grouped_y``), K2
(``fused_grouped_res``: y and the residuals ``i1 = H(s2 x)``, ``i2 = H(u
i1)``) and K3 with the batch reductions (``fused_grouped_bwd_sums``: ``dx``,
``ds1`` and ``ds2`` summed over an expert's rows and ``du`` over a
segment's, on the card, in runs of at most :data:`RUN` rows cut at segment
edges and a second pass that adds each segment's runs in fixed order;
``dx`` added atomically where ``x`` was gathered). In the ``"bf16"``
precision they round as K1-K3's bf16 mode. On CPU tensors the plain
versions here run, a loop of :func:`fwht_cuda.fused_plain` over the
segments.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.utils.profiling import span

__all__ = [
    "MAX_D",
    "MIN_D",
    "RUN",
    "WhviMulGroupedFunction",
    "grouped_bwd_plain",
    "grouped_bwd_raw",
    "grouped_plain",
    "grouped_raw",
]

MIN_D, MAX_D = 4, 4096  # the kernels' widths (csrc/whvi_grouped.cu)
RUN = 16  # rows a run of the backward's sums at most


def _rows(x, index) -> int:
    return x.shape[0] if index is None else index.shape[0]


def _check(s1, u, s2, x, offsets, index) -> tuple:
    """``(E, G, D)`` of valid operands, else ``ValueError``."""
    if s1.dim() != 2 or s1.shape != s2.shape:
        raise ValueError(f"s1 and s2 must be (E, D), got {tuple(s1.shape)}, {tuple(s2.shape)}")
    E, D = s1.shape
    G = u.shape[0]
    if u.dim() != 2 or u.shape[1] != D or G % E:
        raise ValueError(f"u must be (G, D) with G a multiple of E={E}, got {tuple(u.shape)}")
    if x.dim() != 2 or x.shape[1] != D:
        raise ValueError(f"x must be (rows, D={D}), got {tuple(x.shape)}")
    if offsets.shape != (G + 1,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be int64 (G + 1,) = ({G + 1},), got {offsets.dtype} "
                         f"{tuple(offsets.shape)}")
    if index is not None and (index.dim() != 1 or index.dtype != torch.int64):
        raise ValueError(f"index must be int64 (rows,), got {index.dtype} {tuple(index.shape)}")
    return E, G, D


def _card_args(s1, u, s2, x, offsets, index):
    """The operands a launch takes: float32, contiguous, rows on 16 bytes."""
    E, G, D = _check(s1, u, s2, x, offsets, index)
    if not (fc.is_pow_of_2(D) and MIN_D <= D <= MAX_D):
        raise ValueError(f"the grouped kernels take a power-of-two D in [{MIN_D}, {MAX_D}], got {D}")
    if {t.dtype for t in (s1, u, s2, x)} != {torch.float32}:
        raise TypeError("the grouped kernels take float32 storage")
    width = fc.vector_bytes(D)
    s1, u, s2, x = (fc._aligned(t.contiguous(), width) for t in (s1, u, s2, x))
    offsets = offsets.contiguous()
    index = None if index is None else index.contiguous()
    return (E, G, D), s1, u, s2, x, offsets, index


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ plain versions


def grouped_plain(s1, u, s2, x, offsets, index, want_residuals: bool, precision: str = "fp32"):
    """``(y, i1, i2)`` of the grouped product (``i1``, ``i2`` None unless
    ``want_residuals``; 0 in rows outside every segment, as ``y``): a loop
    of :func:`fwht_cuda.fused_plain` over the segments, on the host's copy
    of ``offsets``."""
    E, G, D = _check(s1, u, s2, x, offsets, index)
    fc.check_precision(D, precision, x.dtype)
    M = _rows(x, index)
    outs = [x.new_zeros(M, D) for _ in range(3 if want_residuals else 1)]
    bounds = offsets.tolist()
    for g in range(G):
        a, b = bounds[g], bounds[g + 1]
        if a == b:
            continue
        e = g // (G // E)
        rows = x[a:b] if index is None else x[index[a:b]]
        for out, part in zip(outs, fc.fused_plain(s1[e], u[g], s2[e], rows, want_residuals, precision)):
            out[a:b] = part
    return (outs[0], None, None) if not want_residuals else tuple(outs)


def grouped_bwd_plain(s1, u, s2, x, offsets, index, g, i1, i2, precision: str = "fp32"):
    """``(dx, ds1, du, ds2)`` for the cotangent ``g (rows, D)`` of the
    grouped product and its residuals ``i1``, ``i2``: per segment the
    swapped product ``dx = s2 H(u w1)``, ``w1 = H(s1 g)``, ``t2 = H(u w1)``
    (:func:`fwht_cuda.vjp_plain`'s algebra), ``ds1 = sum g i2`` and ``ds2 =
    sum x t2`` over the expert's rows, ``du = sum w1 i1`` over the
    segment's; ``dx`` of ``x``'s shape, summed into the gathered rows."""
    E, G, D = _check(s1, u, s2, x, offsets, index)
    fc.check_precision(D, precision, x.dtype)
    dx = torch.zeros_like(x)
    ds1, ds2, du = s1.new_zeros(E, D), s2.new_zeros(E, D), u.new_zeros(G, D)
    bounds = offsets.tolist()
    for k in range(G):
        a, b = bounds[k], bounds[k + 1]
        if a == b:
            continue
        e = k // (G // E)
        rows = x[a:b] if index is None else x[index[a:b]]
        part, w1, t2 = fc.fused_plain(s2[e], u[k], s1[e], g[a:b], True, precision)
        ds1[e] += (g[a:b] * i2[a:b]).sum(0)
        du[k] = (w1 * i1[a:b]).sum(0)
        ds2[e] += (rows * t2).sum(0)
        if index is None:
            dx[a:b] = part
        else:
            dx.index_add_(0, index[a:b], part)
    return dx, ds1, du, ds2


# ----------------------------------------------------------------- launches


def grouped_raw(s1, u, s2, x, offsets, index, want_residuals: bool, precision: str = "fp32"):
    """``(y, i1, i2)`` of :func:`grouped_plain`, no autograd: K1 or K2 of the
    grouped product on CUDA tensors (the residuals' rows outside every
    segment are left unwritten there), the plain version on CPU tensors."""
    if fc._on_cpu(s1, u, s2, x, offsets, *(() if index is None else (index,))):
        return grouped_plain(s1, u, s2, x, offsets, index, want_residuals, precision)
    (E, G, D), s1, u, s2, x, offsets, index = _card_args(s1, u, s2, x, offsets, index)
    fc.check_precision(D, precision)
    M = _rows(x, index)
    y = torch.empty(M, D, dtype=x.dtype, device=x.device)
    i1 = torch.empty_like(y) if want_residuals else None
    i2 = torch.empty_like(y) if want_residuals else None
    counter = fc._counter("fused_grouped_res" if want_residuals else "fused_grouped_y", precision,
                          x.dtype)
    lib = fc.load_library()
    with torch.cuda.device(x.device), span(fc.KERNEL_SPANS[counter]):
        err = lib.whvi_grouped_f32(
            x.data_ptr(), _ptr(index), s1.data_ptr(), u.data_ptr(), s2.data_ptr(),
            offsets.data_ptr(), y.data_ptr(), _ptr(i1), _ptr(i2), int(want_residuals),
            int(precision == "bf16"), M, G, G // E, int(math.log2(D)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"whvi_grouped_f32 launch failed: cudaError_t {err}")
    fc.LAUNCHES[counter] += 1
    return y, i1, i2


def grouped_bwd_raw(s1, u, s2, x, offsets, index, g, i1, i2, precision: str = "fp32"):
    """``(dx, ds1, du, ds2)`` of :func:`grouped_bwd_plain`, no autograd: K3 of
    the grouped product with its sums and their second pass (one counted
    launch) on CUDA tensors, the plain version on CPU tensors."""
    if fc._on_cpu(s1, u, s2, x, offsets, g, i1, i2, *(() if index is None else (index,))):
        return grouped_bwd_plain(s1, u, s2, x, offsets, index, g, i1, i2, precision)
    (E, G, D), s1, u, s2, x, offsets, index = _card_args(s1, u, s2, x, offsets, index)
    fc.check_precision(D, precision)
    M = _rows(x, index)
    width = fc.vector_bytes(D)
    g, i1, i2 = (fc._aligned(t.contiguous(), width) for t in (g, i1, i2))
    if g.shape != (M, D) or i1.shape != (M, D) or i2.shape != (M, D):
        raise ValueError(f"cotangent and residuals must be ({M}, {D}), got {tuple(g.shape)}, "
                         f"{tuple(i1.shape)}, {tuple(i2.shape)}")
    runs = torch.div(offsets[1:] - offsets[:-1] + (RUN - 1), RUN, rounding_mode="floor")
    run_offsets = F.pad(torch.cumsum(runs, 0), (1, 0))
    n_slots = -(-M // RUN) + G  # at least the runs there are
    part = torch.empty(3, n_slots, D, dtype=x.dtype, device=x.device)
    dx = torch.zeros_like(x)
    sums = torch.empty(3, G, D, dtype=x.dtype, device=x.device)
    counter = fc._counter("fused_grouped_bwd_sums", precision, x.dtype)
    lib = fc.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device), span(fc.KERNEL_SPANS[counter]):
        err = lib.whvi_grouped_bwd_f32(
            g.data_ptr(), x.data_ptr(), _ptr(index), s1.data_ptr(), u.data_ptr(), s2.data_ptr(),
            i1.data_ptr(), i2.data_ptr(), offsets.data_ptr(), run_offsets.data_ptr(),
            dx.data_ptr(), part.data_ptr(), n_slots, G, G // E, RUN, int(precision == "bf16"),
            int(math.log2(D)), stream,
        )
        if err == 0:
            err = lib.whvi_grouped_sum_runs_f32(
                part.data_ptr(), run_offsets.data_ptr(), sums.data_ptr(), n_slots, G,
                int(math.log2(D)), stream,
            )
    if err != 0:
        raise RuntimeError(f"the grouped backward's launch failed: cudaError_t {err}")
    fc.LAUNCHES[counter] += 1
    per = G // E
    return dx, sums[0].view(E, per, D).sum(1), sums[1], sums[2].view(E, per, D).sum(1)


class WhviMulGroupedFunction(torch.autograd.Function):
    """The grouped product with its gradients (``apply(s1, u, s2, x,
    offsets, index, precision)``): K2 forward, the grouped K3 with its sums
    backward (:func:`grouped_bwd_raw`). ``offsets`` and ``index`` take no
    gradient."""

    @staticmethod
    def forward(ctx, s1, u, s2, x, offsets, index, precision):
        y, i1, i2 = grouped_raw(s1, u, s2, x, offsets, index, True, precision)
        ctx.save_for_backward(s1, u, s2, x, offsets, index, i1, i2)
        ctx.precision = precision
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with span("whvi.op.whvi_mul_grouped_bwd"):
            s1, u, s2, x, offsets, index, i1, i2 = ctx.saved_tensors
            dx, ds1, du, ds2 = grouped_bwd_raw(
                s1, u, s2, x, offsets, index, g.contiguous(), i1, i2, ctx.precision
            )
        return ds1, du, ds2, dx, None, None, None


def _argtypes(lib) -> None:
    """The C entries' signatures (``fwht_cuda.load_library`` calls it)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.whvi_grouped_f32.argtypes = [vp] * 9 + [i32, i32, i64, i32, i32, i32, vp]
    lib.whvi_grouped_bwd_f32.argtypes = [vp] * 12 + [i64, i32, i32, i32, i32, i32, vp]
    lib.whvi_grouped_sum_runs_f32.argtypes = [vp] * 3 + [i64, i32, i32, vp]
    for name in ("whvi_grouped_f32", "whvi_grouped_bwd_f32", "whvi_grouped_sum_runs_f32"):
        getattr(lib, name).restype = ctypes.c_int
