"""The core WHVI structured-matrix operator (PyTorch).

Counterpart of :mod:`whvi_tpu.ops.whvi_op`::

    y = x @ W_bar(u)^T = s1 * H(u * H(s2 * x)),   W_bar(u) = S1 H diag(u) H S2

``whvi_mul`` runs the fused CUDA kernel on CUDA tensors and its plain
PyTorch version on CPU tensors; the device of the operands alone decides
(see :mod:`whvi_tpu_torch.ops.fwht_cuda`). What it computes is chosen by
the operand precision, :func:`set_whvi_mul_precision`, the port's
counterpart of the JAX package's ``set_whvi_mul_backend``. The JAX vmap
probe and its Pallas dispatch table exist for JAX tracers on a TPU and
have no counterpart here.
"""

from __future__ import annotations

import torch

from whvi_tpu_torch.ops.fwht_cuda import PRECISIONS, WhviMulFunction, fused_raw
from whvi_tpu_torch.ops.hadamard import build_H

__all__ = [
    "get_whvi_mul_precision",
    "set_whvi_mul_precision",
    "whvi_dense",
    "whvi_mul",
    "whvi_mul_dense_oracle",
]

# The operand precision of every whvi_mul that does not pass its own,
# read at call time. "fp32" keeps every earlier path's numerics.
_PRECISION = "fp32"


def set_whvi_mul_precision(name: str) -> None:
    """Select the operand precision of ``whvi_mul``: ``"fp32"`` (the JAX
    ``"xla"`` backend at ``"highest"``, and the JAX package on a CPU) or
    ``"bf16"`` (the JAX ``"pallas"`` backend: its kernels' default
    ``precision="bf16"``, operands rounded to bf16 before each factor
    contraction, fp32 sums)."""
    global _PRECISION
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
    _PRECISION = name


def get_whvi_mul_precision() -> str:
    return _PRECISION


def whvi_mul(s1, u, s2, x, precision: str | None = None):
    """Compute ``x @ W_bar(u)^T`` with ``W_bar(u) = S1 H diag(u) H S2``.

    ``s1, u, s2`` are diagonals of shape ``(D,)`` or any shape whose
    leading axes broadcast against ``x``'s (``(stack, D)`` against
    ``x (..., 1, D)``; a per-sample ``u (S, 1, D)``; a per-row
    ``u (S, B, D)``). Returns the broadcast ``(..., D)``.

    ``precision`` (None: :func:`get_whvi_mul_precision`) is ``"fp32"`` or
    ``"bf16"``; ``"bf16"`` takes ``4 <= D <= 16384`` and raises outside
    it. One divergence from the JAX package: under its ``"pallas"``
    backend only products with ``(D,)`` diagonals reach the bf16 kernel
    (``whvi_tpu/ops/whvi_op.py:150-175``), while stacked ``(stack, D)`` and
    per-row products go through XLA in the module-default precision. Here
    the mode applies to every product, stacked ones included.

    With a gradient to record this is :class:`WhviMulFunction` (the
    kernel with residuals forward, the swapped kernel backward);
    otherwise the y-only launch.
    """
    if precision is None:
        precision = _PRECISION
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (s1, u, s2, x)
    ):
        return WhviMulFunction.apply(s1, u, s2, x, precision)
    return fused_raw(s1, u, s2, x, False, precision)[0]


def whvi_dense(s1, u, s2):
    """Materialize ``W_bar(u) = diag(s1) H diag(u) H diag(s2)`` densely
    (test oracle). ``s1, u, s2`` may carry leading batch axes."""
    D = s1.shape[-1]
    H = build_H(D, s1.dtype, s1.device)
    inner = u[..., :, None] * H * s2[..., None, :]  # diag(u) H diag(s2)
    return s1[..., :, None] * torch.matmul(H, inner)


def whvi_mul_dense_oracle(s1, u, s2, x):
    """Oracle: ``x @ W_bar(u)^T`` via the dense matrix. Tests only."""
    W = whvi_dense(s1, u, s2)
    return torch.einsum("...ij,...j->...i", W, x)
