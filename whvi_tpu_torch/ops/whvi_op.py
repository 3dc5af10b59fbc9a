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

from whvi_tpu_torch.ops.fwht_cuda import (
    MAX_D,
    MIN_D_BF16,
    PRECISIONS,
    WhviMulFunction,
    fused_raw,
)
from whvi_tpu_torch.ops.hadamard import build_H, is_pow_of_2

__all__ = [
    "bf16_eligible",
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


def bf16_eligible(s1, u, s2, x, per_example: bool = False, replicated: bool = False) -> bool:
    """Whether the JAX ``"pallas"`` backend sends this product to its bf16
    kernel (``whvi_tpu/ops/whvi_op.py:150-176``): ``(D,)`` diagonals ``s1``
    and ``s2``; a ``u`` that varies only over sample axes (1-D, or its row
    axis, the second-to-last, of size 1: the 1-D ``u`` of JAX's vmap over
    samples) and is not drawn per example; ``D`` a power of two in
    ``[4, 16384]``.

    ``per_example`` says that ``u`` has one row per batch row. JAX decides
    by ``u``'s rank, and its per-example ``u (B, D)`` is 2-D even at
    ``B = 1``; here a batch of one gives ``u (..., 1, D)``, the shape of a
    shared ``u``, so the caller that drew it per example has to say so.

    ``replicated`` says that the operands' leading axis is a replica axis
    (:func:`whvi_tpu_torch.models.networks.stack_replicas`), the counterpart of the
    JAX trainer's vmap over replicas, which the JAX backend does not see:
    a diagonal ``(R, 1, .., 1, D)`` is then each replica's 1-D diagonal,
    so a stacked product rounds exactly where each replica's own product
    does."""
    D = x.shape[-1]

    def diagonal(s):
        if replicated:
            return all(n == 1 for n in s.shape[1:-1])
        return s.dim() == 1

    return (
        not per_example
        and diagonal(s1)
        and diagonal(s2)
        and (u.dim() == 1 or u.shape[-2] == 1)
        and is_pow_of_2(D)
        and MIN_D_BF16 <= D <= MAX_D
    )


def whvi_mul(
    s1, u, s2, x, precision: str | None = None, per_example: bool = False,
    replicated: bool = False,
):
    """Compute ``x @ W_bar(u)^T`` with ``W_bar(u) = S1 H diag(u) H S2``.

    ``s1, u, s2`` are diagonals of shape ``(D,)`` or any shape whose
    leading axes broadcast against ``x``'s (``(stack, D)`` against
    ``x (..., 1, D)``; a per-sample ``u (S, 1, D)``; a per-row
    ``u (S, B, D)``). Returns the broadcast ``(..., D)``.

    ``precision`` (None: :func:`get_whvi_mul_precision`) is ``"fp32"`` or
    ``"bf16"``. As under the JAX ``"pallas"`` backend, ``"bf16"`` rounds
    only the products its kernel takes (:func:`bf16_eligible`): square
    ``(D,)`` diagonals with a shared-noise ``u``, ``4 <= D <= 16384``.
    Stacked ``(stack, D)`` products, per-example-noise ``u (..., B, D)``
    (``per_example``, which also covers ``B = 1``) and other widths
    compute fp32, as JAX sends them to XLA. ``replicated`` (the leading
    axis is a replica axis) makes a per-replica ``(R, 1, .., 1, D)``
    diagonal count as ``(D,)``, as each replica's own product would.

    Storage: the four operands share one dtype, or ``TypeError``
    (``fwht_cuda.fused_raw``); the kernels take float32 and bfloat16 (the
    JAX package's ``dtype=bfloat16``), the plain versions any float dtype.
    On bf16 storage the product is the JAX ``"xla"`` expression with each
    op rounded to bf16 and each transform summed in fp32 (``fwht_cuda``'s
    module docstring).
    A ``"bf16"``-precision product on bf16 storage raises ``ValueError``
    where the JAX ``"pallas"`` backend would reach its kernel (an eligible
    product), as that kernel raises on bf16 refs; ineligible ones compute
    fp32, as JAX sends them to XLA.

    With a gradient to record this is :class:`WhviMulFunction` (the
    kernel with residuals forward, the swapped kernel backward);
    otherwise the y-only launch.
    """
    if precision is None:
        precision = _PRECISION
    if precision == "bf16" and not bf16_eligible(s1, u, s2, x, per_example, replicated):
        precision = "fp32"
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
