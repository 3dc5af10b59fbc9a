"""The core WHVI structured-matrix operator (PyTorch).

Counterpart of :mod:`whvi_tpu.ops.whvi_op`::

    y = x @ W_bar(u)^T = s1 * H(u * H(s2 * x)),   W_bar(u) = S1 H diag(u) H S2

``whvi_mul`` runs the fused CUDA kernel on CUDA tensors and its plain
PyTorch version on CPU tensors; the device of the operands alone decides
(see :mod:`whvi_tpu_torch.ops.fwht_cuda`). The JAX package's backend
switch, its vmap probe and its Pallas dispatch table exist for JAX
tracers on a TPU and have no counterpart here.
"""

from __future__ import annotations

import torch

from whvi_tpu_torch.ops.fwht_cuda import WhviMulFunction, fused_raw
from whvi_tpu_torch.ops.hadamard import build_H

__all__ = ["whvi_mul", "whvi_dense", "whvi_mul_dense_oracle"]


def whvi_mul(s1, u, s2, x):
    """Compute ``x @ W_bar(u)^T`` with ``W_bar(u) = S1 H diag(u) H S2``.

    ``s1, u, s2`` are diagonals of shape ``(D,)`` or any shape whose
    leading axes broadcast against ``x``'s (``(stack, D)`` against
    ``x (..., 1, D)``; a per-sample ``u (S, 1, D)``; a per-row
    ``u (S, B, D)``). Returns the broadcast ``(..., D)``.

    With a gradient to record this is :class:`WhviMulFunction` (the
    kernel with residuals forward, the swapped kernel backward);
    otherwise the y-only launch.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (s1, u, s2, x)
    ):
        return WhviMulFunction.apply(s1, u, s2, x)
    return fused_raw(s1, u, s2, x, want_residuals=False)[0]


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
