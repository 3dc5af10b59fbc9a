"""Walsh-Hadamard numerics core (plain PyTorch).

Counterpart of :mod:`whvi_tpu.ops.hadamard` with the same conventions:
``H_D`` is the unnormalized Sylvester (natural-order) Walsh-Hadamard
matrix, ``H[i, j] = (-1)^popcount(i & j)``, ``H = H^T`` and
``H @ H = D * I``; ``fwht(x)`` applies ``H_D`` along the last axis.

One precision mode is ported: true fp32 (``"fp32"``). The butterfly is
adds and subtracts only, so nothing is rounded below the input dtype.
The TPU's ``default``/``highest``/``bf16`` modes describe MXU operand
rounding and have no counterpart here.

:func:`fwht` is the plain version of the CUDA FWHT kernel
(``ops/fwht_cuda.py``) and runs the same radix-2 stages in the same
order.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "is_pow_of_2",
    "next_pow_of_2",
    "build_H",
    "build_H_rows",
    "fwht",
    "kl_diag_normal",
]


def is_pow_of_2(n: int) -> bool:
    """True iff ``n`` is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def next_pow_of_2(n: int) -> int:
    """Smallest power of two >= n (exact integer bit math)."""
    if n < 1:
        raise ValueError(f"next_pow_of_2 requires n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def _sign_matrix(rows: torch.Tensor, cols: torch.Tensor, dtype, device):
    v = rows[:, None] & cols[None, :]
    parity = torch.zeros_like(v)
    while bool(v.any()):
        parity ^= v & 1
        v >>= 1
    return (1 - 2 * parity).to(dtype=dtype, device=device)


def build_H(D: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense ``H_D`` via the bit trick (test oracle, dense materialization)."""
    if not is_pow_of_2(D):
        raise ValueError(f"Hadamard dimension must be a power of 2, got {D}")
    i = torch.arange(D, dtype=torch.int64)
    return _sign_matrix(i, i, dtype, device)


def build_H_rows(D: int, n_rows: int, dtype=torch.float32, device=None):
    """``H_D[:n_rows, :]`` in O(n_rows * D) memory."""
    if not is_pow_of_2(D):
        raise ValueError(f"Hadamard dimension must be a power of 2, got {D}")
    rows = torch.arange(n_rows, dtype=torch.int64)
    cols = torch.arange(D, dtype=torch.int64)
    return _sign_matrix(rows, cols, dtype, device)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """FWHT along the last axis via ``log2 D`` radix-2 butterfly stages.

    Stage ``h`` combines elements ``j`` and ``j + h`` inside every block
    of ``2h`` (``h = 1, 2, 4, ...``), as ``whvi_tpu.ops.hadamard
    .fwht_butterfly`` does. Differentiable by autograd; any float dtype.
    """
    D = x.shape[-1]
    if not is_pow_of_2(D):
        raise ValueError(f"FWHT length must be a power of 2, got {D}")
    shape = x.shape
    h = 1
    while h < D:
        x = x.reshape(-1, D // (2 * h), 2, h)
        a = x[:, :, 0, :]
        b = x[:, :, 1, :]
        x = torch.stack((a + b, a - b), dim=2)
        h *= 2
    return x.reshape(shape)


def kl_diag_normal(mu_q, sigma_q, mu_p, sigma_p) -> torch.Tensor:
    """KL(N(mu_q, diag sigma_q^2) || N(mu_p, diag sigma_p^2)), summed.

    Arguments are standard deviations (the paper-correct form; see
    ``whvi_tpu.ops.hadamard.kl_diag_normal``)::

        KL = sum[ log(sigma_p / sigma_q)
                  + (sigma_q^2 + (mu_q - mu_p)^2) / (2 sigma_p^2) - 1/2 ]

    The prior's ``mu_p`` and ``sigma_p`` may be tensors or Python floats;
    floats stay host scalars, so no scalar is copied to the device.
    """
    if torch.is_tensor(sigma_p):
        log_sigma_p = torch.log(sigma_p)
    else:
        log_sigma_p = math.log(sigma_p)
    return torch.sum(
        log_sigma_p
        - torch.log(sigma_q)
        + (sigma_q.square() + (mu_q - mu_p) ** 2) / (2.0 * sigma_p * sigma_p)
        - 0.5
    )
