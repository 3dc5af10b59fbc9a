"""A plain Walsh-Hadamard transform: ``log2 D`` radix-2 butterfly stages.

``H_D`` is the unnormalised Sylvester matrix, ``H[i, j] = (-1)^popcount(i
& j)``, applied along the last axis. Stage ``h`` (1, 2, 4, ...) maps each
pair ``(a, b)`` of elements ``h`` apart inside a block of ``2h`` to ``(a +
b, a - b)``. Adds and subtracts only, in the input's dtype.
"""

from __future__ import annotations

import torch


def fwht(x: torch.Tensor) -> torch.Tensor:
    """``x @ H_D`` along the last axis (``H`` is symmetric, so also ``H_D
    x``); differentiable by autograd, whose backward is the same
    transform."""
    D = x.shape[-1]
    if D < 1 or D & (D - 1):
        raise ValueError(f"length must be a power of two, got {D}")
    lead = x.shape[:-1]
    h = 1
    while h < D:
        pairs = x.reshape(*lead, D // (2 * h), 2, h)
        a, b = pairs[..., 0, :], pairs[..., 1, :]
        x = torch.stack((a + b, a - b), dim=-2).reshape(*lead, D)
        h *= 2
    return x
