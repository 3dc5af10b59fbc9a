"""Counting and timing on one NVIDIA H100.

Counterpart of :mod:`whvi_tpu.utils.profiling`:

- :func:`fwht_flops`, :func:`whvi_mul_flops`: the matmul flops of the
  Kronecker-factor formulation, as the JAX package counts them;
- the H100's published peaks (NVIDIA's data sheet, SXM part, dense, at
  its 700 W limit). They are spec, not measurements, and a card set to a
  lower power limit runs below them;
- :func:`cuda_ms`: kernel time from CUDA events, which takes the place of
  the JAX package's ``chain_time`` (difference timing of on-device
  chains, needed only behind the TPU's remote dispatch);
- :func:`card`, :func:`require_cuda`: what the measuring code states
  beside its numbers, and its refusal to run without a card.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch

from whvi_tpu_torch.ops.hadamard import fwht_factors

__all__ = [
    "H100_HBM_GBPS",
    "H100_PEAK_BF16_FLOPS",
    "H100_PEAK_TF32_FLOPS",
    "card",
    "cuda_ms",
    "fwht_flops",
    "require_cuda",
    "whvi_mul_flops",
]

# NVIDIA H100 SXM, data sheet (spec, not measured)
H100_HBM_GBPS = 3350.0  # HBM3, GB/s
H100_PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
H100_PEAK_TF32_FLOPS = 495e12  # tensor cores, dense


def fwht_flops(D: int, batch: int) -> int:
    """Matmul flops of one Kronecker-factor FWHT of a ``(batch, D)``
    operand: factor ``f_i`` is a ``(batch * D / f_i, f_i) @ (f_i, f_i)``
    contraction, ``2 * batch * D * f_i`` flops. Elementwise work is not
    counted."""
    return 2 * batch * D * sum(fwht_factors(D))


def whvi_mul_flops(D: int, batch: int) -> int:
    """Matmul flops of one product ``s1 * H(u * H(s2 * x))`` of a
    ``(batch, D)`` operand: two FWHTs."""
    return 2 * fwht_flops(D, batch)


def cuda_ms(fn: Callable[[], object], reps: int = 20, rounds: int = 7) -> float:
    """Median milliseconds per call of ``fn`` on the current card, warm:
    CUDA events around ``reps`` calls, ``rounds`` times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def require_cuda() -> None:
    """Raise unless a CUDA device is there: a measurement never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device: torch.cuda.is_available() is False")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]
