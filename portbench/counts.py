"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs
of a configuration counted by the butterfly algorithm, the least bytes of
the public WHVI product, and the statistics of a window.

Peaks: NVIDIA's H100 SXM data sheet (dense, at its 700 W limit); spec,
not measured. A card set to a lower power limit runs below them, so every
share is stated with the card's limit beside it.
"""

from __future__ import annotations

import math

H100_HBM_BYTES_PER_S = 3.35e12  # HBM3
H100_FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores

FLOAT_BYTES = {"float32": 4, "bfloat16": 2}


def whvi_product_flops(D: int) -> int:
    """FLOPs of one row-sample of ``s1 * H(u * H(s2 * x))`` at width ``D``:
    two butterfly transforms of ``D log2 D`` adds each, three diagonal
    products of ``D`` multiplies."""
    return 2 * D * int(math.log2(D)) + 3 * D


def column_flops(D: int) -> int:
    """FLOPs of one row-sample of the column head ``sum(x * row)``: ``D``
    multiplies and ``D`` adds (the row itself is a sample's, not a row's)."""
    return 2 * D


def forward_flops(specs: list, rows: int, samples: int) -> int:
    """Model FLOPs of one forward pass of ``rows`` rows under ``samples`` MC
    samples, from the layer specs of :func:`portbench.reference.layer_specs`:
    a square layer one product, a stacked layer one product a block, a
    column head ``2 D``. Activations, the likelihood and padding are not
    counted."""
    per_row_sample = 0
    for spec in specs:
        if spec["kind"] == "square":
            per_row_sample += whvi_product_flops(spec["shape"][-1])
        elif spec["kind"] == "stacked":
            stack, D = spec["shape"]
            per_row_sample += stack * whvi_product_flops(D)
        elif spec["kind"] == "column":
            per_row_sample += column_flops(spec["shape"][-1])
    return rows * samples * per_row_sample


def train_step_flops(specs: list, rows: int, samples: int) -> int:
    """Model FLOPs of a train step: three times the forward (the backward
    twice it). Work done again to save memory is not counted."""
    return 3 * forward_flops(specs, rows, samples)


def whvi_mul_bytes(rows_samples: int, D: int, u_rows: int, itemsize: int, train: bool) -> int:
    """The public product's interface bytes, each operand read once and each
    output written once, for ``x (rows_samples, D)`` with diagonals ``s1,
    s2 (D,)`` and ``u (u_rows, D)``. Forward: ``s1, u, s2, x`` in, ``y``
    out. With ``train``, forward and backward through autograd: ``g`` (the
    output's gradient) in as well, and ``dx``, ``du``, ``ds1``, ``ds2``
    out."""
    big, small = rows_samples * D, (2 + u_rows) * D
    if train:
        return itemsize * (4 * big + 2 * small)
    return itemsize * (2 * big + small)


def rate(units: int, work_per_unit: float, seconds: float) -> float:
    """Work a second over a whole window: every unit's work over all its
    time, never a median of chunks."""
    return units * work_per_unit / seconds


def p95(values: list) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]
