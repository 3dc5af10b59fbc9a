"""Counting and timing on one NVIDIA H100.

Counterpart of :mod:`whvi_tpu.utils.profiling`:

- :func:`fwht_flops`, :func:`whvi_mul_flops`, the layer and network
  counts (:func:`whvi_layer_fwd_flops`, :func:`whvi_layer_train_flops`,
  :func:`net_train_step_flops`, :func:`elbo_step_flops`): the matmul flops
  of the Kronecker-factor formulation, as the JAX package counts them.
  The butterfly kernels do other work (adds only), so a rate computed
  from these counts is a flop-equivalent rate;
- the H100's published peaks (NVIDIA's data sheet, SXM part, dense, at
  its 700 W limit). They are spec, not measurements, and a card set to a
  lower power limit runs below them;
- :func:`cuda_ms`: kernel time from CUDA events, which takes the place of
  the JAX package's ``chain_time`` (difference timing of on-device
  chains, needed only behind the TPU's remote dispatch);
- :func:`device_profile`: what ``torch.profiler`` reads over a window of
  work: the device's own time and events, the busy share, host time in
  ``Optimizer.step``;
- :func:`card`, :func:`require_cuda`: what the measuring code states
  beside its numbers, and its refusal to run without a card.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

from whvi_tpu_torch.models.weights import PaddedSquareMatrix, SquarePow2Matrix, StackedMatrix
from whvi_tpu_torch.ops.hadamard import fwht_factors

__all__ = [
    "H100_HBM_GBPS",
    "H100_PEAK_BF16_FLOPS",
    "H100_PEAK_TF32_FLOPS",
    "card",
    "cuda_ms",
    "device_profile",
    "elbo_step_flops",
    "fwht_flops",
    "net_train_step_flops",
    "require_cuda",
    "whvi_layer_fwd_flops",
    "whvi_layer_train_flops",
    "whvi_mul_flops",
]

# NVIDIA H100 SXM, data sheet (spec, not measured)
H100_HBM_GBPS = 3350.0  # HBM3, GB/s
H100_PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
H100_PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
H100_PEAK_FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores


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


def whvi_layer_fwd_flops(D: int, batch: int, stack: int = 1) -> int:
    """Matmul flops of one forward pass through one WHVI layer, per MC
    sample: one fused product of each of ``stack`` blocks. ``W_bar(u)`` is
    linear in ``u``, so the LRT's mean and noise products merge into one
    (``models/weights.py``): the LRT does not change the count, and the
    JAX counters' ``lrt`` argument, which they ignore, is left out."""
    return whvi_mul_flops(D, batch) * stack


def whvi_layer_train_flops(D: int, batch: int, stack: int = 1) -> int:
    """Matmul flops of one train step through one WHVI layer, per MC
    sample: twice the forward (H is constant, so the backward is one more
    product, on the swapped diagonals; the diagonals' gradients are
    elementwise reductions)."""
    return 2 * whvi_layer_fwd_flops(D, batch, stack)


def net_train_step_flops(net, batch: int, n_samples: int | None = None) -> int:
    """Matmul flops of one ELBO train step of a ``WHVINetwork``, from the
    types of its layers' matrices: square, stacked and padded matrices
    count, column matrices (O(n), no matmul), activations and the layers
    without a ``matrix`` (``Dense``, ``Parallel``) do not, as in JAX."""
    S = net.train_samples if n_samples is None else n_samples
    total = 0
    for layer in net.layers:
        m = getattr(layer, "matrix", None)
        if isinstance(m, (SquarePow2Matrix, PaddedSquareMatrix)):
            total += whvi_layer_train_flops(m.D, batch)
        elif isinstance(m, StackedMatrix):
            D_in, _, _, stack = m.dims
            total += whvi_layer_train_flops(D_in, batch, stack)
    return S * total


def elbo_step_flops(square_dims, batch: int, n_samples: int) -> int:
    """Matmul flops of one ELBO train step of a WHVI MLP whose Bayesian
    layers are the square ``D x D`` of ``square_dims`` (the scaling
    model); its column output layer is O(D) and not counted."""
    return n_samples * sum(whvi_layer_train_flops(D, batch) for D in square_dims)


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


def device_profile(fn: Callable[[], object], top: int = 0) -> dict:
    """What ``torch.profiler`` reads over one call of ``fn``, the card
    (where there is one) synchronized before and after it:

    - ``wall_s``: host-clock seconds of the call;
    - ``device_us`` and ``device_events``: the summed time and the count of
      the device's own events (kernels, copies, memsets). ``key_averages``'
      device totals are not read: they count a kernel again under each op
      and annotation that encloses it (about 3x on a scaling step);
    - ``busy_share``: ``device_us`` over ``wall_s``;
    - ``top``: the ``top`` event names with the most device time,
      ``[name, us]`` each;
    - ``optimizer_host_us``: host time inside ``Optimizer.step``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    events = 0
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            events += 1
    device_us = sum(by_name.values())
    return {
        "wall_s": wall,
        "device_us": device_us,
        "device_events": events,
        "busy_share": device_us / 1e6 / wall,
        "top": [[name, us] for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "optimizer_host_us": sum(
            e.cpu_time_total for e in prof.key_averages() if e.key.startswith("Optimizer.step#")
        ),
    }


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
