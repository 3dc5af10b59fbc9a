"""What ``whvi_mul`` computes in each of the port's modes, and how fast, on
one H100; and whether its default precision is the fp32 mode.

Counterpart of ``benchmarks/precision_check.py`` (the JAX MXU's precision
modes against the float64 oracle) and, as its ``auto_equals_fp32``
column, of ``benchmarks/auto_dispatch_check.py``. For each D and mode it
runs ``ops.whvi_op.whvi_mul`` without a gradient, so K1 runs:

  fp32   float32 storage, the fp32 precision (K1 ``fused_y``; the JAX
         ``"xla"`` backend at ``"highest"``)
  bf16   float32 storage, the bf16 precision (K1 ``fused_y_bf16``; the JAX
         ``"pallas"`` backend's default)
  bf16s  bfloat16 storage, the fp32 precision (K1 ``fused_y_bf16s``; the
         JAX ``dtype=bfloat16``)

Columns:

- ``rel_err_vs_f64``: max |y - oracle| / max |oracle| on an 8-row batch of
  the JAX script's operands (s1, s2 ~ 0.01 N(0, 1), u, x ~ N(0, 1)). The
  oracle is the port's own float64 on the CPU: the dense product
  ``whvi_op.whvi_mul_dense_oracle`` at D <= 1024, the plain ``whvi_mul``
  in float64 above it.
- ``us_per_call``: device microseconds a call at batch ``--batch`` on
  norm-preserving random-sign diagonals ``c0 = D^(-1/3)``
  (``bench.common.time_us``: ``--iters`` calls in a CUDA graph, median of
  5 replays); ``GBps`` and ``hbm_frac``: x read and y written once
  (``2 B D`` elements of 4 bytes, 2 in bf16 storage) over the time and
  over 3.35 TB/s; ``bound_ms``, ``bound_by``: ``bench.common.bound_ms``
  (every input read once and the output written once, or the operations
  over the fp32 peak). The JAX ``TFLOPs`` and ``mfu`` columns are not
  kept: ``v5e_peak_flops`` has no counterpart.
- ``auto_equals_fp32``: the product at the port's default precision
  (``get_whvi_mul_precision()``, as the caller left it) equals the fp32
  mode's bit for bit (``torch.equal``). The JAX ``"auto"`` backend's
  table of Pallas shapes is pinned empty (``whvi_tpu/ops/whvi_op.py:63``),
  so there "auto" is "xla" at every shape; the port has one default.
  The ``--auto-sizes`` rows (auto_dispatch_check's D = 2048, 4096, 8192)
  time both beside each other.

The first line names the card and its power limit. Refuses to run
without a card.

Run: python -m whvi_tpu_torch.bench.precision_check [--batch 512] [--iters 100]
    [--sizes 1024 4096 16384] [--auto-sizes 2048 4096 8192]
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from whvi_tpu_torch.bench.common import bound_ms, emit, fused_ops, header, rates, time_us
from whvi_tpu_torch.ops.fwht_cuda import ONE_FACTOR_MAX
from whvi_tpu_torch.ops.whvi_op import get_whvi_mul_precision, whvi_mul, whvi_mul_dense_oracle
from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS

__all__ = ["MODES", "auto_rows", "main", "oracle", "product", "rows"]

# mode: (precision, storage dtype)
MODES = {
    "fp32": ("fp32", torch.float32),
    "bf16": ("bf16", torch.float32),
    "bf16s": ("fp32", torch.bfloat16),
}
ORACLE_ROWS = 8


def oracle(s1, u, s2, x) -> torch.Tensor:
    """``x @ W_bar(u)^T`` in float64 on the CPU: the dense product up to
    D = 1024, the plain ``whvi_mul`` in float64 above it."""
    s1, u, s2, x = (t.to("cpu", torch.float64) for t in (s1, u, s2, x))
    if x.shape[-1] <= ONE_FACTOR_MAX:
        return whvi_mul_dense_oracle(s1, u, s2, x)
    return whvi_mul(s1, u, s2, x)


def _error_operands(D: int):
    """The JAX script's operands (``RandomState(0)``): s1, u, s2 and an
    8-row x, float32."""
    rng = np.random.RandomState(0)
    s1 = (rng.randn(D) * 0.01).astype(np.float32)
    u = rng.randn(D).astype(np.float32)
    s2 = (rng.randn(D) * 0.01).astype(np.float32)
    x = rng.randn(ORACLE_ROWS, D).astype(np.float32)
    return [torch.from_numpy(a) for a in (s1, u, s2, x)]


def _timing_operands(D: int, B: int, device):
    """Random-sign diagonals of size ``D^(-1/3)`` (the product keeps the
    norm of x, so a chain of calls stays bounded) and a ``(B, D)`` x."""
    rng = np.random.RandomState(7)
    c0 = D ** (-1.0 / 3.0)
    signs = [c0 * np.where(rng.rand(D) < 0.5, 1.0, -1.0) for _ in range(3)]
    x = np.random.RandomState(3).randn(B, D)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (*signs, x)]


def product(ops, mode: str, device) -> torch.Tensor:
    """``whvi_mul`` of the float32 ``ops`` (s1, u, s2, x) in ``mode``, on
    ``device``, in the mode's storage."""
    precision, dtype = MODES[mode]
    return whvi_mul(*(t.to(device, dtype) for t in ops), precision=precision)


def rows(
    sizes, batch: int, iters: int, device, time_fn: Callable[[Callable[[], object], int], float] = time_us,
) -> list[dict]:
    """One row a D and mode. ``time_fn(fn, iters)`` gives a call's
    microseconds (``time_us`` on the card; the tests pass a stub on the
    CPU, where no time is taken)."""
    out = []
    for D in sizes:
        ops = _error_operands(D)
        ref = oracle(*ops)
        scale = ref.abs().max().item()
        timing = _timing_operands(D, batch, device)
        y_default = whvi_mul(*timing)
        auto_equal = torch.equal(y_default, whvi_mul(*timing, precision="fp32"))
        for mode, (precision, dtype) in MODES.items():
            y = product(ops, mode, device)
            err = (y.to("cpu", torch.float64) - ref).abs().max().item() / scale
            c1, c2, c3, xt = (t.to(dtype) for t in timing)
            us = time_fn(lambda: whvi_mul(c1, c2, c3, xt, precision=precision), iters)
            bound, bound_by = bound_ms((xt, c1, c2, c3), (xt,), fused_ops(D, batch),
                                       H100_PEAK_FP32_FLOPS)
            out.append(emit({
                "D": D, "B": batch, "mode": mode, "precision": precision,
                "storage": str(dtype).removeprefix("torch."),
                "rel_err_vs_f64": err, "us_per_call": us,
                **rates(batch, D, us, xt.element_size()),
                "bound_ms": bound, "bound_by": bound_by,
                "auto_equals_fp32": auto_equal,
            }))
    return out


def auto_rows(sizes, batch: int, iters: int, device, time_fn=time_us) -> list[dict]:
    """auto_dispatch_check's rows: the default precision against the fp32
    mode at each D, equal bit for bit, and both times."""
    out = []
    for D in sizes:
        c1, c2, c3, x = _timing_operands(D, batch, device)
        equal = torch.equal(whvi_mul(c1, c2, c3, x), whvi_mul(c1, c2, c3, x, precision="fp32"))
        fp32_us = time_fn(lambda: whvi_mul(c1, c2, c3, x, precision="fp32"), iters)
        auto_us = time_fn(lambda: whvi_mul(c1, c2, c3, x), iters)
        out.append(emit({
            "D": D, "B": batch, "check": "auto_dispatch", "default": get_whvi_mul_precision(),
            "auto_equals_fp32": equal, "fp32_us": fp32_us, "auto_us": auto_us,
            "auto_speedup": fp32_us / auto_us,
        }))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sizes", type=int, nargs="*", default=[1024, 4096, 16384])
    ap.add_argument("--auto-sizes", type=int, nargs="*", default=[2048, 4096, 8192])
    args = ap.parse_args(argv)
    header("precision_check")
    device = torch.device("cuda", 0)
    return (rows(args.sizes, args.batch, args.iters, device)
            + auto_rows(args.auto_sizes, args.batch, args.iters, device))


if __name__ == "__main__":
    main()
