"""The bare FWHT against the dense ``x @ H_D`` across D on one H100, in fp32
and bf16 storage.

Counterpart of ``benchmarks/fwht_sweep.py``, the reference's crossover
study (its ``benchmarks/walsh.py``: 1000 transforms x batch 512, D = 2^6
.. 2^11; its finding, that a vectorized FWHT beats the dense matmul from
D ~ 2^11, ``report/performance-testing.tex:16-17``). The JAX script times
its butterfly and Kronecker transforms against ``v @ H`` by difference
timing of on-device chains; here each call is timed in a CUDA graph
(``bench.common.time_us``: ``--iters`` calls a graph, median of 5
replays), per storage:

  kernel   K4 (``fwht_cuda.fwht_raw``): the row-in-registers butterfly
  plain    its plain PyTorch version (``fwht_plain``: log2 D stages of
           torch ops; bf16 transformed in fp32 and rounded once)
  matmul   ``torch.matmul(x, H_D)``, ``H_D`` built once a D on the card
           and cast to the storage dtype (+-1, exact): fp32 on the CUDA
           cores (TF32 off), bf16 on the tensor cores with fp32 sums

at batch ``--batch`` (512, the reference's), D = 2^6 .. 2^14, with the
bound of the transform (x read and y written once over 3.35 TB/s; the
bytes set it at every D). The kernel must equal the plain version bit
for bit; the matmul's error against the kernel is reported
(``matmul_err``: max |matmul - kernel| / max |kernel|).

Output: the first line names the card and its power limit; then one
JSON row per D with ``kernel_us``, ``plain_us``, ``matmul_us``,
``bound_us`` and ``matmul_err`` for each storage (``_f32``, ``_bf16``);
then ``{"crossover_D": {"f32": D, "bf16": D}}``, the least D from which
the kernel beats the matmul (null if it never does). ``--plot OUT.pdf``
writes the chart where ``matplotlib`` imports, and says so where it does
not.

Run: python -m whvi_tpu_torch.bench.fwht_sweep [--batch 512] [--iters 100]
    [--sizes 64 128 ... 16384] [--plot OUT.pdf]
"""

from __future__ import annotations

import argparse
import math
from typing import Callable

import numpy as np
import torch

from whvi_tpu_torch.bench.common import bound_ms, emit, header, time_us
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops.hadamard import build_H
from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS

__all__ = ["SIZES", "STORAGE", "main", "sweep"]

SIZES = [2**k for k in range(6, 15)]
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}
REFERENCE_CLAIM = (
    "vectorized CPU FWHT beats matmul from D ~ 2^11 (performance-testing.tex:16-17)"
)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def sweep(
    sizes, batch: int, iters: int, device, seed: int = 0,
    time_fn: Callable[[Callable[[], object], int], float] = time_us,
) -> tuple[list[dict], dict]:
    """The rows and the crossovers. ``time_fn(fn, iters)`` gives a call's
    microseconds (``time_us`` on the card; the tests pass a stub on the
    CPU, where no time is taken)."""
    rows, crossover = [], dict.fromkeys(STORAGE)
    for D in sizes:
        x64 = np.random.RandomState(seed + D).randn(batch, D)
        row = {"D": D, "batch": batch}
        H32 = build_H(D, torch.float32, device)  # +-1: exact in bf16 too
        for name, dtype in STORAGE.items():
            x = torch.from_numpy(x64.astype(np.float32)).to(device=device, dtype=dtype)
            H = H32.to(dtype)
            y = fc.fwht_raw(x)
            if not torch.equal(y, fc.fwht_plain(x)):
                raise AssertionError(f"fwht D={D} {name}: kernel is not the plain version")
            bound = bound_ms((x,), (y,), x.numel() * math.log2(D), H100_PEAK_FP32_FLOPS)[0]
            row.update({
                f"kernel_us_{name}": time_fn(lambda: fc.fwht_raw(x), iters),
                f"plain_us_{name}": time_fn(lambda: fc.fwht_plain(x), iters),
                f"matmul_us_{name}": time_fn(lambda: torch.matmul(x, H), iters),
                f"bound_us_{name}": bound * 1e3,
                f"matmul_err_{name}": _err(torch.matmul(x, H), y),
            })
            del H
            if crossover[name] is None and row[f"kernel_us_{name}"] < row[f"matmul_us_{name}"]:
                crossover[name] = D
        rows.append(emit(row))
    return rows, crossover


def _write_plot(rows, crossover, path: str, card: str) -> None:
    """Log-log time a transform against D, each route in each storage
    (the JAX script's chart, ``_write_plot``)."""
    try:
        import matplotlib
    except ImportError:
        emit({"plot": None, "reason": "matplotlib does not import here"})
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ls in (("f32", "-"), ("bf16", "--")):
        for route, color in (("kernel", "#2a78d6"), ("plain", "#eb6834"), ("matmul", "#888888")):
            ax.plot([r["D"] for r in rows], [r[f"{route}_us_{name}"] / r["batch"] for r in rows],
                    label=f"{route} {name}", color=color, linestyle=ls, marker="o",
                    markersize=3)
        if crossover[name] is not None:
            ax.axvline(crossover[name], color="#999999", linewidth=0.8, linestyle=ls)
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("transform size D")
    ax.set_ylabel("µs per transform (one row)")
    ax.set_title(f"FWHT vs dense matmul, batch {rows[0]['batch']} ({card})")
    ax.legend(frameon=False, fontsize=7)
    ax.grid(True, which="both", linewidth=0.3, alpha=0.4)
    fig.tight_layout()
    fig.savefig(path)
    emit({"plot": path})


def main(argv=None) -> tuple[list[dict], dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sizes", type=int, nargs="*", default=SIZES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", default=None, metavar="OUT.pdf")
    args = ap.parse_args(argv)
    head = header("fwht_sweep")
    rows, crossover = sweep(args.sizes, args.batch, args.iters, torch.device("cuda", 0),
                            args.seed)
    emit({"crossover_D": crossover, "reference_claim": REFERENCE_CLAIM})
    if args.plot:
        _write_plot(rows, crossover, args.plot, head["card"])
    return rows, crossover


if __name__ == "__main__":
    main()
