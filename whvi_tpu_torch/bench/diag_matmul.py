"""A diagonal matrix product, dense against broadcast, on one H100.

Counterpart of ``benchmarks/diag_matmul.py`` (the reference's
``benchmarks/utils.py:6-67``, which times ``torch.diag(d) @ A`` against
the broadcast product). For each D, with ``d (D,)`` normalized to unit
mean square and ``A (D, D)`` standard normal (numpy, seeded):

  dense_left       ``torch.diag(d) @ A`` (builds the D x D diagonal matrix)
  broadcast_left   ``ops.matmul_diag_left(d, A)`` (``d[:, None] * A``)
  dense_right      ``A @ torch.diag(d)``
  broadcast_right  ``ops.matmul_diag_right(A, d)``

each timed in a CUDA graph (``bench.common.time_us``: ``--iters`` calls a
graph, median of 5 replays; TF32 off, so the dense products are fp32 on
the CUDA cores). A row holds ``match_left`` / ``match_right`` (dense and
broadcast within atol 1e-4), each ``*_us`` and ``speedup_left`` /
``speedup_right`` (dense over broadcast). The first line names the card
and its power limit. Refuses to run without a card.

Run: python -m whvi_tpu_torch.bench.diag_matmul [--sizes 256 1024 4096] [--iters 50]
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from whvi_tpu_torch.bench.common import emit, header, time_us
from whvi_tpu_torch.ops.hadamard import matmul_diag_left, matmul_diag_right

__all__ = ["MATCH_ATOL", "main", "rows"]

MATCH_ATOL = 1e-4


def rows(sizes, iters: int, device, time_fn: Callable[[Callable[[], object], int], float] = time_us) -> list[dict]:
    """One row a D. ``time_fn(fn, iters)`` gives a call's microseconds
    (``time_us`` on the card; the tests pass a stub on the CPU)."""
    out = []
    for D in sizes:
        if D < 1:
            raise ValueError(f"size must be >= 1, got {D}")
        rng = np.random.RandomState(0)
        d = rng.randn(D)
        d = d / np.sqrt(np.mean(d * d))
        d = torch.from_numpy(d.astype(np.float32)).to(device)
        A = torch.from_numpy(rng.randn(D, D).astype(np.float32)).to(device)
        fns = {
            "dense_left": lambda: torch.diag(d) @ A,
            "broadcast_left": lambda: matmul_diag_left(d, A),
            "dense_right": lambda: A @ torch.diag(d),
            "broadcast_right": lambda: matmul_diag_right(A, d),
        }
        row = {
            "D": D,
            "match_left": torch.allclose(fns["dense_left"](), fns["broadcast_left"](), atol=MATCH_ATOL),
            "match_right": torch.allclose(fns["dense_right"](), fns["broadcast_right"](),
                                          atol=MATCH_ATOL),
        }
        for name, fn in fns.items():
            row[f"{name}_us"] = time_fn(fn, iters)
        row["speedup_left"] = row["dense_left_us"] / row["broadcast_left_us"]
        row["speedup_right"] = row["dense_right_us"] / row["broadcast_right_us"]
        out.append(emit(row))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[256, 1024, 4096])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    header("diag_matmul")
    return rows(args.sizes, args.iters, torch.device("cuda", 0))


if __name__ == "__main__":
    main()
