"""The fused fp32 kernel (K1) at large D on one H100: right, and how fast.

Counterpart of ``benchmarks/tpu_kernel_check.py``. For each D:

- numerics on random normal diagonals: K1 (``fused_raw(.., False)``, fp32
  butterflies) against the plain fp32 butterfly product
  (``rel_err_fp32``) and against the plain bf16 Kronecker path
  ``s1 * fwht_kron(u * fwht_kron(s2 * x, "bf16"), "bf16")``
  (``rel_err_bf16``);
- throughput over a dependent chain ``x <- f(x)`` with random-sign,
  norm-preserving diagonals ``+-D^(-1/3)`` (``|f(x)| = |x|``, and ``f`` is
  not the identity), so the chain stays bounded and a chain that did not
  run shows: the final iterate must differ from ``x`` and keep its norm.
  CUDA events time each of K1, the plain fp32 product and the plain bf16
  Kronecker path.

One JSON row per D: the errors, ``k1_us``, ``plain_us``, ``plain_bf16_us``,
K1's ``k1_GBps`` (``2 * B * D * 4`` bytes a call) and ``hbm_frac``
(against the H100's 3.35 TB/s, spec), ``k1_TFLOPs`` (the Kronecker
formulation's matmul flops, ``whvi_mul_flops``, over K1's time; K1 does
butterflies, so this is a flop-equivalent rate) and the plain paths' times
over K1's. The first line names the card and its power limit.

Run: python -m whvi_tpu_torch.bench.kernel_check [--batch 512] [--iters 200]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from whvi_tpu_torch.bench.common import emit, header, operands, rates, rel_err, time_us
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops.hadamard import fwht_kron
from whvi_tpu_torch.utils.profiling import whvi_mul_flops

# A chain's final iterate keeps the norm of x to within this (relative).
# The fp32 paths hold it to about 1e-4; the bf16 path's roundings walk it
# by about 1% over 600 steps (H100, D=16384). A chain that did not run,
# or ran away, is off by far more.
NORM_TOL = 0.05


def k1(s1, u, s2, x):
    return fc.fused_raw(s1, u, s2, x, False)[0]


def plain_fp32(s1, u, s2, x):
    return fc.fused_plain(s1, u, s2, x, False)[0]


def plain_bf16(s1, u, s2, x):
    return s1 * fwht_kron(u * fwht_kron(s2 * x, precision="bf16"), precision="bf16")


def chain_us(f, diagonals, x, iters: int) -> float:
    """Device microseconds per application of ``x <- f(*diagonals, x)``
    (``iters`` applications in one CUDA graph, ``time_us``); raises if the
    chain's last iterate equals ``x`` or lost its norm."""
    state = [x]
    held = []  # every iterate the captured chain reads stays allocated

    def step():
        held.append(state[0])
        state[0] = f(*diagonals, state[0])

    us = time_us(step, iters)
    v = state[0]
    ratio = (v.norm() / x.norm()).item()
    if torch.equal(v, x) or abs(ratio - 1.0) > NORM_TOL:
        raise RuntimeError(
            f"{f.__name__}: the chain did not run as it must (norm ratio {ratio})"
        )
    return us


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--sizes", type=int, nargs="*", default=[256, 1024, 4096, 8192, 16384])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    header("kernel_check")

    rows = []
    for D in args.sizes:
        B = args.batch
        s1, u, s2, x = operands(D, B, args.seed)
        y = k1(s1, u, s2, x)
        err_fp32 = rel_err(y, plain_fp32(s1, u, s2, x))
        err_bf16 = rel_err(y, plain_bf16(s1, u, s2, x))

        rng = np.random.RandomState(args.seed + 7)
        signs = [
            torch.from_numpy(
                (D ** (-1.0 / 3.0) * np.where(rng.rand(D) < 0.5, 1.0, -1.0)).astype(np.float32)
            ).to(x.device)
            for _ in range(3)
        ]
        t_k1 = chain_us(k1, signs, x, args.iters)
        t_p = chain_us(plain_fp32, signs, x, args.iters)
        t_p16 = chain_us(plain_bf16, signs, x, args.iters)
        r = rates(B, D, t_k1)
        rows.append(emit({
            "D": D, "B": B,
            "rel_err_fp32": err_fp32, "rel_err_bf16": err_bf16,
            "k1_us": t_k1, "plain_us": t_p, "plain_bf16_us": t_p16,
            "k1_GBps": r["GBps"], "hbm_frac": r["hbm_frac"],
            "k1_TFLOPs": whvi_mul_flops(D, B) / (t_k1 * 1e-6) / 1e12,
            "speedup": t_p / t_k1, "speedup_vs_bf16": t_p16 / t_k1,
        }))
    return rows


if __name__ == "__main__":
    main()
