"""Layouts and row tiles of the fused Kronecker product on one H100.

Counterpart of ``benchmarks/pallas_tune.py``. Every variant computes
``y = s1 * H(u * H(s2 * x))`` with bf16 factor operands and fp32
accumulation, in the TPU bodies' order (``ops/kron_cuda.py``):

  flat     tensor cores, the tile's lane-rows as the matmul rows
  cur      CUDA cores, each factor contracted in place
  swap     CUDA cores, transposed through shared memory
  onecast  cur with one bf16 cast of each scaled activation

at each row tile TB, plus ``flat/tbN-rep``, the last flat candidate
again, to gauge the run-to-run noise. The ``plain`` row is the plain
PyTorch product (``kron_plain``).

One JSON row per variant: ``D, variant, TB, us, GBps, hbm_frac, rel_err,
vs_plain``: ``GBps`` counts ``2 * B * D * 4`` bytes, ``hbm_frac`` is
against the H100's 3.35 TB/s (spec), ``rel_err`` is against the fp32
product (K1) and ``vs_plain`` is the plain row's time over the variant's.
The first line names the card and its power limit.

Run: python -m whvi_tpu_torch.bench.kernel_tune [--batch 512] [--sizes 8192 16384]
"""

from __future__ import annotations

import argparse

from whvi_tpu_torch.bench.common import emit, header, operands, rates, rel_err, time_us
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import kron_cuda as kc

LAYOUTS = {
    "flat": kc.k_flat,
    "cur": kc.k_cur,
    "swap": kc.k_swap,
    "onecast": kc.k_onecast,
}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sizes", type=int, nargs="*", default=[8192, 16384])
    ap.add_argument("--tbs", type=int, nargs="*", default=[64, 128, 256])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    header("kernel_tune")

    rows = []
    for D in args.sizes:
        B = args.batch
        s1, u, s2, x = operands(D, B, args.seed)
        ref = fc.fused_raw(s1, u, s2, x, False)[0]
        t_plain = time_us(lambda: kc.kron_plain(s1, u, s2, x), args.iters)
        rows.append(emit({"D": D, "variant": "plain", "us": t_plain, **rates(B, D, t_plain),
                          "rel_err": rel_err(kc.kron_plain(s1, u, s2, x), ref)}))
        cands = [(f"{name}/tb{TB}", TB, fn)
                 for TB in args.tbs if B % TB == 0 for name, fn in LAYOUTS.items()]
        # the last flat candidate again, for the run-to-run noise
        TB_rep = [TB for TB in args.tbs if B % TB == 0][-1]
        cands.append((f"flat/tb{TB_rep}-rep", TB_rep, kc.k_flat))
        for name, TB, fn in cands:
            err = rel_err(fn(s1, u, s2, x, TB), ref)
            us = time_us(lambda: fn(s1, u, s2, x, TB), args.iters)
            rows.append(emit({"D": D, "variant": name, "TB": TB, "us": us,
                              **rates(B, D, us), "rel_err": err, "vs_plain": t_plain / us}))
    return rows


if __name__ == "__main__":
    main()
