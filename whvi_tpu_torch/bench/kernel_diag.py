"""Where does the fused product's time go at large D? A stage at a time.

Counterpart of ``benchmarks/pallas_diag.py`` on one H100. It builds the
Kronecker-factor product up one stage at a time, each stage one kernel
(``ops/kron_cuda.py``), at a row tile of TB rows:

  copy       y = x                       the tiling's streaming floor
  scale      y = x * s1                  + one elementwise pass
  mm1        R(s2*x) @ H_128             + one factor contraction
  mm2        then H_a on the other axis  + the second contraction
  full       s1*H(u*H(s2*x))             the whole product (flat layout)
  emit_full  full through a persistent two-stage cp.async ring
  k1         the port's fp32 fused kernel (``fused_raw(.., False)``)
  plain      the plain PyTorch Kronecker product (``kron_plain``)

``--floors`` measures the copies instead: ``hbm_copy`` (grid-stride),
``copy2d/tbN`` (staged through shared memory), ``emit_copy/tbN`` (the
persistent ring without the compute) and ``copy3d/tbB-1step`` (``copy``
with the whole batch as one tile).

One JSON row per variant: ``D, variant, TB, us, GBps, hbm_frac``, where
``GBps`` counts ``2 * B * D * 4`` bytes (x read once, y written once) and
``hbm_frac`` is against the H100's 3.35 TB/s (spec). The variants that
compute the whole product also carry ``rel_err`` against the fp32 product
(K1). The first line names the card and its power limit.

Run: python -m whvi_tpu_torch.bench.kernel_diag --sizes 16384 --batch 512
     python -m whvi_tpu_torch.bench.kernel_diag --floors
"""

from __future__ import annotations

import argparse

from whvi_tpu_torch.bench.common import emit, header, operands, rates, rel_err, time_us
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import kron_cuda as kc

LADDER = {
    "copy": kc.k_copy,
    "scale": kc.k_scale,
    "mm1": kc.k_mm1,
    "mm2": kc.k_mm2,
    "full": kc.k_full,
    "emit_full": kc.emit_full,
}


def _row(D, B, variant, us, TB=None, **extra) -> dict:
    row = {"D": D, "variant": variant}
    if TB is not None:
        row["TB"] = TB
    return emit({**row, "us": us, **rates(B, D, us), **extra})


def ladder(args) -> list[dict]:
    rows = []
    for D in args.sizes:
        B = args.batch
        s1, u, s2, x = operands(D, B, args.seed)
        ref = fc.fused_raw(s1, u, s2, x, False)[0]
        us = time_us(lambda: fc.fused_raw(s1, u, s2, x, False), args.iters)
        rows.append(_row(D, B, "k1", us))
        us = time_us(lambda: kc.kron_plain(s1, u, s2, x), args.iters)
        rows.append(_row(D, B, "plain", us, rel_err=rel_err(kc.kron_plain(s1, u, s2, x), ref)))
        for TB in args.tbs:
            if B % TB:
                continue
            for name, fn in LADDER.items():
                us = time_us(lambda: fn(s1, u, s2, x, TB), args.iters)
                extra = {}
                if name in ("full", "emit_full"):  # these compute the product
                    extra["rel_err"] = rel_err(fn(s1, u, s2, x, TB), ref)
                rows.append(_row(D, B, name, us, TB, **extra))
    return rows


def floors(args) -> list[dict]:
    rows = []
    for D in args.sizes:
        B = args.batch
        s1, u, s2, x = operands(D, B, args.seed)
        cands = [("hbm_copy", None, kc.hbm_copy)]
        for TB in args.tbs:
            if B % TB == 0:
                cands += [(f"copy2d/tb{TB}", TB, kc.copy_2d), (f"emit_copy/tb{TB}", TB, kc.emit_copy)]
        cands.append((f"copy3d/tb{B}-1step", B, kc.k_copy))
        for name, TB, fn in cands:
            us = time_us(lambda: fn(s1, u, s2, x, TB), args.iters)
            rows.append(_row(D, B, name, us, TB))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--sizes", type=int, nargs="*", default=[16384])
    ap.add_argument("--tbs", type=int, nargs="*", default=None,
                    help="row tiles (default 32 128 256; 64 128 256 with --floors)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--floors", action="store_true")
    args = ap.parse_args(argv)
    if args.tbs is None:
        args.tbs = [64, 128, 256] if args.floors else [32, 128, 256]
    header("kernel_diag --floors" if args.floors else "kernel_diag")
    return floors(args) if args.floors else ladder(args)


if __name__ == "__main__":
    main()
