"""The UCI protocol of the port against the JAX package's, on the CPU, as a
statistical comparison: both packages run the same protocol configuration
on the same synthetic data, sequential and replica-stacked, over several
seeds, and one JSON row a run gives its RMSE and predictive MNLL. The two
packages draw their noise from different generators, so their results
agree in distribution, not number for number.

Data: ``whvi_tpu_torch.bench.protocol_bench.boston_like(seed)``, 506 x
13 (Boston's shape), a fixed random ReLU net of the features plus noise,
made with numpy from the seed. Protocol: ``ProtocolConfig``'s
defaults (the 13 -> 128 -> 128 -> 1 flagship, batch 64, 64 eval samples)
at ``--splits`` splits and ``--epochs1`` + ``--epochs2`` epochs, with
``--lambda-last`` and ``--sigma0``: at the protocol's own 1e-5 and 1.0,
both packages stay at the constant predictor for the first thousands of
epochs on these targets (RMSE = their sd, 0.63 at seed 0), so the
defaults are 1.0 and 0.3, where the net fits within 300 epochs.

Run from the repository root (JAX on the CPU; this tool imports both
packages and stays outside them and the tests):

    python -m tools.protocol_parity [--seeds 0 1 2] [--splits 4]
        [--epochs1 5] [--epochs2 300] [--lambda-last 1.0] [--sigma0 0.3]

The last row is the mean and sd over seeds of each package and path.
"""

from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--splits", type=int, default=4)
    ap.add_argument("--epochs1", type=int, default=5)
    ap.add_argument("--epochs2", type=int, default=300)
    ap.add_argument("--lambda-last", type=float, default=1.0)
    ap.add_argument("--sigma0", type=float, default=0.3)
    args = ap.parse_args(argv)

    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    import whvi_tpu.evaluation as jev
    import whvi_tpu_torch.evaluation as pev
    from whvi_tpu_torch.bench.protocol_bench import boston_like

    rows = []
    for seed in args.seeds:
        X, y = boston_like(seed)
        for package, ev, kw in (("jax", jev, {}), ("torch", pev, {"device": "cpu"})):
            for stacked in (False, True):
                cfg = ev.ProtocolConfig(n_splits=args.splits, epochs1=args.epochs1,
                                        epochs2=args.epochs2, lambda_last=args.lambda_last,
                                        sigma0=args.sigma0, vmap_splits=stacked, seed=seed)
                t0 = time.time()
                out = ev.evaluate_bayesian_regression(X, y, cfg, **kw)
                rows.append({
                    "package": package, "path": "stacked" if stacked else "sequential",
                    "seed": seed, "rmse_mean": out["rmse_mean"],
                    "pred_mnll_per_point_mean": out["pred_mnll_per_point_mean"],
                    "coverage95_mean": out["coverage95_mean"], "cpu_s": time.time() - t0,
                })
                print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for package in ("jax", "torch"):
        for path in ("sequential", "stacked"):
            sel = [r for r in rows if r["package"] == package and r["path"] == path]
            for k in ("rmse_mean", "pred_mnll_per_point_mean"):
                v = np.array([r[k] for r in sel])
                summary[f"{package} {path} {k}"] = [float(v.mean()), float(v.std())]
    print(json.dumps({"summary_over_seeds": summary, "args": vars(args)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
