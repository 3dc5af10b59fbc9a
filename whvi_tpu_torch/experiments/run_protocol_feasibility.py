"""kin8nm-scale protocol feasibility on one NVIDIA H100: the full
500 + 50000-epoch UCI protocol on synthetic data of kin8nm's shape (n =
8192, 8 features), with its wall clock and throughput.

Counterpart of ``experiments/run_protocol_feasibility.py``::

    python -m whvi_tpu_torch.experiments.run_protocol_feasibility [--cpu]
        [--n 8192] [--features 8] [--epochs1 500] [--epochs2 50000]
        [--splits 1] [--configs 0] [--epochs-per-call 2500]
        [--rect-mode stack] [--seed 0]

The reference needed 35 hours a split at this scale on a GTX 970. The
real kin8nm file is not in the repository, so the target is a smooth
nonlinear map of the features plus noise, made with numpy from
``--seed`` as the JAX script makes it; shape and epoch count are the
protocol's. The settings are the tuned recipe of the JAX script (bias,
per-example noise, 8 training samples, sigma0 0.1). ``--configs N``
stacks N configurations (a sigma0 x lambda_hidden spread) on the split
axis and runs the grid as one fit (``evaluate_config_grid``).

Output: the first line names the card and its power limit; the last is
one JSON row with the JAX script's keys (without its TPU utilization,
with ``tflops`` the flop-equivalent rate of the Kronecker-factor count,
``utils.profiling.net_train_step_flops``) plus ``card`` and ``device``.
It runs on the card, and without one refuses, unless ``--cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.evaluation import (
    ProtocolConfig,
    _build_net,
    evaluate_bayesian_regression,
    evaluate_config_grid,
)
from whvi_tpu_torch.utils.profiling import net_train_step_flops

__all__ = ["kin8nm_like", "main", "run"]

REFERENCE_WALL_PER_SPLIT_H = 35.0  # the reference on a GTX 970


def kin8nm_like(n: int = 8192, features: int = 8, seed: int = 0):
    """``(X (n, features), y (n,))``: standard normal features and ``y =
    tanh(X W1) w2`` plus noise of 0.05 of its sd, as the JAX script draws
    them."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, features).astype(np.float32)
    w1 = rng.randn(features, 16).astype(np.float32) / np.sqrt(features)
    w2 = rng.randn(16).astype(np.float32) / 4.0
    f = np.tanh(X @ w1) @ w2
    y = (f + 0.05 * f.std() * rng.randn(n)).astype(np.float32)
    return X, y


def run(
    *,
    device,
    n: int = 8192,
    features: int = 8,
    epochs1: int = 500,
    epochs2: int = 50000,
    splits: int = 1,
    configs: int = 0,
    epochs_per_call: int = 2500,
    rect_mode: str = "stack",
    seed: int = 0,
    card: str = "cpu",
) -> dict:
    """The protocol on ``device``; returns the result row."""
    device = torch.device(device)
    X, y = kin8nm_like(n, features, seed)
    cfg = ProtocolConfig(
        n_splits=splits,
        epochs1=epochs1,
        epochs2=epochs2,
        epochs_per_call=epochs_per_call,
        seed=seed,
        bias=True,
        per_example_noise=True,
        train_samples=8,
        sigma0=0.1,
        rect_mode=rect_mode,
    )
    n_train = n - max(1, int(round(n * cfg.test_frac)))
    batches = -(-n_train // cfg.batch_size)
    step_flops = net_train_step_flops(_build_net(cfg, features, 1), cfg.batch_size)
    total_epochs = epochs1 + epochs2

    t0 = time.time()
    if configs:
        sig = [0.05, 0.1, 0.2, 0.4]
        lam = [1.0, 3.0, 10.0]
        overrides = [
            {"sigma0": sig[i % len(sig)], "lambda_hidden": lam[i % len(lam)]}
            for i in range(configs)
        ]
        out = evaluate_config_grid(X, y, cfg, overrides, device=device)["configs"][0]
        n_replicas = configs * splits
    else:
        out = evaluate_bayesian_regression(X, y, cfg, device=device)
        n_replicas = splits
    wall = time.time() - t0
    eps = n_replicas * total_epochs / wall
    return {
        "experiment": "kin8nm_scale_feasibility",
        "shape": [n, features],
        "epochs": total_epochs,
        "splits": splits,
        "configs": configs or None,
        "rect_mode": rect_mode,
        "stack_replicas": n_replicas,
        "rmse_mean": out["rmse_mean"],
        "pred_mnll_mean": out.get("pred_mnll_per_point_mean"),
        "wall_s": wall,
        "wall_s_per_replica_amortized": wall / n_replicas,
        "epochs_per_s": eps,
        "tflops": eps * batches * step_flops / 1e12,
        "reference_wall_per_split_h": REFERENCE_WALL_PER_SPLIT_H,
        "speedup_vs_reference": REFERENCE_WALL_PER_SPLIT_H * 3600.0 / (wall / n_replicas),
        "card": card,
        "device": device_name(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=50000)
    ap.add_argument("--splits", type=int, default=1)
    ap.add_argument("--configs", type=int, default=0,
                    help="stack N configurations on the split axis and run the "
                    "grid as one fit")
    ap.add_argument("--epochs-per-call", type=int, default=2500,
                    help="epochs between host reads of the metrics")
    ap.add_argument("--rect-mode", choices=["stack", "pad"], default="stack")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpu:
        device, card = torch.device("cpu"), "cpu"
        emit({"tool": "run_protocol_feasibility", "device": "cpu", "torch": torch.__version__})
    else:
        device, card = torch.device("cuda", 0), header("run_protocol_feasibility")["card"]
    return emit(run(
        device=device, n=args.n, features=args.features, epochs1=args.epochs1,
        epochs2=args.epochs2, splits=args.splits, configs=args.configs,
        epochs_per_call=args.epochs_per_call, rect_mode=args.rect_mode, seed=args.seed,
        card=card,
    ))


if __name__ == "__main__":
    main()
