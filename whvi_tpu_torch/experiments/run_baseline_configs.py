"""BASELINE configs 3 and 5 on one NVIDIA H100, on data made from a seed.

Counterpart of ``experiments/run_baseline_configs.py``::

    python -m whvi_tpu_torch.experiments.run_baseline_configs [--quick]
        [--seed 0] [--skip 3 5] [--epochs2 N] [--lambda-last 1.0]
        [--hetero-sigma0 0.3]

- **Config 3**, the deep heteroscedastic net: ``mlp_layers(16, 2,
  hidden=(512, 512), lambda_hidden=3, lambda_last)`` under a
  ``HeteroscedasticGaussianLikelihood(sigma0)`` on
  :func:`synthetic_hetero_data` (2048 rows, 90/10 split), 100 + epochs2
  epochs (5000, or 500 with ``--quick``) at batch 256; test RMSE,
  predictive MNLL and the correlation of the learned noise curve with the
  true one.
- **Config 5**, large D: ``D -> D -> D -> 1`` at D = 8192, S = 64 MC
  samples, batch 256 (2048, 8, 64 with ``--quick``) for 30 steps (10)
  after as many warm-up steps: ELBO steps/s and posterior samples/s.

Output: the first line names the card and its power limit; then one JSON
row per config, with the JAX script's keys plus ``device``. The
functions take their device, and :func:`main` refuses to run without a
card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.models import (
    HeteroscedasticGaussianLikelihood,
    WHVILinear,
    WHVINetwork,
    WHVIRegression,
    mlp_layers,
    relu,
)
from whvi_tpu_torch.train import TrainConfig, Trainer

__all__ = ["config3_deep_hetero", "config5_large_d", "main", "synthetic_hetero_data"]


def synthetic_hetero_data(n=2048, d=16, seed=0):
    """Regression with input-dependent noise, ``y = f(x) + s(x) * eps``,
    ``s(x) = 0.05 + 0.5 * sigmoid(3 x_0)``: ``(X, y (n, 1), s)``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    f = np.sin(X[:, :4].sum(1)) + 0.5 * X[:, 4] * X[:, 5]
    s = 0.05 + 0.5 / (1.0 + np.exp(-3.0 * X[:, 0]))
    y = (f + s * rng.randn(n)).astype(np.float32)[:, None]
    return X, y, s.astype(np.float32)


def config3_deep_hetero(
    *,
    device,
    epochs2: int | None = None,
    quick: bool = False,
    seed: int = 0,
    lambda_last: float = 1.0,
    hetero_sigma0: float = 0.3,
    n: int = 2048,
    hidden=(512, 512),
    epochs1: int = 100,
) -> dict:
    """The deep heteroscedastic net (BASELINE config 3); ``n``, ``hidden``
    and ``epochs1`` keep the JAX script's values unless a test cuts them."""
    device = torch.device(device)
    X, y, s_true = synthetic_hetero_data(n=n)
    n_tr = int(0.9 * len(X))
    X_tr, X_te, y_tr, y_te = X[:n_tr], X[n_tr:], y[:n_tr], y[n_tr:]
    net = WHVINetwork(
        mlp_layers(X.shape[1], 2, hidden=tuple(hidden), lambda_hidden=3.0,
                   lambda_last=lambda_last),
        HeteroscedasticGaussianLikelihood(sigma0=hetero_sigma0),
        train_samples=1,
        eval_samples=64,
    )
    if epochs2 is None:
        epochs2 = 500 if quick else 5000
    cfg = TrainConfig(
        epochs1=epochs1,
        epochs2=epochs2,
        epochs_per_call=min(500, epochs2),
        batch_size=256,
        kl_warmup_steps=2 * (epochs2 + epochs1),
    )
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(seed)
    t0 = time.perf_counter()
    state, logs = trainer.fit(state, X_tr, y_tr)
    wall = time.perf_counter() - t0
    m = trainer.evaluate(X_te, y_te, torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        y_hat = trainer.net.predict(
            torch.as_tensor(X_te, device=device), 64,
            torch.Generator(device=device).manual_seed(2),
        )
        mean, sigma = trainer.net.likelihood.split(y_hat)
        pred = mean.mean(0)[:, 0].cpu().numpy()
        pred_sd = sigma.mean(0)[:, 0].cpu().numpy()
    return {
        "config": "baseline-3-deep-hetero-D512",
        "hidden": list(hidden),
        "lambda_last": lambda_last,
        "hetero_sigma0": hetero_sigma0,
        "rmse": float(np.sqrt(np.mean((pred - y_te[:, 0]) ** 2))),
        "pred_mnll_per_point": m["pred_mnll_per_point"],
        "learned_noise_corr_with_true": float(np.corrcoef(pred_sd, s_true[n_tr:])[0, 1]),
        "epochs_per_s": (epochs1 + epochs2) / wall,
        "final_loss": logs[-1]["loss"],
        "device": device_name(device),
    }


def config5_large_d(*, device, quick: bool = False, D=None, S=None, B=None, steps=None) -> dict:
    """ELBO step throughput of the D -> D -> D -> 1 net (BASELINE config
    5); ``D``, ``S``, ``B`` and ``steps`` default to the JAX script's."""
    device = torch.device(device)
    D = D or (2048 if quick else 8192)
    S = S or (8 if quick else 64)
    B = B or (64 if quick else 256)
    steps = steps or (10 if quick else 30)
    net = WHVIRegression(
        [
            WHVILinear(D, D, lambda_=3.0, s_init="auto"),
            relu,
            WHVILinear(D, D, lambda_=3.0, s_init="auto"),
            relu,
            WHVILinear(D, 1, s_init="auto"),
        ],
        train_samples=S,
    )
    rng = np.random.RandomState(0)
    X = rng.randn(B, D).astype(np.float32)
    y = rng.randn(B, 1).astype(np.float32)
    cfg = TrainConfig(epochs1=0, epochs2=steps, epochs_per_call=steps, batch_size=B)
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(0)
    state, _ = trainer.fit(state, X, y)  # warm-up: the kernels' build and first launches
    t0 = time.perf_counter()
    state, logs = trainer.fit(state, X, y)
    wall = time.perf_counter() - t0
    steps_per_s = steps / wall
    return {
        "config": "baseline-5-largeD-highMC",
        "D": D,
        "mc_samples": S,
        "batch": B,
        "elbo_steps_per_s": steps_per_s,
        "posterior_samples_per_s": steps_per_s * S * B,
        "final_loss": logs[-1]["loss"],
        "device": device_name(device),
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--epochs2", type=int, default=None)
    ap.add_argument("--lambda-last", type=float, default=1.0)
    ap.add_argument("--hetero-sigma0", type=float, default=0.3)
    args = ap.parse_args(argv)
    header("run_baseline_configs")
    device = torch.device("cuda", 0)
    rows = []
    if "3" not in args.skip:
        rows.append(emit(config3_deep_hetero(
            device=device, epochs2=args.epochs2, quick=args.quick, seed=args.seed,
            lambda_last=args.lambda_last, hetero_sigma0=args.hetero_sigma0,
        )))
    if "5" not in args.skip:
        rows.append(emit(config5_large_d(device=device, quick=args.quick)))
    return rows


if __name__ == "__main__":
    main()
