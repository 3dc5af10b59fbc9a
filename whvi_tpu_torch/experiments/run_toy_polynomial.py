"""The paper's toy polynomial experiment on one NVIDIA H100.

Counterpart of ``experiments/run_toy_polynomial.py``::

    python -m whvi_tpu_torch.experiments.run_toy_polynomial [--epochs1 500]
        [--epochs2 20000] [--lambdas 1 2.5 5] [--sigma0 0.1]
        [--activation sigmoid|cosine] [--s-init auto] [--train-samples 4]
        [--ignore-kl] [--seed 0]

A degree-8 polynomial with a gap on x in [0.6, 1.4], noise N(0, exp(-3)),
128 points (``polynomial_data(seed)``); model ``WHVILinear(1, 128,
lambda_=l1)``, act, ``WHVILinear(128, 128, lambda_=l2,
per_example_noise=True)``, act, ``WHVILinear(128, 1, lambda_=l3)`` with
``sigma0``; full batch (128), KL warm-up over 0.4 of the steps. It reports
the training fit and the predictive stddev inside the gap against the
observed support (a Bayesian model should be more uncertain in the gap).

Output: the first line names the card and its power limit; the last line
has the JAX script's keys (``experiment, ignore_kl, train_rmse,
train_mnll_per_point, pred_sd_gap, pred_sd_observed, n_params, wall_s,
epochs_per_s``) plus ``device``. :func:`run` takes its device, and
:func:`main` refuses to run without a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.data import polynomial_data
from whvi_tpu_torch.experiments.run_toy_cubic import parse_s_init
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, cosine, sigmoid
from whvi_tpu_torch.train import TrainConfig, Trainer

__all__ = ["main", "run"]


def run(
    *,
    device,
    epochs1: int = 500,
    epochs2: int = 20000,
    lambdas=(1.0, 2.5, 5.0),
    sigma0: float = 0.1,
    activation: str = "sigmoid",
    s_init="auto",
    train_samples: int = 4,
    ignore_kl: bool = False,
    seed: int = 0,
) -> dict:
    """Train and evaluate on ``device``; returns the result row."""
    device = torch.device(device)
    act = sigmoid if activation == "sigmoid" else cosine
    l1, l2, l3 = lambdas
    X, y = polynomial_data(seed=seed)
    net = WHVIRegression(
        [
            WHVILinear(1, 128, lambda_=l1, s_init=s_init),
            act,
            WHVILinear(128, 128, lambda_=l2, s_init=s_init, per_example_noise=True),
            act,
            WHVILinear(128, 1, lambda_=l3, s_init=s_init),
        ],
        sigma0=sigma0,
        train_samples=train_samples,
        eval_samples=64,
    )
    total = epochs1 + epochs2
    cfg = TrainConfig(
        batch_size=128,  # full batch, as the reference notebook
        epochs1=epochs1,
        epochs2=epochs2,
        ignore_kl=ignore_kl,
        kl_warmup_steps=int(total * 0.4),
        epochs_per_call=500,
    )
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(seed)
    t0 = time.perf_counter()
    trainer.fit(state, X, y)
    wall = time.perf_counter() - t0
    m = trainer.evaluate(X, y, torch.Generator(device=device).manual_seed(1))

    generator = torch.Generator(device=device).manual_seed(2)

    @torch.no_grad()
    def pred_sd(lo, hi):
        xs = torch.linspace(lo, hi, 50, device=device).reshape(-1, 1)
        _, sd = trainer.net.likelihood.predict(trainer.net.predict(xs, 64, generator))
        return float(sd.mean())

    return {
        "experiment": "toy_polynomial",
        "ignore_kl": ignore_kl,
        "train_rmse": m["rmse"],
        "train_mnll_per_point": m["mnll_per_point"],
        "pred_sd_gap": pred_sd(0.7, 1.3),
        "pred_sd_observed": pred_sd(-0.9, 0.5),
        "n_params": sum(p.numel() for p in trainer.net.parameters()),
        "wall_s": round(wall, 1),
        "epochs_per_s": round(total / max(wall, 1e-9), 1),
        "device": device_name(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=20000)
    ap.add_argument("--lambdas", type=float, nargs=3, default=[1.0, 2.5, 5.0])
    ap.add_argument("--sigma0", type=float, default=0.1)
    ap.add_argument("--activation", choices=["sigmoid", "cosine"], default="sigmoid")
    ap.add_argument("--s-init", type=parse_s_init, default="auto")
    ap.add_argument("--train-samples", type=int, default=4)
    ap.add_argument("--ignore-kl", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    header("run_toy_polynomial")
    return emit(run(
        device=torch.device("cuda", 0), epochs1=args.epochs1, epochs2=args.epochs2,
        lambdas=tuple(args.lambdas), sigma0=args.sigma0, activation=args.activation,
        s_init=args.s_init, train_samples=args.train_samples, ignore_kl=args.ignore_kl,
        seed=args.seed,
    ))


if __name__ == "__main__":
    main()
