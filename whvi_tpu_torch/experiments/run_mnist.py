"""Bayesian MNIST classifier with WHVI layers on one NVIDIA H100
(BASELINE config 4).

Counterpart of ``experiments/run_mnist.py``::

    python -m whvi_tpu_torch.experiments.run_mnist [--data synthetic|mnist]
        [--width 1024] [--epochs1 2] [--epochs2 18] [--batch 256]
        [--train-samples 1] [--eval-samples 16] [--lambda-hidden 3]
        [--lambda-last 1] [--bias] [--subset 0] [--seed 0]

Model: ``WHVILinear(784, W)``, relu, ``WHVILinear(W, W)``, relu,
``WHVILinear(W, classes)``, all ``s_init="auto"``, priors
``lambda_hidden`` / ``lambda_last``, a softmax likelihood; at W = 1024
the first and last layers are stacked matrices (one block of D_in 1024)
and the middle one square. Two-phase ELBO training, KL warm-up over 0.3
of the steps, then test accuracy of the mean class probabilities over
``eval_samples`` MC samples.

Data: ``--data mnist`` reads the IDX files (``whvi_tpu_torch.data.mnist``;
the default when they are present), ``--data synthetic`` makes
``synthetic_classification(seed=--seed)``: 4096 / 1024 rows of class
prototypes plus noise at MNIST's shapes (the JAX script always uses seed
0; the default seed gives the same rows). Not ported: the sklearn sets
(digits, wine, breast_cancer), ``--calibrate`` and ``--hmc``.

Output: the first line names the card and its power limit; then one JSON
line per chunk of epochs and a last line with the JAX script's keys
(``experiment, source, width, test_accuracy, wall_s, epochs_per_s``) plus
``device``. :func:`run` takes its device, and :func:`main` refuses to run
without a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.data import load_mnist, mnist_available, synthetic_classification
from whvi_tpu_torch.models import WHVIClassification, WHVILinear, relu
from whvi_tpu_torch.train import TrainConfig, Trainer

__all__ = ["accuracy", "main", "run"]


@torch.no_grad()
def accuracy(net, X, y, generator, n_samples=16, batch=2048) -> float:
    """Share of rows whose most probable class, under the mean of
    ``n_samples`` MC softmaxes, is the label; rows in chunks of ``batch``."""
    device = next(net.parameters()).device
    correct = 0
    for i in range(0, len(X), batch):
        xb = torch.as_tensor(X[i : i + batch], device=device)
        probs = net.likelihood.predict(net.predict(xb, n_samples, generator))
        pred = probs.argmax(-1).cpu().numpy()
        correct += int(np.sum(pred == y[i : i + batch]))
    return correct / len(X)


def run(
    *,
    device,
    data: str = "synthetic",
    width: int = 1024,
    epochs1: int = 2,
    epochs2: int = 18,
    batch: int = 256,
    train_samples: int = 1,
    eval_samples: int = 16,
    lambda_hidden: float = 3.0,
    lambda_last: float = 1.0,
    bias: bool = False,
    subset: int = 0,
    seed: int = 0,
    log_fn=None,
):
    """Train and evaluate on ``device``; returns ``(row, trainer, logs)``."""
    device = torch.device(device)
    if data == "mnist":
        (X_tr, y_tr), (X_te, y_te) = load_mnist()
    else:
        (X_tr, y_tr), (X_te, y_te) = synthetic_classification(seed=seed)
    if subset:
        X_tr, y_tr = X_tr[:subset], y_tr[:subset]
    kw = dict(s_init="auto", bias=bias)
    net = WHVIClassification(
        [
            WHVILinear(X_tr.shape[1], width, lambda_=lambda_hidden, **kw),
            relu,
            WHVILinear(width, width, lambda_=lambda_hidden, **kw),
            relu,
            WHVILinear(width, int(y_tr.max()) + 1, lambda_=lambda_last, **kw),
        ],
        train_samples=train_samples,
        eval_samples=eval_samples,
    )
    total = epochs1 + epochs2
    steps_per_epoch = -(-len(X_tr) // batch)
    cfg = TrainConfig(
        batch_size=batch,
        epochs1=epochs1,
        epochs2=epochs2,
        epochs_per_call=max(1, total // 10),
        kl_warmup_steps=int(0.3 * total * steps_per_epoch),
    )
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(seed)
    t0 = time.perf_counter()
    state, logs = trainer.fit(state, X_tr, y_tr, log_fn=log_fn)
    wall = time.perf_counter() - t0
    generator = torch.Generator(device=device).manual_seed(1)
    acc = accuracy(trainer.net, X_te, y_te, generator, eval_samples)
    row = {
        "experiment": "mnist",
        "source": data,
        "width": width,
        "test_accuracy": acc,
        "wall_s": round(wall, 1),
        "epochs_per_s": round(total / max(wall, 1e-9), 2),
        "device": device_name(device),
    }
    return row, trainer, logs


def main(argv=None):
    """Runs on ``cuda:0``; returns :func:`run`'s ``(row, trainer, logs)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", choices=["synthetic", "mnist"],
                    default="mnist" if mnist_available() else "synthetic")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--epochs1", type=int, default=2)
    ap.add_argument("--epochs2", type=int, default=18)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--train-samples", type=int, default=1)
    ap.add_argument("--eval-samples", type=int, default=16)
    ap.add_argument("--lambda-hidden", type=float, default=3.0)
    ap.add_argument("--lambda-last", type=float, default=1.0)
    ap.add_argument("--bias", action="store_true", help="deterministic bias on every WHVI layer")
    ap.add_argument("--subset", type=int, default=0, help="train subset size")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    header("run_mnist")
    row, trainer, logs = run(
        device=torch.device("cuda", 0), data=args.data, width=args.width,
        epochs1=args.epochs1, epochs2=args.epochs2, batch=args.batch,
        train_samples=args.train_samples, eval_samples=args.eval_samples,
        lambda_hidden=args.lambda_hidden, lambda_last=args.lambda_last, bias=args.bias,
        subset=args.subset, seed=args.seed, log_fn=emit,
    )
    emit(row)
    return row, trainer, logs


if __name__ == "__main__":
    main()
