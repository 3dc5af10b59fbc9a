"""The toy-protocol ELBO training throughput on one NVIDIA H100.

Counterpart of ``bench.py``::

    python -m whvi_tpu_torch.bench.toy_bench [--epochs 6000]

The reference README's toy protocol: ``cubic_data(seed=0)`` (150 training
rows), ``WHVILinear(3, 16, lambda_=2, s_init="auto")`` (four stacked D=4
blocks), relu, ``WHVILinear(16, 1, s_init="auto")`` (a column head),
batch 64 (three wrap-padded batches an epoch), ``epochs1=0``,
``epochs2=--epochs``, the KL weight ramped over 1000 steps, the whole run
one chunk (one host fetch at its end). One warm-up run (seed 1: the
kernels' build and first launches), then runs at seeds 0, 2 and 3; the
value is the best of them. The train step runs eagerly, a Python loop of
kernel launches.

Output: one JSON line with ``bench.py``'s keys, ``metric``
(``toy_elbo_epochs_per_s``), ``value``, ``unit``, ``vs_baseline`` (value
over the reference's 155 epochs/s on a GTX 970), ``runs``, ``spread_pct``
and ``gflops`` (the JAX count: ``4 * whvi_layer_train_flops(4, 64,
stack=4)`` an epoch, a flop-equivalent rate), plus ``device`` and
``power_limit`` in place of ``prng``; the line before it names the card
and its power limit. :func:`run` takes its device, and :func:`main`
refuses to run without a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.data import cubic_data
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.utils.profiling import whvi_layer_train_flops

__all__ = ["BASELINE_EPOCHS_PER_S", "SEEDS", "main", "run"]

BASELINE_EPOCHS_PER_S = 155.0  # the reference's toy LRT run, GTX 970 (BASELINE.md)
SEEDS = (0, 2, 3)


def run(*, device, epochs: int = 6000, power_limit: str | None = None) -> dict:
    """The bench on ``device``; returns its row."""
    device = torch.device(device)
    (X_tr, y_tr), _ = cubic_data(seed=0)
    net = WHVIRegression(
        [
            WHVILinear(3, 16, lambda_=2.0, s_init="auto"),
            relu,
            WHVILinear(16, 1, s_init="auto"),
        ]
    )
    cfg = TrainConfig(epochs1=0, epochs2=epochs, epochs_per_call=epochs, kl_warmup_steps=1000)
    trainer = Trainer(net, cfg, device=device)
    trainer.fit(trainer.init(1), X_tr, y_tr)  # warm-up
    runs = []
    for seed in SEEDS:
        state = trainer.init(seed)
        t0 = time.perf_counter()
        trainer.fit(state, X_tr, y_tr)  # ends in the chunk's host fetch
        runs.append(epochs / (time.perf_counter() - t0))
    eps = max(runs)
    flops_per_epoch = 4 * whvi_layer_train_flops(4, 64, stack=4)
    return {
        "metric": "toy_elbo_epochs_per_s",
        "value": round(eps, 2),
        "unit": "epochs/s",
        "vs_baseline": round(eps / BASELINE_EPOCHS_PER_S, 2),
        "runs": [round(r, 2) for r in runs],
        "spread_pct": round(100.0 * (max(runs) - min(runs)) / max(runs), 1),
        "gflops": round(eps * flops_per_epoch / 1e9, 2),
        "device": device_name(device),
        "power_limit": power_limit,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6000)
    args = ap.parse_args(argv)
    card = header("toy_bench")["card"]
    return emit(run(
        device=torch.device("cuda", 0), epochs=args.epochs,
        power_limit=card.rsplit(",", 1)[-1].strip(),
    ))


if __name__ == "__main__":
    main()
