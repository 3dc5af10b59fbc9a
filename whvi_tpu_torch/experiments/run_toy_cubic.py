"""Toy cubic regression on one NVIDIA H100: the reference README quickstart.

Counterpart of ``experiments/run_toy_cubic.py``::

    python -m whvi_tpu_torch.experiments.run_toy_cubic [--epochs1 500]
        [--epochs2 1500] [--seed 0] [--s-init auto] [--kl-warmup-frac 0.5]

200 points of ``y = x0 + x1^2 - 0.3 x2^3`` (``cubic_data(seed)``), a
150/50 split; model ``WHVILinear(3, 16, lambda_=2)``, relu,
``WHVILinear(16, 1)``; Adam 1e-3 with the ``(1 + 5e-4 t)^-0.3`` decay,
batch 64, ``epochs1`` epochs with the likelihood frozen then ``epochs2``
with everything trained, the KL weight ramped over ``kl_warmup_frac`` of
the steps; test metrics from 64 MC samples.

Output: the first line names the card and its power limit; then one JSON
line per chunk of epochs and a last line with the JAX script's keys
(``experiment, rmse, mnll, mnll_per_point, pred_mnll_per_point, wall_s,
epochs_per_s``) plus ``device``. ``--ckpt-dir`` is not ported (no
checkpoints yet); :func:`run` takes its device, and :func:`main` refuses
to run without a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.data import cubic_data
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu
from whvi_tpu_torch.train import TrainConfig, Trainer

__all__ = ["main", "parse_s_init", "run"]


def parse_s_init(text: str):
    """``--s-init``: ``"auto"`` or a float."""
    return text if text == "auto" else float(text)


def run(
    *,
    device,
    epochs1: int = 500,
    epochs2: int = 1500,
    seed: int = 0,
    s_init="auto",
    kl_warmup_frac: float = 0.5,
    log_fn=None,
) -> dict:
    """Train and evaluate on ``device``; returns the result row."""
    device = torch.device(device)
    (X_tr, y_tr), (X_te, y_te) = cubic_data(seed=seed)
    net = WHVIRegression(
        [
            WHVILinear(3, 16, lambda_=2.0, s_init=s_init),
            relu,
            WHVILinear(16, 1, s_init=s_init),
        ],
        eval_samples=64,
    )
    total = epochs1 + epochs2
    batches_per_epoch = -(-len(X_tr) // 64)
    cfg = TrainConfig(
        epochs1=epochs1,
        epochs2=epochs2,
        kl_warmup_steps=int(total * batches_per_epoch * kl_warmup_frac),
    )
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(seed)
    t0 = time.perf_counter()
    trainer.fit(state, X_tr, y_tr, log_fn=log_fn)
    wall = time.perf_counter() - t0
    metrics = trainer.evaluate(X_te, y_te, torch.Generator(device=device).manual_seed(1))
    return {
        "experiment": "toy_cubic",
        "rmse": metrics["rmse"],
        "mnll": metrics["mnll"],
        "mnll_per_point": metrics["mnll_per_point"],
        "pred_mnll_per_point": metrics["pred_mnll_per_point"],
        "wall_s": wall,
        "epochs_per_s": total / wall,
        "device": device_name(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--s-init", type=parse_s_init, default="auto",
                    help="'auto' (D**-0.5) or a float stddev (0.01: the reference)")
    ap.add_argument("--kl-warmup-frac", type=float, default=0.5,
                    help="fraction of the batch steps over which the KL weight ramps 0->1")
    args = ap.parse_args(argv)
    header("run_toy_cubic")
    return emit(run(
        device=torch.device("cuda", 0), epochs1=args.epochs1, epochs2=args.epochs2,
        seed=args.seed, s_init=args.s_init, kl_warmup_frac=args.kl_warmup_frac, log_fn=emit,
    ))


if __name__ == "__main__":
    main()
