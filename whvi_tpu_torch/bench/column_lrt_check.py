"""The variance of the ELBO's loss and gradient estimators for a D -> 1
column head: one explicit weight sample a forward against the per-row
local reparameterization (the column LRT).

Counterpart of ``benchmarks/column_lrt_check.py``. The reference draws
one explicit weight sample a forward for a column-shaped layer, shared by
every batch row; the column is linear in ``g``, so a per-row LRT exists
(``models.weights.ColumnMatrix``, ``WHVILinear(column_lrt=True)``). For
each D, a ``WHVIRegression([WHVILinear(D, 1, lambda_=1e-5, s_init="auto",
per_example_noise=True, column_lrt=...)], sigma0=1.0, train_samples=1)``
is trained for ``--train-epochs`` epochs of phase 2 on a ``(--batch, D)``
standard normal regression (at its init, ``g_mu = 0`` and the noise scale
``softplus(-3)`` leave the weight noise invisible beside the likelihood's),
then the loss and its gradient are evaluated ``--keys`` times on fresh
noise. A row holds, for each estimator, the variance of the loss across
draws and the mean over parameters of each parameter's mean elementwise
variance (the JAX keys), and the explicit estimator's over the LRT's
(``grad_var_reduction``, ``loss_var_reduction``). The head runs K4 and its
backward on the card.

On the card unless ``--cpu``; the first line names the card and its power
limit (or the CPU).

Run: python -m whvi_tpu_torch.bench.column_lrt_check [--sizes 128 1024 8192]
    [--batch 64] [--keys 64] [--train-epochs 300] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.models import WHVILinear, WHVIRegression
from whvi_tpu_torch.train import TrainConfig, Trainer

__all__ = ["grad_var", "main", "row"]

ESTIMATORS = (("explicit", False), ("column_lrt", True))


def grad_var(net, X, y, generator, keys: int) -> tuple[float, float]:
    """``(loss variance, mean gradient variance)`` over ``keys`` draws of
    the noise from ``generator``: the variance of the loss across draws,
    and the mean over parameters of each one's mean elementwise variance
    across draws."""
    params = list(net.parameters())
    losses, grads = [], []
    for _ in range(keys):
        loss, _ = net.loss(X, y, X.shape[0], generator)
        grads.append([g.detach().double() for g in torch.autograd.grad(loss, params)])
        losses.append(loss.item())
    per_param = [torch.stack(gs).var(dim=0, unbiased=False).mean().item() for gs in zip(*grads)]
    return float(np.var(losses)), float(np.mean(per_param))


def row(D: int, batch: int, keys: int, train_epochs: int, device) -> dict:
    """One D's row: both estimators, each after ``train_epochs`` epochs."""
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randn(batch, D).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randn(batch, 1).astype(np.float32)).to(device)
    out = {"D": D, "B": batch, "keys": keys, "train_epochs": train_epochs,
           "device": device_name(device)}
    for name, column_lrt in ESTIMATORS:
        net = WHVIRegression(
            [WHVILinear(D, 1, lambda_=1e-5, s_init="auto", per_example_noise=True,
                        column_lrt=column_lrt)],
            sigma0=1.0, train_samples=1,
        )
        trainer = Trainer(net, TrainConfig(epochs1=0, epochs2=train_epochs,
                                           epochs_per_call=max(train_epochs, 1)), device=device)
        state = trainer.init(0)
        if train_epochs:
            trainer.fit(state, X, y)
        out[f"{name}_loss_var"], out[f"{name}_grad_var"] = grad_var(
            trainer.net, X, y, torch.Generator(device=device).manual_seed(1), keys)
    out["grad_var_reduction"] = out["explicit_grad_var"] / max(out["column_lrt_grad_var"], 1e-30)
    out["loss_var_reduction"] = out["explicit_loss_var"] / max(out["column_lrt_loss_var"], 1e-30)
    return emit(out)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[128, 1024, 8192])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--keys", type=int, default=64)
    ap.add_argument("--train-epochs", type=int, default=300)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if args.cpu:
        emit({"tool": "column_lrt_check", "device": "cpu"})
        device = torch.device("cpu")
    else:
        header("column_lrt_check")
        device = torch.device("cuda", 0)
    return [row(D, args.batch, args.keys, args.train_epochs, device) for D in args.sizes]


if __name__ == "__main__":
    main()
