"""Optimizer and schedule for WHVI training (PyTorch).

Counterpart of :mod:`whvi_tpu.train.optim`: Adam (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, as ``optax.scale_by_adam``) with the
per-batch decay ``lr(t) = lr0 * (1 + gamma t)^-p`` applied once, the
exact phase-1 likelihood freeze, and the exact freeze of the
heteroscedastic split head's noise branch.

A freeze zeroes gradients; it never sets them to None.
``torch.optim.Adam`` keeps a step count per parameter and skips a
parameter whose gradient is None, so a skipped parameter would come out
of a freeze with a bias correction behind everyone else's, where optax
counts steps globally. A zero gradient keeps its moments at exactly 0,
so its update is exactly 0 and its count advances with the others.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

__all__ = [
    "decay_schedule",
    "decayed_adam",
    "mask_likelihood_grads",
    "mask_noise_branch_grads",
    "validate_split_head",
]


def validate_split_head(net) -> None:
    """Raise unless ``net`` has the heteroscedastic split head the noise
    freeze works on: a last layer with exactly two ``branches`` (``[mean,
    noise]``, the column order of ``[mean, raw_sigma]``) and a likelihood
    with ``split``. A freeze asked for on any other net is an error, not
    a no-op (``whvi_tpu/train/optim.py:37-59``)."""
    head = net.layers[-1]
    branches = getattr(head, "branches", ())
    if not (hasattr(net.likelihood, "split") and len(branches) == 2):
        raise ValueError(
            "noise freeze requires a heteroscedastic split head: the "
            "last layer must be a Parallel with exactly 2 branches "
            "([mean, noise] column order) and the likelihood must "
            f"expose .split; got last layer {type(head).__name__} with "
            f"{len(branches)} branches and likelihood "
            f"{type(net.likelihood).__name__}"
        )


def decay_schedule(
    lr0: float = 1e-3, gamma: float = 5e-4, p: float = 0.3
) -> Callable[[int], float]:
    """``lr(t) = lr0 * (1 + gamma * t)^(-p)`` with t the batch step."""
    return lambda t: lr0 * (1.0 + gamma * t) ** (-p)


def decayed_adam(
    params: Iterable[torch.nn.Parameter],
    lr0: float = 1e-3,
    gamma: float = 5e-4,
    p: float = 0.3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """``(Adam, LambdaLR)``; step the scheduler once per optimizer step."""
    opt = torch.optim.Adam(params, lr=lr0, betas=(b1, b2), eps=eps)
    # LambdaLR multiplies the base lr0 by the factor: applied once
    sched = torch.optim.lr_scheduler.LambdaLR(opt, decay_schedule(1.0, gamma, p))
    return opt, sched


def mask_likelihood_grads(net, train_likelihood: bool) -> None:
    """Zero the likelihood's gradients in place unless ``train_likelihood``."""
    if not train_likelihood:
        for param in net.likelihood.parameters():
            param.grad.zero_()


def mask_noise_branch_grads(net, train_noise: bool) -> None:
    """Zero the gradients of the last layer's ``branches[1:]`` (the noise
    branch of a split head checked by :func:`validate_split_head`) in
    place unless ``train_noise``."""
    if not train_noise:
        for branch in net.layers[-1].branches[1:]:
            for param in branch.parameters():
                param.grad.zero_()
