"""Optimizer and schedule for WHVI training (PyTorch).

Counterpart of :mod:`whvi_tpu.train.optim`: Adam (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, as ``optax.scale_by_adam``) with the
per-batch decay ``lr(t) = lr0 * (1 + gamma t)^-p`` applied once, and the
exact phase-1 likelihood freeze.

The freeze zeroes the likelihood's gradients; it never sets them to
None. ``torch.optim.Adam`` keeps a step count per parameter and skips a
parameter whose gradient is None, so a skipped parameter would come out
of phase 1 with a bias correction behind everyone else's, where optax
counts steps globally. A zero gradient keeps its moments at exactly 0,
so its update is exactly 0 and its count advances with the others.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

__all__ = ["decay_schedule", "decayed_adam", "mask_likelihood_grads"]


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
