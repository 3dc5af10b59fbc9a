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

On a replicated net (:func:`whvi_tpu_torch.models.networks.stack_replicas`) a
freeze may differ between replicas: the flag is then a ``(R,)`` 0/1
tensor multiplied into each parameter's gradient along its replica axis,
so a frozen replica's gradient, moments and update are exactly 0 while
the others train. Adam is elementwise and all replicas share one step
count, so one ``torch.optim.Adam`` over the stacked parameters is ``R``
independent Adams, as optax under the JAX trainer's vmap.

Parameters stored below float32 (bf16, the JAX package's
``dtype=bfloat16``) get :class:`OptaxAdam`: optax's ``scale_by_adam``
and ``scale_by_learning_rate`` op for op, with its casts, so that the
moments and updates stay in the parameters' dtype and round where
optax's do (``torch.optim.Adam`` fuses them differently: a ``lerp`` and
an ``addcdiv`` in fp32, rounded once).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import numpy as np
import torch

from whvi_tpu_torch.ops.hadamard import round_scalar

__all__ = [
    "OptaxAdam",
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


class OptaxAdam(torch.optim.Adam):
    """Adam computed as ``optax.chain(scale_by_adam(b1, b2, eps),
    scale_by_learning_rate(lr))`` and ``optax.apply_updates`` compute it,
    op for op in the parameters' dtype (the ``optax`` 0.2 sources)::

        mu = (1 - b1) g + b1 mu            nu = (1 - b2) g^2 + b2 nu
        mu_hat = mu / (1 - b1^t)           nu_hat = nu / (1 - b2^t)
        u = -lr * (mu_hat / (sqrt(nu_hat) + eps))       p = p + u

    each product, sum, quotient and root rounded to that dtype, the
    Python constants rounded to it first (JAX's weak typing), the bias
    corrections ``1 - b^t`` computed in float32 and then cast (optax's
    ``tree_bias_correction``), and ``lr`` the LambdaLR's current rate,
    cast. The state keeps ``torch.optim.Adam``'s keys (``step``,
    ``exp_avg``, ``exp_avg_sq``), moments in the parameters' dtype, so
    checkpoints and ``load_state_dict`` treat both alike.
    :func:`decayed_adam` takes it when a parameter is stored below
    float32, ``torch.optim.Adam`` otherwise."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_dtype: dict = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                by_dtype.setdefault(p.dtype, []).append(p)
            for params in by_dtype.values():
                torch._foreach_add_([self.state[p]["step"] for p in params], 1.0)
            for dtype, params in by_dtype.items():
                t = np.float32(self.state[params[0]]["step"].item())
                grads = [p.grad for p in params]
                mus = [self.state[p]["exp_avg"] for p in params]
                nus = [self.state[p]["exp_avg_sq"] for p in params]
                c = functools.partial(round_scalar, dtype=dtype)
                # in place, each op rounding as optax's (a sum's two terms
                # commute exactly): mu = (1 - b1) g + b1 mu, nu likewise
                torch._foreach_mul_(mus, c(b1))
                torch._foreach_add_(mus, torch._foreach_mul(grads, c(1 - b1)))
                torch._foreach_mul_(nus, c(b2))
                torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), c(1 - b2)))
                bc1 = float(np.float32(1) - np.power(np.float32(b1), t, dtype=np.float32))
                bc2 = float(np.float32(1) - np.power(np.float32(b2), t, dtype=np.float32))
                updates = torch._foreach_div(mus, c(bc1))
                denom = torch._foreach_div(nus, c(bc2))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, c(group["eps"]))
                torch._foreach_div_(updates, denom)
                torch._foreach_mul_(updates, c(-group["lr"]))
                torch._foreach_add_(params, updates)
        return None


def decayed_adam(
    params: Iterable[torch.nn.Parameter],
    lr0: float = 1e-3,
    gamma: float = 5e-4,
    p: float = 0.3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """``(Adam, LambdaLR)``; step the scheduler once per optimizer step.
    :class:`OptaxAdam` when a parameter is stored below float32."""
    params = list(params)
    narrow = any(param.dtype.itemsize < 4 for param in params)
    opt = (OptaxAdam if narrow else torch.optim.Adam)(params, lr=lr0, betas=(b1, b2), eps=eps)
    # LambdaLR multiplies the base lr0 by the factor: applied once
    sched = torch.optim.lr_scheduler.LambdaLR(opt, decay_schedule(1.0, gamma, p))
    return opt, sched


def _mask(params, flag) -> None:
    """Zero the gradients of ``params`` unless ``flag``: a bool (or a 0/1
    float), or a ``(R,)`` 0/1 tensor, one entry a replica (the parameters'
    leading axis)."""
    if torch.is_tensor(flag):
        for param in params:
            param.grad.mul_(flag.reshape(flag.shape + (1,) * (param.dim() - 1)))
    elif not flag:
        for param in params:
            param.grad.zero_()


def mask_likelihood_grads(net, train_likelihood) -> None:
    """Zero the likelihood's gradients in place unless ``train_likelihood``
    (a bool, or a ``(R,)`` 0/1 tensor on a replicated net)."""
    _mask(net.likelihood.parameters(), train_likelihood)


def mask_noise_branch_grads(net, train_noise) -> None:
    """Zero the gradients of the last layer's ``branches[1:]`` (the noise
    branch of a split head checked by :func:`validate_split_head`) in
    place unless ``train_noise`` (a bool, or a ``(R,)`` 0/1 tensor on a
    replicated net)."""
    for branch in net.layers[-1].branches[1:]:
        _mask(branch.parameters(), train_noise)
