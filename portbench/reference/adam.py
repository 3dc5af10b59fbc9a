"""Adam with the decayed learning rate of WHVI's training protocol.

At step ``t = 1, 2, ...``, with ``g`` the gradient::

    m = b1 m + (1 - b1) g              v = b2 v + (1 - b2) g^2
    p = p - lr(t) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

and ``lr(t) = lr0 * (1 + gamma (t - 1))^-p``: the rate decays once a step,
from ``lr0`` at the first.
"""

from __future__ import annotations

import torch


def lr_at(t: int, lr0: float, gamma: float, power: float) -> float:
    """The learning rate of step ``t`` (1-based)."""
    return lr0 * (1.0 + gamma * (t - 1)) ** (-power)


def adam_steps(params: dict, grad_fn, steps: int, opt: dict):
    """Run ``steps`` steps from ``params`` (left as they are).
    ``grad_fn(params, k)`` gives step ``k``'s ``(loss, mnll, kl, grads)``
    at the current parameters (``k`` 0-based). ``opt`` holds ``lr0``,
    ``gamma``, ``p``, ``b1``, ``b2``, ``eps``. Returns the list of each
    step's ``(loss, mnll, kl)``, the first step's gradients and the
    parameters after the last step."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for k in range(steps):
        t = k + 1
        loss, mnll, kl, grads = grad_fn(p, k)
        losses.append((loss, mnll, kl))
        if first is None:
            first = {key: g.clone() for key, g in grads.items()}
        lr = lr_at(t, opt["lr0"], opt["gamma"], opt["p"])
        for key, g in grads.items():
            m[key] = b1 * m[key] + (1 - b1) * g
            v2[key] = b2 * v2[key] + (1 - b2) * g * g
            m_hat = m[key] / (1 - b1**t)
            v_hat = v2[key] / (1 - b2**t)
            p[key] = p[key] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return losses, first, p
