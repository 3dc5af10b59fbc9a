"""The reference's Gaussian likelihood, ``{"kind": "gaussian", "sigma0"}``:
a learned noise scale ``sigma = softplus(rho)`` shared by every row."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


def log_prob(likelihood: dict, params, y, y_hat):
    """``(S, B)`` log density of ``y (B, n_out)`` under each sample's
    outputs ``y_hat (S, B, n_out)``."""
    sigma = F.softplus(params["rho"])
    z = (y - y_hat) / sigma
    return torch.sum(-0.5 * z * z - 0.5 * LOG_2PI - torch.log(sigma), dim=-1)


@torch.no_grad()
def predict(likelihood: dict, params, y_hat) -> dict:
    """What a predictive call answers, and its parts: ``mean`` and ``sd`` of
    the MC mixture (``(B, n_out)`` each), ``spread``, the population
    variance of the sample means (the epistemic part), and ``noise_var``,
    ``sigma^2``; ``sd^2 = spread + noise_var``."""
    mean = torch.mean(y_hat, dim=0)
    spread = torch.mean((y_hat - mean) ** 2, dim=0)
    noise_var = F.softplus(params["rho"]) ** 2
    return {"mean": mean, "sd": torch.sqrt(spread + noise_var), "spread": spread,
            "noise_var": noise_var}
