"""Likelihoods for the MC-ELBO (PyTorch).

Counterpart of the Gaussian likelihood of
:mod:`whvi_tpu.models.likelihoods`. Predictions carry the MC-sample axis
first, ``y_hat (S, B, n_out)``; ``mnll(y, y_hat, n)`` is the
total-dataset estimate ``-n * mean_{S,B} sum_out log p(y | y_hat)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GaussianLikelihood"]

_LOG_2PI = math.log(2.0 * math.pi)


def _weighted_total(lp_per_point, n, weights):
    """``-(n / (S * B_eff)) * sum(w * lp)`` over ``lp (S, B)`` with
    ``B_eff = sum(w)``; ``weights=None`` means all ones. Padding rows of a
    wrap-padded batch have weight 0, so the estimate equals the unpadded
    batch's."""
    S = lp_per_point.shape[0]
    if weights is None:
        B_eff = lp_per_point.shape[1]
        total = torch.sum(lp_per_point)
    else:
        w = weights.reshape(-1)
        B_eff = torch.sum(w)
        total = torch.sum(lp_per_point * w[None, :])
    return -(n / (S * B_eff)) * total


def _inv_softplus(y: float) -> float:
    return math.log(math.expm1(y))


def _gauss_logpdf(y, mean, sigma):
    z = (y - mean) / sigma
    return -0.5 * (z * z + _LOG_2PI) - torch.log(sigma)


class GaussianLikelihood(nn.Module):
    """Homoscedastic Gaussian likelihood with learnable noise stddev
    ``sigma = softplus(rho)``, initialized to ``sigma0``."""

    def __init__(self, sigma0: float = 1.0, *, device=None, dtype=torch.float32):
        super().__init__()
        self.sigma0 = sigma0
        self.rho = nn.Parameter(torch.empty((), device=device, dtype=dtype))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        del generator
        self.rho.fill_(_inv_softplus(self.sigma0))

    def sigma(self) -> torch.Tensor:
        return F.softplus(self.rho)

    def mnll(self, y, y_hat, n, weights=None):
        """Total-dataset MNLL from ``y (B, n_out)``, ``y_hat (S, B, n_out)``
        and the dataset size ``n``; optional ``weights (B,)``."""
        lp = _gauss_logpdf(y[None], y_hat, self.sigma())
        return _weighted_total(torch.sum(lp, dim=-1), n, weights)

    def log_prob(self, y, y_hat):
        """Per-sample, per-point joint log density ``(S, B)``."""
        return torch.sum(_gauss_logpdf(y[None], y_hat, self.sigma()), dim=-1)

    def predict(self, y_hat):
        """Predictive mean and stddev of the MC mixture ``(S, B, n_out)``."""
        mean = torch.mean(y_hat, dim=0)
        var = torch.var(y_hat, dim=0, unbiased=False) + self.sigma().square()
        return mean, torch.sqrt(var)
