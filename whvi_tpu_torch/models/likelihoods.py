"""Likelihoods for the MC-ELBO (PyTorch).

Counterpart of :mod:`whvi_tpu.models.likelihoods`: the homoscedastic and
heteroscedastic Gaussian and the categorical (softmax) likelihoods.
Predictions carry the MC-sample axis first, ``y_hat (S, B, n_out)``;
``mnll(y, y_hat, n)`` is the total-dataset estimate
``-n * mean_{S,B} sum_out log p(y | y_hat)``, and optional row
``weights (B,)`` give padding rows weight 0. The JAX likelihoods take a
parameter dict; here a likelihood is an ``nn.Module`` and the two new ones
have no parameters (``{}`` in JAX).

The Gaussian likelihoods also take a leading replica axis (``replicas =
R``, :func:`whvi_tpu_torch.models.networks.stack_replicas`): ``y (R, B, n_out)``,
``y_hat (R, S, B, n_out)``, the homoscedastic ``rho (R,)``; ``mnll``,
``log_prob`` and ``predict`` then reduce per replica, each replica over its
own ``S`` and ``B_eff``. The categorical one takes none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from whvi_tpu_torch.ops.hadamard import round_scalar, softplus

__all__ = [
    "GaussianLikelihood",
    "HeteroscedasticGaussianLikelihood",
    "CategoricalLikelihood",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _weighted_total(lp_per_point, n, weights):
    """``-(n / (S * B_eff)) * sum(w * lp)`` over the last two axes of
    ``lp (..., S, B)`` with ``B_eff = sum(w)``, one value per leading
    index (per replica); ``weights (..., B)``, or None for all ones.
    Padding rows of a wrap-padded batch have weight 0, so the estimate
    equals the unpadded batch's."""
    S = lp_per_point.shape[-2]
    if weights is None:
        B_eff = lp_per_point.shape[-1]
        total = torch.sum(lp_per_point, dim=(-2, -1))
        return _scalar(-(n / (S * B_eff)), total) * total
    B_eff = torch.sum(weights, dim=-1)
    total = torch.sum(lp_per_point * weights.unsqueeze(-2), dim=(-2, -1))
    return -(n / (S * B_eff)) * total


def _inv_softplus(y: float) -> float:
    return math.log(math.expm1(y))


def _scalar(value: float, like: torch.Tensor) -> float:
    """``value`` as JAX uses a Python scalar beside ``like``: rounded to
    its dtype where that is below float32 (bf16 storage), else as is (and
    a tensor always as is)."""
    if isinstance(value, (int, float)) and like.dtype.itemsize < 4:
        return round_scalar(value, like.dtype)
    return value


def _gauss_logpdf(y, mean, sigma):
    z = (y - mean) / sigma
    return -0.5 * (z * z + _scalar(_LOG_2PI, z)) - torch.log(sigma)


class GaussianLikelihood(nn.Module):
    """Homoscedastic Gaussian likelihood with learnable noise stddev
    ``sigma = softplus(rho)``, initialized to ``sigma0``."""

    replicas: int | None = None

    def __init__(self, sigma0: float = 1.0, *, device=None, dtype=torch.float32):
        super().__init__()
        self.sigma0 = sigma0
        self.rho = nn.Parameter(torch.empty((), device=device, dtype=dtype))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None, replica=None):
        del generator
        (self.rho if replica is None else self.rho[replica]).fill_(_inv_softplus(self.sigma0))

    def sigma(self, ndim: int = 0) -> torch.Tensor:
        """``softplus(rho)``; a replicated ``(R,)`` one viewed to rank
        ``ndim`` to broadcast against ``(R, ...)``."""
        sigma = softplus(self.rho)
        if self.replicas is None:
            return sigma
        return sigma.reshape(sigma.shape + (1,) * (ndim - 1))

    def mnll(self, y, y_hat, n, weights=None):
        """Total-dataset MNLL from ``y (B, n_out)``, ``y_hat (S, B, n_out)``
        and the dataset size ``n``; optional ``weights (B,)``."""
        lp = _gauss_logpdf(y.unsqueeze(-3), y_hat, self.sigma(y_hat.dim()))
        return _weighted_total(torch.sum(lp, dim=-1), n, weights)

    def log_prob(self, y, y_hat):
        """Per-sample, per-point joint log density ``(S, B)``."""
        return torch.sum(_gauss_logpdf(y.unsqueeze(-3), y_hat, self.sigma(y_hat.dim())), dim=-1)

    def predict(self, y_hat):
        """Predictive mean and stddev of the MC mixture ``(S, B, n_out)``."""
        mean = torch.mean(y_hat, dim=-3)
        var = torch.var(y_hat, dim=-3, unbiased=False) + self.sigma(mean.dim()).square()
        return mean, torch.sqrt(var)


class HeteroscedasticGaussianLikelihood(nn.Module):
    """Gaussian likelihood with input-dependent noise: the network emits
    ``[mean, raw_sigma]`` on its last axis, ``sigma = softplus(raw_sigma
    + shift) + sigma_min`` with ``shift = inv_softplus(max(sigma0 -
    sigma_min, 1e-6))``, so a head near 0 at init starts at ``sigma0``
    (``whvi_tpu/models/likelihoods.py:130-187``)."""

    def __init__(self, sigma_min: float = 1e-4, sigma0: float = 1.0):
        super().__init__()
        self.sigma_min = sigma_min
        self.sigma0 = sigma0

    def reset_parameters(self, generator=None, replica=None):
        del generator, replica

    def split(self, y_hat):
        """``(mean, sigma)``, each half of ``y_hat``'s last axis."""
        if y_hat.shape[-1] % 2:
            raise ValueError(f"needs an even last axis, got {tuple(y_hat.shape)}")
        mean, raw = torch.chunk(y_hat, 2, dim=-1)
        shift = _inv_softplus(max(self.sigma0 - self.sigma_min, 1e-6))
        return mean, softplus(raw + _scalar(shift, raw)) + _scalar(self.sigma_min, raw)

    def mnll(self, y, y_hat, n, weights=None):
        mean, sigma = self.split(y_hat)
        lp = _gauss_logpdf(y.unsqueeze(-3), mean, sigma)
        return _weighted_total(torch.sum(lp, dim=-1), n, weights)

    def log_prob(self, y, y_hat):
        """Per-sample, per-point joint log density ``(S, B)``."""
        mean, sigma = self.split(y_hat)
        return torch.sum(_gauss_logpdf(y.unsqueeze(-3), mean, sigma), dim=-1)

    def predict(self, y_hat):
        """Predictive mean and stddev: the MC variance of the means (the
        population variance, ``correction=0``, as ``jnp.var``) plus the
        mean noise variance."""
        mean, sigma = self.split(y_hat)
        var = torch.var(mean, dim=-3, correction=0) + torch.mean(sigma.square(), dim=-3)
        return torch.mean(mean, dim=-3), torch.sqrt(var)


class CategoricalLikelihood(nn.Module):
    """Softmax likelihood over logits ``y_hat (S, B, C)``. Labels come as
    ``(B,)`` or ``(B, 1)``, integers or floats (the trainer stores targets
    as floats), and are read as ``long`` class indices, as JAX casts them
    to int32 (``whvi_tpu/models/likelihoods.py:190-224``)."""

    def reset_parameters(self, generator=None, replica=None):
        del generator, replica

    @staticmethod
    def _label_log_prob(y, y_hat):
        """``log softmax(y_hat)[..., y]``, ``(S, B)``; ``y_hat`` may carry
        axes ahead of ``S`` (the samplers' walkers), kept in the result."""
        labels = y.reshape(-1).long()
        logp = F.log_softmax(y_hat, dim=-1)
        index = labels.view(-1, 1).expand(*logp.shape[:-1], 1)
        return torch.gather(logp, -1, index)[..., 0]

    def mnll(self, y, y_hat, n, weights=None):
        return _weighted_total(self._label_log_prob(y, y_hat), n, weights)

    def log_prob(self, y, y_hat):
        """Per-sample, per-point class log probability ``(S, B)``."""
        return self._label_log_prob(y, y_hat)

    def predict(self, y_hat):
        """Posterior-mean class probabilities ``(B, C)``."""
        return torch.mean(F.softmax(y_hat, dim=-1), dim=0)
