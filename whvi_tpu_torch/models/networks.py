"""Networks: sequential WHVI models with an MC-ELBO (PyTorch).

Counterpart of :mod:`whvi_tpu.models.networks`. The JAX network maps one
MC sample per ``apply`` and vmaps ``predict`` over sample keys; here the
MC-sample axis is a leading tensor axis that every layer carries, so one
forward computes all samples:

- ``forward(x, generator, eps)``: ``x (S, B, n_in) -> (S, B, n_out)``,
  each WHVI layer drawing its noise for all samples at once;
- ``predict(x, n_samples, generator)``: ``x (B, n_in)`` broadcast to
  ``n_samples`` samples (a view, not a copy) -> ``(S, B, n_out)``;
- ``loss``: negative ELBO = total-dataset MNLL + ``kl_scale`` * KL.

``eps`` is an optional per-layer list of noise tensors (None for
deterministic layers, a tuple of per-branch entries for ``Parallel``)
replacing the generator's draws, so tests can feed both packages the same
noise.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from whvi_tpu_torch.models.layers import WHVILinear, relu
from whvi_tpu_torch.models.likelihoods import CategoricalLikelihood, GaussianLikelihood

__all__ = ["WHVINetwork", "WHVIRegression", "WHVIClassification", "mlp_layers"]


class WHVINetwork(nn.Module):
    """A sequential model over WHVI layers and activations plus a
    likelihood; ``train_samples``/``eval_samples`` are the default MC
    sample counts."""

    def __init__(
        self,
        layers: Sequence[nn.Module],
        likelihood: nn.Module,
        train_samples: int = 1,
        eval_samples: int = 64,
    ):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.likelihood = likelihood
        self.train_samples = train_samples
        self.eval_samples = eval_samples

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.likelihood.reset_parameters(generator)

    def kl(self) -> torch.Tensor:
        """Sum of the layers' KL terms."""
        return sum(layer.kl() for layer in self.layers)

    def forward(self, x, generator=None, eps=None):
        """One stochastic pass over ``x (S, B, n_in)`` for all S samples."""
        if eps is None:
            eps = [None] * len(self.layers)
        if len(eps) != len(self.layers):
            raise ValueError(
                f"eps must have one entry per layer ({len(self.layers)}), "
                f"got {len(eps)}"
            )
        for layer, e in zip(self.layers, eps):
            x = layer(x, generator, e)
        return x

    def predict(self, x, n_samples: int, generator=None, eps=None):
        """``(S, B, n_out)`` MC predictions for ``x (B, n_in)``."""
        return self(x.expand(n_samples, *x.shape), generator, eps)

    def loss(
        self,
        x,
        y,
        n,
        generator=None,
        n_samples: int | None = None,
        ignore_kl: bool = False,
        kl_scale: float = 1.0,
        weights=None,
        eps=None,
    ):
        """``(loss, {"mnll", "kl"})`` with ``loss = mnll + kl_scale * kl``
        (``mnll`` alone under ``ignore_kl``); ``weights (B,)`` mark
        padding rows with 0."""
        S = self.train_samples if n_samples is None else n_samples
        y_hat = self.predict(x, S, generator, eps)
        mnll = self.likelihood.mnll(y, y_hat, n, weights=weights)
        kl = self.kl()
        loss = mnll if ignore_kl else mnll + kl_scale * kl
        return loss, {"mnll": mnll, "kl": kl}

    def eval_metrics(self, x, y, generator=None, n_samples: int | None = None):
        """Test-set metrics from ``eval_samples`` MC predictions."""
        S = self.eval_samples if n_samples is None else n_samples
        y_hat = self.predict(x, S, generator)
        return self.metrics_from_predictions(y, y_hat)

    def metrics_from_predictions(self, y, y_hat) -> dict:
        """Total and per-point MNLL, and from ``y_hat (S, B, n_out)`` what
        applies: the posterior-predictive MNLL (``-mean_i log mean_s
        p(y_i | f_s)``) where the likelihood has ``log_prob``, the RMSE of
        the MC mean where ``y_hat`` has ``y``'s width, and 95% interval
        coverage where ``predict`` gives ``(mean, sd)`` (not class
        probabilities)."""
        S = y_hat.shape[0]
        n = y.shape[0]
        mnll = self.likelihood.mnll(y, y_hat, n)
        out = {"mnll": mnll, "mnll_per_point": mnll / n}
        if hasattr(self.likelihood, "log_prob"):
            lp = self.likelihood.log_prob(y, y_hat)
            pred_ll = torch.logsumexp(lp, dim=0) - math.log(S)
            out["pred_mnll_per_point"] = -torch.mean(pred_ll)
        if y.ndim > 1 and y_hat.ndim == 3 and y_hat.shape[-1] == y.shape[-1]:
            out["rmse"] = torch.sqrt(
                torch.mean((torch.mean(y_hat, dim=0) - y).square())
            )
        if hasattr(self.likelihood, "predict"):
            moments = self.likelihood.predict(y_hat)
            if isinstance(moments, tuple) and y.ndim == moments[0].ndim:
                mean, sd = moments
                inside = torch.abs(y - mean) <= 1.9599640 * sd
                out["coverage95"] = torch.mean(inside.to(y_hat.dtype))
        return out


def mlp_layers(
    n_in: int,
    n_out: int,
    hidden: Sequence[int] = (128, 128),
    lambda_hidden: float = 3.0,
    lambda_last: float = 1e-5,
    activation=None,
    rect_mode: str = "stack",
    bias: bool = False,
) -> list:
    """The reference UCI architecture: a WHVI MLP with ReLU hidden
    activations, prior variance ``lambda_hidden`` on hidden layers and
    ``lambda_last`` on the output layer; ``rect_mode`` ("stack" or "pad")
    builds its non-square layers."""
    act = activation if activation is not None else relu
    dims = [n_in, *hidden]
    kw = dict(rect_mode=rect_mode, bias=bias)
    layers: list = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers.append(WHVILinear(a, b, lambda_=lambda_hidden, **kw))
        layers.append(act)
    layers.append(WHVILinear(dims[-1], n_out, lambda_=lambda_last, **kw))
    return layers


def WHVIClassification(
    layers,
    train_samples: int = 1,
    eval_samples: int = 16,
) -> WHVINetwork:
    """Network plus a categorical (softmax) likelihood over its logits."""
    return WHVINetwork(
        layers,
        CategoricalLikelihood(),
        train_samples=train_samples,
        eval_samples=eval_samples,
    )


def WHVIRegression(
    layers,
    sigma0: float = 1.0,
    train_samples: int = 1,
    eval_samples: int = 64,
) -> WHVINetwork:
    """Network plus a Gaussian likelihood with initial noise ``sigma0``."""
    return WHVINetwork(
        layers,
        GaussianLikelihood(sigma0),
        train_samples=train_samples,
        eval_samples=eval_samples,
    )
