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
noise. ``draw_noise`` draws ahead exactly what a forward would draw (the
mesh draws a batch's global noise this way and slices its shard).

:func:`stack_replicas` turns a network into ``R`` independent replicas
trained together (the JAX trainer's ``vmap_splits``): every parameter
gains a leading ``R`` axis, ``predict`` takes ``x (R, B, n_in)``, and the
loss, KL and metrics come back per replica, ``(R,)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from whvi_tpu_torch.models.layers import Activation, WHVILinear, relu
from whvi_tpu_torch.models.likelihoods import CategoricalLikelihood, GaussianLikelihood
from whvi_tpu_torch.utils.profiling import span

__all__ = [
    "WHVINetwork", "WHVIRegression", "WHVIClassification", "mlp_layers", "stack_replicas",
]


class _LayerSpans(dict):
    """The Model layer's span of layer ``i``, ``whvi.model.layer<i>``."""

    def __missing__(self, i: int) -> str:
        name = self[i] = f"whvi.model.layer{i}"
        return name


_LAYER_SPANS = _LayerSpans()


class WHVINetwork(nn.Module):
    """A sequential model over WHVI layers and activations plus a
    likelihood; ``train_samples``/``eval_samples`` are the default MC
    sample counts."""

    replicas: int | None = None

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
    def reset_parameters(self, generator: torch.Generator | None = None, replica=None):
        """Fresh parameters from ``generator``; of replica ``replica`` only
        when given (a replicated net)."""
        for layer in self.layers:
            layer.reset_parameters(generator, replica)
        self.likelihood.reset_parameters(generator, replica)

    def kl(self, lambdas=None) -> torch.Tensor:
        """Sum of the layers' KL terms. ``lambdas``: None, or one entry a
        layer overriding its prior variance (None keeps the layer's; a
        float, a tensor, ``(R,)`` per replica, or a tuple of per-branch
        entries for a ``Parallel``), as JAX's ``kl(params, lambdas)``.

        Summed in layer order as JAX sums it, whose activations return a
        float32 zero: from the first activation on, a sum of bf16 terms
        (bf16 storage) carries on in float32, and so does the loss."""
        if lambdas is None:
            lambdas = (None,) * len(self.layers)
        if len(lambdas) != len(self.layers):
            raise ValueError(
                f"lambdas must have one entry per layer ({len(self.layers)}), "
                f"got {len(lambdas)}"
            )
        with span("whvi.model.kl"):
            total = 0
            for layer, lam in zip(self.layers, lambdas):
                if isinstance(layer, Activation):
                    if torch.is_tensor(total) and total.dtype.itemsize < 4:
                        total = total.float()
                else:
                    total = total + layer.kl(lam)
            return total

    def forward(self, x, generator=None, eps=None):
        """One stochastic pass over ``x (S, B, n_in)`` for all S samples."""
        if eps is None:
            eps = [None] * len(self.layers)
        if len(eps) != len(self.layers):
            raise ValueError(
                f"eps must have one entry per layer ({len(self.layers)}), "
                f"got {len(eps)}"
            )
        for i, (layer, e) in enumerate(zip(self.layers, eps)):
            with span(_LAYER_SPANS[i]):
                x = layer(x, generator, e)
        return x

    def draw_noise(self, lead, generator=None, dtype=torch.float32, device=None) -> list:
        """The per-layer ``eps`` that :meth:`forward` draws from
        ``generator`` for an input ``x`` of shape ``(*lead, n_in)``, drawn
        now by the layers' own ``draw_eps``, in the forward's order (so the
        same numbers)."""
        return [layer.draw_eps(lead, generator, dtype, device) for layer in self.layers]

    def predict(self, x, n_samples: int, generator=None, eps=None):
        """``(S, B, n_out)`` MC predictions for ``x (B, n_in)``; ``(R, S,
        B, n_out)`` for ``x (R, B, n_in)`` on a replicated net. The Model
        layer's span ``whvi.model.predict`` covers it."""
        with span("whvi.model.predict"):
            if self.replicas is None:
                return self(x.expand(n_samples, *x.shape), generator, eps)
            R = x.shape[0]
            return self(x[:, None].expand(R, n_samples, *x.shape[1:]), generator, eps)

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
        lambdas=None,
    ):
        """``(loss, {"mnll", "kl"})`` with ``loss = mnll + kl_scale * kl``
        (``mnll`` alone under ``ignore_kl``); ``weights (B,)`` mark
        padding rows with 0; ``lambdas`` as :meth:`kl`. Each is ``(R,)`` on
        a replicated net, and so may ``kl_scale`` be. The Model layer's span
        ``whvi.model.loss`` covers it."""
        with span("whvi.model.loss"):
            S = self.train_samples if n_samples is None else n_samples
            y_hat = self.predict(x, S, generator, eps)
            mnll = self.likelihood.mnll(y, y_hat, n, weights=weights)
            kl = self.kl(lambdas)
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
        probabilities). A replicated net gives each metric per replica:
        ``y (R, B, n_out)``, ``y_hat (R, S, B, n_out)``, metrics ``(R,)``."""
        lead = 0 if self.replicas is None else 1
        per_point = tuple(range(lead, y.ndim))  # the axes a metric averages
        S = y_hat.shape[lead]
        n = y.shape[lead]
        mnll = self.likelihood.mnll(y, y_hat, n)
        out = {"mnll": mnll, "mnll_per_point": mnll / n}
        if hasattr(self.likelihood, "log_prob"):
            lp = self.likelihood.log_prob(y, y_hat)
            pred_ll = torch.logsumexp(lp, dim=lead) - math.log(S)
            out["pred_mnll_per_point"] = -torch.mean(pred_ll, dim=-1)
        if (
            y.ndim > 1 + lead
            and y_hat.ndim == 3 + lead
            and y_hat.shape[-1] == y.shape[-1]
        ):
            out["rmse"] = torch.sqrt(
                torch.mean((torch.mean(y_hat, dim=lead) - y).square(), dim=per_point)
            )
        if hasattr(self.likelihood, "predict"):
            moments = self.likelihood.predict(y_hat)
            if isinstance(moments, tuple) and y.ndim == moments[0].ndim:
                mean, sd = moments
                inside = torch.abs(y - mean) <= 1.9599640 * sd
                out["coverage95"] = torch.mean(inside.to(y_hat.dtype), dim=per_point)
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
    *,
    device=None,
    dtype=torch.float32,
) -> WHVINetwork:
    """Network plus a Gaussian likelihood with initial noise ``sigma0``,
    its parameter of ``dtype`` on ``device`` (the layers take theirs; the
    JAX ``init(key, dtype)`` gives one dtype to all)."""
    return WHVINetwork(
        layers,
        GaussianLikelihood(sigma0, device=device, dtype=dtype),
        train_samples=train_samples,
        eval_samples=eval_samples,
    )


@torch.no_grad()
def stack_replicas(net: WHVINetwork, replicas: int) -> WHVINetwork:
    """Make ``net`` ``replicas`` independent replicas of itself, in place:
    every parameter ``p`` becomes ``(replicas,) + p.shape`` (each replica a
    copy of ``p``) and every module gets ``replicas``. The counterpart of
    the JAX trainer's ``vmap_splits``: one forward, one backward and one
    Adam step serve all replicas, which share no parameter, so each
    replica's gradient and update are its own. Returns ``net``."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if net.replicas is not None:
        raise ValueError(f"the net already has {net.replicas} replicas")
    if isinstance(net.likelihood, CategoricalLikelihood):
        raise ValueError("the categorical likelihood takes no replica axis")
    for module in net.modules():
        if isinstance(module, Activation):  # stateless, often a shared instance
            continue
        for name, p in list(module.named_parameters(recurse=False)):
            setattr(module, name, nn.Parameter(p.expand(replicas, *p.shape).clone()))
        module.replicas = replicas
    return net
