"""Layers: the shape-dispatched WHVI linear layer, Dense, Parallel and
activations.

Counterpart of :mod:`whvi_tpu.models.layers`. ``WHVILinear.matrix``
follows the same dispatch (``whvi_tpu/models/layers.py:85-108``):

  n_in == 1            -> ColumnMatrix(n_out)
  n_out == 1           -> ColumnMatrix(n_in, transposed=True)
  square power of two  -> SquarePow2Matrix(n_in)
  rect_mode == "pad"   -> PaddedSquareMatrix(n_in, n_out)
  otherwise            -> StackedMatrix(n_in, n_out)

Every layer's ``forward(x, generator=None, eps=None)`` is one stochastic
pass over ``x (*S, B, n_in)`` (JAX ``apply`` under the vmap over MC
samples), and ``kl(lambda_=None)`` is its KL term (0 for deterministic
layers), ``lambda_`` overriding the prior variance as JAX's
``kl(params, lambda_)`` does (a tuple of per-branch entries for a
``Parallel``). A ``Parallel`` layer's ``eps`` is a tuple with one entry
per branch. Replicated layers (``replicas = R``, see
:mod:`whvi_tpu_torch.models.weights`) take ``x (R, *S, B, n_in)``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from whvi_tpu_torch.models.weights import (
    ColumnMatrix,
    PaddedSquareMatrix,
    SquarePow2Matrix,
    StackedMatrix,
    replica_view,
)
from whvi_tpu_torch.ops.hadamard import is_pow_of_2

__all__ = [
    "WHVILinear",
    "Dense",
    "Activation",
    "Parallel",
    "relu",
    "cosine",
    "sigmoid",
    "tanh",
]


class WHVILinear(nn.Module):
    """Bayesian linear layer with a WHVI-structured variational posterior.

    ``lambda_`` is the prior variance of ``g``; ``lrt`` with
    ``per_example_noise`` draws an independent ``eps`` per batch row
    (square, stacked and padded matrices, and column matrices with
    ``column_lrt``); ``s_init`` is the S1/S2 init stddev (0.01, or
    ``"auto"`` for ``D**-0.5``); ``rect_mode`` builds a non-square,
    non-column matrix as stacked square blocks (``"stack"``) or one padded
    block (``"pad"``); ``bias`` adds a deterministic bias vector.
    """

    replicas: int | None = None

    def __init__(
        self,
        n_in: int,
        n_out: int,
        lambda_: float = 1e-5,
        bias: bool = False,
        lrt: bool = True,
        s_init=0.01,
        per_example_noise: bool = False,
        rect_mode: str = "stack",
        column_lrt: bool = False,
        *,
        device=None,
        dtype=torch.float32,
    ):
        if rect_mode not in ("stack", "pad"):
            raise ValueError(f"rect_mode must be 'stack' or 'pad', got {rect_mode!r}")
        super().__init__()
        self.n_in = n_in
        self.n_out = n_out
        self.lrt = lrt
        self.per_example_noise = per_example_noise
        self.rect_mode = rect_mode
        self.column_lrt = column_lrt
        kw = dict(s_init=s_init, device=device, dtype=dtype)
        if n_in == 1:
            self.matrix = ColumnMatrix(n_out, lambda_, use_lrt=column_lrt, **kw)
        elif n_out == 1:
            self.matrix = ColumnMatrix(
                n_in, lambda_, transposed=True, use_lrt=column_lrt, **kw
            )
        elif n_in == n_out and is_pow_of_2(n_in):
            self.matrix = SquarePow2Matrix(n_in, lambda_, **kw)
        elif rect_mode == "pad":
            self.matrix = PaddedSquareMatrix(n_in, n_out, lambda_, **kw)
        else:
            self.matrix = StackedMatrix(n_in, n_out, lambda_, **kw)
        if bias:
            self.bias = nn.Parameter(torch.zeros(n_out, device=device, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, replica=None):
        self.matrix.reset_parameters(generator, replica)
        if self.bias is not None:
            (self.bias if replica is None else self.bias[replica]).zero_()

    def kl(self, lambda_=None) -> torch.Tensor:
        return self.matrix.kl(lambda_)

    def _add_bias(self, y):
        if self.bias is None:
            return y
        return y + replica_view(self.bias, y.dim(), self.replicas)

    @property
    def noise_per_example(self) -> bool:
        """Whether the forward draws one noise row a batch row."""
        return self.lrt and self.per_example_noise

    def draw_eps(self, lead, generator=None, dtype=None, device=None) -> torch.Tensor:
        """The ``eps`` that :meth:`forward` draws from ``generator`` for an
        input of shape ``(*lead, n_in)``, drawn now."""
        return self.matrix.draw_eps(lead, generator, self.noise_per_example, dtype, device)

    def forward(self, x, generator=None, eps=None):
        y = self.matrix(x, generator, per_example_noise=self.noise_per_example, eps=eps)
        return self._add_bias(y)

    def sample_W(self, generator=None, eps=None) -> torch.Tensor:
        """A dense ``(n_out, n_in)`` weight sample (oracle, inspection)."""
        return self.matrix.sample_W(generator, eps)

    def apply_given_g(self, x, g, per_example_noise: bool = False):
        """Deterministic forward with an explicit ``g`` (the MCMC path),
        bias included; ``per_example_noise`` says ``g`` has one row per
        batch row."""
        return self._add_bias(self.matrix.apply_given_g(x, g, per_example_noise))


class Dense(nn.Module):
    """Deterministic dense layer, ``x @ w + b`` with the JAX parameters
    ``w (n_in, n_out)`` and ``b (n_out,)`` (not an ``nn.Linear``, whose
    weight is ``(n_out, n_in)``). Init ``w ~ U(-1/sqrt(n_in),
    1/sqrt(n_in))``, ``b = 0``; KL 0."""

    replicas: int | None = None

    def __init__(
        self, n_in: int, n_out: int, bias: bool = True, *, device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.n_in = n_in
        self.n_out = n_out
        self.w = nn.Parameter(torch.empty(n_in, n_out, device=device, dtype=dtype))
        if bias:
            self.b = nn.Parameter(torch.zeros(n_out, device=device, dtype=dtype))
        else:
            self.register_parameter("b", None)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, replica=None):
        scale = 1.0 / math.sqrt(self.n_in)
        (self.w if replica is None else self.w[replica]).uniform_(
            -scale, scale, generator=generator
        )
        if self.b is not None:
            (self.b if replica is None else self.b[replica]).zero_()

    def kl(self, lambda_=None) -> torch.Tensor:
        del lambda_
        return self.w.new_zeros(self.w.shape[:1] if self.replicas else ())

    def draw_eps(self, lead, generator=None, dtype=None, device=None) -> None:
        del lead, generator, dtype, device

    def forward(self, x, generator=None, eps=None):
        del generator, eps
        y = x @ replica_view(self.w, x.dim(), self.replicas)
        return y if self.b is None else y + replica_view(self.b, y.dim(), self.replicas)


class Parallel(nn.Module):
    """Branches over the same input, outputs concatenated on the last axis;
    KL the sum over branches. Built for the heteroscedastic split head:
    ``[mean, raw_sigma]`` columns under separate priors. Each branch draws
    its own noise, in branch order; ``eps`` is ``None`` or a tuple with
    one entry per branch."""

    def __init__(self, branches: Sequence[nn.Module]):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, replica=None):
        for branch in self.branches:
            branch.reset_parameters(generator, replica)

    def kl(self, lambda_=None) -> torch.Tensor:
        """Sum of the branches' KL terms; ``lambda_`` is None or a tuple of
        per-branch overrides (each None, a float or a tensor)."""
        if lambda_ is None:
            lambda_ = (None,) * len(self.branches)
        if len(lambda_) != len(self.branches):
            raise ValueError(
                f"lambda_ must have one entry per branch ({len(self.branches)}), "
                f"got {len(lambda_)}"
            )
        return sum(b.kl(lam) for b, lam in zip(self.branches, lambda_))

    def draw_eps(self, lead, generator=None, dtype=None, device=None) -> tuple:
        return tuple(b.draw_eps(lead, generator, dtype, device) for b in self.branches)

    def forward(self, x, generator=None, eps=None):
        if eps is None:
            eps = (None,) * len(self.branches)
        if len(eps) != len(self.branches):
            raise ValueError(
                f"eps must have one entry per branch ({len(self.branches)}), "
                f"got {len(eps)}"
            )
        return torch.cat(
            [b(x, generator, e) for b, e in zip(self.branches, eps)], dim=-1
        )


class Activation(nn.Module):
    """Stateless elementwise activation as a layer."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], name: str):
        super().__init__()
        self.fn = fn
        self.name = name

    def reset_parameters(self, generator=None, replica=None):
        del generator, replica

    def kl(self, lambda_=None) -> float:
        del lambda_
        return 0.0

    def draw_eps(self, lead, generator=None, dtype=None, device=None) -> None:
        del lead, generator, dtype, device

    def forward(self, x, generator=None, eps=None):
        del generator, eps
        return self.fn(x)


relu = Activation(torch.relu, "relu")
cosine = Activation(torch.cos, "cosine")  # the paper's toy example
sigmoid = Activation(torch.sigmoid, "sigmoid")
tanh = Activation(torch.tanh, "tanh")
