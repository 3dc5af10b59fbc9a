"""Layers: the shape-dispatched WHVI linear layer and activations.

Counterpart of :mod:`whvi_tpu.models.layers`. ``WHVILinear.matrix``
follows the same dispatch (``whvi_tpu/models/layers.py:85-108``):

  n_in == 1            -> ColumnMatrix(n_out)
  n_out == 1           -> ColumnMatrix(n_in, transposed=True)
  square power of two  -> SquarePow2Matrix(n_in)
  otherwise            -> StackedMatrix(n_in, n_out)

Every layer's ``forward(x, generator=None, eps=None)`` is one stochastic
pass over ``x (*S, B, n_in)`` (JAX ``apply`` under the vmap over MC
samples), and ``kl()`` is its KL term (0 for activations).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from whvi_tpu_torch.models.weights import (
    ColumnMatrix,
    SquarePow2Matrix,
    StackedMatrix,
)
from whvi_tpu_torch.ops.hadamard import is_pow_of_2

__all__ = ["WHVILinear", "Activation", "relu"]


class WHVILinear(nn.Module):
    """Bayesian linear layer with a WHVI-structured variational posterior.

    ``lambda_`` is the prior variance of ``g``; ``lrt`` with
    ``per_example_noise`` draws an independent ``eps`` per batch row
    (square and stacked matrices); ``s_init`` is the S1/S2 init stddev
    (0.01, or ``"auto"`` for ``D**-0.5``); ``bias`` adds a deterministic
    bias vector.
    """

    def __init__(
        self,
        n_in: int,
        n_out: int,
        lambda_: float = 1e-5,
        bias: bool = False,
        lrt: bool = True,
        s_init=0.01,
        per_example_noise: bool = False,
        *,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.n_in = n_in
        self.n_out = n_out
        self.lrt = lrt
        self.per_example_noise = per_example_noise
        kw = dict(s_init=s_init, device=device, dtype=dtype)
        if n_in == 1:
            self.matrix = ColumnMatrix(n_out, lambda_, **kw)
        elif n_out == 1:
            self.matrix = ColumnMatrix(n_in, lambda_, transposed=True, **kw)
        elif n_in == n_out and is_pow_of_2(n_in):
            self.matrix = SquarePow2Matrix(n_in, lambda_, **kw)
        else:
            self.matrix = StackedMatrix(n_in, n_out, lambda_, **kw)
        if bias:
            self.bias = nn.Parameter(torch.zeros(n_out, device=device, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.matrix.reset_parameters(generator)
        if self.bias is not None:
            self.bias.zero_()

    def kl(self) -> torch.Tensor:
        return self.matrix.kl()

    def forward(self, x, generator=None, eps=None):
        y = self.matrix(
            x,
            generator,
            per_example_noise=self.lrt and self.per_example_noise,
            eps=eps,
        )
        if self.bias is not None:
            y = y + self.bias
        return y


class Activation(nn.Module):
    """Stateless elementwise activation as a layer."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], name: str):
        super().__init__()
        self.fn = fn
        self.name = name

    def reset_parameters(self, generator=None):
        del generator

    def kl(self) -> float:
        return 0.0

    def forward(self, x, generator=None, eps=None):
        del generator, eps
        return self.fn(x)


relu = Activation(torch.relu, "relu")
