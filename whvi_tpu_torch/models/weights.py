"""Structured variational weight matrices as ``nn.Module``s.

Counterparts of ``SquarePow2Matrix``, ``StackedMatrix``, ``ColumnMatrix``
and ``PaddedSquareMatrix`` in :mod:`whvi_tpu.models.weights`, with the
JAX parameter names (``s1``, ``s2``, ``g_mu``, ``g_rho``) and shapes; the
stacked matrix keeps its blocks on a leading ``stack`` axis.

Every matrix has ``kl()``, ``sample_g``, ``forward`` (the counterpart of
JAX ``apply``; ``nn.Module.apply`` keeps its PyTorch meaning),
``apply_given_g`` and ``sample_W``, the dense ``(n_out, n_in)`` sample
(test oracle). Inputs carry the MC-sample axes in front:
``x (*S, B, n_in)``. One forward draws the posterior noise for every
sample at once:

- shared noise, one ``eps`` per sample: ``(*S, 1) + g_mu.shape``;
- per-example noise, one per row: ``(*S, B) + g_mu.shape``.

``W_bar`` is linear in ``u``, so the local reparameterization trick's
mean and noise products merge into one product with
``u = g_mu + softplus(g_rho) * eps`` (``whvi_tpu/models/weights.py``
:161-176); with shared noise that is also the explicit-sample path.
Randomness comes only from the ``torch.Generator`` passed in, or from an
explicit ``eps`` (tests feed both packages the same noise this way).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from whvi_tpu_torch.ops.fwht_cuda import fwht_cuda
from whvi_tpu_torch.ops.hadamard import (
    build_H_rows,
    is_pow_of_2,
    kl_diag_normal,
    next_pow_of_2,
)
from whvi_tpu_torch.ops.whvi_op import whvi_dense, whvi_mul

__all__ = [
    "SquarePow2Matrix",
    "StackedMatrix",
    "ColumnMatrix",
    "PaddedSquareMatrix",
    "setup_dimensions",
]


def setup_dimensions(n_in: int, n_out: int) -> tuple[int, int, int, int]:
    """``(D_in, D_out, padding, stack)`` of a stacked non-square matrix,
    e.g. (3,16)->(4,16,1,4), (13,128)->(16,128,3,8),
    (128,128)->(128,128,0,1), (8,10)->(8,16,0,2)."""
    D_in = next_pow_of_2(n_in)
    padding = D_in - n_in
    stack = -(-n_out // D_in)  # ceil division
    return D_in, stack * D_in, padding, stack


class _WHVIMatrix(nn.Module):
    """Parameters ``s1, s2, g_mu, g_rho`` of ``shape`` (last axis ``D``);
    posterior ``q(g) = N(g_mu, diag softplus(g_rho)^2)``, prior
    ``N(0, lambda_ I)``."""

    def __init__(self, shape, lambda_, s_init, device, dtype):
        super().__init__()
        self.lambda_ = lambda_
        self.s_init = s_init
        for name in ("s1", "s2", "g_mu", "g_rho"):
            self.register_parameter(
                name,
                nn.Parameter(torch.empty(shape, device=device, dtype=dtype)),
            )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """The reference init (``whvi_tpu/models/weights.py:109-120``):
        ``s1, s2 ~ scale * N(0, 1)`` with ``scale`` 0.01 or ``D**-0.5``
        for ``s_init="auto"``, ``g_mu = 0``, ``g_rho ~ U(-3, -2)``."""
        D = self.s1.shape[-1]
        scale = D**-0.5 if self.s_init == "auto" else float(self.s_init)
        self.s1.normal_(generator=generator).mul_(scale)
        self.s2.normal_(generator=generator).mul_(scale)
        self.g_mu.zero_()
        self.g_rho.uniform_(-3.0, -2.0, generator=generator)

    def g_sigma(self) -> torch.Tensor:
        return F.softplus(self.g_rho)

    def kl(self) -> torch.Tensor:
        return kl_diag_normal(
            self.g_mu, self.g_sigma(), 0.0, math.sqrt(self.lambda_)
        )

    def sample_g(self, sample_shape, generator=None) -> torch.Tensor:
        """``g ~ q`` of shape ``sample_shape + g_mu.shape``."""
        eps = torch.randn(
            tuple(sample_shape) + tuple(self.g_mu.shape),
            generator=generator,
            device=self.g_mu.device,
            dtype=self.g_mu.dtype,
        )
        return self.g_mu + self.g_sigma() * eps

    def sample_W(self, generator=None, eps=None) -> torch.Tensor:
        """A dense ``(n_out, n_in)`` weight sample, ``eps`` of ``g_mu``'s
        shape drawn from ``generator`` unless given."""
        if eps is None:
            return self.dense_given_g(self.sample_g((), generator))
        return self.dense_given_g(self.g_mu + self.g_sigma() * eps)

    def noise_shape(self, x: torch.Tensor, per_example_noise: bool):
        lead = x.shape[:-1] if per_example_noise else x.shape[:-2] + (1,)
        return tuple(lead) + tuple(self.g_mu.shape)

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        per_example_noise: bool = False,
        eps: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``y = x @ W^T`` with ``W ~ q``: ``apply_given_g`` at
        ``g = g_mu + softplus(g_rho) * eps``, with ``eps`` drawn from
        ``generator`` unless given."""
        if eps is None:
            eps = torch.randn(
                self.noise_shape(x, per_example_noise),
                generator=generator,
                device=x.device,
                dtype=x.dtype,
            )
        return self.apply_given_g(x, self.g_mu + self.g_sigma() * eps, per_example_noise)


class SquarePow2Matrix(_WHVIMatrix):
    """``D x D`` WHVI matrix, ``D`` a power of two; parameters ``(D,)``."""

    def __init__(
        self, D: int, lambda_: float = 1e-5, s_init=0.01, *,
        device=None, dtype=torch.float32,
    ):
        if not is_pow_of_2(D):
            raise ValueError(f"D must be a power of 2, got {D}")
        self.D = D
        super().__init__((D,), lambda_, s_init, device, dtype)

    @property
    def n_in(self) -> int:
        return self.D

    @property
    def n_out(self) -> int:
        return self.D

    def apply_given_g(self, x, g, per_example_noise: bool = False):
        """``x @ W_bar(g)^T``; ``g`` broadcasts against ``x``'s leading axes
        (one row per batch row with ``per_example_noise``)."""
        return whvi_mul(self.s1, g, self.s2, x, per_example=per_example_noise)

    def dense_given_g(self, g):
        """``W = S1 H diag(g) H S2``, ``(D, D)``."""
        return whvi_dense(self.s1, g, self.s2)


class StackedMatrix(_WHVIMatrix):
    """``(n_in, n_out)`` matrix as ``stack`` square ``D_in`` blocks:
    inputs zero-padded to ``D_in``, all blocks applied in one broadcast
    product, outputs concatenated and truncated to ``n_out``. Parameters
    ``(stack, D_in)``."""

    def __init__(
        self, n_in: int, n_out: int, lambda_: float = 1e-5, s_init=0.01, *,
        device=None, dtype=torch.float32,
    ):
        self.n_in = n_in
        self.n_out = n_out
        self.dims = setup_dimensions(n_in, n_out)
        D_in, _, _, stack = self.dims
        super().__init__((stack, D_in), lambda_, s_init, device, dtype)

    def apply_given_g(self, x, g, per_example_noise: bool = False):
        """``(..., n_in) -> (..., n_out)``; ``g (..., stack, D_in)``
        broadcasts against ``x``'s leading axes."""
        padding = self.dims[2]
        xp = F.pad(x, (0, padding)) if padding else x
        out = whvi_mul(self.s1, g, self.s2, xp[..., None, :], per_example=per_example_noise)
        out = out.reshape(out.shape[:-2] + (-1,))
        return out[..., : self.n_out]

    def dense_given_g(self, g):
        """The blocks stacked vertically and truncated, ``(n_out, n_in)``."""
        D_in, D_out, _, _ = self.dims
        W = whvi_dense(self.s1, g, self.s2).reshape(D_out, D_in)
        return W[: self.n_out, : self.n_in]


class ColumnMatrix(_WHVIMatrix):
    """``(n, 1)`` column (``(1, n)`` row when ``transposed``) matrix: the
    first ``n`` entries, row-major, of a square ``D_adj`` WHVI sample,
    ``D_adj = next_pow_of_2(n)``. Only the ``ceil(n / D_adj)`` surviving
    rows are computed, ``row_i = s1[i] * fwht(H[i, :] * g) * s2``, through
    the FWHT kernel. Parameters ``(D_adj,)``.

    By default one explicit column a sample, as the reference
    (``whvi_tpu/models/weights.py:389-396``). With ``use_lrt`` and
    per-example noise it draws ``eps (*S, B, D_adj)``, one column a batch
    row: the column is linear in ``g``, so this is the local
    reparameterization trick, a lower-variance estimator with the same
    marginals. The layer passes per-example noise only when its ``lrt``
    and ``per_example_noise`` are both on, so the matrix engages it
    exactly when JAX does (``use_lrt and lrt and per_example_noise``)."""

    def __init__(
        self, n: int, lambda_: float = 1e-5, transposed: bool = False,
        s_init=0.01, use_lrt: bool = False, *, device=None,
        dtype=torch.float32,
    ):
        self.n = n
        self.transposed = transposed
        self.use_lrt = use_lrt
        self.D_adj = next_pow_of_2(n)
        super().__init__((self.D_adj,), lambda_, s_init, device, dtype)
        n_rows = -(-n // self.D_adj)
        self.register_buffer(
            "H_rows",
            build_H_rows(self.D_adj, n_rows, dtype, device),
            persistent=False,
        )

    @property
    def n_in(self) -> int:
        return self.n if self.transposed else 1

    @property
    def n_out(self) -> int:
        return 1 if self.transposed else self.n

    def noise_shape(self, x, per_example_noise):
        return super().noise_shape(x, self.use_lrt and per_example_noise)

    def column_given_g(self, g):
        """Column from ``g (..., D_adj)``; returns ``(..., n)``: one column
        a row of ``g``, so ``g (*S, B, D_adj)`` gives one a batch row."""
        n_rows = self.H_rows.shape[0]
        rows = (
            self.s1[:n_rows, None]
            * fwht_cuda(self.H_rows * g[..., None, :])
            * self.s2
        )
        return rows.reshape(g.shape[:-1] + (n_rows * self.D_adj,))[..., : self.n]

    def sample_column(self, sample_shape=(), generator=None):
        """``sample_shape + (n,)`` column samples."""
        return self.column_given_g(self.sample_g(sample_shape, generator))

    def apply_given_g(self, x, g, per_example_noise: bool = False):
        """``x @ W^T`` for the column of ``g``; ``g``'s leading axes say
        whether a column serves a sample or a row (``per_example_noise``
        is not needed: the FWHT has no bf16 mode)."""
        del per_example_noise
        col = self.column_given_g(g)
        if self.transposed:
            return torch.sum(x * col, dim=-1, keepdim=True)
        return x * col

    def dense_given_g(self, g):
        col = self.column_given_g(g)
        return col[None, :] if self.transposed else col[:, None]


class PaddedSquareMatrix(_WHVIMatrix):
    """``(n_in, n_out)`` map as ONE square WHVI block of
    ``D = next_pow_of_2(max(n_in, n_out))``: inputs zero-padded to ``D``,
    outputs truncated to ``n_out``. Unlike the stacked construction every
    output mixes every input (``whvi_tpu/models/weights.py:407-474``).
    Parameters ``(D,)``."""

    def __init__(
        self, n_in: int, n_out: int, lambda_: float = 1e-5, s_init=0.01, *,
        device=None, dtype=torch.float32,
    ):
        self.n_in = n_in
        self.n_out = n_out
        self.D = next_pow_of_2(max(n_in, n_out))
        super().__init__((self.D,), lambda_, s_init, device, dtype)

    def apply_given_g(self, x, g, per_example_noise: bool = False):
        """``(..., n_in) -> (..., n_out)``; ``g (..., D)`` broadcasts
        against ``x``'s leading axes (one row per batch row with
        ``per_example_noise``, which ``whvi_mul`` must be told: at batch 1
        the shape cannot say)."""
        pad = self.D - self.n_in
        xp = F.pad(x, (0, pad)) if pad else x
        y = whvi_mul(self.s1, g, self.s2, xp, per_example=per_example_noise)
        return y[..., : self.n_out]

    def dense_given_g(self, g):
        return whvi_dense(self.s1, g, self.s2)[: self.n_out, : self.n_in]
