"""Walsh-Hadamard numerics core (plain PyTorch).

Counterpart of :mod:`whvi_tpu.ops.hadamard` with the same conventions:
``H_D`` is the unnormalized Sylvester (natural-order) Walsh-Hadamard
matrix, ``H[i, j] = (-1)^popcount(i & j)``, ``H = H^T`` and
``H @ H = D * I``; ``fwht(x)`` applies ``H_D`` along the last axis.

Two transforms:

- :func:`fwht`, radix-2 butterflies: adds and subtracts only, so nothing
  is rounded below the input dtype (below float32 for bf16 storage, which
  is rounded once at the end). It is the plain version of the CUDA
  FWHT kernels (``ops/fwht_cuda.py``) and runs the same stages in the
  same order.
- :func:`fwht_kron`, the Kronecker-factor formulation
  ``H_D = H_f0 (x) H_f1 (x) ...`` with factors of at most 128, as
  ``whvi_tpu.ops.hadamard.fwht_kron``. Its precision modes are named by
  what is multiplied: ``"fp32"`` (no operand rounding below the input
  dtype; the JAX ``"highest"`` mode, which is also what JAX ``"default"``
  is on a CPU) and ``"bf16"`` (the operand is rounded to bf16 before each
  factor contraction; H is +-1 and exact; fp32 accumulation; one final
  cast).
"""

from __future__ import annotations

import functools
import math
import struct

import torch
import torch.nn.functional as F

__all__ = [
    "is_pow_of_2",
    "next_pow_of_2",
    "build_H",
    "build_H_rows",
    "factor_H",
    "fwht",
    "fwht_factors",
    "fwht_kron",
    "kl_diag_normal",
    "round_bf16",
    "round_scalar",
    "softplus",
]

PRECISIONS = ("fp32", "bf16")


def is_pow_of_2(n: int) -> bool:
    """True iff ``n`` is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def next_pow_of_2(n: int) -> int:
    """Smallest power of two >= n (exact integer bit math)."""
    if n < 1:
        raise ValueError(f"next_pow_of_2 requires n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def _sign_matrix(rows: torch.Tensor, cols: torch.Tensor, dtype, device):
    v = rows[:, None] & cols[None, :]
    parity = torch.zeros_like(v)
    while bool(v.any()):
        parity ^= v & 1
        v >>= 1
    return (1 - 2 * parity).to(dtype=dtype, device=device)


def build_H(D: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense ``H_D`` via the bit trick (test oracle, dense materialization),
    computed on ``device``."""
    if not is_pow_of_2(D):
        raise ValueError(f"Hadamard dimension must be a power of 2, got {D}")
    i = torch.arange(D, dtype=torch.int64, device=device)
    return _sign_matrix(i, i, dtype, device)


def build_H_rows(D: int, n_rows: int, dtype=torch.float32, device=None):
    """``H_D[:n_rows, :]`` in O(n_rows * D) memory."""
    if not is_pow_of_2(D):
        raise ValueError(f"Hadamard dimension must be a power of 2, got {D}")
    rows = torch.arange(n_rows, dtype=torch.int64)
    cols = torch.arange(D, dtype=torch.int64)
    return _sign_matrix(rows, cols, dtype, device)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """FWHT along the last axis via ``log2 D`` radix-2 butterfly stages.

    Stage ``h`` combines elements ``j`` and ``j + h`` inside every block
    of ``2h`` (``h = 1, 2, 4, ...``), as ``whvi_tpu.ops.hadamard
    .fwht_butterfly`` does. Differentiable by autograd; any float dtype.
    A dtype narrower than float32 (bf16 storage) is transformed in float32
    and rounded once at the end, as ``whvi_tpu.ops.hadamard.fwht_kron``
    accumulates (``preferred_element_type``) and casts once.
    """
    D = x.shape[-1]
    if not is_pow_of_2(D):
        raise ValueError(f"FWHT length must be a power of 2, got {D}")
    if x.dtype.itemsize < 4:
        return fwht(x.float()).to(x.dtype)
    shape = x.shape
    h = 1
    while h < D:
        x = x.reshape(-1, D // (2 * h), 2, h)
        a = x[:, :, 0, :]
        b = x[:, :, 1, :]
        x = torch.stack((a + b, a - b), dim=2)
        h *= 2
    return x.reshape(shape)


def fwht_factors(D: int, max_factor: int = 128) -> tuple[int, ...]:
    """Kronecker factorization of D into powers of two, each <= max_factor,
    the first factor indexing the most-significant bits
    (``H_{2^n} = H_2 (x) H_{2^{n-1}}``)."""
    if not is_pow_of_2(D):
        raise ValueError(f"FWHT length must be a power of 2, got {D}")
    if not is_pow_of_2(max_factor):
        raise ValueError("max_factor must be a power of 2")
    factors = []
    rem = D
    while rem > 1:
        f = min(rem, max_factor)
        factors.append(f)
        rem //= f
    return tuple(factors) if factors else (1,)


@functools.lru_cache(maxsize=64)
def factor_H(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``H_n`` for a Kronecker factor, built once per (n, dtype, device):
    :func:`build_H` synchronizes with the device, which a transform on
    the card (or one captured into a CUDA graph) must not. Shared: do not
    modify it in place."""
    return build_H(n, dtype, device)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest, ties to even), in ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x)`` as the JAX package computes it: ``F.softplus`` from
    float32 up; below float32 (bf16 storage) ``jax.nn.softplus``'s
    ``logaddexp(x, 0)`` op by op, ``max(x, 0) + log1p(exp(-|x|))``, each op
    rounding to ``x``'s dtype as XLA's do (one rounding of the exact value
    differs from it in about 15% of bf16 inputs)."""
    if x.dtype.itemsize >= 4:
        return F.softplus(x)
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def round_scalar(value: float, dtype: torch.dtype) -> float:
    """The Python float ``value`` rounded to ``dtype`` (nearest, ties to
    even): what JAX does to a weakly typed scalar beside an array of that
    dtype. A host computation; nothing touches a device. bf16 by its bits
    (through float32, as PyTorch converts a double), which costs a
    microsecond where a tensor costs tens."""
    if dtype == torch.bfloat16 and math.isfinite(value):
        bits = struct.unpack("<I", struct.pack("<f", value))[0]
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def fwht_kron(
    x: torch.Tensor, max_factor: int = 128, precision: str = "fp32"
) -> torch.Tensor:
    """FWHT along the last axis as Kronecker-factor contractions.

    ``(..., D)`` is viewed as ``(..., f0, f1, ...)`` and each factor axis
    is contracted with the dense ``H_fi``, most-significant first. The
    intermediate stays in the accumulation dtype (float32, or the input's
    if wider) across the chain, with one final cast. ``"bf16"`` rounds the
    operand of every contraction to bfloat16 (see the module docstring).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    D = x.shape[-1]
    factors = fwht_factors(D, max_factor)
    dtype = x.dtype
    acc = dtype if dtype.itemsize > 4 else torch.float32
    batch = x.shape[:-1]
    t = x.to(acc).reshape(*batch, *factors)
    nb = len(batch)
    for i, f in enumerate(factors):
        if precision == "bf16":
            t = round_bf16(t)
        H = factor_H(f, acc, x.device)
        t = torch.movedim(torch.movedim(t, nb + i, -1) @ H, -1, nb + i)
    return t.reshape(*batch, D).to(dtype)


def kl_diag_normal(mu_q, sigma_q, mu_p, sigma_p, keep: int = 0) -> torch.Tensor:
    """KL(N(mu_q, diag sigma_q^2) || N(mu_p, diag sigma_p^2)), summed over
    all axes but the first ``keep`` (the replica axis of a replicated
    parameter).

    Arguments are standard deviations (the paper-correct form; see
    ``whvi_tpu.ops.hadamard.kl_diag_normal``)::

        KL = sum[ log(sigma_p / sigma_q)
                  + (sigma_q^2 + (mu_q - mu_p)^2) / (2 sigma_p^2) - 1/2 ]

    The prior's ``mu_p`` and ``sigma_p`` may be tensors or Python floats;
    floats stay host scalars, so no scalar is copied to the device. Below
    float32 (bf16 storage) a float ``sigma_p``, its log and ``2 sigma_p^2``
    are rounded to ``mu_q``'s dtype op by op, as JAX computes them on
    ``jnp.asarray(sigma_p, dtype)``.
    """
    if torch.is_tensor(sigma_p):
        log_sigma_p = torch.log(sigma_p)
        two_var_p = 2.0 * sigma_p * sigma_p
    elif mu_q.dtype.itemsize < 4:
        r = functools.partial(round_scalar, dtype=mu_q.dtype)
        sigma_p = r(sigma_p)
        log_sigma_p = r(math.log(sigma_p))
        two_var_p = r(2.0 * r(sigma_p * sigma_p))
    else:
        log_sigma_p = math.log(sigma_p)
        two_var_p = 2.0 * sigma_p * sigma_p
    terms = (
        log_sigma_p
        - torch.log(sigma_q)
        + (sigma_q.square() + (mu_q - mu_p) ** 2) / two_var_p
        - 0.5
    )
    if keep:
        return torch.sum(terms, dim=tuple(range(keep, terms.dim())))
    return torch.sum(terms)
