"""MCMC convergence diagnostics: split-R-hat and ESS (PyTorch).

Counterpart of :mod:`whvi_tpu.mcmc.diagnostics`: the
Vehtari-Gelman-Simpson-Carpenter-Buerkner (2021) estimators as Stan and
ArviZ use them, on tensors of any device:

- :func:`split_rhat`: potential scale reduction over split chains;
- :func:`ess`: effective sample size from FFT autocovariances and Geyer's
  initial monotone positive sequence, combined across chains;
- :func:`summarize`: a per-leaf moment and diagnostic table for a tree of
  chains.

Array convention: ``chains`` has shape ``(n_chains, n_draws, *param)``.
Everything computes in the dtype it is given (float32 from the samplers,
as JAX's default).
"""

from __future__ import annotations

import torch

__all__ = ["split_rhat", "ess", "summarize"]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _autocov(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance along axis 1 through the FFT. x: (C, N, ...)."""
    n = x.shape[1]
    xc = x - torch.mean(x, dim=1, keepdim=True)
    m = _next_pow2(2 * n)
    f = torch.fft.rfft(xc, n=m, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=1)[:, :n]
    return acov / n


def split_rhat(chains) -> torch.Tensor:
    """Split potential-scale-reduction R-hat.

    ``chains: (C, N, *param)`` -> R-hat per parameter element (shape
    ``param``). Each chain is split in half (2C half-chains); values near
    1 say the half-chains agree in mean and variance.
    """
    chains = torch.as_tensor(chains)
    C, N = chains.shape[:2]
    half = N // 2
    s = chains[:, : 2 * half].reshape((2 * C, half) + tuple(chains.shape[2:]))
    m = torch.mean(s, dim=1)  # (2C, *param)
    v = torch.var(s, dim=1, correction=1)
    W = torch.mean(v, dim=0)
    B_over_n = torch.var(m, dim=0, correction=1)  # = B / half
    var_plus = (half - 1) / half * W + B_over_n
    return torch.sqrt(var_plus / torch.clamp(W, min=1e-30))


def ess(chains) -> torch.Tensor:
    """Effective sample size combined across chains.

    ``chains: (C, N, *param)`` -> ESS per parameter element. Per-chain FFT
    autocovariances, the multi-chain correlation estimate ``rho_t = 1 -
    (W - mean_c acov_{c,t}) / var_plus``, truncated by Geyer's initial
    monotone positive pair sequence (as Stan does), capped at ``C * N``.
    """
    chains = torch.as_tensor(chains)
    C, N = chains.shape[:2]
    param_shape = tuple(chains.shape[2:])
    flat = chains.reshape(C, N, -1)  # (C, N, P)
    acov = _autocov(flat)  # (C, N, P)
    chain_var = acov[:, 0, :] * N / max(N - 1, 1)  # (C, P)
    W = torch.mean(chain_var, dim=0)  # (P,)
    mean_acov = torch.mean(acov, dim=0)  # (N, P)
    if C > 1:
        m = torch.mean(flat, dim=1)  # (C, P)
        B_over_n = torch.var(m, dim=0, correction=1)
    else:
        B_over_n = torch.zeros_like(W)
    var_plus = (N - 1) / N * W + B_over_n  # (P,)
    var_plus = torch.clamp(var_plus, min=1e-30)
    rho = 1.0 - (W[None, :] - mean_acov) / var_plus[None, :]  # (N, P)

    # Geyer pairs: P_k = rho_{2k} + rho_{2k+1}
    n_pairs = N // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, -1).sum(dim=1)  # (K, P)
    # keep pairs up to (not including) the first non-positive one; the
    # k=0 pair (rho_0 = 1 plus rho_1) is always kept
    keep = torch.cumprod((pairs > 0.0).to(pairs.dtype), dim=0)
    keep[0] = 1.0
    # initial monotone sequence: the running minimum of the pair sums
    mono = torch.clamp(torch.cummin(pairs, dim=0).values, min=0.0)
    tau = -1.0 + 2.0 * torch.sum(mono * keep, dim=0)  # (P,)
    n_eff = C * N / torch.clamp(tau, min=1e-3)
    # cap at the draw count (iid chains can over-estimate slightly)
    n_eff = torch.clamp(n_eff, max=float(C * N))
    return n_eff.reshape(param_shape) if param_shape else n_eff[0]


def _leaves_with_path(tree, path=""):
    """``(path, leaf)`` in JAX's flatten order, the path as
    ``jax.tree_util.keystr`` writes it (``"['g']"``, ``"[0]"``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, torch.as_tensor(tree)


def summarize(samples) -> dict:
    """Per-leaf diagnostics for a tree of chains ``(C, N, *param)``.

    Returns ``{leaf_path: {"mean", "sd", "rhat_max", "ess_min"}}`` with
    Python floats: the shape of a Stan ``print(fit)`` table. (The JAX
    function's ``max_elems`` is unused there and left out here.)
    """
    out = {}
    for name, leaf in _leaves_with_path(samples):
        pooled = leaf.reshape((-1,) + tuple(leaf.shape[2:]))
        out[name] = {
            "mean": float(torch.mean(pooled)),
            "sd": float(torch.std(pooled, correction=0)),
            "rhat_max": float(torch.max(split_rhat(leaf))),
            "ess_min": float(torch.min(ess(leaf))),
        }
    return out
