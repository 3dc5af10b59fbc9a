"""Warm-up adaptation shared by the golden samplers: expanding-window
mass-matrix estimation (Stan phase II) on Welford accumulators (PyTorch).

Counterpart of :mod:`whvi_tpu.mcmc.adapt`. Stan's windowed scheme (Stan
reference manual, "HMC algorithm parameters"; Hoffman & Gelman 2014 for
the dual averaging it wraps):

- warm-up splits into an initial fast buffer (step size only), a series
  of doubling "slow" windows (25, 50, 100, ... draws), and a terminal
  fast buffer;
- within each slow window the per-coordinate posterior variance (or the
  covariance, for a dense metric) is accumulated with Welford's algorithm
  over the post-accept positions;
- at each window end the inverse mass becomes the regularized estimate
  ``(n/(n+5)) var + 1e-3 (5/(n+5))`` (shrinkage toward unit scale,
  Stan's constants), the accumulator resets, and dual averaging restarts
  at the current step size.

The schedule is host-side numpy (:func:`warmup_schedule`), so a sampler
knows on the host which steps accumulate and where windows end. Every
update here is masked: ``on`` / ``at_end`` is a Python bool (taken from
those masks: the update is applied or not, with no device value read) or
a bool tensor broadcasting against the state's leading axes (applied by
``torch.where``). A state may carry leading axes, one accumulator per
chain or rung: ``count (*lead,)``, ``mean (*lead, dim)``, ``m2 (*lead,
dim)`` or ``(*lead, dim, dim)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "welford_cov_init",
    "welford_cov_update",
    "welford_covariance",
    "warmup_schedule",
    "window_update",
    "window_update_dense",
]


class WelfordState(NamedTuple):
    count: torch.Tensor  # (*lead,) float
    mean: torch.Tensor   # (*lead, dim)
    m2: torch.Tensor     # (*lead, dim) or (*lead, dim, dim)


def _host_off(on) -> bool:
    """Whether ``on`` is a host-side False (a Python or numpy bool)."""
    return isinstance(on, (bool, np.bool_)) and not on


def _select(on, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``on``, else ``old``; ``on`` a host bool, or a bool
    tensor over the leading axes (on ``new``'s device)."""
    if isinstance(on, (bool, np.bool_)):
        return new if on else old
    return torch.where(on.reshape(on.shape + (1,) * (new.dim() - on.dim())), new, old)


def _masked(on, new: WelfordState, old: WelfordState) -> WelfordState:
    return WelfordState(*(_select(on, a, b) for a, b in zip(new, old)))


def welford_init(dim: int, dtype=torch.float32, device=None, lead=()) -> WelfordState:
    lead = tuple(lead)
    return WelfordState(
        count=torch.zeros(lead, dtype=dtype, device=device),
        mean=torch.zeros(lead + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(lead + (dim,), dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x: torch.Tensor, on) -> WelfordState:
    """One masked Welford step: accumulate ``x (*lead, dim)`` iff ``on``."""
    if _host_off(on):
        return state
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return _masked(on, WelfordState(count, mean, m2), state)


def welford_variance(state: WelfordState) -> torch.Tensor:
    """Stan-regularized sample variance: shrink toward 1e-3 * I with
    weight 5/(n+5) (keeps the metric sane for short windows)."""
    n = state.count[..., None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    w = n / (n + 5.0)
    return w * var + 1e-3 * (1.0 - w)


def welford_cov_init(dim: int, dtype=torch.float32, device=None, lead=()) -> WelfordState:
    """Full-covariance accumulator: ``m2`` is ``(*lead, dim, dim)``.

    For low-dimensional posteriors (the mixed-lambda WHVI g-posterior is
    16-dim) a dense metric captures the cross-coordinate geometry a
    diagonal cannot.
    """
    lead = tuple(lead)
    return WelfordState(
        count=torch.zeros(lead, dtype=dtype, device=device),
        mean=torch.zeros(lead + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(lead + (dim, dim), dtype=dtype, device=device),
    )


def welford_cov_update(state: WelfordState, x: torch.Tensor, on) -> WelfordState:
    """Masked Welford covariance step (outer-product form)."""
    if _host_off(on):
        return state
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    return _masked(on, WelfordState(count, mean, m2), state)


def welford_covariance(state: WelfordState) -> torch.Tensor:
    """Stan-regularized sample covariance: shrink toward 1e-3 * I, plus a
    scale-aware ridge (1e-3 of the mean diagonal).

    The extra ridge is an fp32 necessity Stan (in doubles) skips: a window
    whose draws lie on a tight correlation ridge yields a near-rank-1
    covariance; its Cholesky then has a tiny diagonal, the momentum draw
    ``L^{-T} xi`` explodes, and the fp32 kinetic energy overflows
    (measured in the JAX package on a rho=0.95 Gaussian before this floor,
    ``tests/test_mass_adapt.py``'s dense tests).
    """
    n = state.count[..., None, None]
    cov = state.m2 / torch.clamp(n - 1.0, min=1.0)
    w = n / (n + 5.0)
    dim = state.mean.shape[-1]
    eye = torch.eye(dim, dtype=cov.dtype, device=cov.device)
    trace = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    scale = torch.clamp(trace / dim, min=1e-3)
    return w * cov + (1e-3 * (1.0 - w) + 1e-3 * w * scale) * eye


def warmup_schedule(
    n_warmup: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side window masks for ``n_warmup`` adaptation steps.

    Returns ``(accumulate, window_end)`` boolean arrays of length
    ``n_warmup``: ``accumulate[t]`` marks steps whose position feeds the
    variance estimate (the slow windows), ``window_end[t]`` the last step
    of each slow window (where the mass matrix updates and dual averaging
    restarts). Buffers follow Stan: if the requested buffers don't fit,
    they shrink to the 15% / 75% / 10% proportions; if no slow window fits
    at all, both masks are all-False (pure step-size adaptation).
    """
    accumulate = np.zeros(n_warmup, dtype=bool)
    window_end = np.zeros(n_warmup, dtype=bool)
    if n_warmup < 20:
        # a variance estimate from a handful of draws is noise even with
        # shrinkage; fall back to pure step-size adaptation
        return accumulate, window_end
    if n_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * n_warmup)
        term_buffer = int(0.10 * n_warmup)
        base_window = n_warmup - init_buffer - term_buffer
        if base_window <= 0:
            return accumulate, window_end
    slow_end = n_warmup - term_buffer
    t = init_buffer
    w = base_window
    while t < slow_end:
        # the last window absorbs the remainder (Stan: a final short
        # window would be a noisy metric, so extend instead of split)
        end = t + w
        if end + 2 * w > slow_end:
            end = slow_end
        accumulate[t:end] = True
        window_end[end - 1] = True
        t = end
        w *= 2
    return accumulate, window_end


def window_update(wf: WelfordState, m_inv: torch.Tensor, at_end):
    """At a window end: inverse mass ``(*lead, dim)`` <- regularized
    variance, and the accumulator resets. Masked by ``at_end``."""
    if _host_off(at_end):
        return wf, m_inv
    new_m_inv = _select(at_end, welford_variance(wf), m_inv)
    fresh = welford_init(m_inv.shape[-1], m_inv.dtype, m_inv.device, wf.count.shape)
    return _masked(at_end, fresh, wf), new_m_inv


def window_update_dense(wf: WelfordState, m_inv: torch.Tensor, at_end):
    """Dense-metric window end: inverse mass (a ``(*lead, dim, dim)``
    posterior-covariance estimate) <- regularized sample covariance."""
    if _host_off(at_end):
        return wf, m_inv
    new_m_inv = _select(at_end, welford_covariance(wf), m_inv)
    fresh = welford_cov_init(m_inv.shape[-1], m_inv.dtype, m_inv.device, wf.count.shape)
    return _masked(at_end, fresh, wf), new_m_inv
