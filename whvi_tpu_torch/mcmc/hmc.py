"""Hamiltonian Monte Carlo golden sampler (PyTorch).

Counterpart of :mod:`whvi_tpu.mcmc.hmc`: leapfrog integration over the
raveled position, dual-averaging step-size adaptation (Hoffman & Gelman
2014, Algorithm 5) and windowed mass-matrix adaptation (Stan phase II,
:mod:`whvi_tpu_torch.mcmc.adapt`) during warm-up. JAX scans a one-chain
step and vmaps it over chains; here one eager Python loop over draws
advances every chain at once, chains on a leading axis
(:mod:`whvi_tpu_torch.mcmc.chains`), with no host sync inside a draw:
accept and divergence decisions stay tensors (``torch.where``), and only
the host-side warm-up masks steer Python.

Random numbers. Each transition takes its draws as tensors
(:func:`hmc_draws` makes them from a ``torch.Generator``), so a test can
feed the draws JAX makes from its keys and hold the transition to JAX's.
JAX keys and torch generators give different streams.

The leapfrog carries its end gradient into the next step and the
transition carries the accepted position's log density and gradient: the
same numbers as recomputing them, one gradient evaluation a leapfrog step.

:func:`make_whvi_g_log_posterior` builds the unnormalized log posterior
of the WHVI diagonals ``g`` (one vector per Bayesian layer) with every
other parameter frozen at its trained value: the distribution that the
variational ``q(g) = N(g_mu, diag(softplus(g_rho)^2))`` approximates.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from whvi_tpu_torch.mcmc import adapt
from whvi_tpu_torch.mcmc.chains import (
    StructuredLogProb,
    ravel,
    run_chains,
    tree_map,
    value_and_grad,
)

__all__ = [
    "HMCConfig",
    "forward_given_g",
    "hmc_draws",
    "hmc_sample",
    "hmc_sample_chains",
    "hmc_transition",
    "make_whvi_g_log_posterior",
    "moments",
]

_F32 = np.float32
_LOG10 = float(np.log(_F32(10.0)))  # jnp.log(10.0), float32


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    n_samples: int = 1000
    n_warmup: int = 500
    n_leapfrog: int = 32
    init_step_size: float = 1e-2
    target_accept: float = 0.8
    adapt: bool = True
    # Windowed diagonal mass-matrix adaptation (Stan phase II; see
    # mcmc.adapt): the flagship WHVI posterior mixes prior scales
    # lambda = {3, 1e-5} (~550x stddev ratio) that an identity kinetic
    # energy handles badly.
    mass_adapt: bool = True
    # Dense (full-covariance) metric instead of diagonal, for
    # low-dimensional posteriors (see NUTSConfig.dense_mass).
    dense_mass: bool = False
    # Per-draw uniform step-size jitter (+-fraction): fixed-length HMC
    # resonates when eps * n_leapfrog lands near a full period of a
    # (whitened) coordinate (Neal 2011 section 3.2).
    jitter_eps: float = 0.3


class DualAveraging:
    """Dual-averaging step size (Hoffman & Gelman 2014, Alg. 5), one per
    chain (and rung): ``mu``, ``log_eps``, ``log_eps_bar``, ``h_bar`` of
    ``shape`` on the device. The count of steps since the last restart is
    the same for every chain, so it lives on the host, and the
    coefficients it sets are computed there in float32, as JAX computes
    them on the device."""

    GAMMA, T0, KAPPA = 0.05, 10.0, 0.75

    def __init__(self, init_step_size: float, target_accept: float, shape, device, dtype):
        def full(v):
            return torch.full(tuple(shape), float(v), dtype=dtype, device=device)

        self.target = target_accept
        self.mu = full(np.log(_F32(10.0 * init_step_size)))
        self.log_eps = full(np.log(_F32(init_step_size)))
        self.log_eps_bar = full(np.log(_F32(init_step_size)))
        self.h_bar = full(0.0)
        self.t = 0

    def update(self, accept_stat: torch.Tensor, on: bool) -> None:
        """One step fed ``accept_stat``; ``on`` (warm-up with adaptation)
        moves the step size, otherwise it is held at ``exp(log_eps_bar)``."""
        if on:
            t = _F32(self.t) + _F32(1.0)
            denom = t + _F32(self.T0)
            h_bar = float(_F32(1.0) - _F32(1.0) / denom) * self.h_bar + (
                self.target - accept_stat
            ) / float(denom)
            log_eps = self.mu - float(np.sqrt(t) / _F32(self.GAMMA)) * h_bar
            w = t ** _F32(-self.KAPPA)
            self.log_eps_bar = float(w) * log_eps + float(_F32(1.0) - w) * self.log_eps_bar
            self.log_eps, self.h_bar = log_eps, h_bar
        else:
            self.log_eps = self.log_eps_bar
        self.t += 1

    def restart(self) -> None:
        """At a mass-window end: the new metric changes the optimal step
        size, so averaging restarts anchored at ten times the current one."""
        self.mu = _LOG10 + self.log_eps
        self.log_eps_bar = self.log_eps
        self.h_bar = torch.zeros_like(self.h_bar)
        self.t = 0


def warmup_masks(n_warmup: int, n_samples: int, windows: bool):
    """Host masks ``(accumulate, window_end)`` over all ``n_warmup +
    n_samples`` steps (all False without mass windows)."""
    acc, end = adapt.warmup_schedule(n_warmup) if windows else (
        np.zeros(n_warmup, bool), np.zeros(n_warmup, bool)
    )
    pad = np.zeros(n_samples, bool)
    return np.concatenate([acc, pad]), np.concatenate([end, pad])


def mdot(m_inv: torch.Tensor, p: torch.Tensor, dense: bool) -> torch.Tensor:
    """Metric-weighted momentum, the rate of change of q: ``m_inv @ p``
    (dense ``(.., dim, dim)``, as a broadcast sum, so that a chain's
    product rounds the same in a batch of any size) or ``m_inv * p``."""
    return torch.sum(m_inv * p[..., None, :], dim=-1) if dense else m_inv * p


def kinetic(p: torch.Tensor, m_inv: torch.Tensor, dense: bool) -> torch.Tensor:
    return 0.5 * torch.sum(p * mdot(m_inv, p, dense), dim=-1)


def momentum(xi: torch.Tensor, m_inv: torch.Tensor, dense: bool) -> torch.Tensor:
    """``p ~ N(0, M)``, ``M = m_inv^-1``, from standard normal ``xi``:
    ``xi / sqrt(m_inv)``, or ``L^-T xi`` for ``m_inv = L L^T`` (the
    Cholesky without its error check, which would read the device)."""
    if not dense:
        return xi * torch.rsqrt(m_inv)
    L = torch.linalg.cholesky_ex(m_inv).L
    return torch.linalg.solve_triangular(L.mT, xi[..., None], upper=True)[..., 0]


def leapfrog_step(vg, q, p, grad, eps, m_inv, dense: bool, scale=None):
    """One leapfrog step of signed size ``eps (W,)`` from ``(q, p)`` with
    ``grad`` the log density's gradient at ``q``; ``scale (W,)`` multiplies
    the gradient (a tempering rung's beta). Returns ``(q, p, logp, grad)``
    at the end point: its gradient carries into the next step."""
    half = 0.5 * eps if scale is None else 0.5 * eps * scale
    p = p + half[..., None] * grad
    q = q + eps[..., None] * mdot(m_inv, p, dense)
    logp, grad = vg(q)
    p = p + half[..., None] * grad
    return q, p, logp, grad


def hmc_draws(generator: torch.Generator, n_chains: int, dim: int, device, dtype=torch.float32):
    """``draws(t)``: step t's random numbers for ``n_chains`` chains, from
    ``generator``: ``xi (C, dim)`` standard normal for the momentum,
    ``jitter_u (C,)`` and ``accept_u (C,)`` uniform on [0, 1)."""

    def draws(t: int) -> dict:
        del t
        return {
            "xi": torch.randn((n_chains, dim), generator=generator, device=device, dtype=dtype),
            "jitter_u": torch.rand((n_chains,), generator=generator, device=device, dtype=dtype),
            "accept_u": torch.rand((n_chains,), generator=generator, device=device, dtype=dtype),
        }

    return draws


def hmc_transition(vg, q, logp, grad, draws: dict, eps, m_inv, n_leapfrog: int,
                   jitter_eps: float, dense: bool, beta=None):
    """One HMC transition of every walker: ``(q, logp, grad, accept_prob,
    divergent)`` after it, from the walkers' ``q (W, dim)`` with its log
    density and gradient, the step's ``draws`` (:func:`hmc_draws`), step
    size ``eps (W,)`` (jittered by ``jitter_eps``) and inverse metric
    ``m_inv``. ``beta (W,)`` tempers the density (a tempering rung's
    ``beta * logp``); ``logp`` and ``grad`` stay untempered.

    Divergence (Stan's rule): the Hamiltonian error exceeds 1000 or is not
    finite. A divergent proposal is rejected and feeds ``accept_prob = 0``
    to dual averaging; without it an fp32 overflow can score a blown-up
    position as infinitely good and park the chain there (measured in the
    JAX package on a dense-metric rho=0.95 Gaussian).
    """
    p = momentum(draws["xi"], m_inv, dense)
    eps_used = eps * (1.0 + jitter_eps * (2.0 * draws["jitter_u"] - 1.0))
    q_new, p_new, logp_new, grad_new = q, p, logp, grad
    for _ in range(n_leapfrog):
        q_new, p_new, logp_new, grad_new = leapfrog_step(
            vg, q_new, p_new, grad_new, eps_used, m_inv, dense, beta
        )
    pot_old, pot_new = (-logp, -logp_new) if beta is None else (-beta * logp, -beta * logp_new)
    h_old = pot_old + kinetic(p, m_inv, dense)
    h_new = pot_new + kinetic(p_new, m_inv, dense)
    accept_prob = torch.exp(torch.clamp(-(h_new - h_old), max=0.0))
    accept_prob = torch.where(torch.isfinite(accept_prob), accept_prob, 0.0)
    divergent = ~torch.isfinite(h_new) | ((h_new - h_old) > 1000.0)
    accept_prob = torch.where(divergent, 0.0, accept_prob)
    take = (draws["accept_u"] < accept_prob) & ~divergent
    q = torch.where(take[:, None], q_new, q)
    logp = torch.where(take, logp_new, logp)
    grad = torch.where(take[:, None], grad_new, grad)
    return q, logp, grad, accept_prob, divergent


def init_metric(n: tuple, dim: int, dense: bool, device, dtype):
    """Unit inverse metric and a fresh accumulator over leading axes ``n``."""
    if dense:
        m_inv = torch.eye(dim, dtype=dtype, device=device).expand(*n, dim, dim).clone()
        return m_inv, adapt.welford_cov_init(dim, dtype, device, n)
    return torch.ones(n + (dim,), dtype=dtype, device=device), adapt.welford_init(dim, dtype, device, n)


def _hmc_chains(log_prob_fn, inits, generator, config: HMCConfig, draws=None):
    """HMC over a leading chain axis (see :func:`run_chains`)."""
    cfg = config
    dense = cfg.dense_mass
    update = adapt.welford_cov_update if dense else adapt.welford_update
    window = adapt.window_update_dense if dense else adapt.window_update
    q, unflat = ravel(inits)
    C, dim = q.shape
    if draws is None:
        draws = hmc_draws(generator, C, dim, q.device, q.dtype)
    vg = value_and_grad(log_prob_fn, unflat)
    acc_mask, end_mask = warmup_masks(cfg.n_warmup, cfg.n_samples, cfg.adapt and cfg.mass_adapt)
    da = DualAveraging(cfg.init_step_size, cfg.target_accept, (C,), q.device, q.dtype)
    m_inv, wf = init_metric((C,), dim, dense, q.device, q.dtype)
    logp, grad = vg(q)
    kept, accepts, divs = [], [], []
    for i in range(cfg.n_warmup + cfg.n_samples):
        q, logp, grad, accept_prob, divergent = hmc_transition(
            vg, q, logp, grad, draws(i), torch.exp(da.log_eps), m_inv, cfg.n_leapfrog,
            cfg.jitter_eps, dense,
        )
        da.update(accept_prob, i < cfg.n_warmup and cfg.adapt)
        wf = update(wf, q, bool(acc_mask[i]))
        wf, m_inv = window(wf, m_inv, bool(end_mask[i]))
        if end_mask[i]:
            da.restart()
        accepts.append(accept_prob)
        divs.append(divergent)
        if i >= cfg.n_warmup:
            kept.append(q)
    accepts = torch.stack(accepts, dim=1)
    divs = torch.stack(divs, dim=1)[:, cfg.n_warmup :]
    stats = {
        "accept_rate": torch.mean(accepts[:, cfg.n_warmup :], dim=1),
        "warmup_accept_rate": torch.mean(accepts[:, : cfg.n_warmup], dim=1),
        "step_size": torch.exp(da.log_eps_bar),
        "divergences": torch.sum(divs, dim=1, dtype=torch.int32),
        "inv_mass": m_inv,
    }
    return unflat(torch.stack(kept, dim=1)), stats


def _one_chain(sample_fn, log_prob_fn, init_position, generator, config, draws):
    """A chain sampler run on one chain, the chain axis dropped."""
    inits = tree_map(lambda leaf: leaf[None], init_position)
    samples, stats = sample_fn(log_prob_fn, inits, generator, config, draws)
    return tree_map(lambda a: a[0], samples), {k: v[0] for k, v in stats.items()}


def hmc_sample(
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config: HMCConfig = HMCConfig(),
    draws=None,
):
    """Run one HMC chain; returns ``(samples, stats)``.

    ``log_prob_fn`` takes a position with a leading walker axis and
    returns ``(W,)`` (:mod:`whvi_tpu_torch.mcmc.chains`). ``samples``:
    the tree of ``init_position`` with a leading ``n_samples`` axis
    (post-warm-up draws). ``stats``: ``accept_rate``,
    ``warmup_accept_rate``, ``step_size`` (final), ``divergences``
    (post-warm-up) and ``inv_mass`` (the adapted inverse metric, a
    posterior-variance estimate), as tensors; nothing is read back to
    the host. Random numbers come from ``generator`` (on the position's
    device), or from ``draws(t)`` (:func:`hmc_draws`' dict, one chain).
    """
    return _one_chain(_hmc_chains, log_prob_fn, init_position, generator, config, draws)


def hmc_sample_chains(
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config: HMCConfig = HMCConfig(),
    n_chains: int = 4,
    jitter: float = 0.1,
    inits=None,
    draws=None,
    mesh=None,
):
    """``n_chains`` independent HMC chains in one batched run. Chain c
    starts at ``init_position + jitter * N(0, I)`` unless ``inits`` (a
    tree with a leading ``n_chains`` axis) gives the starts. Every output
    leaf has a leading ``(n_chains,)`` axis, the shape
    :mod:`whvi_tpu_torch.mcmc.diagnostics` reads. ``mesh``: the chains
    split over its ranks (:func:`~whvi_tpu_torch.mcmc.chains.run_chains`)."""
    return run_chains(
        _hmc_chains, log_prob_fn, init_position, generator, config, n_chains, jitter,
        inits, draws, mesh, hmc_draws,
    )


def forward_given_g(net, X, position: dict):
    """The deterministic forward of ``net`` at the walkers' ``position
    {layer_index: g (W, *g_shape)}``: ``(W, B, n_out)`` for ``X (B,
    n_in)``, every other parameter as it is. Each walker's ``g`` enters its
    layer as ``(W, 1, *g_shape)``, the walker axis ahead of the batch axis.
    A sampled ``g`` serves every row, so no layer draws per-example noise
    here (``per_example_noise`` False, whatever the layer trained with);
    in the bf16 mode the square products then round as JAX's ``"pallas"``
    backend rounds a 1-D ``g``."""
    h = X
    for i, layer in enumerate(net.layers):
        h = layer.apply_given_g(h, position[i].unsqueeze(1)) if i in position else layer(h)
    return h


def _whvi_g_log_posterior_impl(net, data: dict, position: dict):
    """Body of the g log posterior: ``position {layer_index: g (W,
    *g_shape)}`` -> ``(W,)``. The likelihood gets ``(W, 1, B, n_out)``:
    one MC sample a walker, so no walker is averaged with another."""
    X, y = data["X"], data["y"]
    h = forward_given_g(net, X, position)
    loglik = -net.likelihood.mnll(y, h.unsqueeze(1), X.shape[0])
    prior = 0.0
    for i, g in position.items():
        lam = net.layers[i].matrix.lambda_
        terms = -0.5 * torch.square(g) / lam - 0.5 * math.log(2.0 * math.pi * lam)
        prior = prior + torch.sum(terms.reshape(g.shape[0], -1), dim=-1)
    return loglik + prior


def make_whvi_g_log_posterior(net, X, y):
    """Unnormalized log posterior over the per-layer ``g`` vectors of
    ``net`` (a trained :class:`~whvi_tpu_torch.models.WHVINetwork`; the
    JAX function's separate ``params`` are the net's own parameters here).

    ``position`` is ``{layer_index: g}`` for every ``WHVILinear`` layer,
    each ``g (W, *g_mu.shape)`` with a leading walker axis; the result is
    ``(W,)``. Every other parameter stays frozen: the net is copied, its
    parameters detached. The likelihood term is the log-likelihood summed
    over ``(X, y)``; the prior the same ``N(0, lambda_l I)`` the KL is
    taken against, so this is exactly the target of the variational
    approximation.

    Returns ``(log_posterior, init)``: a :class:`StructuredLogProb` and
    ``init = {layer_index: g_mu.clone()}``. ``X`` and ``y`` go to the
    net's device. A ``Parallel`` layer is refused: the JAX function runs
    it with noise from a fixed key, which the port cannot reproduce.
    """
    from whvi_tpu_torch.models.layers import Parallel, WHVILinear

    if any(isinstance(layer, Parallel) for layer in net.layers):
        raise ValueError("the g posterior takes WHVILinear layers, not Parallel branches")
    frozen = copy.deepcopy(net).requires_grad_(False)
    param = next(frozen.parameters())
    X = torch.as_tensor(X, dtype=param.dtype).to(param.device)
    y = torch.as_tensor(y).to(device=param.device, dtype=param.dtype)
    y2 = y if y.dim() > 1 else y[:, None]
    bayes = [i for i, layer in enumerate(frozen.layers) if isinstance(layer, WHVILinear)]
    log_posterior = StructuredLogProb(
        _whvi_g_log_posterior_impl, data={"X": X, "y": y2}, static=frozen
    )
    init = {i: frozen.layers[i].matrix.g_mu.detach().clone() for i in bayes}
    return log_posterior, init


def moments(samples):
    """Per-leaf posterior mean and stddev of stacked samples (axis 0)."""
    mean = tree_map(lambda a: torch.mean(a, dim=0), samples)
    std = tree_map(lambda a: torch.std(a, dim=0, correction=0), samples)
    return mean, std
