"""Parallel tempering (replica exchange) over batched HMC rungs (PyTorch).

Counterpart of :mod:`whvi_tpu.mcmc.tempering`. K rungs sample the
geometric path

    p_k(q)  ∝  exp(beta_k * logp(q)),      1 = beta_0 > ... > beta_{K-1}

and adjacent rungs propose state swaps with the Metropolis probability
``min(1, exp((beta_i - beta_j) * (logp(q_j) - logp(q_i))))``, so hot rungs
cross barriers and feed decorrelated states down to the cold rung, whose
draws are exact posterior samples.

Shape: rungs are a second leading axis after the chains, ``q (C, K,
dim)``; one HMC update of every rung of every chain is one batched
transition (JAX's ``jax.vmap(one_hmc)``) whose log density sees the ``C *
K`` walkers flattened into one axis. Swaps follow the deterministic
even-odd scheme (Okabe et al. 2001): the round's parity, known on the
host, picks the pairing, and each pair shares one uniform.

Per-rung adaptation during warm-up: dual-averaging step size and Stan's
windowed diagonal mass, each rung its own; step size and metric stay with
the rung on a swap (they belong to the tempered density, not the walker).

Random numbers per round (:func:`pt_draws`): ``xi (C, K, dim)``,
``accept_u``, ``jitter_u`` and ``swap_u``, each ``(C, K)``; the rungs'
HMC update and the swap sweep take them as tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from whvi_tpu_torch.mcmc import adapt
from whvi_tpu_torch.mcmc.chains import ravel, run_chains, value_and_grad
from whvi_tpu_torch.mcmc.hmc import DualAveraging, _one_chain, hmc_transition, warmup_masks

__all__ = ["PTConfig", "pt_betas", "pt_draws", "pt_sample", "pt_sample_chains"]


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """One "round" = one HMC update on every rung + one alternating-parity
    adjacent-swap sweep."""

    n_samples: int = 1000  # kept rounds (rung-0 draws)
    n_warmup: int = 500  # adaptation rounds, discarded
    n_rungs: int = 8
    # hottest inverse temperature; betas are geometric from 1 down to it
    beta_min: float = 0.05
    n_leapfrog: int = 16
    init_step_size: float = 1e-2
    target_accept: float = 0.8
    adapt: bool = True
    mass_adapt: bool = True
    # per-round uniform step-size jitter (+-fraction), as HMCConfig's
    jitter_eps: float = 0.3


def pt_betas(config: PTConfig, device, dtype=torch.float32) -> torch.Tensor:
    """``(K,)`` inverse temperatures, geometric from 1 to ``beta_min``,
    made on the device."""
    return torch.logspace(
        0.0, math.log10(config.beta_min), config.n_rungs, base=10.0, dtype=dtype, device=device
    )


def pt_draws(generator: torch.Generator, n_chains: int, n_rungs: int, dim: int, device,
             dtype=torch.float32):
    """``draws(t)``: round t's random numbers from ``generator``."""

    def draws(t: int) -> dict:
        del t
        shape = (n_chains, n_rungs)
        return {
            "xi": torch.randn(shape + (dim,), generator=generator, device=device, dtype=dtype),
            "accept_u": torch.rand(shape, generator=generator, device=device, dtype=dtype),
            "jitter_u": torch.rand(shape, generator=generator, device=device, dtype=dtype),
            "swap_u": torch.rand(shape, generator=generator, device=device, dtype=dtype),
        }

    return draws


def _rung_hmc(vg, q, logp, grad, betas, draws, log_eps, m_inv, cfg: PTConfig):
    """One HMC proposal on every rung's tempered density (diagonal
    metric), the ``(C, K)`` walkers flattened into one axis: the potential
    is ``-beta * logp``, the gradient ``beta * grad``; ``logp`` and
    ``grad`` stay untempered, as the swaps need them."""
    C, K, dim = q.shape
    flat = {"xi": draws["xi"].reshape(C * K, dim), "jitter_u": draws["jitter_u"].reshape(-1),
            "accept_u": draws["accept_u"].reshape(-1)}
    out = hmc_transition(
        vg, q.reshape(-1, dim), logp.reshape(-1), grad.reshape(-1, dim), flat,
        torch.exp(log_eps).reshape(-1), m_inv.reshape(-1, dim), cfg.n_leapfrog, cfg.jitter_eps,
        False, betas.expand(C, K).reshape(-1),
    )
    return tuple(t.reshape((C, K) + t.shape[1:]) for t in out)


def _swap(state, betas, swap_u, parity: int):
    """The even-odd swap sweep: the pairing ((0,1),(2,3),...) on even
    rounds, ((1,2),(3,4),...) on odd ones; each pair swaps states with
    probability ``min(1, exp((b_i - b_j)(L_j - L_i)))``, symmetric in
    (i, j), so deciding from the left member with the pair's shared
    uniform moves both members alike. Returns the state and the
    ``(C, K-1)`` attempts and accepts recorded at each pair's left index."""
    q, logp, grad = state
    K = betas.shape[0]
    idx = torch.arange(K, device=betas.device)
    is_left = (idx % 2) == parity
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < K)
    partner_c = torch.clamp(partner, 0, K - 1)
    delta = (betas - betas[partner_c]) * (logp[:, partner_c] - logp)
    u_shared = torch.where(is_left, swap_u, swap_u[:, partner_c])
    accept = valid & (torch.log(u_shared) < delta)
    q = torch.where(accept[..., None], q[:, partner_c], q)
    grad = torch.where(accept[..., None], grad[:, partner_c], grad)
    logp = torch.where(accept, logp[:, partner_c], logp)
    attempted = (valid & is_left)[:-1].expand(q.shape[0], K - 1)
    accepted = (accept & is_left)[:, :-1]
    return (q, logp, grad), attempted, accepted


def _pt_chains(log_prob_fn, inits, generator, config: PTConfig, draws=None):
    """Parallel tempering over a leading chain axis (see :func:`run_chains`)."""
    cfg = config
    K = cfg.n_rungs
    q0, unflat = ravel(inits)
    C, dim = q0.shape
    dev, dt = q0.device, q0.dtype
    if draws is None:
        draws = pt_draws(generator, C, K, dim, dev, dt)
    vg = value_and_grad(log_prob_fn, unflat)
    betas = pt_betas(cfg, dev, dt)
    acc_mask, end_mask = warmup_masks(cfg.n_warmup, cfg.n_samples, cfg.adapt and cfg.mass_adapt)
    da = DualAveraging(cfg.init_step_size, cfg.target_accept, (C, K), dev, dt)
    m_inv = torch.ones((C, K, dim), dtype=dt, device=dev)
    wf = adapt.welford_init(dim, dt, dev, (C, K))
    logp0, grad0 = vg(q0)
    state = (
        q0[:, None].expand(C, K, dim).clone(),
        logp0[:, None].expand(C, K).clone(),
        grad0[:, None].expand(C, K, dim).clone(),
    )
    kept, accepts, divs, atts, accs = [], [], [], [], []
    for i in range(cfg.n_warmup + cfg.n_samples):
        d = draws(i)
        q, logp, grad, accept_prob, divergent = _rung_hmc(
            vg, *state, betas, d, da.log_eps, m_inv, cfg
        )
        # per-rung dual averaging and mass windows (shared schedule)
        da.update(accept_prob, i < cfg.n_warmup and cfg.adapt)
        wf = adapt.welford_update(wf, q, bool(acc_mask[i]))
        wf, m_inv = adapt.window_update(wf, m_inv, bool(end_mask[i]))
        if end_mask[i]:
            da.restart()
        state, attempted, accepted = _swap((q, logp, grad), betas, d["swap_u"], i % 2)
        accepts.append(accept_prob)
        if i >= cfg.n_warmup:
            kept.append(state[0][:, 0])
            divs.append(divergent)
            atts.append(attempted)
            accs.append(accepted)
    accepts = torch.stack(accepts, dim=1)  # (C, total, K)
    divs = torch.stack(divs, dim=1)
    att_n = torch.sum(torch.stack(atts, dim=1).to(dt), dim=1)
    acc_n = torch.sum(torch.stack(accs, dim=1).to(dt), dim=1)
    stats = {
        "accept_rate": torch.mean(accepts[:, cfg.n_warmup :], dim=1),
        "warmup_accept_rate": torch.mean(accepts[:, : cfg.n_warmup], dim=1),
        "swap_rate": acc_n / torch.clamp(att_n, min=1.0),
        "step_size": torch.exp(da.log_eps_bar),
        "divergences": torch.sum(divs[:, :, 0], dim=1, dtype=torch.int32),
        "divergences_any": torch.sum(divs, dim=(1, 2), dtype=torch.int32),
        "inv_mass": m_inv,
        "betas": betas.expand(C, K),
    }
    return unflat(torch.stack(kept, dim=1)), stats


def pt_sample(
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config: PTConfig = PTConfig(),
    draws=None,
):
    """Run one tempering ladder; returns ``(samples, stats)``.

    ``samples``: the tree of ``init_position`` with a leading
    ``n_samples`` axis, the post-warm-up draws of the cold (beta = 1) rung.
    ``stats``: ``accept_rate (K,)`` per-rung post-warm-up HMC acceptance,
    ``warmup_accept_rate (K,)``; ``swap_rate (K-1,)`` acceptance of each
    adjacent pair's swaps (a pair near 0 is a bottleneck: raise
    ``n_rungs`` or ``beta_min``); ``step_size (K,)``; ``inv_mass (K,
    dim)``; ``betas (K,)``; ``divergences`` (cold rung) and
    ``divergences_any`` (all rungs)."""
    return _one_chain(_pt_chains, log_prob_fn, init_position, generator, config, draws)


def pt_sample_chains(
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config: PTConfig = PTConfig(),
    n_chains: int = 4,
    jitter: float = 0.1,
    inits=None,
    draws=None,
    mesh=None,
):
    """``n_chains`` independent tempering ladders in one batched run (for
    split-R-hat and ESS over the cold-rung draws): chains and rungs are
    the two leading axes of every state tensor. ``mesh``: the ladders
    split over its ranks (:func:`~whvi_tpu_torch.mcmc.chains.run_chains`)."""

    def make_draws(gen, C, dim, device, dtype):
        return pt_draws(gen, C, config.n_rungs, dim, device, dtype)

    return run_chains(
        _pt_chains, log_prob_fn, init_position, generator, config, n_chains, jitter,
        inits, draws, mesh, make_draws,
    )
