"""No-U-Turn Sampler, statically unrolled, multinomial (PyTorch).

Counterpart of :mod:`whvi_tpu.mcmc.nuts`: NUTS (Hoffman & Gelman 2014)
with Stan's multinomial state selection, its doubling tree unrolled to
``max_tree_depth``: every draw computes ``2^max_tree_depth - 1`` leapfrog
steps, and U-turn and divergence termination are masks, not early exits.
A doubling after the stop is computed and discarded, as in JAX, so no
decision is read back to the host: the chains of a batch (a leading axis,
:mod:`whvi_tpu_torch.mcmc.chains`) never wait for each other.

Semantics per draw:

- repeatedly double the trajectory in a random direction;
- a doubling whose subtree holds an internal U-turn or divergence is
  discarded (its proposal cannot be selected), and expansion stops;
- otherwise the new half's proposal replaces the current one with
  probability ``w_new / (w_old + w_new)``, and expansion stops when the
  whole trajectory U-turns.

Step size is dual-averaged during warm-up as in :mod:`.hmc`, and the
mass matrix adapted in Stan's windows (:mod:`.adapt`): momenta come from
the estimated metric and the U-turn criterion uses metric-weighted
momenta. Each leapfrog step evaluates the gradient once: the tree's edges
carry their gradients, and the proposal its log density and gradient.

Random numbers per draw (:func:`nuts_draws`): the momentum ``xi``, one
direction per doubling, one uniform per internal tree node and one merge
uniform per doubling; :func:`nuts_draw` takes them as tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from whvi_tpu_torch.mcmc import adapt
from whvi_tpu_torch.mcmc.chains import ravel, run_chains, value_and_grad
from whvi_tpu_torch.mcmc.hmc import (
    DualAveraging,
    _one_chain,
    init_metric,
    kinetic,
    leapfrog_step,
    mdot,
    momentum,
    warmup_masks,
)

__all__ = [
    "NUTSConfig", "gradient_evaluations", "nuts_draw", "nuts_draws", "nuts_sample",
    "nuts_sample_chains",
]


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    n_samples: int = 1000
    n_warmup: int = 500
    max_tree_depth: int = 6
    init_step_size: float = 1e-2
    target_accept: float = 0.8
    adapt: bool = True
    # Windowed diagonal mass-matrix adaptation (Stan phase II; see
    # mcmc.adapt), on by default for the same reason as HMCConfig's.
    mass_adapt: bool = True
    # Dense (full-covariance) metric instead of diagonal: captures
    # cross-coordinate posterior geometry at O(dim^2) memory and an
    # O(dim^3) Cholesky per draw, so it is meant for low-dimensional
    # posteriors (the 16-dim mixed-lambda WHVI g-posterior).
    dense_mass: bool = False


def gradient_evaluations(config: NUTSConfig) -> int:
    """Gradient evaluations of a NUTS run, each over every walker: one at
    the start, then the whole unrolled tree, ``2^depth - 1`` leapfrog
    steps, every draw."""
    return 1 + (config.n_warmup + config.n_samples) * (2**config.max_tree_depth - 1)


def nuts_draws(generator: torch.Generator, n_chains: int, dim: int, depth: int, device,
               dtype=torch.float32):
    """``draws(t)``: draw t's random numbers for ``n_chains`` chains, from
    ``generator``: ``xi (C, dim)`` standard normal; ``dirs (C, depth)``,
    +1 or -1 with probability 1/2; ``node_u``, for doubling j a ``(C, 2^j
    - 1)`` uniform a node of its subtree, in post-order (a subtree's left
    subtree's nodes, its right's, its own); ``merge_u (C, depth)``."""

    def draws(t: int) -> dict:
        del t
        C = n_chains
        xi = torch.randn((C, dim), generator=generator, device=device, dtype=dtype)
        dirs = torch.rand((C, depth), generator=generator, device=device, dtype=dtype)
        nodes = torch.rand((C, 2**depth - 1 - depth), generator=generator, device=device, dtype=dtype)
        merge = torch.rand((C, depth), generator=generator, device=device, dtype=dtype)
        sizes = [2**j - 1 for j in range(depth)]
        return {
            "xi": xi,
            "dirs": torch.where(dirs < 0.5, 1.0, -1.0),
            "node_u": list(torch.split(nodes, sizes, dim=1)),
            "merge_u": merge,
        }

    return draws


def _uturn(q_minus, q_plus, p_minus, p_plus, m_inv, dense):
    # rate of change of q is m_inv @ p, so the U-turn projection uses the
    # metric-weighted momenta (Stan's criterion)
    dq = q_plus - q_minus
    return (torch.sum(dq * mdot(m_inv, p_minus, dense), -1) < 0.0) | (
        torch.sum(dq * mdot(m_inv, p_plus, dense), -1) < 0.0
    )


def _pick(mask, a, b):
    """``a`` where ``mask (C,)``, else ``b``, leaf by leaf over tuples."""
    if isinstance(a, tuple):
        return tuple(_pick(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _build_tree(vg, depth, edge, direction, eps, h0, node_u, m_inv, dense):
    """Statically unrolled subtree of ``2^depth`` leapfrog steps grown from
    ``edge = (q, p, grad)`` in ``direction (C,)`` (+1 or -1).

    Returns ``(near, far, prop, log_w, turned, diverged)``: ``near`` the
    ``(q, p)`` of its first step, ``far`` the ``(q, p, grad)`` of its last
    (the edge the next doubling grows from), ``prop`` the proposal's ``(q,
    logp, grad)``, and its log weight relative to the start energy
    ``h0``."""
    if depth == 0:
        q, p, grad = edge
        q1, p1, logp1, g1 = leapfrog_step(vg, q, p, grad, direction * eps, m_inv, dense)
        h1 = -logp1 + kinetic(p1, m_inv, dense)
        log_w = h0 - h1  # multinomial weight relative to the start energy
        diverged = ~torch.isfinite(log_w) | (log_w < -1000.0)
        log_w = torch.where(diverged, -torch.inf, log_w)
        return (q1, p1), (q1, p1, g1), (q1, logp1, g1), log_w, diverged, diverged
    half = 2 ** (depth - 1) - 1
    near_l, far_l, prop_l, lw_l, turn_l, div_l = _build_tree(
        vg, depth - 1, edge, direction, eps, h0, node_u[:, :half], m_inv, dense
    )
    # grow from the far edge of the left subtree
    _, far_r, prop_r, lw_r, turn_r, div_r = _build_tree(
        vg, depth - 1, far_l, direction, eps, h0, node_u[:, half : 2 * half], m_inv, dense
    )
    total = torch.logaddexp(lw_l, lw_r)
    take_right = (torch.log(node_u[:, -1]) < lw_r - total) & ~turn_r
    prop = _pick(take_right, prop_r, prop_l)
    # U-turn across the combined subtree (oriented by the direction)
    fwd = direction > 0
    (qm, pm), (qp, pp) = near_l, far_r[:2]
    turned_here = _uturn(
        _pick(fwd, qm, qp), _pick(fwd, qp, qm), _pick(fwd, pm, pp), _pick(fwd, pp, pm),
        m_inv, dense,
    )
    turned = turn_l | turn_r | turned_here
    log_w = torch.where(turn_r, lw_l, total)
    return near_l, far_r, prop, log_w, turned, div_l | div_r


def nuts_draw(vg, state, draws: dict, eps, m_inv, depth: int, dense: bool):
    """One NUTS draw of every chain from ``state = (q, logp, grad)`` (``q
    (C, dim)``): returns ``((q, logp, grad) of the selected point,
    accept_stat (C,), divergent (C,))``; ``draws`` as :func:`nuts_draws`
    makes them."""
    q, logp, grad = state
    p0 = momentum(draws["xi"], m_inv, dense)
    h0 = -logp + kinetic(p0, m_inv, dense)
    minus = plus = (q, p0, grad)
    prop = state
    log_w = torch.zeros_like(logp)  # weight of the initial point
    stopped = torch.zeros_like(logp, dtype=torch.bool)
    any_div = torch.zeros_like(stopped)
    sum_alpha = torch.zeros_like(logp)
    n_alpha = torch.zeros_like(logp)
    for j in range(depth):
        direction = draws["dirs"][:, j]
        fwd = direction > 0
        edge = _pick(fwd, plus, minus)
        _, far, prop_j, lw_j, turn_j, div_j = _build_tree(
            vg, j, edge, direction, eps, h0, draws["node_u"][j], m_inv, dense
        )
        any_div = any_div | (div_j & ~stopped)
        # mean acceptance statistic for dual averaging (per doubling)
        alpha_j = torch.clamp(torch.exp(lw_j - float(np.log(np.float32(2.0**j)))), max=1.0)
        sum_alpha = sum_alpha + torch.where(stopped, 0.0, alpha_j)
        n_alpha = n_alpha + torch.where(stopped, 0.0, 1.0)
        usable = ~stopped & ~turn_j
        # multinomial merge of the new half
        take = (torch.log(draws["merge_u"][:, j]) < lw_j - torch.logaddexp(log_w, lw_j)) & usable
        prop = _pick(take, prop_j, prop)
        log_w = torch.where(usable, torch.logaddexp(log_w, lw_j), log_w)
        # move an edge only if the doubling was kept
        minus = _pick(usable & ~fwd, far, minus)
        plus = _pick(usable & fwd, far, plus)
        full_turn = _uturn(minus[0], plus[0], minus[1], plus[1], m_inv, dense)
        stopped = stopped | turn_j | full_turn
    accept_stat = torch.where(n_alpha > 0, sum_alpha / n_alpha, 0.0)
    return prop, accept_stat, any_div


def _nuts_chains(log_prob_fn, inits, generator, config: NUTSConfig, draws=None):
    """NUTS over a leading chain axis (see :func:`run_chains`)."""
    cfg = config
    dense = cfg.dense_mass
    update = adapt.welford_cov_update if dense else adapt.welford_update
    window = adapt.window_update_dense if dense else adapt.window_update
    q, unflat = ravel(inits)
    C, dim = q.shape
    if draws is None:
        draws = nuts_draws(generator, C, dim, cfg.max_tree_depth, q.device, q.dtype)
    vg = value_and_grad(log_prob_fn, unflat)
    acc_mask, end_mask = warmup_masks(cfg.n_warmup, cfg.n_samples, cfg.adapt and cfg.mass_adapt)
    da = DualAveraging(cfg.init_step_size, cfg.target_accept, (C,), q.device, q.dtype)
    m_inv, wf = init_metric((C,), dim, dense, q.device, q.dtype)
    state = (q, *vg(q))
    kept, alphas, divs = [], [], []
    for i in range(cfg.n_warmup + cfg.n_samples):
        state, accept_stat, divergent = nuts_draw(
            vg, state, draws(i), torch.exp(da.log_eps), m_inv, cfg.max_tree_depth, dense
        )
        da.update(accept_stat, i < cfg.n_warmup and cfg.adapt)
        # mass-matrix window: accumulate the selected draw, update the
        # metric and restart dual averaging at window ends
        wf = update(wf, state[0], bool(acc_mask[i]))
        wf, m_inv = window(wf, m_inv, bool(end_mask[i]))
        if end_mask[i]:
            da.restart()
        if i >= cfg.n_warmup:
            kept.append(state[0])
            alphas.append(accept_stat)
            divs.append(divergent)
    stats = {
        "accept_stat": torch.mean(torch.stack(alphas, dim=1), dim=1),
        "step_size": torch.exp(da.log_eps_bar),
        "divergences": torch.sum(torch.stack(divs, dim=1), dim=1, dtype=torch.int32),
        "inv_mass": m_inv,
    }
    return unflat(torch.stack(kept, dim=1)), stats


def nuts_sample(
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config: NUTSConfig = NUTSConfig(),
    draws=None,
):
    """Run one NUTS chain; returns ``(samples, stats)`` like
    :func:`~whvi_tpu_torch.mcmc.hmc.hmc_sample` (stats: ``accept_stat``,
    ``step_size``, ``divergences``, ``inv_mass``)."""
    return _one_chain(_nuts_chains, log_prob_fn, init_position, generator, config, draws)


def nuts_sample_chains(
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config: NUTSConfig = NUTSConfig(),
    n_chains: int = 4,
    jitter: float = 0.1,
    inits=None,
    draws=None,
    mesh=None,
):
    """``n_chains`` independent NUTS chains (over-dispersed jittered starts
    unless ``inits``) in one batched run; every output leaf gains a
    leading ``(n_chains,)`` axis, ready for
    :mod:`whvi_tpu_torch.mcmc.diagnostics`. ``mesh``: the chains split
    over its ranks (:func:`~whvi_tpu_torch.mcmc.chains.run_chains`)."""

    def make_draws(gen, C, dim, device, dtype):
        return nuts_draws(gen, C, dim, config.max_tree_depth, device, dtype)

    return run_chains(
        _nuts_chains, log_prob_fn, init_position, generator, config, n_chains, jitter,
        inits, draws, mesh, make_draws,
    )
