"""Chains as a leading axis of every sampler state tensor (PyTorch).

Counterpart of :mod:`whvi_tpu.mcmc.chains`. The JAX package ``vmap``s a
one-chain sampler over chains inside one jit. Here the samplers are
written over a leading chain axis: a position is ``(C, dim)``, a step
size ``(C,)``, a metric ``(C, dim)`` or ``(C, dim, dim)``, and one call of
the log density evaluates every chain (every walker: chains, or chains
times tempering rungs, flattened into one axis). Chains share no state,
so ``C`` chains in one call draw what each chain alone draws from the
same random numbers.

A log density in this package takes a position whose every leaf carries
a leading walker axis ``W`` and returns ``(W,)``, one value a walker;
walkers must not interact, so the gradient of the sum is each walker's
own gradient and one ``torch.autograd.grad`` serves them all.

Positions are trees of tensors (dicts, lists, tuples; leaves
``(*lead, *shape)``) flattened into one vector a walker in the JAX
package's order: dict keys sorted, so ``{layer_index: g}`` runs by layer
(``jax.flatten_util.ravel_pytree``, :func:`ravel`).

Chains on a mesh (``mesh=``, :mod:`whvi_tpu_torch.parallel`): the chain
axis is split over every rank, ``n_chains`` a multiple of the world size.
Every rank draws the **global** random numbers (the jittered starts, and
each step's draws for all ``n_chains`` chains) and keeps its chains', so
the sharded chains draw what the unsharded ones draw; no collective runs
until the draws and statistics are gathered at the end.

What the JAX module has and this one does not: the jit-cache keyed on a
log density's structure (nothing here is traced, so
:class:`StructuredLogProb` has no ``structure_key``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = [
    "run_chains", "jittered_inits", "StructuredLogProb", "ravel", "tree_map", "value_and_grad",
]


class StructuredLogProb:
    """A log density with its array data split from its code.

    ``fn(static, data, position)`` is a module-level function; ``static``
    is auxiliary structure (e.g. the frozen network); ``data`` a tree of
    tensors. Instances are callable like any log density: ``lp(position)``.

    The JAX package keys its compiled samplers on this split; the port
    compiles nothing, so it keeps the class only so that code written
    against the JAX API reads the same.
    """

    __slots__ = ("fn", "static", "data")

    def __init__(self, fn: Callable, data: Any, static: Any = None):
        self.fn = fn
        self.static = static
        self.data = data

    def __call__(self, position):
        return self.fn(self.static, self.data, position)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    return _rebuild(tree, iter([fn(leaf) for leaf in _leaves(tree)]))


def ravel(tree, n_lead: int = 1):
    """``(vec, unflat)``: the leaves of ``tree``, each ``(*lead, *shape)``
    with ``n_lead`` leading axes, flattened and concatenated into ``vec
    (*lead, dim)`` in sorted-key order; ``unflat(v)`` takes ``v (*other,
    dim)`` with any leading axes back to the tree, leaves ``(*other,
    *shape)``."""
    leaves = _leaves(tree)
    lead = tuple(leaves[0].shape[:n_lead])
    shapes = [tuple(leaf.shape[n_lead:]) for leaf in leaves]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    vec = torch.cat([leaf.reshape(lead + (-1,)) for leaf in leaves], dim=-1)

    def unflat(v):
        out, off = [], 0
        for size, shape in zip(sizes, shapes):
            out.append(v[..., off : off + size].reshape(tuple(v.shape[:-1]) + shape))
            off += size
        return _rebuild(tree, iter(out))

    return vec, unflat


def value_and_grad(log_prob_fn: Callable, unflat: Callable):
    """``vg(qv)`` for walkers ``qv (W, dim)``: ``(logp (W,), grad (W,
    dim))`` of ``log_prob_fn(unflat(qv))``, both detached; one backward
    through the sum gives every walker its own gradient."""

    def vg(qv):
        with torch.enable_grad():
            q = qv.detach().requires_grad_(True)
            lp = log_prob_fn(unflat(q))
            (grad,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), grad

    return vg


def jittered_inits(init_position: Any, generator: torch.Generator, n_chains: int, jitter: float):
    """Over-dispersed starts: chain c gets ``init + jitter * N(0, I)``
    (what makes split-R-hat informative). Returns the tree with a leading
    ``(n_chains,)`` axis on every leaf; the noise is drawn leaf by leaf in
    sorted-key order from ``generator`` (on the leaves' device)."""
    return tree_map(
        lambda leaf: leaf + jitter * torch.randn(
            (n_chains,) + tuple(leaf.shape), generator=generator,
            device=leaf.device, dtype=leaf.dtype,
        ),
        init_position,
    )


def run_chains(
    sample_fn: Callable,
    log_prob_fn: Callable,
    init_position: Any,
    generator: torch.Generator | None,
    config,
    n_chains: int,
    jitter: float,
    inits=None,
    draws=None,
    mesh=None,
    make_draws: Callable | None = None,
):
    """Shared driver behind ``hmc_sample_chains``, ``nuts_sample_chains``
    and ``pt_sample_chains``.

    ``sample_fn(log_prob_fn, inits, generator, config, draws)`` is a
    sampler over a leading chain axis (the port's counterpart of
    ``jax.vmap`` of a one-chain sampler): ``inits`` a tree whose leaves
    are ``(C, *shape)``; it returns ``(samples, stats)``, every leaf with
    the leading ``(C,)`` axis. ``inits``: optional explicit per-chain
    starts, e.g. draws from a trained q for mode-local validation of a
    multimodal BNN posterior; otherwise :func:`jittered_inits` from
    ``generator``. ``draws``: the sampler's random numbers given instead
    of drawn (see each sampler).

    ``mesh``: a mesh whose every axis splits the chain axis (the JAX
    ``P(mesh.axis_names)``); ``make_draws(generator, n_chains, dim,
    device, dtype)`` is the sampler's maker of the whole run's draws,
    which every rank calls and slices. Each rank runs its chains and the
    results are gathered: every rank returns every chain.
    """
    if mesh is not None and n_chains % mesh.size:
        raise ValueError(
            f"n_chains={n_chains} must be a multiple of the mesh device count "
            f"{mesh.size} to shard the chain axis"
        )
    if inits is None:
        inits = jittered_inits(init_position, generator, n_chains, jitter)
    if mesh is None:
        return sample_fn(log_prob_fn, inits, generator, config, draws)
    mine = mesh.part(n_chains, mesh.axis_names)
    if draws is None:
        q, _ = ravel(inits)
        draws = make_draws(generator, n_chains, q.shape[1], q.device, q.dtype)
    samples, stats = sample_fn(
        log_prob_fn, tree_map(lambda a: a[mine], inits), None, config,
        lambda t: tree_map(lambda a: a[mine], draws(t)),
    )
    whole = {0: mesh.axis_names}
    return (
        tree_map(lambda a: mesh.gather(a, whole), samples),
        {k: mesh.gather(v, whole) for k, v in stats.items()},
    )
