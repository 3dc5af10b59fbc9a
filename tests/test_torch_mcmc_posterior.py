"""The port's WHVI g log posterior against JAX's
``make_whvi_g_log_posterior`` (``whvi_tpu/mcmc/hmc.py:298``) on the same
converted parameters: value per walker and ``jax.grad`` per walker, fp32
on the CPU; and the bf16 g path against JAX's ``"pallas"`` backend
(Pallas in interpret mode) for nets trained with per-example noise, at
batch 1 and 5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whvi_tpu.models as jm
from whvi_tpu.mcmc import make_whvi_g_log_posterior as jax_log_posterior
from whvi_tpu.ops import whvi_op as jax_whvi_op
import whvi_tpu_torch.models as pm
from whvi_tpu_torch.convert import load_jax_params
from whvi_tpu_torch.mcmc import make_whvi_g_log_posterior
from whvi_tpu_torch.mcmc.chains import ravel, value_and_grad
from whvi_tpu_torch.ops import get_whvi_mul_precision, set_whvi_mul_precision
from whvi_tpu_torch.ops.fwht_cuda import bf16_tol

torch.set_num_threads(1)

F32_TOL = 1e-5  # value and gradient, max |port - JAX| / max |JAX|


def _nets(kind, per_example_noise=False):
    """The same architecture in both packages: ``(jax_net, port_net, n_in,
    classes or 0)``."""
    def lin(pkg, a, b, lam, **kw):
        return pkg.WHVILinear(a, b, lambda_=lam, per_example_noise=per_example_noise, **kw)

    if kind == "4-8-1":  # tests/test_hmc.py:71: stacked 4->8, a transposed column head
        layers = lambda pkg: [lin(pkg, 4, 8, 1.0), pkg.relu, lin(pkg, 8, 1, 1.0)]
        make = lambda pkg, ls: pkg.WHVIRegression(ls, sigma0=0.3)
        return make(jm, layers(jm)), make(pm, layers(pm)), 4, 0
    if kind.startswith("square-column"):  # a square layer, a column head, biases
        # the flagship's prior mix, or unit priors, under which the
        # likelihood is not lost beside the 1e-5 prior's term in fp32
        lam = 1e-5 if kind == "square-column" else 1.0
        layers = lambda pkg: [lin(pkg, 8, 8, 3.0, bias=True, s_init="auto"), pkg.relu,
                              lin(pkg, 8, 1, lam, bias=True, s_init="auto")]
        make = lambda pkg, ls: pkg.WHVIRegression(ls, sigma0=0.3)
        return make(jm, layers(jm)), make(pm, layers(pm)), 8, 0
    if kind == "classifier":  # config 4's shape, narrow: stacked, square, stacked; softmax
        layers = lambda pkg: [lin(pkg, 12, 16, 3.0, s_init="auto"), pkg.relu,
                              lin(pkg, 16, 16, 3.0, s_init="auto"), pkg.relu,
                              lin(pkg, 16, 5, 1.0, s_init="auto")]
        return (jm.WHVIClassification(layers(jm)), pm.WHVIClassification(layers(pm)), 12, 5)
    raise ValueError(kind)


def _setup(kind, B, seed, per_example_noise=False):
    jnet, pnet, n_in, classes = _nets(kind, per_example_noise)
    params = jnet.init(jax.random.PRNGKey(seed))
    # trained-looking posteriors: g_mu away from 0, random biases
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.3 * rng.randn(*np.shape(a))).astype(np.float32),
                          params)
    load_jax_params(pnet, params)
    X = rng.randn(B, n_in).astype(np.float32)
    if classes:
        y = rng.randint(0, classes, size=B).astype(np.int32)
    else:
        y = (np.sin(X.sum(1, keepdims=True)) + 0.1 * rng.randn(B, 1)).astype(np.float32)
    return jnet, pnet, params, X, y


def _walkers(init, W, seed):
    """``W`` positions around ``init`` per layer, numpy."""
    rng = np.random.RandomState(seed + 100)
    return {i: (np.asarray(g)[None] + 0.5 * rng.randn(W, *np.shape(g))).astype(np.float32)
            for i, g in init.items()}


def _jax_value_and_grad(jlp, pos):
    vals = jax.vmap(jlp)({i: jnp.asarray(g) for i, g in pos.items()})
    grads = jax.vmap(jax.grad(jlp))({i: jnp.asarray(g) for i, g in pos.items()})
    return np.asarray(vals), {i: np.asarray(g) for i, g in grads.items()}


def _port_value_and_grad(plp, pos):
    tree = {i: torch.from_numpy(g) for i, g in pos.items()}
    qv, unflat = ravel(tree)
    vals, grad = value_and_grad(plp, unflat)(qv)
    return vals.numpy(), {i: g.numpy() for i, g in unflat(grad).items()}


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind", ["4-8-1", "square-column", "classifier"])
def test_log_posterior_and_gradient_match_jax(kind):
    jnet, pnet, params, X, y = _setup(kind, B=24, seed=3)
    jlp, jinit = jax_log_posterior(jnet, params, X, y)
    plp, pinit = make_whvi_g_log_posterior(pnet, X, y)
    assert sorted(pinit) == sorted(jinit)
    for i in jinit:
        np.testing.assert_array_equal(pinit[i].numpy(), np.asarray(jinit[i]))
    pos = _walkers(jinit, W=3, seed=3)
    want_v, want_g = _jax_value_and_grad(jlp, pos)
    got_v, got_g = _port_value_and_grad(plp, pos)
    assert got_v.shape == (3,)
    assert _rel(got_v, want_v) <= F32_TOL
    for i in want_g:
        assert got_g[i].shape == want_g[i].shape
        assert _rel(got_g[i], want_g[i]) <= F32_TOL, i
    # walkers never mix: each walker's value and gradient is its own
    for w in range(3):
        one = {i: g[w : w + 1] for i, g in pos.items()}
        v1, g1 = _port_value_and_grad(plp, one)
        np.testing.assert_allclose(v1[0], got_v[w], rtol=1e-6)
        for i in g1:
            np.testing.assert_allclose(g1[i][0], got_g[i][w], rtol=1e-5, atol=1e-6)


def test_log_posterior_freezes_the_net():
    """The posterior holds a frozen copy: training the net on afterwards
    leaves it, and none of its parameters asks for a gradient."""
    _, pnet, _, X, y = _setup("4-8-1", B=8, seed=4)
    plp, init = make_whvi_g_log_posterior(pnet, X, y)
    pos = {i: g[None] for i, g in init.items()}
    before = plp(pos)
    with torch.no_grad():
        for p in pnet.parameters():
            p.add_(1.0)
    assert torch.equal(plp(pos), before)
    assert not any(p.requires_grad for p in plp.static.parameters())


@pytest.fixture
def bf16_backends():
    """The JAX ``"pallas"`` backend and the port's bf16 mode, restored after."""
    jax_backend, port_precision = jax_whvi_op._BACKEND, get_whvi_mul_precision()
    jax_whvi_op.set_whvi_mul_backend("pallas")
    set_whvi_mul_precision("bf16")
    try:
        yield
    finally:
        jax_whvi_op.set_whvi_mul_backend(jax_backend)
        set_whvi_mul_precision(port_precision)


@pytest.mark.parametrize("B", [1, 5])
def test_bf16_g_path_of_a_per_example_noise_net_matches_jax_pallas(B, bf16_backends):
    """A net trained with per-example noise: a sampled g serves every row,
    so its square products are shared-u products, which JAX's "pallas"
    backend sends to its bf16 kernel (a 1-D g under vmap). The port's
    ``g (W, 1, D)`` must round the same at batch 1, where a per-example u
    has that shape too, and at batch 5. Tolerance ``bf16_tol(D)``: one
    rounding flip between the two orders of summation."""
    jnet, pnet, params, X, y = _setup("square-column-unit", B=B, seed=5, per_example_noise=True)
    assert pnet.layers[0].per_example_noise and jnet.layers[0].per_example_noise
    jlp, jinit = jax_log_posterior(jnet, params, X, y)
    plp, _ = make_whvi_g_log_posterior(pnet, X, y)
    pos = _walkers(jinit, W=2, seed=5)
    want_v, want_g = _jax_value_and_grad(jlp, pos)
    got_v, got_g = _port_value_and_grad(plp, pos)
    tol = bf16_tol(8)
    assert _rel(got_v, want_v) <= tol
    for i in want_g:
        assert _rel(got_g[i], want_g[i]) <= tol, i
    # and it is the bf16 product, not fp32: fp32 misses JAX by more
    set_whvi_mul_precision("fp32")
    f32_v, f32_g = _port_value_and_grad(plp, pos)
    assert _rel(f32_g[0], want_g[0]) > 10 * max(_rel(got_g[0], want_g[0]), 1e-7)
