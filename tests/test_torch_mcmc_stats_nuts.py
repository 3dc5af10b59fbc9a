"""The port's NUTS by its moments on analytic targets: the statistical
tests of the JAX package's ``tests/test_hmc.py``, ``test_mass_adapt.py``
and ``test_diagnostics.py`` carried over with their tolerances, at draw
counts (and a tree depth) cut to fit the CPU; each docstring gives the
original's. Every NUTS draw computes its whole tree, so a draw at depth d
costs 2^d - 1 gradient evaluations whatever the target."""

import numpy as np
import torch

from whvi_tpu_torch.mcmc import (
    NUTSConfig,
    ess,
    make_whvi_g_log_posterior,
    moments,
    nuts_sample,
    nuts_sample_chains,
    split_rhat,
)
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu

torch.set_num_threads(1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_nuts_recovers_gaussian_moments():
    """JAX: 1500 + 500 draws at depth 5."""
    mean, sd = torch.tensor([1.0, -2.0, 0.5]), torch.tensor([0.5, 2.0, 1.0])
    cfg = NUTSConfig(n_samples=500, n_warmup=250, max_tree_depth=5)
    samples, stats = nuts_sample(
        lambda q: torch.sum(-0.5 * torch.square((q["x"] - mean) / sd), -1),
        {"x": torch.zeros(3)}, gen(7), cfg,
    )
    m, s = moments(samples)
    assert float(stats["accept_stat"]) > 0.4
    np.testing.assert_allclose(m["x"].numpy(), mean.numpy(), atol=0.2)
    np.testing.assert_allclose(s["x"].numpy(), sd.numpy(), rtol=0.3)


def test_nuts_on_whvi_posterior():
    rng = np.random.RandomState(2)
    X = rng.randn(30, 4).astype(np.float32)
    y = (X.sum(axis=1, keepdims=True) + 0.1 * rng.randn(30, 1)).astype(np.float32)
    torch.manual_seed(9)
    net = WHVIRegression([WHVILinear(4, 8, lambda_=1.0), relu, WHVILinear(8, 1, lambda_=1.0)])
    logp, init = make_whvi_g_log_posterior(net, X, y)
    samples, stats = nuts_sample(logp, init, gen(10), NUTSConfig(n_samples=100, n_warmup=100, max_tree_depth=4))
    m, _ = moments(samples)
    for i in init:
        assert torch.isfinite(m[i]).all()
    assert samples[0].shape == (100,) + tuple(init[0].shape)


def test_multichain_nuts_gaussian_converges():
    """JAX: 600 + 300 draws, 4 chains, depth 5."""
    mean, sd = torch.tensor([0.5, -1.0]), torch.tensor([1.0, 0.3])
    cfg = NUTSConfig(n_samples=400, n_warmup=300, max_tree_depth=5)
    samples, stats = nuts_sample_chains(
        lambda q: torch.sum(-0.5 * torch.square((q["x"] - mean) / sd), -1),
        {"x": torch.zeros(2)}, gen(1), cfg, n_chains=4,
    )
    assert samples["x"].shape == (4, 400, 2)
    assert int(stats["divergences"].sum()) == 0
    assert float(split_rhat(samples["x"]).max()) < 1.05
    assert float(ess(samples["x"]).min()) > 100.0
    np.testing.assert_allclose(samples["x"].mean((0, 1)).numpy(), mean.numpy(), atol=0.15)


def test_nuts_adapted_mass_recovers_mixed_scales():
    """JAX: 1200 + 600 draws at depth 5."""
    sd = torch.tensor(np.logspace(-2, 2, 8), dtype=torch.float32)
    cfg = NUTSConfig(n_samples=500, n_warmup=400, max_tree_depth=5)
    samples, stats = nuts_sample(lambda q: torch.sum(-0.5 * torch.square(q["x"] / sd), -1),
                                 {"x": torch.zeros(8)}, gen(1), cfg)
    np.testing.assert_allclose(samples["x"].std(0, correction=0).numpy(), sd.numpy(), rtol=0.35)
    assert int(stats["divergences"]) == 0
    assert float(ess(samples["x"][None]).min()) > 100


def test_dense_mass_momentum_marginals():
    """Dense-metric momenta keep the energies finite on an isotropic target."""
    s, st = nuts_sample(lambda q: -0.5 * torch.sum(q["x"] ** 2, -1), {"x": torch.zeros(3)}, gen(1),
                        NUTSConfig(n_samples=100, n_warmup=100, max_tree_depth=4, dense_mass=True))
    assert torch.isfinite(s["x"]).all()
    assert int(st["divergences"]) == 0
