"""The port's HMC sampler by its moments on analytic targets: the
statistical tests of the JAX package's ``tests/test_hmc.py``,
``test_mass_adapt.py`` and ``test_diagnostics.py`` carried over with their
tolerances, at draw counts cut to fit the CPU (each docstring or comment
gives the original's). Targets take a leading walker axis, as every log
density of the port does. Tempering: ``test_torch_mcmc_stats_pt.py``."""

import math

import numpy as np
import pytest
import torch

from whvi_tpu_torch.mcmc import (
    HMCConfig,
    ess,
    hmc_sample,
    hmc_sample_chains,
    make_whvi_g_log_posterior,
    moments,
)
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu

torch.set_num_threads(1)

MEAN = torch.tensor([1.0, -2.0, 0.5])
SD = torch.tensor([0.5, 2.0, 1.0])


def gauss(q):
    return torch.sum(-0.5 * torch.square((q["x"] - MEAN) / SD), -1)


def quad(prec):
    def logp(q):
        x = q["x"]
        return -0.5 * torch.sum(torch.sum(x[..., None, :] * prec, -1) * x, -1)
    return logp


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_hmc_recovers_gaussian_moments():
    cfg = HMCConfig(n_samples=1500, n_warmup=500, n_leapfrog=16)  # JAX: 2000 + 500
    samples, stats = hmc_sample(gauss, {"x": torch.zeros(3)}, gen(0), cfg)
    m, s = moments(samples)
    assert float(stats["accept_rate"]) > 0.5
    np.testing.assert_allclose(m["x"].numpy(), MEAN.numpy(), atol=0.15)
    np.testing.assert_allclose(s["x"].numpy(), SD.numpy(), rtol=0.25)


@pytest.mark.parametrize("dense", [False, True])
def test_hmc_correlated_gaussian(dense):
    """JAX: 3000 + 500 draws at rho 0.8 (diagonal, here 1500 + 500), 600 +
    600 at rho 0.95 (dense, with ESS > 100)."""
    rho = 0.95 if dense else 0.8
    cov = torch.tensor([[1.0, rho], [rho, 1.0]])
    cfg = (HMCConfig(n_samples=600, n_warmup=600, n_leapfrog=16, dense_mass=True) if dense
           else HMCConfig(n_samples=1500, n_warmup=500, n_leapfrog=24))
    samples, _ = hmc_sample(quad(torch.linalg.inv(cov)), {"x": torch.zeros(2)}, gen(1), cfg)
    xs = samples["x"].numpy()
    np.testing.assert_allclose(np.cov(xs.T), cov.numpy(), atol=0.3 if dense else 0.2)
    if dense:
        assert float(torch.min(ess(samples["x"][None]))) > 100


def test_hmc_step_size_adaptation():
    def logp(q):
        return torch.sum(-0.5 * torch.square(q["x"]) / 0.01, -1)  # tight target

    # mass_adapt off: this isolates the dual-averaging mechanism
    cfg = HMCConfig(n_samples=300, n_warmup=500, n_leapfrog=8, init_step_size=0.5, mass_adapt=False)
    _, stats = hmc_sample(logp, {"x": torch.zeros(4)}, gen(2), cfg)
    assert 0.5 < float(stats["accept_rate"]) <= 1.0
    assert float(stats["step_size"]) < 0.5


def test_whvi_g_log_posterior_runs_and_samples():
    rng = np.random.RandomState(0)
    X = rng.randn(40, 4).astype(np.float32)
    y = (X.sum(axis=1, keepdims=True) + 0.1 * rng.randn(40, 1)).astype(np.float32)
    torch.manual_seed(3)
    net = WHVIRegression([WHVILinear(4, 8, lambda_=1.0), relu, WHVILinear(8, 1, lambda_=1.0)],
                         eval_samples=4)
    logp, init = make_whvi_g_log_posterior(net, X, y)
    assert set(init) == {0, 2}  # layers 0 and 2 are Bayesian
    assert math.isfinite(float(logp({i: g[None] for i, g in init.items()})[0]))
    cfg = HMCConfig(n_samples=100, n_warmup=100, n_leapfrog=8)
    samples, stats = hmc_sample(logp, init, gen(4), cfg)
    assert float(stats["accept_rate"]) > 0.2
    m, s = moments(samples)
    for i in (0, 2):
        assert torch.isfinite(m[i]).all() and (s[i] >= 0).all()


def test_vi_vs_hmc_moments_linear_gaussian():
    """A square WHVI layer is linear in g: the g-posterior is an exact
    Gaussian, and HMC must find its mean and marginal sds. JAX: 3000 +
    500 draws, here 1500 + 500."""
    rng = np.random.RandomState(1)
    D = 4
    s1, s2 = rng.randn(D), rng.randn(D)
    H = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], np.float64) / 2
    g_true, X = rng.randn(D), rng.randn(60, D)
    W = np.diag(s1) @ H @ np.diag(g_true) @ H @ np.diag(s2)
    sigma, lam = 0.1, 10.0
    y = X @ W.T + sigma * rng.randn(60, D)
    M = s1[None, :, None] * H[None] * ((X * s2[None]) @ H)[:, None, :]  # (B, D, D)
    M2 = M.reshape(-1, D)
    cov = np.linalg.inv(np.eye(D) / lam + M2.T @ M2 / sigma**2)
    mean = cov @ (M2.T @ y.reshape(-1)) / sigma**2
    Mt, yt = torch.tensor(M, dtype=torch.float32), torch.tensor(y, dtype=torch.float32)

    def logp(q):
        g = q["g"]
        r = yt - torch.einsum("bik,wk->wbi", Mt, g)
        return -0.5 * torch.sum(torch.square(r), (-2, -1)) / sigma**2 - 0.5 * torch.sum(g * g, -1) / lam

    samples, _ = hmc_sample(logp, {"g": torch.zeros(D)}, gen(5), HMCConfig(n_samples=1500, n_warmup=500, n_leapfrog=16))
    m, s = moments(samples)
    np.testing.assert_allclose(m["g"].numpy(), mean, atol=0.05)
    np.testing.assert_allclose(s["g"].numpy(), np.sqrt(np.diag(cov)), rtol=0.3)


def test_hmc_divergence_detected_on_pathological_target():
    def logp(q):
        x = q["x"]
        return -0.5 * torch.sum(torch.square(x) * torch.exp(10.0 * x), -1)

    cfg = HMCConfig(n_samples=100, n_warmup=0, n_leapfrog=32, init_step_size=1.0, adapt=False)
    samples, stats = hmc_sample_chains(logp, {"x": torch.ones(2) * 2.0}, gen(2), cfg,
                                       n_chains=2, jitter=0.0)
    assert int(stats["divergences"].sum()) > 0
    assert torch.isfinite(samples["x"]).all()  # divergent proposals are never kept
