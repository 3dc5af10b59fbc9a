"""The port's NUTS by its moments, continued from
``test_torch_mcmc_stats_nuts.py``: the exact Gaussian posterior of a model
linear in g and the dense metric on a rho = 0.99 Gaussian (the JAX
package's ``tests/test_mass_adapt.py``), at the draw counts their
docstrings give."""

import numpy as np
import torch

from whvi_tpu_torch.mcmc import NUTSConfig, ess, nuts_sample

torch.set_num_threads(1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def quad(prec):
    def logp(q):
        x = q["x"]
        return -0.5 * torch.sum(torch.sum(x[..., None, :] * prec, -1) * x, -1)
    return logp


def test_nuts_matches_exact_gaussian_posterior():
    """The exact-Gaussian target of a model linear in g; JAX: 1500 + 500
    draws at depth 5 (here 600 + 300), marginal sds within 15% and means
    within 0.05."""
    D, n, sigma, lam = 8, 32, 0.1, 1.0
    rng = np.random.RandomState(0)
    M = rng.randn(n, D, D) / np.sqrt(D)
    y = np.einsum("nij,j->ni", M, rng.randn(D) * np.sqrt(lam)) + sigma * rng.randn(n, D)
    Lam = np.eye(D) / lam + np.einsum("nij,nik->jk", M, M) / sigma**2
    Sigma = np.linalg.inv(Lam)
    mu = Sigma @ (np.einsum("nij,ni->j", M, y) / sigma**2)
    Mt, yt = torch.tensor(M, dtype=torch.float32), torch.tensor(y, dtype=torch.float32)

    def logp(q):
        g = q["g"]
        r = yt - torch.einsum("nij,wj->wni", Mt, g)
        return -0.5 * torch.sum(torch.square(r), (-2, -1)) / sigma**2 - 0.5 * torch.sum(g * g, -1) / lam

    samples, stats = nuts_sample(logp, {"g": torch.zeros(D)}, gen(5),
                                 NUTSConfig(n_samples=600, n_warmup=300, max_tree_depth=5))
    gs = samples["g"]
    np.testing.assert_allclose(gs.mean(0).numpy(), mu, atol=0.05)
    np.testing.assert_allclose(gs.std(0, correction=0).numpy(), np.sqrt(np.diag(Sigma)), rtol=0.15)


def test_nuts_correlated_gaussian_dense_beats_diagonal():
    """JAX: rho 0.9, 2000 + 500 draws at depth 6 (diagonal); rho 0.99,
    600 + 600 each metric (dense against diagonal). Here rho 0.99, 300 +
    300 at depth 5, both metrics in one test."""
    rho = 0.99
    cov = torch.tensor([[1.0, rho], [rho, 1.0]])
    base = dict(n_samples=300, n_warmup=300, max_tree_depth=5)
    lp = quad(torch.linalg.inv(cov))
    s_diag, _ = nuts_sample(lp, {"x": torch.zeros(2)}, gen(0), NUTSConfig(**base))
    s_dense, st_dense = nuts_sample(lp, {"x": torch.zeros(2)}, gen(0), NUTSConfig(**base, dense_mass=True))
    m = st_dense["inv_mass"].numpy()
    assert m.shape == (2, 2)
    np.testing.assert_allclose(m, cov.numpy(), atol=0.25)
    np.testing.assert_allclose(np.cov(s_dense["x"].numpy().T), cov.numpy(), atol=0.25)
    ess_dense = float(ess(s_dense["x"][None]).min())
    ess_diag = float(ess(s_diag["x"][None]).min())
    assert ess_dense > 1.5 * ess_diag, (ess_dense, ess_diag)
