"""The port's samplers by their moments on analytic targets, continued
from ``test_torch_mcmc_stats_hmc.py``: mass adaptation on mixed scales,
multi-chain HMC, and parallel tempering (the JAX package's
``tests/test_mass_adapt.py``, ``test_diagnostics.py`` and
``test_tempering.py``, at the draw counts their docstrings give)."""

import numpy as np
import torch

from whvi_tpu_torch.mcmc import (
    HMCConfig,
    PTConfig,
    ess,
    hmc_sample,
    hmc_sample_chains,
    moments,
    pt_sample,
    pt_sample_chains,
    split_rhat,
    summarize,
)

torch.set_num_threads(1)

MEAN = torch.tensor([1.0, -2.0, 0.5])
SD = torch.tensor([0.5, 2.0, 1.0])


def gauss(q):
    return torch.sum(-0.5 * torch.square((q["x"] - MEAN) / SD), -1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


MIXED_SD = torch.tensor(np.logspace(-2, 2, 8), dtype=torch.float32)  # 1e4 scale ratio


def mixed(q):
    return torch.sum(-0.5 * torch.square(q["x"] / MIXED_SD), -1)


def test_hmc_adapted_mass_recovers_mixed_scales_identity_does_not():
    """The adapted metric recovers every scale; the identity metric leaves
    the widest random-walking. JAX: 2000 + 800 draws each, here 1500 + 800."""
    cfg = HMCConfig(n_samples=1500, n_warmup=800, n_leapfrog=16)
    samples, stats = hmc_sample(mixed, {"x": torch.zeros(8)}, gen(0), cfg)
    _, sd = moments(samples)
    np.testing.assert_allclose(sd["x"].numpy(), MIXED_SD.numpy(), rtol=0.35)
    np.testing.assert_allclose(stats["inv_mass"].numpy(), MIXED_SD.numpy() ** 2, rtol=0.9)
    assert float(stats["accept_rate"]) > 0.5
    samples, _ = hmc_sample(mixed, {"x": torch.zeros(8)}, gen(0),
                            HMCConfig(n_samples=1500, n_warmup=800, n_leapfrog=16, mass_adapt=False))
    widest = float(moments(samples)[1]["x"][-1])
    assert widest < 0.3 * float(MIXED_SD[-1]), widest


def test_multichain_hmc_gaussian_converges():
    cfg = HMCConfig(n_samples=1000, n_warmup=400, n_leapfrog=16)
    samples, stats = hmc_sample_chains(gauss, {"x": torch.zeros(3)}, gen(0), cfg, n_chains=4)
    assert samples["x"].shape == (4, 1000, 3)
    # JAX asserts none at its key 0; its own keys 0-5 give 4 divergences in
    # 24 chains of 1000 draws (1 in 6000), and the port's seeds 0-5 give 1
    assert stats["divergences"].shape == (4,) and int(stats["divergences"].sum()) <= 2
    assert float(split_rhat(samples["x"]).max()) < 1.05
    assert float(ess(samples["x"]).min()) > 100.0
    (row,) = summarize(samples).values()
    np.testing.assert_allclose(row["mean"], float(MEAN.mean()), atol=0.2)


def test_pt_cold_rung_recovers_gaussian_moments():
    """JAX: 2000 + 600 rounds."""
    cfg = PTConfig(n_samples=1500, n_warmup=600, n_rungs=4, n_leapfrog=12)
    samples, stats = pt_sample(gauss, {"x": torch.zeros(3)}, gen(0), cfg)
    m, s = moments(samples)
    assert float(stats["accept_rate"][0]) > 0.5
    np.testing.assert_allclose(m["x"].numpy(), MEAN.numpy(), atol=0.2)
    np.testing.assert_allclose(s["x"].numpy(), SD.numpy(), rtol=0.3)
    assert (stats["swap_rate"] > 0.1).all()


def bimodal(q):
    # modes at +-3 with sd 0.3: a 50-nat barrier at 0
    x = q["x"]
    a = -0.5 * torch.sum(torch.square((x - 3.0) / 0.3), -1)
    b = -0.5 * torch.sum(torch.square((x + 3.0) / 0.3), -1)
    return torch.logaddexp(a, b)


def test_pt_crosses_the_barrier_plain_hmc_cannot():
    """JAX: HMC 1500 + 500, PT 2000 + 1000 rounds."""
    init = {"x": torch.full((2,), 3.0)}
    h_samples, _ = hmc_sample(bimodal, init, gen(1), HMCConfig(n_samples=1000, n_warmup=500, n_leapfrog=16))
    assert float((h_samples["x"][:, 0] < 0).float().mean()) == 0.0
    cfg = PTConfig(n_samples=1500, n_warmup=1000, n_rungs=10, beta_min=0.02, n_leapfrog=8,
                   init_step_size=0.1, target_accept=0.9)
    samples, stats = pt_sample(bimodal, init, gen(2), cfg)
    frac_neg = float((samples["x"][:, 0] < 0).float().mean())
    assert 0.2 < frac_neg < 0.8
    assert (stats["swap_rate"] > 0.05).all()
    assert int(stats["divergences"]) <= 2


def test_pt_chains_driver_and_diagnostics():
    mean = torch.tensor([0.5, -1.0])
    cfg = PTConfig(n_samples=800, n_warmup=400, n_rungs=4, n_leapfrog=8)
    samples, stats = pt_sample_chains(
        lambda q: torch.sum(-0.5 * torch.square(q["x"] - mean), -1), {"x": torch.zeros(2)},
        gen(3), cfg, n_chains=2,
    )
    assert samples["x"].shape == (2, 800, 2)
    assert stats["swap_rate"].shape == (2, 3) and stats["betas"].shape == (2, 4)
    assert float(split_rhat(samples["x"]).max()) < 1.05
