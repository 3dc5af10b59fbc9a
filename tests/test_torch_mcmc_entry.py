"""The sampler entry points of the port on the CPU at tiny sizes:
``run_vi_vs_hmc``'s tiers (the exact posterior against the JAX script's
formula on the same arrays, ``experiments/run_vi_vs_hmc.py:112-134``) and
``run_mnist --cpu`` with ``--hmc``, ``--calibrate`` and scikit-learn's
digits, each with the JSON keys of the JAX CLI."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whvi_tpu_torch.experiments import run_mnist, run_vi_vs_hmc

torch.set_num_threads(1)

POSTERIOR_TOL = 1e-5  # fp32 normal equations, max |port - JAX| / max |JAX|


def test_exact_posterior_matches_the_jax_formula():
    D, n, sigma, lam = 16, 48, 0.1, 1.0
    rng = np.random.RandomState(0)
    s1, s2 = (rng.randn(D) / 4).astype(np.float32), (rng.randn(D) / 4).astype(np.float32)
    X = rng.randn(n, D).astype(np.float32)
    y = rng.randn(n, D).astype(np.float32)
    M, mu, Sigma, Lam = run_vi_vs_hmc.exact_posterior(
        *(torch.from_numpy(a) for a in (s1, s2, X, y)), sigma, lam)
    # the JAX script's lines, at Precision.HIGHEST
    from whvi_tpu.ops.hadamard import build_H

    HI = jax.lax.Precision.HIGHEST
    H = build_H(D)
    design = lambda x: s1[:, None] * H * jnp.matmul(H, s2 * x, precision=HI)[None, :]
    jM = jax.vmap(design)(jnp.asarray(X))
    jLam = jnp.eye(D) / lam + jnp.einsum("nij,nik->jk", jM, jM, precision=HI) / sigma**2
    jSigma = jnp.linalg.inv(jLam)
    jmu = jnp.matmul(jSigma, jnp.einsum("nij,ni->j", jM, jnp.asarray(y), precision=HI) / sigma**2,
                     precision=HI)
    for got, want in ((M, jM), (Lam, jLam), (Sigma, jSigma), (mu, jmu)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= POSTERIOR_TOL


ANALYTIC_KEYS = {"D", "n", "nuts", "vi", "exact_meanfield_sd_deficit", "final_elbo"}
NUTS_KEYS = {"rhat_max", "ess_min", "divergences", "mean_rmse_vs_exact", "sd_ratio_vs_exact_mean"}
VI_KEYS = {"mean_corr_vs_exact", "mean_rmse_vs_exact", "sd_ratio_vs_exact_marginal",
           "sd_ratio_vs_meanfield_optimum"}
RATE_KEYS = {"wall_s", "draws_per_s", "grad_evals_per_s"}


def test_analytic_tier_runs_small_and_gates():
    a = run_vi_vs_hmc.analytic_tier(D=8, n=16, n_vi_steps=400, n_nuts=60, n_warmup=60,
                                    tree_depth=4, device="cpu")
    assert set(a) == ANALYTIC_KEYS | {"device"}
    assert set(a["nuts"]) == NUTS_KEYS | RATE_KEYS and set(a["vi"]) == VI_KEYS
    assert a["nuts"]["divergences"] == 0
    # a short run already finds the exact mean; VI's mean correlates with it
    assert a["nuts"]["mean_rmse_vs_exact"] < 0.05
    assert a["vi"]["mean_corr_vs_exact"] > 0.99
    gates = run_vi_vs_hmc.analytic_gates(a)
    assert set(gates) == {"nuts_rhat_ok", "nuts_ess_ok", "nuts_divergence_free",
                          "nuts_matches_exact_sd", "vi_mean_matches_exact",
                          "vi_sd_matches_meanfield_theory"}


def test_analytic_tier_refuses_tf32():
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="fp32 matmuls"):
            run_vi_vs_hmc.analytic_tier(D=4, n=4, device="cpu")
    finally:
        torch.set_float32_matmul_precision("highest")


def test_nonlinear_and_mixed_tiers_run_small():
    nl = run_vi_vs_hmc.nonlinear_tier(epochs=20, n_test=10, n_nuts=8, tree_depth=3, device="cpu")
    assert nl["source"] == "synthetic"  # yacht's file is not in the repository
    assert set(nl["per_layer"]) == {"layer0", "layer2"}
    assert set(nl["function_space"]) == {"n_test", "vi", "nuts_mode_local", "nuts_overdispersed",
                                         "overdispersed_param_rhat_max",
                                         "overdispersed_divergences", "note"}
    assert math.isfinite(nl["function_space"]["nuts_mode_local"]["rmse"])
    study = run_vi_vs_hmc.mixed_lambda_study(n_draws=8, tree_depth=3, epochs_pass=10,
                                             epochs_fail=12, device="cpu")
    assert set(study) == {"epochs_10", "epochs_12", "verdict"}
    row = study["epochs_12"]
    assert set(row["gates"]) == {"adapted_ess_beats_identity", "adapted_rhat_ok",
                                 "adapted_divergence_free"}
    assert {"inv_mass_mean_layer0", "inv_mass_mean_layer2"} <= set(row["adapted_mass"])
    assert len(row["tempering"]["swap_rate_per_pair"]) == 15  # 16 rungs


def test_tempering_row_counts_kept_cold_draws():
    """The 4 ladders keep n_draws cold draws each after as many warm-up
    rounds: cold_draws_per_s counts the kept draws, rounds_per_s (the JAX
    row's "cold_draws_per_s") every round."""
    ctx = run_vi_vs_hmc._train_mixed_posterior(0, n_train=16, epochs=2, device="cpu")
    n_draws = 8
    row = run_vi_vs_hmc.tempering_row(ctx, n_draws=n_draws, n_rungs=2, n_leapfrog=2)
    assert row["cold_draws_per_s"] * row["wall_s"] == pytest.approx(4 * n_draws, rel=1e-12)
    assert row["rounds_per_s"] == pytest.approx(2 * row["cold_draws_per_s"], rel=1e-12)


def test_mains_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_vi_vs_hmc.main(["--tier", "analytic"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_mnist.main(["--data", "synthetic", "--hmc"])


MNIST_KEYS = {"experiment", "source", "width", "test_accuracy", "wall_s", "epochs_per_s", "device"}
CALIBRATE_KEYS = {"logit_temperature", "tau_at_edge", "test_nll_raw", "test_nll_cal",
                  "test_ece_raw", "test_ece_cal"}
HMC_KEYS = {"sampler", "rhat_max", "ess_min", "divergences", "converged", "mu_corr_vi_hmc",
            "hmc_sd_mean", "vi_sd_mean", "sd_ratio_vi_over_hmc", "criterion"}


def test_run_mnist_cpu_hmc_and_calibrate(monkeypatch, capsys):
    """``--cpu --hmc --calibrate`` through main, the sampler cut to 8 + 8
    draws at depth 3 (the CLI's is 400 + 500 at depth 6)."""
    monkeypatch.setattr(run_mnist, "hmc_check", functools.partial(
        run_mnist.hmc_check, n_samples=8, n_warmup=8, max_tree_depth=3))
    row, _, _ = run_mnist.main(["--cpu", "--data", "synthetic", "--width", "16", "--epochs1", "1",
                                "--epochs2", "1", "--subset", "300", "--eval-samples", "4",
                                "--hmc", "--calibrate"])
    assert set(row) - {"logit_temperature_raw"} == MNIST_KEYS | CALIBRATE_KEYS | {"hmc"}
    assert row["device"] == "cpu" and row["source"] == "synthetic"
    assert set(row["hmc"]) == HMC_KEYS | RATE_KEYS
    assert row["hmc"]["sampler"] == "nuts-4chain"
    assert math.isfinite(row["hmc"]["hmc_sd_mean"]) and row["hmc"]["divergences"] >= 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"experiment": "mnist"')


@pytest.mark.parametrize("data", ["digits", "wine"])
def test_run_mnist_cpu_on_sklearn_sets(data):
    row, _, _ = run_mnist.main(["--cpu", "--data", data, "--width", "16", "--epochs1", "1",
                                "--epochs2", "2", "--eval-samples", "4"])
    assert set(row) == MNIST_KEYS and row["source"] == data
    assert 0.0 <= row["test_accuracy"] <= 1.0


def test_sampler_bench_refuses_without_a_card_and_builds_config_4():
    from whvi_tpu_torch.bench import sampler_bench

    net = sampler_bench.config4_net(0)
    shapes = [tuple(layer.matrix.g_mu.shape) for layer in net.layers[::2]]
    assert shapes == [(1, 1024), (1024,), (1, 1024)]  # 3072 g coordinates
    assert torch.equal(net.layers[2].matrix.g_mu, sampler_bench.config4_net(0).layers[2].matrix.g_mu)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        sampler_bench.main([])
