"""Golden-sampler validation study on one NVIDIA H100: VI against NUTS
against the exact posterior.

Counterpart of ``experiments/run_vi_vs_hmc.py``::

    python -m whvi_tpu_torch.experiments.run_vi_vs_hmc [--tier analytic|nonlinear|mixed]
        [--epochs 12000] [--skip-nonlinear] [--skip-mixed] [--skip-tempering]
        [--dense-mass] [--precision fp32|bf16] [--out results.json] [--cpu]

Tiers:

1. **Analytic** (:func:`analytic_tier`): a square WHVI layer is linear in
   ``g``, ``y = diag(s1) H diag(g) H (s2 * x) = M(x) g``, so with a
   Gaussian likelihood and the ``N(0, lambda I)`` prior the g posterior is
   an exact Gaussian (:func:`exact_posterior`). NUTS must match it; a
   mean-field VI trained on the same model must land on the mean-field
   optimum, the exact mean with variances ``1 / Lambda_ii`` (an
   underestimate of the marginal ``(Lambda^-1)_ii`` wherever the posterior
   is correlated). ``main`` gates it as the JAX script does
   (:func:`analytic_gates`).
2. **Nonlinear** (:func:`nonlinear_tier`): a 6 -> 8 -> 1 WHVI MLP trained
   by VI on a yacht subset (the synthetic fallback: yacht's file is not in
   the repository), then 4-chain NUTS over its g posterior, mode-local
   (chains started at q draws) and over-dispersed, with the per-layer
   moment table and the symmetry-invariant comparison of the posterior
   predictive on held-out rows.
3. **Mixed-lambda study** (:func:`mixed_lambda_study`): the flagship prior
   mix {3, 1e-5} at 8000 epochs (adapted mass passes its gates) and 12000
   (the documented limitation), with a parallel-tempering arm
   (:func:`tempering_row`) on the second.

Every tier takes its device and the JAX functions' sizes (``n_nuts``,
``tree_depth``, ``n_draws``, ``epochs``...), so a short run needs no new
flag. Data and initial parameters come from seeded generators on the CPU
and move to the device, so a run on the card and one on the CPU see the
same arrays. Output: on the card a first line naming it and its power
limit, then the JSON of the results (``--out`` also writes it).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from whvi_tpu_torch.bench.common import device_name, header
from whvi_tpu_torch.mcmc import (
    NUTSConfig,
    PTConfig,
    ess,
    make_whvi_g_log_posterior,
    nuts_sample_chains,
    pt_sample_chains,
    split_rhat,
)
from whvi_tpu_torch.mcmc.hmc import forward_given_g
from whvi_tpu_torch.mcmc.nuts import gradient_evaluations
from whvi_tpu_torch.models import SquarePow2Matrix, WHVILinear, WHVIRegression, relu
from whvi_tpu_torch.ops import set_whvi_mul_precision
from whvi_tpu_torch.ops.hadamard import build_H, kl_diag_normal

__all__ = [
    "analytic_gates",
    "analytic_problem",
    "analytic_tier",
    "exact_posterior",
    "main",
    "mixed_lambda_study",
    "mixed_lambda_tier",
    "nonlinear_tier",
    "rates",
    "tempering_row",
]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rates(n_chains: int, n_draws: int, grad_evals: int, wall: float) -> dict:
    """Draws (all chains) and gradient evaluations (each of a batch of
    walkers) per second of sampler wall clock."""
    return {
        "wall_s": wall,
        "draws_per_s": n_chains * n_draws / max(wall, 1e-9),
        "grad_evals_per_s": grad_evals / max(wall, 1e-9),
    }


# ------------------------------------------------------------ analytic tier


def exact_posterior(s1, s2, X, y, sigma: float, lam: float):
    """The design ``M (n, D, D)`` with ``y_i = M[i] g``, ``M(x) = diag(s1)
    H diag(H (s2 x))``, and the exact Gaussian posterior of ``g`` under the
    ``N(0, lam I)`` prior: ``(M, mu, Sigma, Lam)``, ``Lam = I / lam + sum_i
    M_i^T M_i / sigma^2`` its precision."""
    D = s1.shape[-1]
    H = build_H(D, s1.dtype, s1.device)
    M = s1[None, :, None] * H[None] * ((s2 * X) @ H)[:, None, :]  # H symmetric
    eye = torch.eye(D, dtype=s1.dtype, device=s1.device)
    Lam = eye / lam + torch.einsum("nij,nik->jk", M, M) / sigma**2
    Sigma = torch.linalg.inv(Lam)
    mu = Sigma @ (torch.einsum("nij,ni->j", M, y) / sigma**2)
    return M, mu, Sigma, Lam


def _corr(a, b) -> float:
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def analytic_problem(D=16, n=48, sigma=0.1, lam=1.0, seed=0, device="cpu") -> dict:
    """The analytic tier's data and its exact posterior on ``device``:
    ``s1, s2`` of a ``SquarePow2Matrix(D, s_init="auto")``, ``X (n, D)``, a
    ``g_true ~ N(0, lam I)``, ``y = M g_true + sigma * noise``, all drawn
    on the CPU from ``seed``; ``M``, ``mu``, ``Sigma``, ``Lam``
    (:func:`exact_posterior`) and ``logp``, the log density of ``g`` over
    walkers."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    layer = SquarePow2Matrix(D, lambda_=lam, s_init="auto")
    layer.reset_parameters(gen)
    X = torch.randn(n, D, generator=gen)
    g_true = torch.randn(D, generator=gen) * math.sqrt(lam)
    noise = torch.randn(n, D, generator=gen)
    s1, s2 = (p.detach().to(device) for p in (layer.s1, layer.s2))
    X, g_true, noise = X.to(device), g_true.to(device), noise.to(device)
    H = build_H(D, X.dtype, device)
    design = s1[None, :, None] * H[None] * ((s2 * X) @ H)[:, None, :]
    y = torch.einsum("nij,j->ni", design, g_true) + sigma * noise
    M, mu, Sigma, Lam = exact_posterior(s1, s2, X, y, sigma, lam)

    def logp(q):
        g = q["g"]
        r = y - torch.einsum("nij,wj->wni", M, g)
        return -0.5 * torch.sum(torch.square(r), (-2, -1)) / sigma**2 - 0.5 * torch.sum(
            torch.square(g), -1) / lam

    return {"M": M, "y": y, "mu": mu, "Sigma": Sigma, "Lam": Lam, "logp": logp}


def analytic_tier(D=16, n=48, sigma=0.1, lam=1.0, seed=0, n_vi_steps=4000, *,
                  n_nuts=1000, n_warmup=500, tree_depth=6, device=None):
    """Exact Gaussian posterior vs 4-chain NUTS vs trained mean-field VI.

    The tier is an exactness oracle, so its matmuls must be plain fp32:
    the JAX script pins them to ``Precision.HIGHEST`` because the TPU's
    default (bf16 operands) left NUTS at R-hat 22; here that means no TF32,
    which ``torch.get_float32_matmul_precision() == "highest"`` says.
    """
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the analytic tier needs fp32 matmuls: set "
                           "torch.set_float32_matmul_precision('highest')")
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    prob = analytic_problem(D, n, sigma, lam, seed, device)
    M, y, mu, logp = prob["M"], prob["y"], prob["mu"], prob["logp"]
    exact_sd = torch.sqrt(torch.diagonal(prob["Sigma"]))
    mf_sd = 1.0 / torch.sqrt(torch.diagonal(prob["Lam"]))  # the mean-field optimum's sds

    cfg = NUTSConfig(n_samples=n_nuts, n_warmup=n_warmup, max_tree_depth=tree_depth)
    _sync(device)
    t0 = time.perf_counter()
    samples, stats = nuts_sample_chains(
        logp, {"g": torch.zeros(D, device=device)},
        torch.Generator(device=device).manual_seed(seed + 5), cfg, n_chains=4,
    )
    _sync(device)
    wall = time.perf_counter() - t0
    gs = samples["g"]  # (4, n_nuts, D)
    nuts_mean = gs.mean((0, 1))
    nuts_sd = gs.std((0, 1), correction=0)

    # mean-field VI on the same model (s1, s2, sigma frozen)
    g_mu = torch.zeros(D, device=device, requires_grad=True)
    g_rho = torch.full((D,), -2.5, device=device, requires_grad=True)
    opt = torch.optim.Adam([g_mu, g_rho], lr=1e-2)
    vi_gen = torch.Generator(device=device).manual_seed(seed + 1)
    const = y.numel() * 0.5 * math.log(2 * math.pi * sigma**2)
    loss = None
    for _ in range(n_vi_steps):
        g_sigma = F.softplus(g_rho)
        g = g_mu + g_sigma * torch.randn((8, D), generator=vi_gen, device=device)
        r = y[None] - torch.einsum("nij,sj->sni", M, g)
        ll = -0.5 * torch.sum(torch.square(r), (1, 2)) / sigma**2 - const
        loss = -(ll.mean() - kl_diag_normal(g_mu, g_sigma, 0.0, math.sqrt(lam)))
        opt.zero_grad()
        loss.backward()
        opt.step()
    vi_mean = g_mu.detach()
    vi_sd = F.softplus(g_rho).detach()
    return {
        "D": D,
        "n": n,
        "nuts": {
            "rhat_max": float(split_rhat(gs).max()),
            "ess_min": float(ess(gs).min()),
            "divergences": int(stats["divergences"].sum()),
            "mean_rmse_vs_exact": float(torch.sqrt(torch.mean(torch.square(nuts_mean - mu)))),
            "sd_ratio_vs_exact_mean": float(torch.mean(nuts_sd / exact_sd)),
            **rates(4, n_nuts + n_warmup, gradient_evaluations(cfg), wall),
        },
        "vi": {
            "mean_corr_vs_exact": _corr(vi_mean.cpu().numpy(), mu.cpu().numpy()),
            "mean_rmse_vs_exact": float(torch.sqrt(torch.mean(torch.square(vi_mean - mu)))),
            # the two sd comparisons that explain the mean-field gap
            "sd_ratio_vs_exact_marginal": float(torch.mean(vi_sd / exact_sd)),
            "sd_ratio_vs_meanfield_optimum": float(torch.mean(vi_sd / mf_sd)),
        },
        # how correlated the exact posterior is (drives the mean-field gap)
        "exact_meanfield_sd_deficit": float(torch.mean(mf_sd / exact_sd)),
        "final_elbo": float(-loss.detach()) if loss is not None else float("nan"),
        "device": device_name(device),
    }


def analytic_gates(a: dict) -> dict:
    """The JAX script's six gates on the analytic tier's row."""
    return {
        "nuts_rhat_ok": a["nuts"]["rhat_max"] < 1.01,
        "nuts_ess_ok": a["nuts"]["ess_min"] > 400,  # 100 per chain
        "nuts_divergence_free": a["nuts"]["divergences"] == 0,
        "nuts_matches_exact_sd": abs(a["nuts"]["sd_ratio_vs_exact_mean"] - 1) < 0.1,
        "vi_mean_matches_exact": a["vi"]["mean_corr_vs_exact"] > 0.99,
        "vi_sd_matches_meanfield_theory": abs(a["vi"]["sd_ratio_vs_meanfield_optimum"] - 1) < 0.15,
    }


# ------------------------------------------------------------ shared helpers


def _load_subset(seed=0, n_train=64, n_test=0):
    """Yacht subset (synthetic fallback when its file is absent):
    standardized train rows plus ``n_test`` disjoint held-out rows of the
    same permutation."""
    from whvi_tpu_torch.data import load_uci

    try:
        X_all, y_all = load_uci("yacht")
        idx = np.random.RandomState(seed).permutation(len(X_all))
        Xf = X_all[idx].astype(np.float32)
        yf = y_all[idx].astype(np.float32)
        yf = yf if yf.ndim > 1 else yf[:, None]
        source = "yacht"
    except FileNotFoundError:
        rng = np.random.RandomState(seed)
        Xf = rng.randn(n_train + n_test, 6).astype(np.float32)
        yf = np.sin(Xf.sum(1, keepdims=True)).astype(np.float32)
        source = "synthetic"
    X, y = Xf[:n_train], yf[:n_train]
    mu_x, sd_x = X.mean(0), X.std(0) + 1e-8
    mu_y, sd_y = y.mean(0), y.std(0) + 1e-8
    X_te = (Xf[n_train : n_train + n_test] - mu_x) / sd_x
    y_te = (yf[n_train : n_train + n_test] - mu_y) / sd_y
    return (X - mu_x) / sd_x, (y - mu_y) / sd_y, X_te, y_te, source


def _q_draw_inits(net, bayes_i, n_chains, seed):
    """Per-chain starts drawn from the trained q (mode-local protocol):
    ``{layer_index: (n_chains, *g_shape)}``."""
    gen = torch.Generator().manual_seed(seed + 11)
    out = {}
    for i in bayes_i:
        m = net.layers[i].matrix
        eps = torch.randn((n_chains,) + tuple(m.g_mu.shape), generator=gen).to(m.g_mu.device)
        out[i] = (m.g_mu + m.g_sigma() * eps).detach()
    return out


@torch.no_grad()
def _predictive_from_g_draws(net, X_te, y_te, samples, n_use=256):
    """Held-out posterior-predictive metrics from MCMC g draws ``{layer:
    (C, N, *g_shape)}``: the pooled draws thinned to ``n_use`` evenly
    spaced g's, each a walker of one deterministic forward (the log
    posterior's, :func:`forward_given_g`), scored by
    ``metrics_from_predictions`` as the VI draws are. Symmetry-invariant:
    it reads function values only."""
    bayes_i = sorted(samples)
    flat = {i: samples[i].reshape((-1,) + tuple(samples[i].shape[2:])) for i in bayes_i}
    total = flat[bayes_i[0]].shape[0]
    sel = torch.as_tensor(np.linspace(0, total - 1, min(n_use, total)).astype(np.int64))
    device = flat[bayes_i[0]].device
    g = {i: flat[i][sel.to(device)] for i in bayes_i}
    X = torch.as_tensor(X_te, device=device)
    y_hat = forward_given_g(net, X, g)  # (S, B, n_out)
    m = net.metrics_from_predictions(torch.as_tensor(y_te, device=device), y_hat)
    return {k: float(v) for k, v in m.items()}


@torch.no_grad()
def _vi_predictive(net, X_te, y_te, seed, n_samples=256):
    """The same held-out metrics from VI posterior draws."""
    device = next(net.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed + 29)
    y_hat = net.predict(torch.as_tensor(X_te, device=device), n_samples, gen)
    m = net.metrics_from_predictions(torch.as_tensor(y_te, device=device), y_hat)
    return {k: float(v) for k, v in m.items()}


def _train(layers, X, y, seed, epochs, device):
    """VI for ``epochs`` epochs, all in phase 1 (the noise frozen at
    sigma0 for the whole run), warm-up over 0.3 of them; returns the
    trained net and its log."""
    from whvi_tpu_torch.train import TrainConfig, Trainer

    net = WHVIRegression(layers, sigma0=0.3, train_samples=4)
    cfg = TrainConfig(epochs1=epochs, epochs2=0, epochs_per_call=2000, batch_size=64,
                      kl_warmup_steps=(epochs * 3) // 10)
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(seed)
    _, logs = trainer.fit(state, X, y)
    return trainer.net, logs


def _lin(a, b, lam):
    # bias + per-example noise + warm-up: the recipe that avoids the
    # posterior-collapse optimum (the JAX script's yacht study)
    return WHVILinear(a, b, lambda_=lam, s_init="auto", bias=True, per_example_noise=True)


# ----------------------------------------------------------- nonlinear tier


def nonlinear_tier(seed=0, n_train=64, epochs=20000, n_test=100, n_nuts=1500, tree_depth=9,
                   *, device=None):
    """A small WHVI MLP: VI, then 4-chain NUTS over its g posterior, two
    arms (mode-local: chains started at q draws; over-dispersed: jittered
    starts, which land in other sign/permutation modes of the ReLU
    posterior), each compared with VI in function space on ``n_test``
    held-out rows. One hidden layer, 16 g dims: deeper posteriors have
    geometry NUTS does not traverse reliably, which the gates enforce."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    X, y, X_te, y_te, source = _load_subset(seed, n_train, n_test)
    net, logs = _train([_lin(6, 8, 1.0), relu, _lin(8, 1, 1.0)], X, y, seed, epochs, device)
    logp, init = make_whvi_g_log_posterior(net, X, y)
    n_chains = 4
    bayes_i = sorted(init)
    cfg = NUTSConfig(n_samples=n_nuts, n_warmup=n_nuts, max_tree_depth=tree_depth,
                     target_accept=0.95)
    _sync(device)
    t0 = time.perf_counter()
    samples, stats = nuts_sample_chains(
        logp, init, torch.Generator(device=device).manual_seed(seed + 7), cfg,
        n_chains=n_chains, inits=_q_draw_inits(net, bayes_i, n_chains, seed),
    )
    _sync(device)
    wall = time.perf_counter() - t0
    per_layer = {}
    for i in bayes_i:
        gs = samples[i]
        m = net.layers[i].matrix
        vi_mu = m.g_mu.detach().reshape(-1).cpu().numpy()
        vi_sd = m.g_sigma().detach().reshape(-1).cpu().numpy()
        hmc_mu = gs.mean((0, 1)).reshape(-1).cpu().numpy()
        hmc_sd = gs.std((0, 1), correction=0).reshape(-1).cpu().numpy()
        per_layer[f"layer{i}"] = {
            "dim": int(vi_mu.size),
            "rhat_max": float(split_rhat(gs).max()),
            "ess_min": float(ess(gs).min()),
            "mu_corr": _corr(vi_mu, hmc_mu),
            "mu_rmse": float(np.sqrt(np.mean((vi_mu - hmc_mu) ** 2))),
            "sd_ratio_vi_over_hmc": float(np.mean(vi_sd / (hmc_sd + 1e-12))),
            "vi_sd_mean": float(vi_sd.mean()),
            "hmc_sd_mean": float(hmc_sd.mean()),
        }
    out = {
        "source": source,
        "scope": "mode-local (chains initialized from q draws; over-dispersed starts land in "
        "symmetry-equivalent modes of the ReLU posterior)",
        "n_train": n_train,
        "final_train_loss": logs[-1]["loss"],
        "noise_sigma": float(net.likelihood.sigma().detach()),
        "divergences": int(stats["divergences"].sum()),
        "per_layer": per_layer,
        **rates(n_chains, 2 * n_nuts, gradient_evaluations(cfg), wall),
        "device": device_name(device),
    }
    if n_test:
        vi_pred = _vi_predictive(net, X_te, y_te, seed)
        nuts_pred = _predictive_from_g_draws(net, X_te, y_te, samples)
        samples_od, stats_od = nuts_sample_chains(
            logp, init, torch.Generator(device=device).manual_seed(seed + 17), cfg,
            n_chains=n_chains, jitter=1.0,
        )
        out["function_space"] = {
            "n_test": int(len(y_te)),
            "vi": vi_pred,
            "nuts_mode_local": nuts_pred,
            "nuts_overdispersed": _predictive_from_g_draws(net, X_te, y_te, samples_od),
            "overdispersed_param_rhat_max": max(float(split_rhat(samples_od[i]).max())
                                                for i in bayes_i),
            "overdispersed_divergences": int(stats_od["divergences"].sum()),
            "note": "param-space R-hat of the over-dispersed arm is expected to explode "
            "(chains sit in different symmetry modes); the predictive rows must agree anyway",
        }
    return out


# --------------------------------------------------------- mixed-lambda tier


def _train_mixed_posterior(seed=0, n_train=64, epochs=8000, device=None):
    """Train the flagship prior mix (hidden lambda 3, output 1e-5) and
    freeze its g posterior, shared by the NUTS arms and the tempering arm."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    X, y, _, _, source = _load_subset(seed, n_train, 0)
    net, _ = _train([_lin(6, 8, 3.0), relu, _lin(8, 1, 1e-5)], X, y, seed, epochs, device)
    logp, init = make_whvi_g_log_posterior(net, X, y)
    bayes_i = sorted(init)
    return dict(net=net, source=source, epochs=epochs, n_train=n_train, seed=seed, logp=logp,
                init=init, bayes_i=bayes_i, device=device,
                inits=_q_draw_inits(net, bayes_i, 4, seed))


def _per_layer(samples, bayes_i):
    return {f"layer{i}": {"rhat_max": float(split_rhat(samples[i]).max()),
                          "ess_min": float(ess(samples[i]).min())} for i in bayes_i}


def mixed_lambda_tier(seed=0, n_train=64, epochs=8000, n_draws=800, tree_depth=6,
                      dense_mass=False, ctx=None, *, device=None):
    """Identity against adapted mass on the flagship prior mix, hidden
    lambda 3 and output 1e-5 (a ~550x prior-scale ratio), mode-local
    chains as in the nonlinear tier."""
    if ctx is None:
        ctx = _train_mixed_posterior(seed, n_train, epochs, device)
    device, bayes_i = ctx["device"], ctx["bayes_i"]
    n_chains = 4
    out = {"source": ctx["source"], "n_train": n_train, "epochs": epochs,
           "prior_scale_ratio": float(np.sqrt(3.0 / 1e-5))}
    for name, mass in (("identity_mass", False), ("adapted_mass", True)):
        cfg = NUTSConfig(n_samples=n_draws, n_warmup=n_draws, max_tree_depth=tree_depth,
                         target_accept=0.9, mass_adapt=mass, dense_mass=dense_mass and mass)
        _sync(device)
        t0 = time.perf_counter()
        samples, stats = nuts_sample_chains(
            ctx["logp"], ctx["init"], torch.Generator(device=device).manual_seed(seed + 7), cfg,
            n_chains=n_chains, inits=ctx["inits"],
        )
        _sync(device)
        wall = time.perf_counter() - t0
        per_layer = _per_layer(samples, bayes_i)
        row = {
            "per_layer": per_layer,
            "ess_min_overall": min(v["ess_min"] for v in per_layer.values()),
            "rhat_max_overall": max(v["rhat_max"] for v in per_layer.values()),
            "divergences": int(stats["divergences"].sum()),
            "step_size_mean": float(stats["step_size"].mean()),
            **rates(n_chains, 2 * n_draws, gradient_evaluations(cfg), wall),
            "backend": device_name(device),
        }
        if mass:
            # adapted inverse-mass scale per layer: should track the
            # ~550x posterior scale split
            m_inv = stats["inv_mass"]
            if m_inv.dim() == 3:  # dense metric: its diagonal
                m_inv = torch.diagonal(m_inv, dim1=1, dim2=2)
            off = 0
            for i in bayes_i:
                size = ctx["init"][i].numel()
                row[f"inv_mass_mean_layer{i}"] = float(m_inv[:, off : off + size].mean())
                off += size
        out[name] = row
    out["gates"] = {
        "adapted_ess_beats_identity": out["adapted_mass"]["ess_min_overall"]
        > out["identity_mass"]["ess_min_overall"],
        "adapted_rhat_ok": out["adapted_mass"]["rhat_max_overall"] < 1.05,
        "adapted_divergence_free": out["adapted_mass"]["divergences"] == 0,
    }
    return out


def tempering_row(ctx, n_draws=1600, n_rungs=16, beta_min=0.05, n_leapfrog=16):
    """Parallel tempering on a frozen g posterior: a quarter budget and the
    full one, since whether ESS scales with draws tells "slow but mixing"
    from "frozen"."""
    device, bayes_i, seed = ctx["device"], ctx["bayes_i"], ctx["seed"]

    def run(nd):
        cfg = PTConfig(n_samples=nd, n_warmup=nd, n_rungs=n_rungs, beta_min=beta_min,
                       n_leapfrog=n_leapfrog, target_accept=0.9)
        _sync(device)
        t0 = time.perf_counter()
        s, st = pt_sample_chains(ctx["logp"], ctx["init"],
                                 torch.Generator(device=device).manual_seed(seed + 13), cfg,
                                 n_chains=4, inits=ctx["inits"])
        _sync(device)
        return s, st, time.perf_counter() - t0

    s_q, _, _ = run(n_draws // 4)
    ess_quarter = min(float(ess(s_q[i]).min()) for i in bayes_i)
    samples, stats, wall = run(n_draws)
    per_layer = _per_layer(samples, bayes_i)
    ess_full = min(v["ess_min"] for v in per_layer.values())
    swap = stats["swap_rate"].cpu().numpy()  # (chains, K-1)
    return {
        "sampler": f"pt-{n_rungs}rung-hmc",
        "n_rungs": n_rungs,
        "beta_min": beta_min,
        "n_draws": n_draws,
        "per_layer": per_layer,
        "ess_min_overall": ess_full,
        "rhat_max_overall": max(v["rhat_max"] for v in per_layer.values()),
        "ess_scaling": {
            "draws_quarter": n_draws // 4,
            "ess_quarter": ess_quarter,
            "draws_full": n_draws,
            "ess_full": ess_full,
            "scales_with_draws": ess_full > 1.5 * ess_quarter,
        },
        "divergences": int(stats["divergences"].sum()),
        "swap_rate_per_pair": [round(float(x), 3) for x in swap.mean(0)],
        "swap_rate_min": float(swap.mean(0).min()),
        "cold_accept_rate": float(stats["accept_rate"][:, 0].mean()),
        "wall_s": wall,
        # a round spends K rungs x n_leapfrog gradients for one cold draw a ladder
        "cold_draws_per_s": 4 * 2 * n_draws / max(wall, 1e-9),
        "grad_evals_per_s": (1 + 2 * n_draws * n_leapfrog) / max(wall, 1e-9),
        "backend": device_name(device),
    }


def mixed_lambda_study(seed=0, n_train=64, n_draws=800, tree_depth=6, dense_mass=False,
                       epochs_pass=8000, epochs_fail=12000, skip_tempering=False, *,
                       device=None):
    """One run records both the 8000-epoch row (mass adaptation passes its
    gates) and the 12000-epoch row (the measured limitation: the
    over-trained posterior defeats linear preconditioning), plus the
    tempering arm on the failing posterior."""
    out = {}
    ctx_p = _train_mixed_posterior(seed, n_train, epochs_pass, device)
    out[f"epochs_{epochs_pass}"] = mixed_lambda_tier(
        seed, n_train, epochs_pass, n_draws, tree_depth, dense_mass, ctx=ctx_p)
    ctx_f = _train_mixed_posterior(seed, n_train, epochs_fail, device)
    row_f = mixed_lambda_tier(seed, n_train, epochs_fail, n_draws, tree_depth, dense_mass,
                              ctx=ctx_f)
    if not skip_tempering:
        ml = tempering_row(ctx_f, n_draws=2 * n_draws)
        ml["gates"] = {
            "pt_ess_beats_adapted_nuts": ml["ess_min_overall"]
            > row_f["adapted_mass"]["ess_min_overall"],
            "pt_ladder_connected": ml["swap_rate_min"] > 0.2,
            # NUTS ESS stays ~2 at any budget; a connected ladder's grows
            "pt_ess_scales_with_draws": ml["ess_scaling"]["scales_with_draws"],
        }
        row_f["tempering"] = ml
    out[f"epochs_{epochs_fail}"] = row_f
    out["verdict"] = {
        "passing_config": f"epochs={epochs_pass}",
        "failing_config": f"epochs={epochs_fail}",
        "pass_gates_all": all(out[f"epochs_{epochs_pass}"]["gates"].values()),
        "fail_is_limitation": not all(row_f["gates"].values()),
    }
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-nonlinear", action="store_true")
    ap.add_argument("--skip-mixed", action="store_true")
    ap.add_argument("--tier", default=None, choices=("analytic", "nonlinear", "mixed"),
                    help="run just one tier (default: all)")
    ap.add_argument("--epochs", type=int, default=12000,
                    help="nonlinear-tier training epochs; the mixed study ignores this and "
                    "records both its 8000 (passing) and 12000 (failing) configs")
    ap.add_argument("--skip-tempering", action="store_true",
                    help="drop the parallel-tempering arm from the mixed study")
    ap.add_argument("--dense-mass", action="store_true",
                    help="full-covariance metric for the adapted-mass arm (the mixed posterior "
                    "is 16-dim)")
    ap.add_argument("--precision", default=None, choices=("fp32", "bf16"),
                    help="what every WHVI product multiplies: fp32 (JAX's 'highest', and its "
                    "'default' on a CPU) or bf16 (the operand of each Hadamard factor "
                    "contraction rounded to bf16, fp32 sums: JAX's 'bf16' and its 'pallas' "
                    "backend; the TPU's 'default' rounds its operands to bf16 too). The "
                    "analytic tier's design matmuls stay fp32 either way")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        header("run_vi_vs_hmc")
        device = torch.device("cuda", 0)
    if args.precision:
        set_whvi_mul_precision(args.precision)
    if args.tier == "mixed":
        results = {"mixed_lambda": mixed_lambda_study(
            dense_mass=args.dense_mass, skip_tempering=args.skip_tempering, device=device)}
    elif args.tier == "nonlinear":
        results = {"nonlinear": nonlinear_tier(epochs=args.epochs, device=device)}
    else:
        results = {"analytic": analytic_tier(device=device)}
        results["analytic_gates"] = analytic_gates(results["analytic"])
        if not args.skip_nonlinear and args.tier != "analytic":
            results["nonlinear"] = nonlinear_tier(epochs=args.epochs, device=device)
        if not args.skip_mixed and args.tier != "analytic":
            results["mixed_lambda"] = mixed_lambda_study(
                dense_mass=args.dense_mass, skip_tempering=args.skip_tempering, device=device)
    print(json.dumps(results, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
