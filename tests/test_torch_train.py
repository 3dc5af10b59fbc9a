"""Parity of the PyTorch port's optimizer and trainer with the JAX package,
on the CPU.

Deterministic checks feed both packages the same gradients, batches and
noise as numpy arrays (fp32, ``max|port - ref| / max|ref| <= 1e-5``).
The whole training loop draws its own noise on each side, so its check is
statistical, against JAX numbers written into the test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from whvi_tpu.data import cubic_data
from whvi_tpu.models import WHVILinear as JaxWHVILinear
from whvi_tpu.models import WHVIRegression as JaxWHVIRegression
from whvi_tpu.models import relu as jax_relu
from whvi_tpu.train import decayed_adam as jax_decayed_adam
from whvi_tpu.train import mask_likelihood_grads as jax_mask_likelihood_grads

from whvi_tpu_torch.convert import export_params, load_jax_params
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu
from whvi_tpu_torch.train import (
    TrainConfig,
    Trainer,
    batch_layout,
    decayed_adam,
    mask_likelihood_grads,
)

torch.set_num_threads(1)

F32_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t(a):
    return torch.tensor(np.asarray(a))


def _bench_nets(train_samples=1):
    """The bench's toy net (bench.py:51-57) in both packages."""
    jnet = JaxWHVIRegression(
        [
            JaxWHVILinear(3, 16, lambda_=2.0, s_init="auto"),
            jax_relu,
            JaxWHVILinear(16, 1, s_init="auto"),
        ],
        train_samples=train_samples,
    )
    pnet = WHVIRegression(
        [
            WHVILinear(3, 16, lambda_=2.0, s_init="auto"),
            relu,
            WHVILinear(16, 1, s_init="auto"),
        ],
        train_samples=train_samples,
    )
    return jnet, pnet


def _assert_params_match(pnet, jparams):
    flat_p = jax.tree_util.tree_flatten_with_path(export_params(pnet))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(
        {"layers": tuple(jparams["layers"]), "likelihood": jparams["likelihood"]}
    )[0]
    assert len(flat_p) == len(flat_j)
    for (path, a), (_, b) in zip(flat_p, flat_j):
        assert rel_err(a, b) <= F32_TOL, jax.tree_util.keystr(path)


def test_optimizer_matches_optax_with_phase1_freeze():
    """Five steps of the same gradients through both optimizers; steps 0-1
    are phase 1 (likelihood gradient masked). A large lr and a fast decay
    make the updates and the schedule visible against the tolerance."""
    lr0, gamma, p = 0.05, 0.5, 0.3
    jnet, pnet = _bench_nets()
    jparams = jnet.init(jax.random.PRNGKey(0))
    load_jax_params(pnet, jax.tree.map(np.asarray, jparams))
    tx = jax_decayed_adam(lr0, gamma, p)
    opt_state = tx.init(jparams)
    opt, sched = decayed_adam(pnet.parameters(), lr0, gamma, p)
    rho0 = pnet.likelihood.rho.detach().clone()
    rng = np.random.RandomState(0)
    for step in range(5):
        train_likelihood = step >= 2
        grads = jax.tree.map(
            lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), jparams
        )
        jg = jax_mask_likelihood_grads(
            jax.tree.map(jnp.asarray, grads), float(train_likelihood)
        )
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for layer, g in zip(pnet.layers, grads["layers"]):
            if isinstance(layer, WHVILinear):
                for k in ("s1", "s2", "g_mu", "g_rho"):
                    getattr(layer.matrix, k).grad = t(g[k])
        pnet.likelihood.rho.grad = t(grads["likelihood"]["rho"])
        mask_likelihood_grads(pnet, train_likelihood)
        assert pnet.likelihood.rho.grad is not None
        opt.step()
        sched.step()
        _assert_params_match(pnet, jparams)
        if not train_likelihood:
            assert torch.equal(pnet.likelihood.rho.detach(), rho0)
    assert not torch.equal(pnet.likelihood.rho.detach(), rho0)


def test_train_steps_match_jax_with_given_noise():
    """Three train steps (one phase-1, two phase-2) under KL warm-up, with
    the same batches and noise, against a JAX step built from its pieces."""
    S, Bsz, n, warmup = 2, 8, 30, 4
    cfg = TrainConfig(lr0=0.01, gamma=0.1, p=0.3, kl_warmup_steps=warmup)
    jnet, pnet = _bench_nets(train_samples=S)
    trainer = Trainer(pnet, cfg, device="cpu")
    state = trainer.init(0)
    jparams = jnet.init(jax.random.PRNGKey(1))
    load_jax_params(pnet, jax.tree.map(np.asarray, jparams))
    tx = jax_decayed_adam(cfg.lr0, cfg.gamma, cfg.p)
    opt_state = tx.init(jparams)
    rng = np.random.RandomState(1)

    def jax_loss(params, x, y, eps, w, kl_scale):
        preds = []
        for s in range(S):
            h = x
            for layer, p, e in zip(jnet.layers, params["layers"], eps):
                if e is None:
                    h = layer.apply(p, h, None)
                else:
                    g = p["g_mu"] + jax.nn.softplus(p["g_rho"]) * e[s, 0]
                    h = layer.apply_given_g(p, h, g)
            preds.append(h)
        mnll = jnet.likelihood.mnll(
            params["likelihood"], y, jnp.stack(preds), n, weights=w
        )
        return mnll + kl_scale * jnet.kl(params)

    for step, train_likelihood in enumerate((False, True, True)):
        x = rng.randn(Bsz, 3).astype(np.float32)
        y = rng.randn(Bsz, 1).astype(np.float32)
        w = (np.arange(Bsz) < Bsz - 2).astype(np.float32)
        eps = [
            rng.randn(S, 1, *layer.matrix.g_mu.shape).astype(np.float32)
            if isinstance(layer, WHVILinear) else None
            for layer in pnet.layers
        ]
        kl_scale = min(1.0, step / warmup)  # the step count before the update
        jloss, jg = jax.value_and_grad(jax_loss)(
            jparams, jnp.asarray(x), jnp.asarray(y),
            [None if e is None else jnp.asarray(e) for e in eps],
            jnp.asarray(w), kl_scale,
        )
        jg = jax_mask_likelihood_grads(jg, float(train_likelihood))
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        metrics = trainer.train_step(
            state, t(x), t(y), n, train_likelihood, weights=t(w),
            eps=[None if e is None else t(e) for e in eps],
        )
        assert rel_err(metrics["loss"].numpy(), jloss) <= F32_TOL
        _assert_params_match(pnet, jparams)
    assert state.step == 3


@pytest.mark.parametrize("n_train,batch", [(150, 64), (455, 64), (64, 64), (10, 64), (65, 64)])
def test_batch_weights_match_jax_runner(n_train, batch):
    # the JAX runner's padding weights, trainer.py:340-354
    B = min(batch, n_train)
    num_batches = -(-n_train // B)
    padded = num_batches * B
    want = (jnp.arange(padded) < n_train).astype(jnp.float32).reshape(num_batches, B)
    got_B, got_nb, weights = batch_layout(n_train, batch)
    assert (got_B, got_nb) == (B, num_batches)
    np.testing.assert_array_equal(weights.numpy(), np.asarray(want))


def test_padded_batch_loss_equals_unpadded():
    """Weight-0 wrap-padding rows leave the MNLL estimate unchanged."""
    _, pnet = _bench_nets(train_samples=2)
    pnet.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    x = t(rng.randn(5, 3).astype(np.float32))
    y = t(rng.randn(5, 1).astype(np.float32))
    eps = [
        t(rng.randn(2, 1, *layer.matrix.g_mu.shape).astype(np.float32))
        if isinstance(layer, WHVILinear) else None
        for layer in pnet.layers
    ]
    wrap = torch.arange(8) % 5
    w = (torch.arange(8) < 5).float()
    with torch.no_grad():
        full, _ = pnet.loss(x, y, 50, eps=eps)
        padded, _ = pnet.loss(x[wrap], y[wrap], 50, weights=w, eps=eps)
    assert rel_err(padded.numpy(), full.numpy()) <= F32_TOL


# JAX Trainer on cubic_data(seed=0) with the bench net, TrainConfig(epochs1=0,
# epochs2=300, kl_warmup_steps=300), init key PRNGKey(seed), evaluate key
# PRNGKey(100 + seed), seeds 0, 1, 2 (measured on the CPU):
JAX_TEST_RMSE = (2.2829084, 2.2822258, 2.2818339)
JAX_PRED_MNLL = (2.5580661, 2.5581925, 2.5592961)
# At 300 epochs both packages predict a mean near 0 (RMSE ~2.28) and the
# training shows in the noise scale: pred-MNLL falls from about 3.5 at
# init to ~2.56. The bands (seed means) allow for the different noise
# streams: the port's seeds landed within 0.001 (RMSE) and 0.005
# (pred-MNLL) of JAX's, and a net whose sigma did not train misses the
# pred-MNLL band by ~1.
RMSE_BAND = 0.02
PRED_MNLL_BAND = 0.05


def test_fit_matches_jax_statistically():
    (X, y), (Xt, yt) = cubic_data(seed=0)
    cfg = TrainConfig(epochs1=0, epochs2=300, epochs_per_call=100, kl_warmup_steps=300)
    rmse, pred_mnll = [], []
    for seed in (0, 1, 2):
        _, pnet = _bench_nets()
        trainer = Trainer(pnet, cfg, device="cpu")
        state = trainer.init(seed)
        state, logs = trainer.fit(state, X, y)
        assert [e["epoch"] for e in logs] == [100, 200, 300]
        assert logs[-1]["loss"] < logs[0]["loss"]
        assert state.step == 300 * 3
        m = trainer.evaluate(Xt, yt, torch.Generator().manual_seed(100 + seed))
        assert all(np.isfinite(v) for v in m.values())
        rmse.append(m["rmse"])
        pred_mnll.append(m["pred_mnll_per_point"])
    assert abs(np.mean(rmse) - np.mean(JAX_TEST_RMSE)) <= RMSE_BAND
    assert abs(np.mean(pred_mnll) - np.mean(JAX_PRED_MNLL)) <= PRED_MNLL_BAND


def test_phase1_freezes_likelihood_in_fit():
    _, pnet = _bench_nets()
    trainer = Trainer(pnet, TrainConfig(epochs1=3, epochs2=0, epochs_per_call=3), "cpu")
    state = trainer.init(5)
    rho0 = pnet.likelihood.rho.detach().clone()
    s1_0 = pnet.layers[0].matrix.s1.detach().clone()
    (X, y), _ = cubic_data(seed=1)
    trainer.fit(state, X, y)
    assert torch.equal(pnet.likelihood.rho.detach(), rho0)
    assert not torch.equal(pnet.layers[0].matrix.s1.detach(), s1_0)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import whvi_tpu_torch\n"
        "for m in pkgutil.walk_packages(whvi_tpu_torch.__path__, 'whvi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('whvi_tpu_torch.')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke exits non-zero and prints no result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
