"""The port's UCI protocol against the JAX package's, on the CPU.

- ``ProtocolConfig``, ``_build_net``, ``standardize`` and the splits are
  the JAX package's (splits bit-equal).
- The replica axis: ``kl(lambdas)`` per layer, branch and replica against
  JAX's ``net.kl(params, lambdas)``; a replica-stacked step (R = 3) on the
  same noise against ``jax.vmap`` of JAX's loss with per-replica lambdas
  and KL scales (loss and gradients within 1e-5); the same step against R
  unreplicated steps of the port (1e-6, and 1e-5 after 3 Adam steps), each
  replica with its own lambda and warm-up; ``hyper``'s warm-up and noise
  freeze against JAX's ``train_step``; a stacked product in bf16 equal
  bit for bit to each replica's own bf16 product.
- The protocol's post-processing on fixed predictions (the same function
  of the inputs in both packages, training skipped): every metric of the
  sequential and stacked protocols (plain, ``calibrate``, ``normalize_y``,
  heteroscedastic) and of the grid within 1e-5 of JAX's, with the same
  keys; the real port protocol at a tiny size gives those keys, finite.
- ``calibration``, ``_aggregate``, ``_calibrate_splits``, the grid's
  refusals, the UCI registry and loaders and the xlsx reader against
  JAX's; both CLIs refuse without a card and run small with ``--cpu``.
"""

import dataclasses
import math
import os
import warnings
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whvi_tpu.calibration as jcal
import whvi_tpu.data.sheets as jsheets
import whvi_tpu.data.uci as juci
import whvi_tpu.evaluation as jev
import whvi_tpu.models as jm
from whvi_tpu.train import Trainer as JaxTrainer

import whvi_tpu_torch.calibration as pcal
import whvi_tpu_torch.data.sheets as psheets
import whvi_tpu_torch.data.uci as puci
import whvi_tpu_torch.evaluation as pev
import whvi_tpu_torch.models as pm
from whvi_tpu_torch.convert import load_jax_params, param_tree
from whvi_tpu_torch.bench import protocol_bench
from whvi_tpu_torch.experiments import run_protocol_feasibility, run_uci
from whvi_tpu_torch.models.networks import stack_replicas
from whvi_tpu_torch.ops import get_whvi_mul_precision, set_whvi_mul_precision
from whvi_tpu_torch.train import TrainConfig, Trainer, hyper_schedule

torch.set_num_threads(1)

F32_TOL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale) if scale else float(np.max(np.abs(got)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_params(jparams, rng):
    """JAX parameters away from the init's zeros and small scales."""
    def leaf(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "g_rho":
            return rng.uniform(-3.0, -1.0, size=shape).astype(np.float32)
        scale = {"s1": 0.5, "s2": 0.5, "g_mu": 1.0, "rho": 0.3}.get(name, 0.1)
        return np.asarray(scale * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jparams)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _data(n=240, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * [1.0, 2.0, 0.5, 3.0][:d] + 1.0).astype(np.float32)
    y = (np.sin(X[:, :1]) + 0.5 * X[:, 1:2] + 0.2 * rng.randn(n, 1) + 3.0).astype(np.float32)
    return X, y


# ------------------------------------------------------------- construction


def test_protocol_config_fields_and_defaults_match_jax():
    mine = [(f.name, f.default) for f in dataclasses.fields(pev.ProtocolConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jev.ProtocolConfig)]
    assert mine == theirs
    assert pev._GRID_KEYS == jev._GRID_KEYS


@pytest.mark.parametrize("kw", [
    {}, {"heteroscedastic": True, "bias": True}, {"rect_mode": "pad", "per_example_noise": True,
                                                  "column_lrt": True, "s_init": 0.01},
    {"hidden": (), "heteroscedastic": True}, {"hidden": (16,), "rect_mode": "pad"},
])
def test_build_net_matches_jax(kw):
    cfg = dict(hidden=(8, 8), **kw) if "hidden" not in kw else kw
    jnet = jev._build_net(jev.ProtocolConfig(**cfg), 5, 2)
    pnet = pev._build_net(pev.ProtocolConfig(**cfg), 5, 2)
    shapes = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jnet.init, jax.random.PRNGKey(0)))[0]}
    got = jax.tree.map(lambda p: p.detach().numpy(), param_tree(pnet))
    assert {k: v.shape for k, v in _flat(got).items()} == shapes

    def describe(layer):
        if isinstance(layer, (jm.Parallel, pm.Parallel)):
            return ("parallel", tuple(describe(b) for b in layer.branches))
        if not hasattr(layer, "matrix"):
            return (layer.name,)
        m = layer.matrix
        bias = layer.bias if isinstance(layer.bias, bool) else layer.bias is not None
        return (type(m).__name__, layer.n_in, layer.n_out, m.lambda_, m.s_init,
                layer.per_example_noise, getattr(m, "use_lrt", None), bias)

    assert [describe(layer) for layer in pnet.layers] == [describe(layer) for layer in jnet.layers]
    assert type(pnet.likelihood).__name__ == type(jnet.likelihood).__name__
    assert pnet.likelihood.sigma0 == jnet.likelihood.sigma0
    assert (pnet.train_samples, pnet.eval_samples) == (jnet.train_samples, jnet.eval_samples)


@pytest.mark.parametrize("kw", [
    {}, {"calibrate": True, "normalize_y": True}, {"scale_reference_exact": True, "seed": 3},
])
def test_standardize_and_splits_are_bit_equal_to_jax(monkeypatch, kw):
    X, y = _data()
    A = X[:50] * 3.0
    for got, want in zip(pev.standardize(A, X, y), jev.standardize(A, X, y)):
        assert np.array_equal(got, want)
    assert np.array_equal(pev.standardize(A), jev.standardize(A))
    cfg = dict(n_splits=3, **kw)
    monkeypatch.setattr(jev, "_run_vmapped_protocol", lambda net, tr, c, splits, *a: splits)
    monkeypatch.setattr(pev, "_run_stacked_protocol", lambda net, tc, c, splits, *a: splits)
    want = jev.evaluate_bayesian_regression(X, y[:, 0], jev.ProtocolConfig(**cfg))
    got = pev.evaluate_bayesian_regression(X, y[:, 0], pev.ProtocolConfig(**cfg), device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k] is None:
                assert g[k] is None
            else:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


# ---------------------------------------------------------------- replicas


def _split_head_pair(R=None, n_in=3, hidden=(8, 8), hetero=True):
    cfg = dict(hidden=hidden, heteroscedastic=hetero, bias=True, train_samples=2)
    jnet = jev._build_net(jev.ProtocolConfig(**cfg), n_in, 1)
    pnet = pev._build_net(pev.ProtocolConfig(**cfg), n_in, 1)
    if R is not None:
        stack_replicas(pnet, R)
    return jnet, pnet


def _stacked_random_params(jnet, R, rng):
    ps = [_random_params(jnet.init(jax.random.PRNGKey(r)), rng) for r in range(R)]
    return jax.tree.map(lambda *a: np.stack(a), *ps)


def test_kl_lambdas_match_jax_per_layer_branch_and_replica():
    rng = np.random.RandomState(1)
    jnet, pnet = _split_head_pair()
    params = _random_params(jnet.init(jax.random.PRNGKey(0)), rng)
    load_jax_params(pnet, params)
    jparams = jax.tree.map(jnp.asarray, params)
    for lambdas in (None, (0.5, None, 2.0, None, (0.01, 3.0)),
                    (torch.tensor(0.5), None, None, None, (None, torch.tensor(3.0)))):
        jl = None if lambdas is None else jax.tree.map(
            lambda v: None if v is None else float(v), lambdas, is_leaf=lambda v: v is None)
        want = jnet.kl(jparams, jl)
        assert rel_err(pnet.kl(lambdas).detach().numpy(), want) <= F32_TOL
    for bad in ((1.0,) * 4, (1.0, None, 1.0, None, (1.0,))):
        with pytest.raises(ValueError, match="one entry per"):
            pnet.kl(bad)
        with pytest.raises(ValueError, match="one entry per"):
            jnet.kl(jparams, bad)

    R = 3
    jnet, pnet = _split_head_pair(R)
    sparams = _stacked_random_params(jnet, R, rng)
    load_jax_params(pnet, sparams)
    lam = [rng.uniform(0.1, 3.0, R).astype(np.float32) for _ in range(4)]
    lambdas = (t(lam[0]), None, t(lam[1]), None, (t(lam[2]), t(lam[3])))
    got = pnet.kl(lambdas).detach().numpy()
    jl = (lam[0], None, lam[1], None, (lam[2], lam[3]))
    want = jax.vmap(lambda p, l: jnet.kl(p, l))(jax.tree.map(jnp.asarray, sparams),
                                                 jax.tree.map(jnp.asarray, jl))
    assert got.shape == (R,) and rel_err(got, want) <= F32_TOL
    assert rel_err(pnet.kl().detach().numpy(),
                   jax.vmap(jnet.kl)(jax.tree.map(jnp.asarray, sparams))) <= F32_TOL


def _given_noise(pnet, R, S, B, rng):
    def noise(layer):
        if isinstance(layer, pm.Parallel):
            return tuple(noise(b) for b in layer.branches)
        if not isinstance(layer, pm.WHVILinear):
            return None
        x = torch.empty(R, S, B, layer.n_in)
        return rng.randn(*layer.matrix.noise_shape(x, layer.lrt and layer.per_example_noise)
                         ).astype(np.float32)
    return [noise(layer) for layer in pnet.layers]


def _jax_forward(jnet, p, x, eps, s):
    """One JAX replica and MC sample ``s`` on the replica's given noise."""
    def layer_out(layer, lp, h, e):
        if isinstance(layer, jm.Parallel):
            return jnp.concatenate([layer_out(b, bp, h, be) for b, bp, be in
                                    zip(layer.branches, lp["branches"], e)], axis=-1)
        if e is None:
            return layer.apply(lp, h, None)
        return layer.apply_given_g(lp, h, lp["g_mu"] + jax.nn.softplus(lp["g_rho"]) * e[s, 0])

    h = x
    for layer, lp, e in zip(jnet.layers, p["layers"], eps):
        h = layer_out(layer, lp, h, e)
    return h


def _to_torch(e):
    if e is None:
        return None
    return tuple(map(_to_torch, e)) if isinstance(e, tuple) else t(e)


@pytest.mark.parametrize("hetero", [False, True])
def test_stacked_step_matches_jax_vmap_with_per_replica_lambdas(hetero):
    R, S, B, n = 3, 2, 6, 50
    rng = np.random.RandomState(2)
    jnet, pnet = _split_head_pair(R, hetero=hetero)
    sparams = _stacked_random_params(jnet, R, rng)
    load_jax_params(pnet, sparams)
    x = rng.randn(R, B, 3).astype(np.float32)
    y = rng.randn(R, B, 1).astype(np.float32)
    w = (np.arange(B) < B - 2).astype(np.float32)
    kl_scale = np.array([0.25, 1.0, 0.5], np.float32)
    lam = [np.array(v, np.float32) for v in ([0.5, 3.0, 1.0], [2.0, 0.1, 3.0], [1e-5, 1e-3, 1e-4],
                                             [1.0, 0.3, 2.0])]
    head = (lam[2], lam[3]) if hetero else lam[2]
    jl = (lam[0], None, lam[1], None, head)
    eps = _given_noise(pnet, R, S, B, rng)

    def loss_r(p, xr, yr, ks, lr, er):
        y_hat = jnp.stack([_jax_forward(jnet, p, xr, er, s) for s in range(S)])
        mnll = jnet.likelihood.mnll(p["likelihood"], yr, y_hat, n, weights=jnp.asarray(w))
        return mnll + ks * jnet.kl(p, lr)

    as_j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    want, jgrads = jax.vmap(jax.value_and_grad(loss_r))(
        as_j(sparams), as_j(x), as_j(y), as_j(kl_scale), as_j(jl), as_j(eps))
    lambdas = (t(lam[0]), None, t(lam[1]), None, (t(lam[2]), t(lam[3])) if hetero else t(lam[2]))
    loss, _ = pnet.loss(t(x), t(y), n, kl_scale=t(kl_scale), weights=t(w),
                        eps=[_to_torch(e) for e in eps], lambdas=lambdas)
    assert loss.shape == (R,)
    assert rel_err(loss.detach().numpy(), want) <= F32_TOL
    loss.sum().backward()
    got = _flat(jax.tree.map(lambda p: p.grad.numpy(), param_tree(pnet)))
    want_g = _flat(jgrads)
    assert sorted(got) == sorted(want_g)
    for k in want_g:
        assert rel_err(got[k], want_g[k]) <= 1e-4, k


def _trainers(R, hetero=False):
    """A replicated trainer and R unreplicated ones, replica r from seed
    20 + r in both."""
    cfg = pev.ProtocolConfig(hidden=(8, 8), heteroscedastic=hetero, bias=True, train_samples=2)
    tcfg = TrainConfig(batch_size=8, epochs1=0, epochs2=1)
    stacked = Trainer(pev._build_net(cfg, 3, 1), tcfg, device="cpu", replicas=R)
    st = stacked.init([20 + r for r in range(R)])
    singles = [Trainer(pev._build_net(cfg, 3, 1), tcfg, device="cpu") for _ in range(R)]
    ss = [tr.init(20 + r) for r, tr in enumerate(singles)]
    return stacked, st, singles, ss


def test_stacked_step_matches_unreplicated_steps_each_with_its_own_lambda():
    R, S, B = 3, 2, 8
    stacked, st, singles, ss = _trainers(R, hetero=True)
    for r, tr in enumerate(singles):  # init: replica r is the net of seed 20 + r
        for p, q in zip(stacked.net.parameters(), tr.net.parameters()):
            assert torch.equal(p[r], q)
    rng = np.random.RandomState(3)
    lam = np.array([[0.5, 3.0, 1.0], [1e-5, 1e-3, 1e-4], [1.0, 0.2, 5.0]], np.float32)
    hyper = {"kl_warmup_steps": np.array([0.0, 2.0, 5.0], np.float32),
             "noise_freeze_steps": np.array([0.0, 2.0, 9.0], np.float32),
             "lambdas": (lam[0], None, lam[0][::-1].copy(), None, (lam[1], lam[2]))}
    hyper_s = stacked._hyper_on_device(hyper)
    for step in range(3):
        x = rng.randn(R, B, 3).astype(np.float32)
        y = rng.randn(R, B, 1).astype(np.float32)
        eps = _given_noise(stacked.net, R, S, B, rng)
        m = stacked.train_step(st, t(x), t(y), 40, True, eps=[_to_torch(e) for e in eps],
                               hyper=hyper_s)
        for r, (tr, s) in enumerate(zip(singles, ss)):
            hr = tr._hyper_on_device({
                "kl_warmup_steps": hyper["kl_warmup_steps"][r],
                "noise_freeze_steps": hyper["noise_freeze_steps"][r],
                "lambdas": (lam[0][r], None, lam[0][::-1][r], None, (lam[1][r], lam[2][r])),
            })
            er = [None if e is None else tuple(t(b[r]) for b in e) if isinstance(e, tuple)
                  else t(e[r]) for e in eps]
            mr = tr.train_step(s, t(x[r]), t(y[r]), 40, True, eps=er, hyper=hr)
            tol = 1e-6 if step == 0 else F32_TOL
            for k in ("loss", "mnll", "kl"):
                assert rel_err(m[k][r].numpy(), mr[k].numpy()) <= tol, (step, r, k)
            if step == 0:
                for p, q in zip(stacked.net.parameters(), tr.net.parameters()):
                    assert rel_err(p.grad[r].numpy(), q.grad.numpy()) <= 1e-6
    for r, tr in enumerate(singles):
        for p, q in zip(stacked.net.parameters(), tr.net.parameters()):
            assert rel_err(p[r].detach().numpy(), q.detach().numpy()) <= F32_TOL
            assert rel_err(st.optimizer.state[p]["exp_avg"][r].numpy(),
                           ss[r].optimizer.state[q]["exp_avg"].numpy()) <= F32_TOL


def test_hyper_warmup_and_freeze_match_jax_train_step():
    """Per replica, the KL scale (loss - mnll) / kl and whether the noise
    branch moved, from JAX's own ``train_step`` at several steps, against
    the port's ``hyper_schedule``."""
    R = 4
    hyper = {"kl_warmup_steps": np.array([0, 1, 4, 10], np.float32),
             "noise_freeze_steps": np.array([0, 3, 7, 100], np.float32)}
    jnet = jev._build_net(jev.ProtocolConfig(hidden=(4,), heteroscedastic=True,
                                             lambda_hidden=1e-3), 2, 1)
    jtr = JaxTrainer(jnet, jev.TrainConfig(), vmap_splits=True)
    state0 = jtr.init(jnp.stack([jax.random.PRNGKey(r) for r in range(R)]))
    x = jnp.asarray(np.random.RandomState(4).randn(R, 8, 2).astype(np.float32))
    yv = jnp.asarray(np.random.RandomState(5).randn(R, 8, 1).astype(np.float32))
    step_fn = jax.jit(jax.vmap(lambda s, xx, yy, h: jtr.train_step(s, xx, yy, 8, 1.0, hyper=h)))
    jh = jax.tree.map(jnp.asarray, hyper)
    for step in (0, 1, 2, 3, 5, 7, 11):
        st = state0._replace(step=jnp.full((R,), step, jnp.int32))
        new, m = step_fn(st, x, yv, jh)
        scale = (np.asarray(m["loss"]) - np.asarray(m["mnll"])) / np.asarray(m["kl"])
        noise_mu = [np.asarray(s.params["layers"][-1]["branches"][1]["g_mu"]) for s in (new, st)]
        moved = [not np.array_equal(noise_mu[0][r], noise_mu[1][r]) for r in range(R)]
        kl_scale, train_noise = hyper_schedule(hyper, step)
        assert kl_scale.dtype == train_noise.dtype == np.float32
        np.testing.assert_allclose(kl_scale, scale, rtol=F32_TOL, atol=F32_TOL)
        assert list(train_noise.astype(bool)) == moved, step


def test_stacked_bf16_product_equals_each_replicas_own():
    """The bf16 mode rounds a replicated square matrix's product exactly as
    each replica's own (plain versions); a stacked (stack, D) product stays
    fp32 in both, as JAX's ``"pallas"`` backend leaves it to XLA."""
    prev = get_whvi_mul_precision()
    set_whvi_mul_precision("bf16")
    try:
        for make, n_in in ((lambda: pm.SquarePow2Matrix(32, s_init="auto"), 32),
                           (lambda: pm.StackedMatrix(8, 32, s_init="auto"), 8)):
            R, S, B = 3, 2, 5
            rng = np.random.RandomState(6)
            singles = [make() for _ in range(R)]
            for m in singles:
                m.reset_parameters(torch.Generator().manual_seed(int(rng.randint(1000))))
            stacked = make()
            with torch.no_grad():
                for name, p in list(stacked.named_parameters()):
                    setattr(stacked, name, torch.nn.Parameter(
                        torch.stack([getattr(m, name) for m in singles])))
            stacked.replicas = R
            x = t(rng.randn(R, S, B, n_in).astype(np.float32))
            eps = t(rng.randn(*stacked.noise_shape(x, False)).astype(np.float32))
            with torch.no_grad():
                got = stacked(x, eps=eps)
                for r, m in enumerate(singles):
                    own = m(x[r], eps=eps[r])
                    assert torch.equal(got[r], own)
                    set_whvi_mul_precision("fp32")
                    fp32 = m(x[r], eps=eps[r])
                    set_whvi_mul_precision("bf16")
                    # the square product rounds; the stacked one stays fp32
                    assert torch.equal(own, fp32) == isinstance(m, pm.StackedMatrix)
    finally:
        set_whvi_mul_precision(prev)


# ------------------------------------------------- post-processing, fixed


def _fake_y_hat(d, S, width):
    """What both packages' patched predict return for ``x (.., B, d)``:
    ``tanh(x W)`` spread over S samples, ``* (1 + 0.2 c_s) + 0.3 c_s``;
    returns ``(c (S, 1, 1), W (d, width))``."""
    W = np.linspace(-0.7, 0.9, d * width, dtype=np.float32).reshape(d, width)
    return np.linspace(-1.0, 1.0, S, dtype=np.float32).reshape(S, 1, 1), W


def _patch_jax(monkeypatch, width):
    def predict(self, params, x, key, n_samples):
        cs, W = _fake_y_hat(x.shape[-1], n_samples, width)
        base = jnp.tanh(x @ jnp.asarray(W))
        return base[None] * (1.0 + 0.2 * jnp.asarray(cs)) + 0.3 * jnp.asarray(cs)

    monkeypatch.setattr(jm.WHVINetwork, "predict", predict)
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, state, X, y, **kw: (state, []))


def _patch_port(monkeypatch, width):
    def predict(self, X, generator, n_samples=None):
        X = torch.as_tensor(X, dtype=torch.float32)
        S = self.net.eval_samples if n_samples is None else n_samples
        cs, W = _fake_y_hat(X.shape[-1], S, width)
        base = torch.tanh(X @ t(W)).unsqueeze(-3)
        return base * (1.0 + 0.2 * t(cs)) + 0.3 * t(cs)

    monkeypatch.setattr(Trainer, "predict", predict)
    monkeypatch.setattr(Trainer, "fit", lambda self, state, X, y, **kw: (state, []))


_TIMES = {"wall_s", "epochs_per_s", "wall_s_amortized", "epochs_per_s_amortized", "protocol_wall_s"}


def _compare(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            if k not in _TIMES:
                _compare(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, path
    else:
        assert abs(got - want) <= F32_TOL * max(1.0, abs(want)), (path, got, want)


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


VARIANTS = {
    "plain": {},
    "calibrate": {"calibrate": True},
    "normalize_y": {"normalize_y": True},
    "heteroscedastic": {"heteroscedastic": True},
    "hetero_normalize_calibrate_pooled": {"heteroscedastic": True, "normalize_y": True,
                                          "calibrate": True, "calib_pooled": True},
}


@pytest.mark.parametrize("stacked", [False, True], ids=["sequential", "stacked"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_protocol_matches_jax_on_fixed_predictions(monkeypatch, variant, stacked):
    X, y = _data()
    cfg = dict(n_splits=3, hidden=(8,), epochs1=1, epochs2=2, eval_samples=6,
               vmap_splits=stacked, **VARIANTS[variant])
    # the real port protocol, small: the keys JAX gives below, finite
    real = pev.evaluate_bayesian_regression(X, y, pev.ProtocolConfig(**cfg), device="cpu")
    width = 2 if cfg.get("heteroscedastic") else 1
    _patch_jax(monkeypatch, width)
    _patch_port(monkeypatch, width)
    want = jev.evaluate_bayesian_regression(X, y, jev.ProtocolConfig(**cfg))
    got = pev.evaluate_bayesian_regression(X, y, pev.ProtocolConfig(**cfg), device="cpu")
    _compare(got, want)
    assert sorted(real) == sorted(want)
    assert [sorted(s) for s in real["splits"]] == [sorted(s) for s in want["splits"]]
    assert _finite(real)


@pytest.mark.parametrize("hetero", [False, True])
def test_grid_matches_jax_on_fixed_predictions(monkeypatch, hetero):
    X, y = _data()
    base = dict(n_splits=2, hidden=(8,), epochs1=1, epochs2=2, eval_samples=6,
                heteroscedastic=hetero)
    overrides = ([{}, {"lambda_noise": 0.1, "noise_freeze_frac": 0.0, "seed": 4}] if hetero else
                 [{}, {"lambda_hidden": 1.0, "sigma0": 0.5, "kl_warmup_frac": 0.0}])
    real = pev.evaluate_config_grid(X, y, pev.ProtocolConfig(**base), overrides, device="cpu")
    width = 2 if hetero else 1
    _patch_jax(monkeypatch, width)
    _patch_port(monkeypatch, width)
    want = jev.evaluate_config_grid(X, y, jev.ProtocolConfig(**base), overrides)
    got = pev.evaluate_config_grid(X, y, pev.ProtocolConfig(**base), overrides, device="cpu")
    _compare(got, want)
    assert sorted(real) == sorted(want) and real["stack_size"] == 4
    assert _finite(real)


@pytest.mark.parametrize("bad", [
    ({"hidden": (4,)}, {}), ({}, {"calibrate": True}), ({}, {"normalize_y": True}),
    ({"sigma0": 0.5}, {"heteroscedastic": True}),
])
def test_grid_refuses_where_jax_refuses(bad):
    override, base = bad
    X, y = _data(40)
    with pytest.raises(ValueError) as want:
        jev.evaluate_config_grid(X, y, jev.ProtocolConfig(**base), [{}, override])
    with pytest.raises(ValueError) as got:
        pev.evaluate_config_grid(X, y, pev.ProtocolConfig(**base), [{}, override], device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stacked", [False, True])
def test_bad_calib_mode_is_refused_before_any_train_step(monkeypatch, stacked):
    """The calibration's refusal of a mode, raised before the first split
    trains (``calibration.fit_temperature_from_z`` raises it only after
    every split has), with the JAX package's text."""
    def trained(*args, **kwargs):
        raise AssertionError("a split trained before the refusal")

    monkeypatch.setattr(Trainer, "train_step", trained)
    monkeypatch.setattr(Trainer, "fit", trained)
    X, y = _data(60)
    cfg = pev.ProtocolConfig(n_splits=2, hidden=(8,), epochs1=1, epochs2=1, eval_samples=4,
                             calibrate=True, calib_mode="ml", vmap_splits=stacked)
    with pytest.raises(ValueError) as want:
        jcal.fit_temperature_from_z(np.zeros(8), mode="ml")
    with pytest.raises(ValueError) as got:
        pev.evaluate_bayesian_regression(X, y, cfg, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["ml", "quantile", "nll"])
def test_one_rule_decides_the_calib_mode(monkeypatch, mode):
    """``calibration.check_calib_mode`` is the one rule: the early check of
    the protocol and the fit both call it, and it refuses what the JAX
    package's fit refuses, with its text."""
    try:
        jcal.fit_temperature_from_z(np.zeros(32), mode=mode)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        pcal.check_calib_mode(mode)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    seen = []
    monkeypatch.setattr(pcal, "check_calib_mode", seen.append)
    pcal.fit_temperature_from_z(np.zeros(32) + 0.5, mode="nll")
    net = pm.WHVIRegression([pm.WHVILinear(2, 1)])
    pev._check_calibratable(net, mode)
    assert seen == ["nll", mode]


def test_protocol_resumes_from_its_checkpoints(tmp_path):
    X, y = _data(120)
    cfg = pev.ProtocolConfig(n_splits=2, hidden=(8,), epochs1=1, epochs2=4, checkpoint_every=2,
                             eval_samples=4, calibrate=True)
    first = pev.evaluate_bayesian_regression(X, y, cfg, ckpt_dir=str(tmp_path), device="cpu")
    (cfg_dir,) = os.listdir(tmp_path)
    assert cfg_dir.startswith("cfg-")
    assert sorted(os.listdir(tmp_path / cfg_dir / "stacked"))[::2] == ["ckpt-3.npz", "ckpt-5.npz"]
    again = pev.evaluate_bayesian_regression(X, y, cfg, ckpt_dir=str(tmp_path), device="cpu")
    _compare(again, first)


def test_entry_points_refuse_without_a_card():
    X, y = _data(40)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pev.evaluate_bayesian_regression(X, y, pev.ProtocolConfig(n_splits=1))
    with pytest.raises(RuntimeError, match="CUDA device"):
        pev.evaluate_config_grid(X, y, pev.ProtocolConfig(n_splits=1), [{}])


# ------------------------------------------------------ calibration, misc


def test_aggregate_and_calibrate_splits_match_jax():
    rng = np.random.RandomState(7)
    results = [{"rmse": rng.rand(), "mnll": rng.rand() * 50, "mnll_per_point": rng.rand(),
                "pred_mnll_per_point": rng.rand(), "coverage95": rng.rand()} for _ in range(4)]
    assert pev._aggregate(results) == jev._aggregate(results)
    results[1].pop("coverage95")
    assert pev._aggregate(results) == jev._aggregate(results)
    def moments(n):  # (y, mean, sd) of n points, 2 outputs
        return (rng.randn(n, 2).astype(np.float32), rng.randn(n, 2).astype(np.float32),
                (np.abs(rng.randn(n, 2)) + 0.1).astype(np.float32))

    cal_inputs = [moments(30) + moments(17) for _ in range(3)]
    for kw in ({}, {"calib_pooled": True}, {"calib_mode": "nll"}):
        cfg = jev.ProtocolConfig(**kw)
        got, want = pev._calibrate_splits(cal_inputs, cfg), jev._calibrate_splits(cal_inputs, cfg)
        for (tg, cg, zg), (tw, cw, zw) in zip(got, want):
            assert tg == tw and cg == cw and np.array_equal(zg, zw)
    out_p, out_j = pev._aggregate(results[:3]), jev._aggregate(results[:3])
    for r, (tau, cov, _) in zip(out_p["splits"], got):
        r["temperature"], r["coverage95_cal"] = tau, cov
    pev._attach_reliability(out_p, [z for _, _, z in got], [z / tau for tau, _, z in got])
    jev._attach_reliability(out_j, [z for _, _, z in want], [z / tau for tau, _, z in want])
    assert out_p == out_j


_CAL_CASES = [
    ("fit_temperature", lambda y, m, s, lg, lb: ((y, m, s), {})),
    ("fit_temperature_quantile", lambda y, m, s, lg, lb: ((y, m, s), {"level": 0.9})),
    ("fit_temperature_from_z", lambda y, m, s, lg, lb: (((y - m) / s,), {"mode": "nll"})),
    ("fit_temperature_from_z", lambda y, m, s, lg, lb: (((y - m) / s,), {})),
    ("coverage", lambda y, m, s, lg, lb: ((y, m, s), {"level": 0.8, "tau": 1.3})),
    ("reliability_table", lambda y, m, s, lg, lb: ((y, m, s), {"tau": 0.9})),
    ("table_from_z", lambda y, m, s, lg, lb: (((y - m) / s,), {})),
    ("tempered_mc_probs", lambda y, m, s, lg, lb: ((lg, 1.7), {})),
    ("expected_calibration_error", lambda y, m, s, lg, lb: ((lg.mean(0) ** 2 / 10, lb), {})),
    ("fit_logit_temperature", lambda y, m, s, lg, lb: ((lg, lb), {"return_info": True})),
    ("fit_logit_temperature", lambda y, m, s, lg, lb: ((lg, lb), {"objective": "nll"})),
]


@pytest.mark.parametrize("case", range(len(_CAL_CASES)))
def test_calibration_functions_match_jax(case):
    name, make = _CAL_CASES[case]
    rng = np.random.RandomState(case)
    y, m = rng.randn(2, 60, 1)
    s = np.abs(rng.randn(60, 1)) + 0.2
    logits = 3.0 * rng.randn(5, 60, 4)
    labels = rng.randint(0, 4, 60)
    args, kw = make(y, m, s, logits, labels)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a grid-edge fit warns in both
        got = getattr(pcal, name)(*args, **kw)
        want = getattr(jcal, name)(*args, **kw)
    if isinstance(want, np.ndarray):
        assert np.array_equal(got, want)
    else:
        assert got == want
    assert sorted(pcal.__all__) == sorted(jcal.__all__)
    assert pcal.DEFAULT_LEVELS == jcal.DEFAULT_LEVELS


def test_uci_registry_loaders_and_errors_match_jax(tmp_path, monkeypatch):
    assert list(puci.UCI_DATASETS) == list(juci.UCI_DATASETS)
    with pytest.raises(KeyError) as got:
        puci.load_uci("mnist")
    with pytest.raises(KeyError) as want:
        juci.load_uci("mnist")
    assert str(got.value) == str(want.value)
    table = np.random.RandomState(8).rand(9, 5)
    for k in (1, 2):
        for a, b in zip(puci._split_xy(table, k), juci._split_xy(table, k)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    np.savetxt(tmp_path / "yacht_hydrodynamics.data", np.random.RandomState(9).rand(12, 7))
    monkeypatch.setenv("WHVI_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(juci, "_SEARCH_DIRS", [str(tmp_path)])
    for a, b in zip(puci.load_uci("yacht"), juci.load_uci("yacht")):
        assert np.array_equal(a, b)
    assert puci.dataset_info("yacht") == juci.dataset_info("yacht") == {
        "name": "yacht", "available": True, "n": 12, "n_in": 6, "n_out": 1}
    missing_p, missing_j = puci.dataset_info("kin8nm"), juci.dataset_info("kin8nm")
    assert missing_p["available"] is missing_j["available"] is False
    assert "dataset_2175_kin8nm.csv" in missing_p["reason"]
    pytest.importorskip("sklearn")
    for name in ("diabetes", "linnerud"):
        for a, b in zip(puci.load_uci(name), juci.load_uci(name)):
            assert np.array_equal(a, b)


def test_sklearn_sets_say_so_without_sklearn(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *a, **kw):
        if name.startswith("sklearn"):
            raise ImportError("No module named 'sklearn'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(ImportError, match="scikit-learn"):
        puci.load_uci("diabetes")
    assert puci.dataset_info("linnerud")["available"] is False


def _write_xlsx(path, rows):
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    cells = []
    for r, row in enumerate(rows, start=1):
        cs = []
        for c, v in enumerate(row):
            ref = f"{chr(ord('A') + c)}{r}"
            if isinstance(v, str):
                cs.append(f'<c r="{ref}" t="inlineStr"><is><t>{v}</t></is></c>')
            else:
                cs.append(f'<c r="{ref}"><v>{v!r}</v></c>')
        cells.append(f'<row r="{r}">{"".join(cs)}</row>')
    sheet = f'<worksheet xmlns="{ns}"><sheetData>{"".join(cells)}</sheetData></worksheet>'
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/worksheets/sheet1.xml", sheet)
        z.writestr("xl/worksheets/sheet2.xml", f'<worksheet xmlns="{ns}"><sheetData/></worksheet>')


def test_xlsx_reader_matches_jax(tmp_path):
    rng = np.random.RandomState(10)
    rows = [["X1", "X2", "Y1", "Y2"]] + [list(map(float, rng.rand(4).round(6))) for _ in range(7)]
    rows[3][1] = "n/a"
    path = str(tmp_path / "ENB2012_data.xlsx")
    _write_xlsx(path, rows)
    got, want = psheets.read_xlsx_numeric(path), jsheets.read_xlsx_numeric(path)
    assert got.shape == want.shape == (7, 4)
    assert np.array_equal(got, want, equal_nan=True) and np.isnan(got[2, 1])
    assert np.array_equal(psheets._cells_to_array({}), jsheets._cells_to_array({}))
    for rk in (0x00000002 | (12345 << 2), 0x3FF00000 << 32 >> 32, 0x00000003 | (77 << 2)):
        assert psheets._decode_rk(rk) == jsheets._decode_rk(rk)


# ------------------------------------------------------------------- CLIs


def test_clis_refuse_without_a_card_and_run_with_cpu(tmp_path, monkeypatch, capsys):
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_uci.main(["diabetes"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_protocol_feasibility.main([])
    np.savetxt(tmp_path / "yacht_hydrodynamics.data", np.random.RandomState(11).rand(40, 7))
    monkeypatch.setenv("WHVI_DATA_DIR", str(tmp_path))
    row = run_uci.main(["yacht", "--cpu", "--splits", "2", "--epochs1", "1", "--epochs2", "2",
                        "--hidden", "8", "--calibrate", "--ckpt-dir", str(tmp_path / "ck")])
    assert row["dataset"] == "yacht" and row["device"] == "cpu" and _finite(row)
    assert "splits" not in row and row["vmapped_splits"] is True
    grid = run_uci.main(["yacht", "--cpu", "--splits", "2", "--epochs1", "0", "--epochs2", "1",
                         "--hidden", "8", "--quiet", "--ckpt-dir", str(tmp_path / "ck"),
                         "--grid", '[{}, {"lambda_hidden": 1.0}]'])
    assert grid["n_configs"] == 2 and all("splits" not in c for c in grid["configs"])
    feas = run_protocol_feasibility.main(["--cpu", "--n", "256", "--epochs1", "1", "--epochs2",
                                          "1", "--splits", "2"])
    assert feas["shape"] == [256, 8] and feas["stack_replicas"] == 2 and _finite(feas)
    assert feas["card"] == "cpu"
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"tool": "run_uci"' in lines[0]


def test_protocol_bench_runs_small_on_the_cpu_and_refuses_without_a_card():
    rows = protocol_bench.run(device="cpu", epochs1=1, epochs2=2, splits=2, profile=0)
    assert [r["path"] for r in rows] == ["stacked", "sequential"]
    assert all(_finite(r) and r["device"] == "cpu" and r["epochs"] == 3 for r in rows)
    assert protocol_bench.run(device="cpu", epochs1=0, epochs2=1, splits=2, profile=0,
                              stacked_only=True)[0]["path"] == "stacked"
    X, y = protocol_bench.boston_like(0)
    assert X.shape == (506, 13) and y.shape == (506, 1) and X.dtype == y.dtype == np.float32
    with pytest.raises(RuntimeError, match="CUDA device"):
        protocol_bench.main([])
