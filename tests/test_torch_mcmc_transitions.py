"""The port's HMC, NUTS and tempering transitions fed the random numbers
JAX draws from its own keys, against the JAX samplers' results on the
CPU (``whvi_tpu/mcmc/hmc.py:136``, ``nuts.py:186``, :201-203,
``tempering.py:131``, :174). JAX keys and torch generators give
different streams, so the parity is on the same inputs. Also: C chains
in one batched call against each chain alone, and the carried leapfrog
gradient against recomputing it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whvi_tpu.mcmc import hmc as jhmc
from whvi_tpu.mcmc import nuts as jnuts
from whvi_tpu.mcmc import tempering as jpt
from whvi_tpu_torch.mcmc import hmc, nuts, tempering
from whvi_tpu_torch.mcmc import HMCConfig, NUTSConfig, PTConfig

torch.set_num_threads(1)

TOL = 1e-5  # float32 trajectories of linear (Gaussian) dynamics, two libraries
CHAIN_TOL = 1e-6  # a batched chain against itself alone: the same ops

_MEAN = np.array([1.0, -2.0, 0.5], np.float32)
_SD = np.array([0.5, 2.0, 1.0], np.float32)
_COV = np.array([[1.0, 0.9, 0.0], [0.9, 1.0, 0.3], [0.0, 0.3, 1.0]], np.float32)
_PREC = np.linalg.inv(_COV).astype(np.float32)


def jax_diag(q):
    return jnp.sum(-0.5 * jnp.square((q["x"] - _MEAN) / _SD))


def torch_diag(q):
    x = q["x"]
    return torch.sum(-0.5 * torch.square((x - torch.from_numpy(_MEAN)) / torch.from_numpy(_SD)), -1)


def jax_corr(q):
    return -0.5 * q["x"] @ jnp.asarray(_PREC) @ q["x"]


def torch_corr(q):
    x = q["x"]  # a broadcast sum: rounds alike at every batch size
    return -0.5 * torch.sum(torch.sum(x[..., None, :] * torch.from_numpy(_PREC), -1) * x, -1)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))[None]


def jax_hmc_draws(key, total, dim):
    """The draws of ``whvi_tpu.mcmc.hmc.hmc_sample``'s steps."""
    out = []
    for k in jax.random.split(key, total):
        k_mom, k_acc, k_jit = jax.random.split(k, 3)
        out.append({
            "xi": _t(jax.random.normal(k_mom, (dim,))),
            "jitter_u": _t(jax.random.uniform(k_jit)),
            "accept_u": _t(jax.random.uniform(k_acc)),
        })
    return out


def _node_uniforms(key, depth):
    if depth == 0:
        return []
    k1, k2, k3 = jax.random.split(key, 3)
    return (_node_uniforms(k1, depth - 1) + _node_uniforms(k2, depth - 1)
            + [float(jax.random.uniform(k3))])


def jax_nuts_draws(key, total, dim, depth):
    """The draws of ``whvi_tpu.mcmc.nuts.nuts_sample``'s draws, node
    uniforms in post-order as :func:`nuts.nuts_draws` lays them out."""
    out = []
    for k in jax.random.split(key, total):
        k_mom, k_dirs, k_tree, k_acc = jax.random.split(k, 4)
        dirs = np.asarray(jax.random.bernoulli(k_dirs, 0.5, (depth,)))
        tree_keys = jax.random.split(k_tree, depth)
        acc_keys = jax.random.split(k_acc, depth)
        out.append({
            "xi": _t(jax.random.normal(k_mom, (dim,))),
            "dirs": _t(np.where(dirs, 1.0, -1.0)),
            "node_u": [_t(np.array(_node_uniforms(tree_keys[j], j), np.float32).reshape(-1))
                       for j in range(depth)],
            "merge_u": _t([float(jax.random.uniform(acc_keys[j])) for j in range(depth)]),
        })
    return out


def jax_pt_draws(key, total, dim, K):
    """The draws of ``whvi_tpu.mcmc.tempering.pt_sample``'s rounds."""
    out = []
    for k in jax.random.split(key, total):
        k_hmc, k_swap, k_jit = jax.random.split(k, 3)
        xi, acc = [], []
        for kk in jax.random.split(k_hmc, K):
            k_mom, k_acc = jax.random.split(kk)
            xi.append(_np(jax.random.normal(k_mom, (dim,))))
            acc.append(float(jax.random.uniform(k_acc)))
        out.append({
            "xi": _t(np.stack(xi)),
            "accept_u": _t(acc),
            "jitter_u": _t(jax.random.uniform(k_jit, (K,))),
            "swap_u": _t(jax.random.uniform(k_swap, (K,))),
        })
    return out


def _assert_stats(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=TOL, atol=TOL, err_msg=k)


# Dual averaging feeds each step's acceptance back into the next step
# size, and in warm-up that loop can amplify float32 rounding by orders of
# magnitude: at HMC's defaults a 3e-7 relative change of the log density
# moves JAX's own 30-draw trajectory by up to 0.4. The long trajectories
# below use settings under which JAX's own trajectory moves by less than
# TOL under that change (asserted first, by _conditioned), so that they
# hold the port to JAX, not to rounding.
PERTURB = 3e-7


def _conditioned(run, jlp):
    """Run the JAX sampler on ``jlp`` and on ``jlp * (1 + PERTURB)``; assert
    the positions agree within TOL / 2 and return the first run."""
    want = run(jlp)
    moved = run(lambda q: jlp(q) * (1.0 + PERTURB))
    gap = np.abs(_np(moved[0]["x"]) - _np(want[0]["x"])).max()
    assert gap < TOL / 2, f"the JAX trajectory itself moves {gap:.2e}: not a parity test"
    return want


# (n_warmup, n_samples, init_step_size, target_accept, leapfrog steps or
# tree depth, key): one draw at the defaults' target, and a trajectory
# through warmup_schedule(20)'s window end at step 17, where the metric
# updates and dual averaging restarts.
HMC_RUNS = [(0, 1, 0.3, 0.8, 6, 11), (20, 10, 0.1, 0.99, 2, 0)]
NUTS_RUNS = [(0, 1, 0.4, 0.8, 3, 12), (20, 5, 0.1, 0.9, 3, 0)]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("run", HMC_RUNS)
def test_hmc_fed_jax_draws_matches_jax(dense, run):
    n_warmup, n_samples, eps0, target, n_leapfrog, seed = run
    cfg = HMCConfig(n_samples=n_samples, n_warmup=n_warmup, n_leapfrog=n_leapfrog,
                    init_step_size=eps0, target_accept=target, dense_mass=dense)
    jlp, tlp = (jax_corr, torch_corr) if dense else (jax_diag, torch_diag)
    key = jax.random.PRNGKey(seed)
    init = np.array([0.2, -0.4, 0.1], np.float32)
    want_s, want_st = _conditioned(
        lambda lp: jhmc.hmc_sample(lp, {"x": jnp.asarray(init)}, key, cfg), jlp
    )
    draws = jax_hmc_draws(key, n_warmup + n_samples, 3)
    got_s, got_st = hmc.hmc_sample(tlp, {"x": torch.from_numpy(init)}, None, cfg,
                                   draws=lambda t: draws[t])
    np.testing.assert_allclose(got_s["x"].numpy(), _np(want_s["x"]), rtol=TOL, atol=TOL)
    _assert_stats(got_st, want_st, ("accept_rate", "step_size", "inv_mass", "divergences"))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("run", NUTS_RUNS)
def test_nuts_fed_jax_draws_matches_jax(dense, run):
    n_warmup, n_samples, eps0, target, depth, seed = run
    cfg = NUTSConfig(n_samples=n_samples, n_warmup=n_warmup, max_tree_depth=depth,
                     init_step_size=eps0, target_accept=target, dense_mass=dense)
    jlp, tlp = (jax_corr, torch_corr) if dense else (jax_diag, torch_diag)
    key = jax.random.PRNGKey(seed)
    init = np.array([0.3, -0.2, 0.4], np.float32)
    want_s, want_st = _conditioned(
        lambda lp: jnuts.nuts_sample(lp, {"x": jnp.asarray(init)}, key, cfg), jlp
    )
    draws = jax_nuts_draws(key, n_warmup + n_samples, 3, depth)
    got_s, got_st = nuts.nuts_sample(tlp, {"x": torch.from_numpy(init)}, None, cfg,
                                     draws=lambda t: draws[t])
    np.testing.assert_allclose(got_s["x"].numpy(), _np(want_s["x"]), rtol=TOL, atol=TOL)
    _assert_stats(got_st, want_st, ("accept_stat", "step_size", "inv_mass", "divergences"))


@pytest.mark.parametrize("n_warmup,n_samples", [(0, 1), (0, 2), (20, 2)])
def test_pt_round_fed_jax_draws_matches_jax(n_warmup, n_samples):
    """One round (every rung's HMC update and the even swap sweep), two
    (the odd sweep too), and 22 through a window end."""
    cfg = PTConfig(n_samples=n_samples, n_warmup=n_warmup, n_rungs=4, beta_min=0.1,
                   n_leapfrog=2, init_step_size=0.3, target_accept=0.99)
    key = jax.random.PRNGKey(2)
    init = np.array([0.5, 0.1, -0.3], np.float32)
    want_s, want_st = _conditioned(
        lambda lp: jpt.pt_sample(lp, {"x": jnp.asarray(init)}, key, cfg), jax_diag
    )
    draws = jax_pt_draws(key, n_warmup + n_samples, 3, 4)
    got_s, got_st = tempering.pt_sample(torch_diag, {"x": torch.from_numpy(init)}, None, cfg,
                                        draws=lambda t: draws[t])
    np.testing.assert_allclose(got_s["x"].numpy(), _np(want_s["x"]), rtol=TOL, atol=TOL)
    _assert_stats(got_st, want_st, ("accept_rate", "swap_rate", "step_size", "inv_mass",
                                    "betas", "divergences", "divergences_any"))


def test_divergences_are_rejected_as_jax_rejects_them():
    """A target far too steep for the step: every proposal diverges, is
    rejected (the position stays) and feeds accept 0, as in JAX."""
    cfg = HMCConfig(n_samples=4, n_warmup=0, n_leapfrog=8, init_step_size=1.0, adapt=False)
    key = jax.random.PRNGKey(3)
    init = np.array([0.5, -0.5], np.float32)
    want_s, want_st = jhmc.hmc_sample(
        lambda q: -1e6 * jnp.sum(q["x"] ** 4), {"x": jnp.asarray(init)}, key, cfg
    )
    draws = jax_hmc_draws(key, 4, 2)
    got_s, got_st = hmc.hmc_sample(
        lambda q: -1e6 * torch.sum(q["x"] ** 4, -1), {"x": torch.from_numpy(init)}, None, cfg,
        draws=lambda t: draws[t],
    )
    assert int(want_st["divergences"]) == 4 == int(got_st["divergences"])
    assert float(got_st["accept_rate"]) == 0.0
    np.testing.assert_array_equal(got_s["x"].numpy(), np.broadcast_to(init, (4, 2)))
    np.testing.assert_array_equal(got_s["x"].numpy(), _np(want_s["x"]))


# Through a window end, in settings that keep dual averaging from
# amplifying rounding (see _conditioned): a batched matmul may round
# otherwise than one chain's.
_SAMPLERS = {
    "hmc": (hmc._hmc_chains,
            HMCConfig(n_samples=6, n_warmup=20, n_leapfrog=2, init_step_size=0.1, target_accept=0.99),
            lambda gen, C: hmc.hmc_draws(gen, C, 3, "cpu")),
    "hmc_dense": (hmc._hmc_chains,
                  HMCConfig(n_samples=6, n_warmup=20, n_leapfrog=2, init_step_size=0.1,
                            target_accept=0.99, dense_mass=True),
                  lambda gen, C: hmc.hmc_draws(gen, C, 3, "cpu")),
    "nuts": (nuts._nuts_chains,
             NUTSConfig(n_samples=5, n_warmup=20, max_tree_depth=3, init_step_size=0.1, target_accept=0.9),
             lambda gen, C: nuts.nuts_draws(gen, C, 3, 3, "cpu")),
    "pt": (tempering._pt_chains,
           PTConfig(n_samples=5, n_warmup=20, n_rungs=3, n_leapfrog=2, init_step_size=0.3,
                    target_accept=0.99),
           lambda gen, C: tempering.pt_draws(gen, C, 3, 3, "cpu")),
}


def _slice_draws(d, c):
    if isinstance(d, list):
        return [_slice_draws(x, c) for x in d]
    if isinstance(d, dict):
        return {k: _slice_draws(v, c) for k, v in d.items()}
    return d[c : c + 1]


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_chains_in_one_call_equal_each_chain_alone(name):
    sample_fn, cfg, make = _SAMPLERS[name]
    C, total = 3, cfg.n_warmup + cfg.n_samples
    gen = torch.Generator().manual_seed(5)
    draws = [make(gen, C)(t) for t in range(total)]
    inits = {"x": torch.from_numpy(np.random.RandomState(1).randn(C, 3).astype(np.float32))}
    lp = torch_corr if name == "hmc_dense" else torch_diag
    s, st = sample_fn(lp, inits, None, cfg, lambda t: draws[t])
    for c in range(C):
        s_c, st_c = sample_fn(lp, {"x": inits["x"][c : c + 1]}, None, cfg,
                              lambda t: _slice_draws(draws[t], c))
        torch.testing.assert_close(s["x"][c : c + 1], s_c["x"], rtol=CHAIN_TOL, atol=CHAIN_TOL)
        for k in st:
            torch.testing.assert_close(st[k][c : c + 1], st_c[k], rtol=CHAIN_TOL, atol=CHAIN_TOL)


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_carried_gradient_equals_recomputed_one(name, monkeypatch):
    """The leapfrog carries its end gradient into the next step; a
    leapfrog that evaluates the gradient at its start again gives the
    same draws bit for bit, with twice the evaluations."""
    sample_fn, cfg, make = _SAMPLERS[name]
    C, total = 2, cfg.n_warmup + cfg.n_samples
    gen = torch.Generator().manual_seed(6)
    draws = [make(gen, C)(t) for t in range(total)]
    inits = {"x": torch.from_numpy(np.random.RandomState(2).randn(C, 3).astype(np.float32))}
    lp = torch_corr if name == "hmc_dense" else torch_diag
    calls = {"n": 0}

    def counted(q):
        calls["n"] += 1
        return lp(q)

    carried = sample_fn(counted, inits, None, cfg, lambda t: draws[t])
    n_carried = calls["n"]
    step = hmc.leapfrog_step

    def recomputing(vg, q, p, grad, eps, m_inv, dense, scale=None):
        _, fresh = vg(q)
        return step(vg, q, p, fresh, eps, m_inv, dense, scale)

    for module in (hmc, nuts):  # tempering steps through hmc.hmc_transition
        monkeypatch.setattr(module, "leapfrog_step", recomputing)
    calls["n"] = 0
    stepwise = sample_fn(counted, inits, None, cfg, lambda t: draws[t])
    assert torch.equal(carried[0]["x"], stepwise[0]["x"])
    for k in carried[1]:
        assert torch.equal(carried[1][k], stepwise[1][k]), k
    assert calls["n"] == 2 * n_carried - 1  # the start's one evaluation is shared
