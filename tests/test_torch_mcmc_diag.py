"""The port's MCMC diagnostics and warm-up adaptation against the JAX
package's (``whvi_tpu.mcmc.diagnostics``, ``whvi_tpu.mcmc.adapt``) on the
same numpy inputs, on the CPU, and the import rule of the port's mcmc
package."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whvi_tpu.mcmc import adapt as jadapt
from whvi_tpu.mcmc import diagnostics as jdiag
from whvi_tpu_torch.mcmc import adapt, diagnostics

torch.set_num_threads(1)

DIAG_RTOL = 1e-5  # float32 FFTs and sums in two libraries, same formulas
WELFORD_TOL = 1e-6  # the same float32 arithmetic step for step


def _chains(shape, seed):
    """AR(1) chains with a per-chain offset: autocorrelated, so ESS sums
    several Geyer pairs, and R-hat away from 1."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    for t in range(1, shape[1]):
        x[:, t] = 0.7 * x[:, t - 1] + x[:, t]
    offset = 0.3 * rng.randn(shape[0], *([1] * (len(shape) - 1)))
    return (x + offset).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 1000), (4, 999, 3), (1, 500, 2, 2)])
def test_split_rhat_ess_and_summarize_match_jax(shape):
    x = _chains(shape, seed=sum(shape))
    want_rhat = np.asarray(jdiag.split_rhat(jnp.asarray(x)))
    want_ess = np.asarray(jdiag.ess(jnp.asarray(x)))
    got_rhat = diagnostics.split_rhat(torch.from_numpy(x)).numpy()
    got_ess = diagnostics.ess(torch.from_numpy(x)).numpy()
    assert got_rhat.shape == want_rhat.shape and got_ess.shape == want_ess.shape
    np.testing.assert_allclose(got_rhat, want_rhat, rtol=DIAG_RTOL)
    np.testing.assert_allclose(got_ess, want_ess, rtol=DIAG_RTOL)
    tree = {"b": x, "a": {0: x[..., ::-1].copy() if x.ndim > 2 else -x}}
    want = jdiag.summarize({"b": jnp.asarray(tree["b"]), "a": {0: jnp.asarray(tree["a"][0])}})
    got = diagnostics.summarize(
        {"b": torch.from_numpy(tree["b"]), "a": {0: torch.from_numpy(tree["a"][0])}}
    )
    assert list(got) == list(want)  # the same names in the same order
    for name in want:
        for k in ("mean", "sd", "rhat_max", "ess_min"):
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=DIAG_RTOL, atol=1e-6)


@pytest.mark.parametrize("n_warmup", [10, 19, 20, 100, 150, 500, 1500])
def test_warmup_schedule_equals_jax(n_warmup):
    acc, end = adapt.warmup_schedule(n_warmup)
    want_acc, want_end = jadapt.warmup_schedule(n_warmup)
    assert acc.dtype == want_acc.dtype == bool
    np.testing.assert_array_equal(acc, want_acc)
    np.testing.assert_array_equal(end, want_end)


def _draws(seed, n=40, dim=5):
    rng = np.random.RandomState(seed)
    scale = np.array([0.1, 1.0, 3.0, 10.0, 0.5], np.float32)[:dim]
    xs = (rng.randn(n, dim).astype(np.float32) * scale + rng.randn(dim)).astype(np.float32)
    on = rng.rand(n) < 0.7
    return xs, on


@pytest.mark.parametrize("dense", [False, True])
def test_welford_updates_match_jax(dense):
    xs, on = _draws(3)
    j_init, j_upd = (
        (jadapt.welford_cov_init, jadapt.welford_cov_update) if dense
        else (jadapt.welford_init, jadapt.welford_update)
    )
    t_init, t_upd = (
        (adapt.welford_cov_init, adapt.welford_cov_update) if dense
        else (adapt.welford_init, adapt.welford_update)
    )
    js, ts = j_init(5), t_init(5)
    for x, o in zip(xs, on):
        js = j_upd(js, jnp.asarray(x), bool(o))
        ts = t_upd(ts, torch.from_numpy(x), bool(o))
    for got, want in zip(ts, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=WELFORD_TOL, atol=WELFORD_TOL)
    j_est = jadapt.welford_covariance(js) if dense else jadapt.welford_variance(js)
    t_est = adapt.welford_covariance(ts) if dense else adapt.welford_variance(ts)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(j_est), rtol=WELFORD_TOL, atol=WELFORD_TOL)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("at_end", [False, True])
def test_window_updates_match_jax(dense, at_end):
    xs, _ = _draws(4, n=12)
    j_init, j_upd, j_win = (
        (jadapt.welford_cov_init, jadapt.welford_cov_update, jadapt.window_update_dense) if dense
        else (jadapt.welford_init, jadapt.welford_update, jadapt.window_update)
    )
    t_init, t_upd, t_win = (
        (adapt.welford_cov_init, adapt.welford_cov_update, adapt.window_update_dense) if dense
        else (adapt.welford_init, adapt.welford_update, adapt.window_update)
    )
    js, ts = j_init(5), t_init(5)
    for x in xs:
        js = j_upd(js, jnp.asarray(x), True)
        ts = t_upd(ts, torch.from_numpy(x), True)
    m0 = np.eye(5, dtype=np.float32) * 2.0 if dense else np.full(5, 2.0, np.float32)
    js, jm = j_win(js, jnp.asarray(m0), at_end)
    ts, tm = t_win(ts, torch.from_numpy(m0), at_end)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=WELFORD_TOL, atol=WELFORD_TOL)
    for got, want in zip(ts, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=WELFORD_TOL, atol=WELFORD_TOL)


def test_masked_updates_take_a_per_chain_tensor_mask():
    """A bool tensor over the chains masks each chain's accumulator as
    the host bool would alone."""
    xs, _ = _draws(5, n=6)
    x2 = torch.from_numpy(np.stack([xs, 2 * xs], axis=1))  # (n, 2 chains, 5)
    mask = torch.tensor([True, False])
    st = adapt.welford_init(5, lead=(2,))
    for x in x2:
        st = adapt.welford_update(st, x, mask)
    alone = adapt.welford_init(5)
    for x in x2[:, 0]:
        alone = adapt.welford_update(alone, x, True)
    for got, want in zip(st, alone):
        assert torch.equal(got[0], want)
    assert torch.equal(st.count[1], torch.tensor(0.0)) and not st.mean[1].any()
    _, m_inv = adapt.window_update(st, torch.ones(2, 5), mask)
    assert torch.equal(m_inv[0], adapt.welford_variance(alone)) and torch.equal(m_inv[1], torch.ones(5))


def test_mcmc_package_imports_neither_jax_nor_the_jax_package():
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "whvi_tpu_torch", "mcmc")
    files = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert {"__init__.py", "adapt.py", "chains.py", "diagnostics.py", "hmc.py", "nuts.py",
            "tempering.py"} <= set(files)
    for name in files:
        tree = ast.parse(open(os.path.join(root, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "whvi_tpu", "optax"), f"{name} imports {mod}"


def test_mcmc_exports_match_jax():
    import whvi_tpu.mcmc as jm
    import whvi_tpu_torch.mcmc as tm

    assert tm.__all__ == jm.__all__
    for name in tm.__all__:
        assert hasattr(tm, name)
