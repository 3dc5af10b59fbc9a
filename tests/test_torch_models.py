"""Parity of the PyTorch port's models with the JAX package, on the CPU.

Both packages get the same parameters (``whvi_tpu_torch.convert``) and the
same posterior noise as numpy arrays: JAX keys and torch generators give
different streams, so noise is never drawn on both sides.

Tolerance: ``max|port - ref| / max|ref| <= 1e-5`` in fp32 (same
arithmetic up to summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whvi_tpu.models import ColumnMatrix as JaxColumnMatrix
from whvi_tpu.models import SquarePow2Matrix as JaxSquarePow2Matrix
from whvi_tpu.models import StackedMatrix as JaxStackedMatrix
from whvi_tpu.models import WHVILinear as JaxWHVILinear
from whvi_tpu.models import WHVIRegression as JaxWHVIRegression
from whvi_tpu.models import mlp_layers as jax_mlp_layers
from whvi_tpu.models import setup_dimensions as jax_setup_dimensions

from whvi_tpu_torch.convert import export_params, load_jax_params
from whvi_tpu_torch.models import (
    ColumnMatrix,
    SquarePow2Matrix,
    StackedMatrix,
    WHVILinear,
    WHVIRegression,
    mlp_layers,
    setup_dimensions,
)

torch.set_num_threads(1)

F32_TOL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t(a):
    return torch.tensor(np.asarray(a))


def _random_matrix_params(shape, rng):
    """Parameters away from the init's zeros and 0.01 scales."""
    return {
        "s1": (0.5 * rng.randn(*shape)).astype(np.float32),
        "s2": (0.5 * rng.randn(*shape)).astype(np.float32),
        "g_mu": rng.randn(*shape).astype(np.float32),
        "g_rho": rng.uniform(-3.0, -1.0, size=shape).astype(np.float32),
    }


def _load_matrix(module, params):
    with torch.no_grad():
        for name, value in params.items():
            getattr(module, name).copy_(t(value))


# (port matrix, JAX matrix, x's last dim)
MATRICES = {
    "square16": (lambda: SquarePow2Matrix(16, 2.0), JaxSquarePow2Matrix(16, 2.0), 16),
    "square128": (lambda: SquarePow2Matrix(128), JaxSquarePow2Matrix(128), 128),
    "stacked13x20": (lambda: StackedMatrix(13, 20, 3.0), JaxStackedMatrix(13, 20, 3.0), 13),
    "stacked3x16": (lambda: StackedMatrix(3, 16), JaxStackedMatrix(3, 16), 3),
    "column20": (lambda: ColumnMatrix(20), JaxColumnMatrix(20), 1),
    "row20": (lambda: ColumnMatrix(20, transposed=True), JaxColumnMatrix(20, transposed=True), 20),
    "row128": (lambda: ColumnMatrix(128, 1e-5, transposed=True), JaxColumnMatrix(128, 1e-5, transposed=True), 128),
}


def _matrix_pair(name, seed=0):
    make, jm, n_in = MATRICES[name]
    pm = make()
    rng = np.random.RandomState(seed)
    params = _random_matrix_params(tuple(pm.g_mu.shape), rng)
    _load_matrix(pm, params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    x = rng.randn(6, n_in).astype(np.float32)
    return pm, jm, jparams, x, rng


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_matrix_apply_given_g_and_kl_match_jax(name):
    pm, jm, jparams, x, rng = _matrix_pair(name)
    g = rng.randn(*pm.g_mu.shape).astype(np.float32)
    got = pm.apply_given_g(t(x), t(g)).detach().numpy()
    want = jm.apply_given_g(jparams, jnp.asarray(x), jnp.asarray(g))
    assert rel_err(got, want) <= F32_TOL
    assert rel_err(pm.kl().detach().numpy(), jm.kl(jparams)) <= F32_TOL
    if isinstance(pm, ColumnMatrix):
        got = pm.column_given_g(t(g)).detach().numpy()
        assert rel_err(got, jm.column_given_g(jparams, jnp.asarray(g))) <= F32_TOL


@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("name", ["square16", "stacked13x20"])
def test_lrt_apply_equals_apply_given_g(name, per_example):
    """JAX ``apply`` with a key equals ``apply_given_g(mu + softplus(rho)
    * eps)`` for the eps that key draws; the port's forward with that eps
    (carried on a leading sample axis of 1) equals it too."""
    pm, jm, jparams, x, _ = _matrix_pair(name, seed=1)
    key = jax.random.PRNGKey(7)
    shape = (x.shape[:-1] if per_example else ()) + tuple(pm.g_mu.shape)
    eps = np.asarray(jax.random.normal(key, shape, jnp.float32))
    want = jm.apply(jparams, jnp.asarray(x), key, lrt=True, per_example_noise=per_example)
    g = jparams["g_mu"] + jax.nn.softplus(jparams["g_rho"]) * jnp.asarray(eps)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jm.apply_given_g(jparams, jnp.asarray(x), g))
    )
    x1 = t(x)[None]  # (S=1, B, n_in)
    eps1 = t(eps)[None] if per_example else t(eps)[None, None]
    assert tuple(eps1.shape) == pm.noise_shape(x1, per_example)
    got = pm(x1, per_example_noise=per_example, eps=eps1)[0].detach().numpy()
    assert rel_err(got, want) <= F32_TOL


def test_forward_draws_from_the_generator():
    pm = StackedMatrix(13, 20)
    x = torch.randn(3, 5, 13)
    a = pm(x, torch.Generator().manual_seed(0))
    b = pm(x, torch.Generator().manual_seed(0))
    c = pm(x, torch.Generator().manual_seed(1))
    assert a.shape == (3, 5, 20)
    assert torch.equal(a, b) and not torch.equal(a, c)
    col = ColumnMatrix(20, transposed=True)
    gen = torch.Generator().manual_seed(0)
    cols = col.sample_column((3,), gen)
    assert cols.shape == (3, 20)
    g = col.sample_g((3,), torch.Generator().manual_seed(0))
    assert torch.equal(cols, col.column_given_g(g))


@pytest.mark.parametrize(
    "n_in,n_out", [(3, 16), (13, 128), (128, 128), (8, 10), (13, 20), (1, 5)]
)
def test_setup_dimensions_matches_jax(n_in, n_out):
    assert setup_dimensions(n_in, n_out) == jax_setup_dimensions(n_in, n_out)


@pytest.mark.parametrize(
    "n_in,n_out,kind",
    [(1, 5, ColumnMatrix), (5, 1, ColumnMatrix), (8, 8, SquarePow2Matrix), (5, 9, StackedMatrix)],
)
def test_layer_dispatch_matches_jax(n_in, n_out, kind):
    layer = WHVILinear(n_in, n_out)
    assert isinstance(layer.matrix, kind)
    assert type(JaxWHVILinear(n_in, n_out).matrix).__name__ == kind.__name__


# ---------------------------------------------------------------- whole net

S, B, N_DATA = 3, 10, 40


def _nets(seed=0, bias=False):
    jnet = JaxWHVIRegression(jax_mlp_layers(13, 1, hidden=(32, 32), bias=bias), train_samples=S)
    pnet = WHVIRegression(mlp_layers(13, 1, hidden=(32, 32), bias=bias), train_samples=S)
    jparams = jnet.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    layers = []
    for p in jparams["layers"]:
        q = _random_matrix_params(p["g_mu"].shape, rng) if p else {}
        if "bias" in p:
            q["bias"] = (0.1 * rng.randn(*p["bias"].shape)).astype(np.float32)
        layers.append(q)
    params = {"layers": tuple(layers), "likelihood": {"rho": np.float32(-0.3)}}
    load_jax_params(pnet, params)
    return jnet, pnet, jax.tree.map(jnp.asarray, params), rng


def _eps(pnet, rng):
    """Shared noise per sample for each WHVI layer: (S, 1) + g_mu.shape."""
    return [
        rng.randn(S, 1, *layer.matrix.g_mu.shape).astype(np.float32)
        if isinstance(layer, WHVILinear) else None
        for layer in pnet.layers
    ]


def _jax_loss(jnet, params, x, y, eps, weights, kl_scale):
    """The MC-ELBO from the JAX package's public pieces, one Python pass
    per MC sample with the given noise."""
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
    y_hat = jnp.stack(preds)
    mnll = jnet.likelihood.mnll(params["likelihood"], y, y_hat, N_DATA, weights=weights)
    return mnll + kl_scale * jnet.kl(params), y_hat


def _port_grads(pnet) -> dict:
    """Parameter gradients in the JAX pytree layout."""
    grads = {"layers": [], "likelihood": {"rho": pnet.likelihood.rho.grad.numpy()}}
    for layer in pnet.layers:
        entry = {}
        if isinstance(layer, WHVILinear):
            for k in ("s1", "s2", "g_mu", "g_rho"):
                entry[k] = getattr(layer.matrix, k).grad.numpy()
            if layer.bias is not None:
                entry["bias"] = layer.bias.grad.numpy()
        grads["layers"].append(entry)
    return grads


@pytest.mark.parametrize("bias", [False, True])
def test_whole_net_loss_predictions_and_grads_match_jax(bias):
    jnet, pnet, jparams, rng = _nets(bias=bias)
    x = rng.randn(B, 13).astype(np.float32)
    y = rng.randn(B, 1).astype(np.float32)
    weights = (np.arange(B) < B - 3).astype(np.float32)  # 3 padding rows
    eps = _eps(pnet, rng)
    kl_scale = 0.25

    def loss_fn(params):
        return _jax_loss(
            jnet, params, jnp.asarray(x), jnp.asarray(y),
            [None if e is None else jnp.asarray(e) for e in eps],
            jnp.asarray(weights), kl_scale,
        )

    (jloss, jy_hat), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    peps = [None if e is None else t(e) for e in eps]
    ploss, aux = pnet.loss(
        t(x), t(y), N_DATA, kl_scale=kl_scale, weights=t(weights), eps=peps
    )
    ploss.backward()
    assert rel_err(ploss.detach().numpy(), jloss) <= F32_TOL
    with torch.no_grad():  # the y-only launch path
        py_hat = pnet.predict(t(x), S, eps=peps)
    assert py_hat.shape == (S, B, 1)
    assert rel_err(py_hat.numpy(), jy_hat) <= F32_TOL
    pgrads = _port_grads(pnet)
    flat_p = jax.tree_util.tree_flatten_with_path(pgrads)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        {"layers": list(jgrads["layers"]), "likelihood": jgrads["likelihood"]}
    )[0])
    assert len(flat_p) == len(flat_j)
    for path, g in flat_p:
        assert rel_err(g, flat_j[path]) <= F32_TOL, jax.tree_util.keystr(path)


def test_convert_round_trip():
    jnet, pnet, jparams, _ = _nets(seed=3, bias=True)
    back = export_params(pnet)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_flatten_with_path(back)[0],
        jax.tree_util.tree_flatten_with_path(jparams)[0],
    ):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    with pytest.raises(ValueError):
        load_jax_params(pnet, {"layers": jparams["layers"][:-1], "likelihood": {}})


def test_metrics_from_predictions_match_jax():
    jnet, pnet, jparams, rng = _nets(seed=4)
    y = rng.randn(B, 1).astype(np.float32)
    y_hat = (y[None] + 0.7 * rng.randn(16, B, 1)).astype(np.float32)
    want = jnet.metrics_from_predictions(jparams, jnp.asarray(y), jnp.asarray(y_hat))
    got = pnet.metrics_from_predictions(t(y), t(y_hat))
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].detach().numpy(), want[k]) <= F32_TOL, k
