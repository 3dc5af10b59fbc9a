"""Parity of the port's model family with the JAX package, on the CPU: the
data sets, the padded and column-LRT matrices, ``sample_W``, ``Dense``,
``Parallel``, the activations, the heteroscedastic and categorical
likelihoods, the split-head and classification networks, and the nested
parameter pytrees of ``convert``.

Both packages get the same parameters and the same posterior noise as
numpy arrays (JAX keys and torch generators give different streams).
Tolerance: ``max|port - ref| / max|ref| <= 1e-5`` in fp32; the data sets
are bit-equal (both draw from numpy's ``RandomState``).
"""

import gzip
import importlib.util
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whvi_tpu.data.mnist as jax_mnist
import whvi_tpu.data.toy as jax_toy
import whvi_tpu.models as jm
from whvi_tpu.evaluation import ProtocolConfig, _build_net

import whvi_tpu_torch.data.mnist as port_mnist
import whvi_tpu_torch.data.toy as port_toy
import whvi_tpu_torch.models as pm
from whvi_tpu_torch.convert import export_params, load_jax_params, param_tree
from whvi_tpu_torch.experiments.run_baseline_configs import synthetic_hetero_data

torch.set_num_threads(1)

F32_TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t(a):
    return torch.tensor(np.asarray(a))


def _random_leaf(path, leaf, rng):
    """A parameter away from the init's zeros and small scales."""
    name = path[-1].key
    shape = np.shape(leaf)
    if name == "g_rho":
        return rng.uniform(-3.0, -1.0, size=shape).astype(np.float32)
    scale = {"s1": 0.5, "s2": 0.5, "g_mu": 1.0, "w": 0.3}.get(name, 0.1)
    return (scale * rng.randn(*shape)).astype(np.float32)


def _random_params(jparams, rng):
    return jax.tree_util.tree_map_with_path(lambda p, l: _random_leaf(p, l, rng), jparams)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 3])
def test_toy_data_is_bit_equal_to_jax(seed):
    for got, want in zip(jax.tree.leaves(port_toy.cubic_data(seed=seed)),
                         jax.tree.leaves(jax_toy.cubic_data(seed=seed))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_toy.polynomial_data(seed=seed), jax_toy.polynomial_data(seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_toy.POLY_COEFFS, jax_toy.POLY_COEFFS)
    x = np.linspace(-1, 2, 7)
    np.testing.assert_array_equal(port_toy.polynomial_f(x), jax_toy.polynomial_f(x))


def _jax_baseline_configs():
    """``experiments/run_baseline_configs.py`` as a module (the JAX script)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_baseline_configs", os.path.join(ROOT, "experiments", "run_baseline_configs.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_sets_are_bit_equal_to_jax(seed):
    got = port_mnist.synthetic_classification(n_train=64, n_test=16, n_in=20, seed=seed)
    want = jax_mnist.synthetic_classification(n_train=64, n_test=16, n_in=20, seed=seed)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jax_script = _jax_baseline_configs()
    for a, b in zip(synthetic_hetero_data(n=100, seed=seed),
                    jax_script.synthetic_hetero_data(n=100, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _write_idx(path, array, gz=False):
    header = bytes([0, 0, 8, array.ndim]) + struct.pack(f">{array.ndim}I", *array.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def test_idx_reader_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    files = {
        "train-images-idx3-ubyte": rng.randint(0, 256, size=(5, 4, 3)),
        "train-labels-idx1-ubyte.gz": rng.randint(0, 10, size=5),
        "t10k-images.idx3-ubyte.gz": rng.randint(0, 256, size=(2, 4, 3)),
        "t10k-labels.idx1-ubyte": rng.randint(0, 10, size=2),
    }
    for module in (port_mnist, jax_mnist):
        monkeypatch.setattr(module, "_SEARCH_DIRS", [str(tmp_path)])
    assert not port_mnist.mnist_available() and not jax_mnist.mnist_available()
    with pytest.raises(FileNotFoundError):
        port_mnist.load_mnist()
    for name, array in files.items():
        _write_idx(tmp_path / name, array, gz=name.endswith(".gz"))
        path = str(tmp_path / name)
        np.testing.assert_array_equal(port_mnist._read_idx(path), jax_mnist._read_idx(path))
        np.testing.assert_array_equal(port_mnist._read_idx(path), array)
    assert port_mnist.mnist_available() and jax_mnist.mnist_available()
    for flatten in (True, False):
        got, want = port_mnist.load_mnist(flatten), jax_mnist.load_mnist(flatten)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- matrices

# (port matrix, JAX matrix, x's last dim)
MATRICES = {
    "square16": (lambda: pm.SquarePow2Matrix(16, 2.0), jm.SquarePow2Matrix(16, 2.0), 16),
    "stacked13x20": (lambda: pm.StackedMatrix(13, 20, 3.0), jm.StackedMatrix(13, 20, 3.0), 13),
    "padded6x20": (lambda: pm.PaddedSquareMatrix(6, 20, 3.0), jm.PaddedSquareMatrix(6, 20, 3.0), 6),
    "padded20x6": (lambda: pm.PaddedSquareMatrix(20, 6), jm.PaddedSquareMatrix(20, 6), 20),
    "padded13x128": (lambda: pm.PaddedSquareMatrix(13, 128, 2.0), jm.PaddedSquareMatrix(13, 128, 2.0), 13),
    "column20": (lambda: pm.ColumnMatrix(20), jm.ColumnMatrix(20), 1),
    "row20": (lambda: pm.ColumnMatrix(20, transposed=True), jm.ColumnMatrix(20, transposed=True), 20),
}


def _matrix_pair(name, seed=0):
    make, jmat, n_in = MATRICES[name]
    pmat = make()
    rng = np.random.RandomState(seed)
    params = _random_params(jmat.init(jax.random.PRNGKey(0)), rng)
    with torch.no_grad():
        for k, v in params.items():
            getattr(pmat, k).copy_(t(v))
    x = rng.randn(6, n_in).astype(np.float32)
    return pmat, jmat, jax.tree.map(jnp.asarray, params), x, rng


@pytest.mark.parametrize("name", ["padded6x20", "padded20x6", "padded13x128"])
def test_padded_matrix_apply_given_g_and_kl_match_jax(name):
    pmat, jmat, jparams, x, rng = _matrix_pair(name)
    assert tuple(pmat.g_mu.shape) == (jmat.D,) and pmat.D == jmat.D
    for g_lead in ((), (6,)):  # one g, and one per row
        g = rng.randn(*g_lead, jmat.D).astype(np.float32)
        got = pmat.apply_given_g(t(x), t(g), per_example_noise=bool(g_lead)).detach().numpy()
        want = jmat.apply_given_g(jparams, jnp.asarray(x), jnp.asarray(g))
        assert got.shape == (6, jmat.n_out)
        assert rel_err(got, want) <= F32_TOL
    assert rel_err(pmat.kl().detach().numpy(), jmat.kl(jparams)) <= F32_TOL


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("per_example", [False, True])
def test_column_lrt_forward_matches_jax_apply(per_example, transposed):
    """JAX ``apply`` with a key against the port's forward with the noise
    that key draws: one column a batch row with ``per_example_noise``, one
    explicit column otherwise."""
    n = 20
    jmat = jm.ColumnMatrix(n, transposed=transposed, use_lrt=True)
    pmat = pm.ColumnMatrix(n, transposed=transposed, use_lrt=True)
    rng = np.random.RandomState(2)
    params = _random_params(jmat.init(jax.random.PRNGKey(0)), rng)
    with torch.no_grad():
        for k, v in params.items():
            getattr(pmat, k).copy_(t(v))
    x = rng.randn(7, n if transposed else 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    shape = (x.shape[:-1] if per_example else ()) + (jmat.D_adj,)
    eps = np.asarray(jax.random.normal(key, shape, jnp.float32))
    want = jmat.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), key, lrt=True,
                      per_example_noise=per_example)
    x1 = t(x)[None]  # (S=1, B, n_in)
    eps1 = t(eps)[None] if per_example else t(eps)[None, None]
    assert tuple(eps1.shape) == pmat.noise_shape(x1, per_example)
    got = pmat(x1, per_example_noise=per_example, eps=eps1)[0].detach().numpy()
    assert rel_err(got, want) <= F32_TOL
    # without use_lrt the column stays one explicit sample, as the reference
    shared = pm.ColumnMatrix(n, transposed=transposed)
    assert shared.noise_shape(x1, True) == (1, 1, jmat.D_adj)


SAMPLE_W = {
    **{k: MATRICES[k] for k in ("square16", "stacked13x20", "padded6x20", "padded20x6",
                                "column20", "row20")},
    "stacked3x16": (lambda: pm.StackedMatrix(3, 16), jm.StackedMatrix(3, 16), 3),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_W))
def test_sample_W_matches_jax_and_apply_given_g(name):
    """The dense ``(n_out, n_in)`` sample on the noise a JAX key draws, and
    ``x @ W.T == apply_given_g(x, g)`` for that ``g``."""
    make, jmat, n_in = SAMPLE_W[name]
    pmat = make()
    rng = np.random.RandomState(4)
    params = _random_params(jmat.init(jax.random.PRNGKey(0)), rng)
    with torch.no_grad():
        for k, v in params.items():
            getattr(pmat, k).copy_(t(v))
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, params["g_mu"].shape, jnp.float32))
    want = jmat.sample_W(jax.tree.map(jnp.asarray, params), key)
    W = pmat.sample_W(eps=t(eps)).detach()
    assert W.shape == (jmat.n_out, jmat.n_in)
    assert rel_err(W.numpy(), want) <= F32_TOL
    g = pmat.g_mu + pmat.g_sigma() * t(eps)
    x = t(rng.randn(5, n_in).astype(np.float32))
    assert rel_err((x @ W.T).numpy(), pmat.apply_given_g(x, g).detach().numpy()) <= F32_TOL
    a = pmat.sample_W(torch.Generator().manual_seed(0))
    assert torch.equal(a, pmat.sample_W(torch.Generator().manual_seed(0)))


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("n_in,n_out,rect_mode", [(13, 20, "stack"), (6, 20, "pad"), (16, 16, "pad"), (20, 1, "stack")])
def test_layer_apply_given_g_and_sample_W_with_bias_match_jax(n_in, n_out, rect_mode):
    jl = jm.WHVILinear(n_in, n_out, 2.0, bias=True, rect_mode=rect_mode)
    pl = pm.WHVILinear(n_in, n_out, 2.0, bias=True, rect_mode=rect_mode)
    assert type(pl.matrix).__name__ == type(jl.matrix).__name__
    rng = np.random.RandomState(6)
    params = _random_params(jl.init(jax.random.PRNGKey(0)), rng)
    with torch.no_grad():
        for k, v in params.items():
            (pl.bias if k == "bias" else getattr(pl.matrix, k)).copy_(t(v))
    jparams = jax.tree.map(jnp.asarray, params)
    x = rng.randn(4, n_in).astype(np.float32)
    g = rng.randn(*params["g_mu"].shape).astype(np.float32)
    got = pl.apply_given_g(t(x), t(g)).detach().numpy()
    assert rel_err(got, jl.apply_given_g(jparams, jnp.asarray(x), jnp.asarray(g))) <= F32_TOL
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, params["g_mu"].shape, jnp.float32))
    assert rel_err(pl.sample_W(eps=t(eps)).detach().numpy(), jl.sample_W(jparams, key)) <= F32_TOL


@pytest.mark.parametrize(
    "n_in,n_out,rect_mode,kind",
    [(6, 20, "pad", "PaddedSquareMatrix"), (6, 20, "stack", "StackedMatrix"),
     (20, 6, "pad", "PaddedSquareMatrix"), (8, 8, "pad", "SquarePow2Matrix"),
     (1, 5, "pad", "ColumnMatrix"), (5, 1, "pad", "ColumnMatrix")],
)
def test_rect_mode_dispatch_matches_jax(n_in, n_out, rect_mode, kind):
    assert type(pm.WHVILinear(n_in, n_out, rect_mode=rect_mode).matrix).__name__ == kind
    assert type(jm.WHVILinear(n_in, n_out, rect_mode=rect_mode).matrix).__name__ == kind


def test_bad_rect_mode_raises_in_both():
    with pytest.raises(ValueError, match="rect_mode"):
        jm.WHVILinear(6, 20, rect_mode="tile")
    with pytest.raises(ValueError, match="rect_mode"):
        pm.WHVILinear(6, 20, rect_mode="tile")


def test_column_lrt_reaches_the_column_matrix():
    layer = pm.WHVILinear(20, 1, per_example_noise=True, column_lrt=True)
    assert layer.matrix.use_lrt
    x = torch.randn(3, 7, 20)
    assert layer.matrix.noise_shape(x, True) == (3, 7, 32)
    assert layer(x, torch.Generator().manual_seed(0)).shape == (3, 7, 1)
    plain = pm.WHVILinear(20, 1, per_example_noise=True)
    assert not plain.matrix.use_lrt and plain.matrix.noise_shape(x, True) == (3, 1, 32)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_matches_jax(bias):
    jd, pd = jm.Dense(7, 5, bias=bias), pm.Dense(7, 5, bias=bias)
    jparams = jd.init(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in jparams.items()} == {k: tuple(v.shape) for k, v in param_tree_of(pd).items()}
    # the init: U(-1/sqrt(n_in), 1/sqrt(n_in)), bias zero, KL zero
    pd.reset_parameters(torch.Generator().manual_seed(0))
    bound = 1 / np.sqrt(7)
    assert pd.w.abs().max() <= bound and pd.w.abs().max() > 0.5 * bound
    if bias:
        assert torch.equal(pd.b, torch.zeros(5))
    assert float(pd.kl()) == 0.0 == float(jd.kl(jparams))
    rng = np.random.RandomState(1)
    params = _random_params(jparams, rng)
    load_jax_params_layer(pd, params)
    x = rng.randn(3, 4, 7).astype(np.float32)
    want = jd.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), None)
    got = pd(t(x)).detach().numpy()
    assert rel_err(got, want) <= F32_TOL


def param_tree_of(layer):
    """One layer's entry of ``convert.param_tree``."""
    return param_tree(pm.WHVINetwork([layer], pm.CategoricalLikelihood()))["layers"][0]


def load_jax_params_layer(layer, params):
    load_jax_params(pm.WHVINetwork([layer], pm.CategoricalLikelihood()),
                    {"layers": (params,), "likelihood": {}})


def _split_heads(kw):
    return (
        jm.Parallel((jm.WHVILinear(16, 1, 1e-5, **kw), jm.WHVILinear(16, 3, 1.0, **kw))),
        pm.Parallel([pm.WHVILinear(16, 1, 1e-5, **kw), pm.WHVILinear(16, 3, 1.0, **kw)]),
    )


def test_parallel_matches_jax_branches_on_given_noise():
    """Branch outputs concatenated, on per-branch noise, against the JAX
    branches composed by ``apply_given_g``; KL the sum; the generator
    draws the branches' noise in branch order."""
    jp, pp = _split_heads(dict(s_init="auto", per_example_noise=True, column_lrt=True))
    rng = np.random.RandomState(3)
    params = _random_params(jp.init(jax.random.PRNGKey(0)), rng)
    load_jax_params_layer(pp, params)
    jparams = jax.tree.map(jnp.asarray, params)
    S, B = 2, 5
    x = rng.randn(S, B, 16).astype(np.float32)
    eps = tuple(rng.randn(*b.matrix.noise_shape(t(x), True)).astype(np.float32) for b in pp.branches)
    assert eps[0].shape == (S, B, 16) and eps[1].shape == (S, B, 1, 16)
    got = pp(t(x), eps=tuple(map(t, eps))).detach().numpy()
    want = []
    for s in range(S):
        outs = []
        for b, p, e in zip(jp.branches, jparams["branches"], eps):
            g = p["g_mu"] + jax.nn.softplus(p["g_rho"]) * e[s]
            outs.append(b.apply_given_g(p, jnp.asarray(x[s]), g))
        want.append(jnp.concatenate(outs, axis=-1))
    assert got.shape == (S, B, 4)
    assert rel_err(got, np.stack(want)) <= F32_TOL
    assert rel_err(pp.kl().detach().numpy(), jp.kl(jparams)) <= F32_TOL
    a = pp(t(x), torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    drawn = tuple(torch.randn(e.shape, generator=gen) for e in eps)
    assert torch.equal(a, pp(t(x), eps=drawn))
    with pytest.raises(ValueError, match="one entry per branch"):
        pp(t(x), eps=drawn[:1])


@pytest.mark.parametrize("name", ["relu", "cosine", "sigmoid", "tanh"])
def test_activations_match_jax(name):
    x = np.linspace(-3, 3, 25, dtype=np.float32).reshape(5, 5)
    want = getattr(jm, name).apply({}, jnp.asarray(x), None)
    got = getattr(pm, name)(t(x)).numpy()
    assert rel_err(got, want) <= F32_TOL
    assert getattr(pm, name).kl() == 0.0


# ------------------------------------------------------------ likelihoods

S, B, N_DATA = 4, 9, 50


@pytest.mark.parametrize("sigma0", [1.0, 0.3, 1e-5])
def test_heteroscedastic_likelihood_matches_jax(sigma0):
    """``sigma0 = 1e-5`` sits below ``sigma_min``: both clamp the shift at
    ``inv_softplus(1e-6)``."""
    jl, pl = jm.HeteroscedasticGaussianLikelihood(sigma0=sigma0), pm.HeteroscedasticGaussianLikelihood(sigma0=sigma0)
    assert jl.init() == {} and list(pl.parameters()) == []
    rng = np.random.RandomState(0)
    y = rng.randn(B, 2).astype(np.float32)
    y_hat = rng.randn(S, B, 4).astype(np.float32)
    w = (np.arange(B) < B - 3).astype(np.float32)  # 3 padding rows
    args_j, args_p = (jnp.asarray(y), jnp.asarray(y_hat)), (t(y), t(y_hat))
    for got, want in zip(pl.split(args_p[1]), jl.split(args_j[1])):
        assert rel_err(got.numpy(), want) <= F32_TOL
    assert rel_err(pl.mnll(*args_p, N_DATA, weights=t(w)).numpy(),
                   jl.mnll({}, *args_j, N_DATA, weights=jnp.asarray(w))) <= F32_TOL
    assert rel_err(pl.mnll(*args_p, N_DATA).numpy(), jl.mnll({}, *args_j, N_DATA)) <= F32_TOL
    assert rel_err(pl.log_prob(*args_p).numpy(), jl.log_prob({}, *args_j)) <= F32_TOL
    for got, want in zip(pl.predict(args_p[1]), jl.predict({}, args_j[1])):
        assert rel_err(got.numpy(), want) <= F32_TOL
    # padding rows carry no weight: the padded batch's estimate is the real rows'
    real = pl.mnll(t(y[: B - 3]), t(y_hat[:, : B - 3]), N_DATA)
    assert rel_err(pl.mnll(*args_p, N_DATA, weights=t(w)).numpy(), real.numpy()) <= F32_TOL
    with pytest.raises(ValueError):
        pl.split(t(y_hat[..., :3]))


@pytest.mark.parametrize("labels", ["int (B,)", "int (B, 1)", "float (B, 1)"])
def test_categorical_likelihood_matches_jax(labels):
    jl, pl = jm.CategoricalLikelihood(), pm.CategoricalLikelihood()
    assert jl.init() == {} and list(pl.parameters()) == []
    rng = np.random.RandomState(1)
    y = rng.randint(0, 6, size=B)
    y_port = {"int (B,)": y, "int (B, 1)": y[:, None], "float (B, 1)": y[:, None].astype(np.float32)}[labels]
    y_hat = (2 * rng.randn(S, B, 6)).astype(np.float32)
    w = (np.arange(B) < B - 2).astype(np.float32)
    yj, yp = jnp.asarray(y[:, None].astype(np.int32)), t(y_port)
    assert rel_err(pl.mnll(yp, t(y_hat), N_DATA, weights=t(w)).numpy(),
                   jl.mnll({}, yj, jnp.asarray(y_hat), N_DATA, weights=jnp.asarray(w))) <= F32_TOL
    assert rel_err(pl.mnll(yp, t(y_hat), N_DATA).numpy(),
                   jl.mnll({}, jnp.asarray(y), jnp.asarray(y_hat), N_DATA)) <= F32_TOL
    assert rel_err(pl.log_prob(yp, t(y_hat)).numpy(), jl.log_prob({}, yj, jnp.asarray(y_hat))) <= F32_TOL
    probs = pl.predict(t(y_hat)).numpy()
    assert probs.shape == (B, 6)
    assert rel_err(probs, jl.predict({}, jnp.asarray(y_hat))) <= F32_TOL
    real = pl.mnll(yp[: B - 2], t(y_hat[:, : B - 2]), N_DATA)
    assert rel_err(pl.mnll(yp, t(y_hat), N_DATA, weights=t(w)).numpy(), real.numpy()) <= F32_TOL


# --------------------------------------------------------------- networks


def _jax_layer(layer, p, h, e):
    """One JAX layer on one MC sample's noise ``e`` (None: deterministic)."""
    if isinstance(layer, jm.Parallel):
        return jnp.concatenate(
            [_jax_layer(b, bp, h, be) for b, bp, be in zip(layer.branches, p["branches"], e)], axis=-1)
    if e is None:
        return layer.apply(p, h, None)
    return layer.apply_given_g(p, h, p["g_mu"] + jax.nn.softplus(p["g_rho"]) * e)


def _sample(e, s):
    if e is None:
        return None
    if isinstance(e, tuple):
        return tuple(_sample(x, s) for x in e)
    return jnp.asarray(e[s])


def _given_noise(pnet, x, rng):
    """Noise of each layer's shape on ``x (S, B, n_in)``, in layer order."""
    def noise(layer):
        if isinstance(layer, pm.Parallel):
            return tuple(noise(b) for b in layer.branches)
        if not isinstance(layer, pm.WHVILinear):
            return None
        xs = torch.empty(x.shape[0], x.shape[1], layer.n_in)
        return rng.randn(*layer.matrix.noise_shape(xs, layer.lrt and layer.per_example_noise)).astype(np.float32)
    return [noise(layer) for layer in pnet.layers]


def _to_torch(e):
    if e is None:
        return None
    return tuple(map(_to_torch, e)) if isinstance(e, tuple) else t(e)


def _split_head_nets(bias=False):
    """A small split-head net as ``whvi_tpu/evaluation.py:169-240`` builds it
    (heteroscedastic, rect_mode "pad", per-example noise, column LRT)."""
    cfg = ProtocolConfig(hidden=(16, 16), heteroscedastic=True, rect_mode="pad", bias=bias,
                         per_example_noise=True, column_lrt=True, sigma0=0.3, train_samples=S)
    jnet = _build_net(cfg, 5, 1)
    kw = dict(s_init="auto", per_example_noise=True, column_lrt=True, rect_mode="pad", bias=bias)
    pnet = pm.WHVINetwork(
        [pm.WHVILinear(5, 16, 3.0, **kw), pm.relu, pm.WHVILinear(16, 16, 3.0, **kw), pm.relu,
         pm.Parallel([pm.WHVILinear(16, 1, 1e-5, **kw), pm.WHVILinear(16, 1, 1.0, **kw)])],
        pm.HeteroscedasticGaussianLikelihood(sigma0=0.3), train_samples=S,
    )
    return jnet, pnet


@pytest.mark.parametrize("bias", [False, True])
def test_split_head_net_loss_predictions_and_grads_match_jax(bias):
    jnet, pnet = _split_head_nets(bias)
    rng = np.random.RandomState(8)
    params = _random_params(jnet.init(jax.random.PRNGKey(0)), rng)
    load_jax_params(pnet, params)
    jparams = jax.tree.map(jnp.asarray, params)
    x = rng.randn(B, 5).astype(np.float32)
    y = rng.randn(B, 1).astype(np.float32)
    w = (np.arange(B) < B - 2).astype(np.float32)
    eps = _given_noise(pnet, np.empty((S, B)), rng)
    assert eps[0].shape == (S, B, 16) and eps[-1][1].shape == (S, B, 16)

    def loss_fn(params):
        preds = []
        for s in range(S):
            h = jnp.asarray(x)
            for layer, p, e in zip(jnet.layers, params["layers"], eps):
                h = _jax_layer(layer, p, h, _sample(e, s))
            preds.append(h)
        y_hat = jnp.stack(preds)
        mnll = jnet.likelihood.mnll({}, jnp.asarray(y), y_hat, N_DATA, weights=jnp.asarray(w))
        return mnll + 0.5 * jnet.kl(params), y_hat

    (jloss, jy_hat), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    peps = [_to_torch(e) for e in eps]
    ploss, _ = pnet.loss(t(x), t(y), N_DATA, kl_scale=0.5, weights=t(w), eps=peps)
    ploss.backward()
    assert rel_err(ploss.detach().numpy(), jloss) <= F32_TOL
    with torch.no_grad():
        py_hat = pnet.predict(t(x), S, eps=peps)
    assert py_hat.shape == (S, B, 2)
    assert rel_err(py_hat.numpy(), jy_hat) <= F32_TOL
    pgrads = _flat(jax.tree.map(lambda p: p.grad.numpy(), param_tree(pnet)))
    want = _flat(jgrads)
    assert sorted(pgrads) == sorted(want)
    for k in want:
        assert rel_err(pgrads[k], want[k]) <= F32_TOL, k


@pytest.mark.parametrize("kind", ["classification", "split_head"])
def test_metrics_from_predictions_match_jax(kind):
    """The guards: no RMSE where the widths differ, no coverage where
    ``predict`` gives class probabilities."""
    rng = np.random.RandomState(9)
    if kind == "classification":
        layers = pm.mlp_layers(5, 4, hidden=(8,))
        pnet = pm.WHVIClassification(layers)
        jnet = jm.WHVIClassification(jm.mlp_layers(5, 4, hidden=(8,)))
        assert pnet.eval_samples == jnet.eval_samples == 16
        labels = rng.randint(0, 4, size=B)
        yj, yp = labels[:, None].astype(np.int32), labels[:, None].astype(np.float32)
        y_hat = (2 * rng.randn(16, B, 4)).astype(np.float32)
        keys = {"mnll", "mnll_per_point", "pred_mnll_per_point"}
    else:
        jnet, pnet = _split_head_nets()
        yj = yp = rng.randn(B, 1).astype(np.float32)
        y_hat = rng.randn(16, B, 2).astype(np.float32)
        keys = {"mnll", "mnll_per_point", "pred_mnll_per_point", "coverage95"}
    want = jnet.metrics_from_predictions({"likelihood": {}}, jnp.asarray(yj), jnp.asarray(y_hat))
    got = pnet.metrics_from_predictions(t(yp), t(y_hat))
    assert set(got) == set(want) == keys
    for k in want:
        assert rel_err(got[k].detach().numpy(), want[k]) <= F32_TOL, k


def test_convert_round_trips_nested_pytrees():
    """Dense, a padded layer with bias, a Parallel of a column and a Dense,
    and a likelihood without parameters: JAX params in, the same out."""
    jnet = jm.WHVINetwork(
        (jm.WHVILinear(6, 20, 3.0, bias=True, rect_mode="pad"), jm.tanh, jm.Dense(20, 8),
         jm.sigmoid, jm.Parallel((jm.WHVILinear(8, 1), jm.Dense(8, 1, bias=False)))),
        jm.HeteroscedasticGaussianLikelihood(),
    )
    pnet = pm.WHVINetwork(
        [pm.WHVILinear(6, 20, 3.0, bias=True, rect_mode="pad"), pm.tanh, pm.Dense(20, 8),
         pm.sigmoid, pm.Parallel([pm.WHVILinear(8, 1), pm.Dense(8, 1, bias=False)])],
        pm.HeteroscedasticGaussianLikelihood(),
    )
    params = _random_params(jnet.init(jax.random.PRNGKey(0)), np.random.RandomState(0))
    assert params["likelihood"] == {}
    load_jax_params(pnet, params)
    back = export_params(pnet)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    got, want = _flat(back), _flat(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad = jax.tree.map(lambda a: a, params)
    bad["layers"] = bad["layers"][:-1] + ({"branches": bad["layers"][-1]["branches"][:1]},)
    with pytest.raises(ValueError, match="branches"):
        load_jax_params(pnet, bad)
    bad = jax.tree.map(lambda a: a, params)
    bad["layers"][2]["w"] = np.zeros((8, 20), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(pnet, bad)
    with pytest.raises(ValueError, match="keys"):
        load_jax_params(pnet, {**params, "likelihood": {"rho": np.float32(0.0)}})


def test_models_all_matches_jax():
    assert sorted(pm.__all__) == sorted(jm.__all__)
    for name in pm.__all__:
        assert hasattr(pm, name), name
