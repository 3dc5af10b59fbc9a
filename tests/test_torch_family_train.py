"""The port's noise-branch freeze, the padded layer's bf16 mode and the
model family's entry points, against the JAX package, on the CPU.

- ``mask_noise_branch_grads`` and ``validate_split_head`` against JAX's on
  the same gradients and nets; the freeze in ``fit`` leaves the noise
  branch bit-unchanged until its boundary (``torch.equal``).
- The padded layer at batch 1 with per-example noise under the bf16 mode
  against the JAX net under ``set_whvi_mul_backend("pallas")`` (the Pallas
  kernel in interpret mode where JAX sends the product to it): a u drawn
  per example computes fp32 on both sides (1e-5, within the 2^-7 that
  holds the bf16 mode); a shared u is rounded on both (2^-7,
  ``kron_cuda.BF16_TOL``).
- Each new entry point's ``run(..., device="cpu")`` at a tiny size gives
  the JAX script's keys with finite values, and each ``main`` refuses to
  run without a card.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whvi_tpu.models as jm
import whvi_tpu.ops.whvi_op as jax_whvi_op
from whvi_tpu.train.optim import mask_noise_branch_grads as jax_mask_noise_branch_grads
from whvi_tpu.train import TrainConfig as JaxTrainConfig
from whvi_tpu.train import Trainer as JaxTrainer
from whvi_tpu.train.optim import validate_split_head as jax_validate_split_head

import whvi_tpu_torch.models as pm
from whvi_tpu_torch.bench import toy_bench
from whvi_tpu_torch.convert import param_tree
from whvi_tpu_torch.experiments import (
    run_baseline_configs,
    run_mnist,
    run_toy_cubic,
    run_toy_polynomial,
)
from whvi_tpu_torch.ops import get_whvi_mul_precision, kron_cuda, set_whvi_mul_precision
from whvi_tpu_torch.train import (
    TrainConfig,
    Trainer,
    mask_noise_branch_grads,
    validate_split_head,
)

torch.set_num_threads(1)

F32_TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _split_head(lib, n_branches=2, likelihood="hetero", last="parallel"):
    """A 4 -> 8 -> [1 | 1] split-head net of either package (lib: the JAX
    or the port's ``models``), or one of the nets the validator refuses."""
    def make(*a, **kw):
        return lib.WHVILinear(*a, per_example_noise=True, column_lrt=True, s_init="auto", **kw)

    branches = [make(8, 1, 1e-5), make(8, 1, 1.0), make(8, 1, 1.0)][:n_branches]
    if last == "parallel":
        head = lib.Parallel(tuple(branches) if lib is jm else branches)
    else:
        head = make(8, 2, 1e-5)
    lik = (lib.HeteroscedasticGaussianLikelihood(sigma0=0.3) if likelihood == "hetero"
           else lib.GaussianLikelihood())
    layers = [lib.WHVILinear(4, 8, 3.0, rect_mode="pad", per_example_noise=True, s_init="auto"),
              lib.relu, head]
    if lib is jm:
        return jm.WHVINetwork(tuple(layers), lik)
    return pm.WHVINetwork(layers, lik)


@pytest.mark.parametrize("train_noise", [False, True])
def test_mask_noise_branch_grads_matches_jax(train_noise):
    jnet, pnet = _split_head(jm), _split_head(pm)
    rng = np.random.RandomState(0)
    grads = jax.tree.map(lambda a: rng.randn(*np.shape(a)).astype(np.float32),
                         jnet.init(jax.random.PRNGKey(0)))
    for p in pnet.parameters():
        p.grad = torch.zeros_like(p)
    tree = param_tree(pnet)
    for (path, dst), src in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(grads)):
        dst.grad.copy_(t(src))
    mask_noise_branch_grads(pnet, train_noise)
    want = _flat(jax_mask_noise_branch_grads(grads, float(train_noise)))
    got = _flat(jax.tree.map(lambda p: p.grad.numpy(), tree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    noise = got["['layers'][2]['branches'][1]['g_mu']"]
    assert (not noise.any()) == (not train_noise)
    assert got["['layers'][2]['branches'][0]['g_mu']"].any()


@pytest.mark.parametrize(
    "case", ["split_head", "three_branches", "one_branch", "no_parallel", "gaussian"]
)
def test_validate_split_head_raises_where_jax_raises(case):
    kw = {
        "split_head": {}, "three_branches": {"n_branches": 3}, "one_branch": {"n_branches": 1},
        "no_parallel": {"last": "column"}, "gaussian": {"likelihood": "gaussian"},
    }[case]
    jnet, pnet = _split_head(jm, **kw), _split_head(pm, **kw)
    try:
        jax_validate_split_head(jnet)
        jax_raised = False
    except ValueError:
        jax_raised = True
    assert jax_raised == (case != "split_head")
    cfg = dict(epochs1=0, epochs2=1, noise_freeze_steps=4)
    if jax_raised:
        with pytest.raises(ValueError, match="split head"):
            validate_split_head(pnet)
        with pytest.raises(ValueError, match="split head"):
            Trainer(pnet, TrainConfig(**cfg), "cpu")
        with pytest.raises(ValueError, match="split head"):
            JaxTrainer(jnet, JaxTrainConfig(**cfg))
    else:
        validate_split_head(pnet)
        Trainer(pnet, TrainConfig(**cfg), "cpu")
    Trainer(pnet, TrainConfig(epochs1=0, epochs2=1), "cpu")  # no freeze, no check


def test_noise_freeze_is_exact_in_fit():
    """40 rows at batch 8 (5 steps an epoch), the noise branch frozen for 10
    steps: bit-unchanged at every chunk up to step 10, moved after it,
    while the rest of the net trains from the first step."""
    pnet = _split_head(pm)
    cfg = TrainConfig(epochs1=1, epochs2=3, epochs_per_call=1, batch_size=8,
                      kl_warmup_steps=5, noise_freeze_steps=10)
    trainer = Trainer(pnet, cfg, "cpu")
    state = trainer.init(3)
    mean, noise = (list(b.parameters()) for b in pnet.layers[-1].branches)
    noise0 = [p.detach().clone() for p in noise]
    mean0 = [p.detach().clone() for p in mean]
    first0 = pnet.layers[0].matrix.s1.detach().clone()
    seen = []

    def log_fn(entry):
        same = all(torch.equal(p, q) for p, q in zip(noise, noise0))
        seen.append((state.step, same))
        if state.step == 5:
            assert not torch.equal(pnet.layers[0].matrix.s1, first0)
            assert not all(torch.equal(p, q) for p, q in zip(mean, mean0))

    rng = np.random.RandomState(1)
    X = rng.randn(40, 4).astype(np.float32)
    y = rng.randn(40, 1).astype(np.float32)
    trainer.fit(state, X, y, log_fn=log_fn)
    assert seen == [(5, True), (10, True), (15, False), (20, False)]


# ------------------------------------------------ the padded layer in bf16


@pytest.fixture
def bf16_backends():
    """The JAX ``"pallas"`` backend and the port's bf16 mode, restored after."""
    jax_backend, port_precision = jax_whvi_op._BACKEND, get_whvi_mul_precision()
    jax_whvi_op.set_whvi_mul_backend("pallas")
    set_whvi_mul_precision("bf16")
    try:
        yield
    finally:
        jax_whvi_op.set_whvi_mul_backend(jax_backend)
        set_whvi_mul_precision(port_precision)


@pytest.mark.parametrize("per_example", [True, False])
def test_padded_layer_at_batch_1_matches_jax_pallas_backend(per_example, bf16_backends):
    """``WHVILinear(40, 64, rect_mode="pad")`` at batch 1. JAX draws a
    per-example u as (1, D), 2-D, and computes it in fp32 (XLA); a shared
    u (D,) goes to the bf16 Pallas kernel. The port's u is (S, 1, D) either
    way, so the padded matrix must tell whvi_mul that it was drawn per
    example."""
    n_in, n_out, S = 40, 64, 3
    jl = jm.WHVILinear(n_in, n_out, rect_mode="pad", per_example_noise=per_example)
    pl = pm.WHVILinear(n_in, n_out, rect_mode="pad", per_example_noise=per_example)
    assert type(pl.matrix).__name__ == type(jl.matrix).__name__ == "PaddedSquareMatrix"
    rng = np.random.RandomState(21)
    params = {k: rng.randn(64).astype(np.float32) for k in ("s1", "s2", "g_mu", "g_rho")}
    with torch.no_grad():
        for k, v in params.items():
            getattr(pl.matrix, k).copy_(t(v))
    jparams = jax.tree.map(jnp.asarray, params)
    x = rng.randn(S, 1, n_in).astype(np.float32)
    eps = rng.randn(*pl.matrix.noise_shape(t(x), per_example)).astype(np.float32)
    assert eps.shape == (S, 1, 64)
    with torch.no_grad():
        got = pl(t(x), eps=t(eps)).numpy()
        u = (pl.matrix.g_mu + pl.matrix.g_sigma() * t(eps)).numpy()
        rounded = pl.apply_given_g(t(x), t(u)).numpy()  # told nothing: a shared u
    u_jax = [u[s] if per_example else u[s, 0] for s in range(S)]  # (1, D) or (D,)
    want = np.stack([np.asarray(jl.apply_given_g(jparams, jnp.asarray(x[s]), jnp.asarray(u_jax[s])))
                     for s in range(S)])
    assert got.shape == (S, 1, n_out)
    if per_example:
        assert rel_err(got, want) <= F32_TOL  # fp32 on both sides
        assert rel_err(rounded, want) > 1e-4  # what the flag prevents
    else:
        assert rel_err(got, want) <= kron_cuda.BF16_TOL
        assert np.array_equal(got, rounded)


# ------------------------------------------------------------ entry points

# each entry point's tiny CPU run and the JAX script's result keys
ENTRY_POINTS = {
    "run_toy_cubic": (
        lambda: run_toy_cubic.run(device="cpu", epochs1=2, epochs2=3),
        {"experiment", "rmse", "mnll", "mnll_per_point", "pred_mnll_per_point", "wall_s",
         "epochs_per_s"},
    ),
    "run_toy_polynomial": (
        lambda: run_toy_polynomial.run(device="cpu", epochs1=2, epochs2=3),
        {"experiment", "ignore_kl", "train_rmse", "train_mnll_per_point", "pred_sd_gap",
         "pred_sd_observed", "n_params", "wall_s", "epochs_per_s"},
    ),
    "run_mnist": (
        lambda: run_mnist.run(device="cpu", width=32, epochs1=1, epochs2=1, subset=256)[0],
        {"experiment", "source", "width", "test_accuracy", "wall_s", "epochs_per_s"},
    ),
    "baseline_config3": (
        lambda: run_baseline_configs.config3_deep_hetero(
            device="cpu", epochs2=2, n=300, hidden=(16, 16), epochs1=1),
        {"config", "hidden", "lambda_last", "hetero_sigma0", "rmse", "pred_mnll_per_point",
         "learned_noise_corr_with_true", "epochs_per_s", "final_loss"},
    ),
    "baseline_config5": (
        lambda: run_baseline_configs.config5_large_d(device="cpu", D=64, S=2, B=8, steps=2),
        {"config", "D", "mc_samples", "batch", "elbo_steps_per_s", "posterior_samples_per_s",
         "final_loss"},
    ),
    "toy_bench": (
        lambda: toy_bench.run(device="cpu", epochs=2),
        {"metric", "value", "unit", "vs_baseline", "runs", "spread_pct", "gflops",
         "power_limit"},
    ),
}


# a short run's noise curve may be flat: np.corrcoef warns and gives nan
@pytest.mark.filterwarnings("ignore:invalid value encountered in divide:RuntimeWarning")
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_small_on_the_cpu(name):
    run, keys = ENTRY_POINTS[name]
    row = run()
    assert set(row) == keys | {"device"}
    assert row["device"] == "cpu"
    for k, v in row.items():
        if isinstance(v, float) and k != "learned_noise_corr_with_true":
            assert math.isfinite(v), (k, v)


def test_toy_polynomial_n_params_matches_jax():
    """The notebook's ~1537 parameters, as the JAX script counts them."""
    jnet = jm.WHVIRegression([jm.WHVILinear(1, 128), jm.sigmoid, jm.WHVILinear(128, 128),
                              jm.sigmoid, jm.WHVILinear(128, 1)])
    n = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(jnet.init(jax.random.PRNGKey(0))))
    assert run_toy_polynomial.run(device="cpu", epochs1=1, epochs2=0)["n_params"] == n == 1537


MAINS = {
    "run_toy_cubic": (run_toy_cubic.main, ["--epochs1", "1", "--epochs2", "1"]),
    "run_toy_polynomial": (run_toy_polynomial.main, ["--epochs1", "1", "--epochs2", "1"]),
    "run_mnist": (run_mnist.main, ["--data", "synthetic", "--width", "32"]),
    "run_baseline_configs": (run_baseline_configs.main, ["--quick"]),
    "toy_bench": (toy_bench.main, ["--epochs", "2"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run")
    main, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(argv)


def test_toy_bench_module_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run")
    proc = subprocess.run(
        [sys.executable, "-m", "whvi_tpu_torch.bench.toy_bench", "--epochs", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_smoke_split_head_is_the_protocols():
    """chip_smoke's config 3 net is ``whvi_tpu/evaluation.py``'s
    ``_build_net`` with ``heteroscedastic=True``, ``rect_mode="pad"``,
    per-example noise and the column LRT: the same layers, priors, options
    and parameter shapes."""
    from whvi_tpu.evaluation import ProtocolConfig, _build_net

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cfg = ProtocolConfig(hidden=(512, 512), heteroscedastic=True, rect_mode="pad", sigma0=0.3,
                         per_example_noise=True, column_lrt=True)
    jnet, pnet = _build_net(cfg, 16, 1), chip_smoke.hetero_split_net()

    def describe(layer, lib):
        if isinstance(layer, lib.Parallel):
            return [describe(b, lib) for b in layer.branches]
        if isinstance(layer, lib.WHVILinear):
            m = layer.matrix
            return (type(m).__name__, m.lambda_, m.s_init, layer.per_example_noise,
                    layer.column_lrt, layer.rect_mode, layer.lrt, getattr(m, "use_lrt", None))
        return layer.name

    assert [describe(l, pm) for l in pnet.layers] == [describe(l, jm) for l in jnet.layers]
    assert type(pnet.likelihood).__name__ == type(jnet.likelihood).__name__
    assert (pnet.likelihood.sigma0, pnet.likelihood.sigma_min) == (jnet.likelihood.sigma0, jnet.likelihood.sigma_min)
    assert (pnet.train_samples, pnet.eval_samples) == (jnet.train_samples, jnet.eval_samples)
    shapes = jax.tree.map(np.shape, jnet.init(jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda p: tuple(p.shape), param_tree(pnet)) == shapes


@pytest.mark.parametrize("batch", [1, 64])
def test_net_flops_count_padded_layers_as_jax(batch):
    """Padded matrices count as one square block; ``Parallel`` and
    ``Dense`` layers, which have no ``matrix``, count nothing, as in JAX."""
    from whvi_tpu.utils import profiling as jax_profiling
    from whvi_tpu_torch.utils import profiling

    nets = [
        (_split_head(jm), _split_head(pm)),
        (jm.WHVIRegression(jm.mlp_layers(13, 3, hidden=(40, 24), rect_mode="pad")),
         pm.WHVIRegression(pm.mlp_layers(13, 3, hidden=(40, 24), rect_mode="pad"))),
        (jm.WHVIRegression([jm.Dense(5, 8), jm.WHVILinear(8, 20, rect_mode="pad")]),
         pm.WHVIRegression([pm.Dense(5, 8), pm.WHVILinear(8, 20, rect_mode="pad")])),
    ]
    for jnet, pnet in nets:
        want = jax_profiling.net_train_step_flops(jnet, batch, 3)
        assert want > 0
        assert profiling.net_train_step_flops(pnet, batch, 3) == want
