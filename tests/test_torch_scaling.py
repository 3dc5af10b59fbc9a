"""The port's large-D scaling path against the JAX package, on the CPU.

The bf16 mode of the fused product (``fused_plain(.., "bf16")``, the plain
version of K1-K3 in that mode) against the Pallas kernel at
``precision="bf16"`` in interpret mode, its gradients against the
kernel's VJP, the whole scaling net in bf16 mode against the JAX net
under ``set_whvi_mul_backend("pallas")``, the flop counters, and the
``run_scaling`` entry point. The kernels themselves are held against
these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances, as ``max|port - ref| / max|ref|``:

- ``fc.bf16_tol(D, transform)``, ``2^-6 / sqrt(f)``: the roundings sit at
  the same points on both sides, but the fp32 sums run in another order,
  so one may land on the other side of a bf16 rounding boundary; f is the
  last contraction after the last rounding (``fwht_cuda.bf16_tol``).
- ``kc.BF16_TOL`` (2^-7) for the whole net. One flipped rounding perturbs
  its row downstream, the next layer's roundings of that row then flip by
  the thousand, and within two layers two computations of the bf16 net
  differ as independent roundings would, about as far as the bf16 product
  from the fp32 one. (A one-ulp change of the noise moves the scaling
  net's predictions by 2.3e-3 to 2.6e-3 at D = 4096, S = 8, B = 256.) At
  this test's size the JAX net and the port agree within 2.1e-4 in loss,
  predictions and gradients, and the test also checks that the JAX net's
  fp32 product lies farther off.
- bit equality (``torch.equal``): the fp32 mode, which this path must leave
  as it was.
"""

import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whvi_tpu.ops.whvi_op as jax_whvi_op
from whvi_tpu.models import WHVILinear as JaxWHVILinear
from whvi_tpu.models import WHVIRegression as JaxWHVIRegression
from whvi_tpu.models import mlp_layers as jax_mlp_layers
from whvi_tpu.models import relu as jax_relu
from whvi_tpu.models.weights import SquarePow2Matrix as JaxSquarePow2Matrix
from whvi_tpu.models.weights import StackedMatrix as JaxStackedMatrix
from whvi_tpu.ops.fwht_pallas import _fused_raw, whvi_mul_pallas
from whvi_tpu.utils import profiling as jax_profiling

from whvi_tpu_torch.convert import load_jax_params
from whvi_tpu_torch.experiments import run_scaling
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, mlp_layers, relu
from whvi_tpu_torch.models.weights import SquarePow2Matrix, StackedMatrix
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import kron_cuda as kc
from whvi_tpu_torch.ops import (
    get_whvi_mul_precision,
    set_whvi_mul_precision,
    whvi_mul,
)
from whvi_tpu_torch.ops.hadamard import fwht
from whvi_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(D, B=8, seed=0):
    rng = np.random.RandomState(seed + D)
    s1, u, s2 = (rng.randn(D).astype(np.float32) for _ in range(3))
    return s1, u, s2, rng.randn(B, D).astype(np.float32)


def _natural(i1, D):
    """The Pallas kernel's i1 from its swapped (b, a) layout (D >= 2048)."""
    i1 = np.asarray(i1)
    if D <= fc.ONE_FACTOR_MAX:
        return i1
    a = D // fc.LANE
    return i1.reshape(-1, fc.LANE, a).transpose(0, 2, 1).reshape(i1.shape)


@pytest.fixture
def steady_clock(monkeypatch):
    """``run_scaling``'s timer replaced by one that runs ``fn(k)`` once and
    takes ``k`` ms for N = k steps and ``2k`` for 2N: a CPU run of a step
    or two is too short for the host clock to tell N steps from 2N, which
    ``run`` refuses to report."""
    monkeypatch.setattr(run_scaling, "_least_times", lambda fn, k: (k * 1e-3, 2 * k * 1e-3, fn(k)))


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


# ----------------------------------------------- K1-K3 in bf16 mode, plain


@pytest.mark.parametrize("D", [4, 16, 128, 1024, 2048, 4096])
def test_bf16_plain_matches_pallas_kernel(D):
    """y, i1 and i2 of the plain bf16 product against ``_fused_raw(..,
    interpret=True, precision="bf16")``, with and without residuals."""
    s1, u, s2, x = _inputs(D)
    args = [jnp.asarray(a) for a in (s1, u, s2, x)]
    y, i1, i2 = _fused_raw(*args, interpret=True, want_residuals=True, precision="bf16")
    y_only, _, _ = _fused_raw(*args, interpret=True, want_residuals=False, precision="bf16")
    got = fc.fused_raw(*map(t, (s1, u, s2, x)), True, "bf16")
    assert rel_err(got[0].numpy(), y) <= fc.bf16_tol(D)
    assert rel_err(got[1].numpy(), _natural(i1, D)) <= fc.bf16_tol(D, transform=1)
    assert rel_err(got[2].numpy(), i2) <= fc.bf16_tol(D)
    y_port, none1, none2 = fc.fused_raw(*map(t, (s1, u, s2, x)), False, "bf16")
    assert none1 is None and none2 is None
    err = rel_err(y_port.numpy(), y_only)
    assert err <= fc.bf16_tol(D)
    # and it rounds: the fp32 product is much farther from the kernel
    fp32 = fc.fused_plain(*map(t, (s1, u, s2, x)), False)[0]
    assert rel_err(fp32.numpy(), y_only) > 4 * err


@pytest.mark.parametrize("D", [16, 1024, 2048])
def test_bf16_grads_match_pallas_vjp(D):
    s1, u, s2, x = _inputs(D, seed=1)
    inputs = [t(a).requires_grad_() for a in (s1, u, s2, x)]
    fc.reset_launches()
    y = whvi_mul(*inputs, precision="bf16")
    g = np.random.RandomState(D).randn(*y.shape).astype(np.float32)
    y.backward(t(g))
    want_y, vjp = jax.vjp(
        lambda *a: whvi_mul_pallas(*a, True, "bf16"),
        *map(jnp.asarray, (s1, u, s2, x)),
    )
    assert rel_err(y.detach().numpy(), want_y) <= fc.bf16_tol(D)
    for name, mine, ref in zip(("s1", "u", "s2", "x"), inputs, vjp(jnp.asarray(g))):
        tol = fc.bf16_tol(D, transform=1 if name == "u" else 2)
        assert mine.grad.shape == ref.shape, name
        assert rel_err(mine.grad.numpy(), ref) <= tol, name
    # the CPU path ran the plain versions, never a kernel
    assert all(v == 0 for v in fc.LAUNCHES.values())


def test_vjp_plain_is_the_function_backward():
    """The plain backward (chip_smoke's reference) is the Function's own
    algebra, on broadcast shapes: a per-sample u over an expanded x."""
    rng = np.random.RandomState(3)
    D, S, B = 2048, 2, 4
    s1, s2 = (t(rng.randn(D).astype(np.float32)) for _ in range(2))
    u = t(rng.randn(S, 1, D).astype(np.float32))
    x0 = t(rng.randn(B, D).astype(np.float32))
    g = t(rng.randn(S, B, D).astype(np.float32))
    leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x0)]
    y = fc.WhviMulFunction.apply(*leaves[:3], leaves[3].expand(S, B, D), "bf16")
    y.backward(g)
    want = fc.vjp_plain(s1, u, s2, x0.expand(S, B, D), g, "bf16")
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad, ref.sum_to_size(leaf.shape))


# ------------------------------------------------------ the mode switch


def test_fp32_mode_is_unchanged():
    """The default mode is fp32 and computes exactly what it computed
    before the bf16 mode: the butterflies' y, residuals and gradients."""
    assert get_whvi_mul_precision() == "fp32"
    s1, u, s2, x = map(t, _inputs(256, B=5, seed=4))
    i1 = fwht(s2 * x)
    i2 = fwht(u * i1)
    for got in (fc.fused_plain(s1, u, s2, x, True), fc.fused_raw(s1, u, s2, x, True, "fp32")):
        for a, b in zip(got, (s1 * i2, i1, i2)):
            assert torch.equal(a, b)
    assert torch.equal(whvi_mul(s1, u, s2, x), s1 * i2)
    leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x)]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    whvi_mul(*leaves).backward(g)
    w1 = fwht(s1 * g)
    t2 = fwht(u * w1)
    want = ((g * i2).sum(0), (w1 * i1).sum(0), (x * t2).sum(0), s2 * t2)
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad, ref)


def test_precision_switch_is_read_at_call_time():
    s1, u, s2, x = map(t, _inputs(2048, B=3, seed=5))
    want_bf16 = fc.fused_plain(s1, u, s2, x, False, "bf16")[0]
    want_fp32 = fc.fused_plain(s1, u, s2, x, False)[0]
    try:
        set_whvi_mul_precision("bf16")
        assert torch.equal(whvi_mul(s1, u, s2, x), want_bf16)
        assert torch.equal(whvi_mul(s1, u, s2, x, precision="fp32"), want_fp32)
    finally:
        set_whvi_mul_precision("fp32")
    assert torch.equal(whvi_mul(s1, u, s2, x), want_fp32)
    with pytest.raises(ValueError):
        set_whvi_mul_precision("tf32")
    assert get_whvi_mul_precision() == "fp32"


@pytest.mark.parametrize("D", [2, 12, 2 * fc.MAX_D])
def test_bf16_mode_refuses_widths_outside_the_kernel(D):
    d = torch.ones(D)
    x = torch.ones(3, D)
    for call in (
        lambda: fc.fused_raw(d, d, d, x, False, "bf16"),
        lambda: fc.fused_raw(d, d, d, x, True, "bf16"),
        lambda: fc.fused_bwd_raw(d, d, d, x, "bf16"),
        lambda: fc.fused_plain(d, d, d, x, False, "bf16"),
    ):
        with pytest.raises(ValueError):
            call()
    # whvi_mul's bf16 mode computes fp32 there, as JAX's "pallas" backend
    # sends such widths to XLA
    if fc.is_pow_of_2(D):
        assert torch.equal(whvi_mul(d, d, d, x, precision="bf16"), whvi_mul(d, d, d, x))
    else:
        with pytest.raises(ValueError):
            whvi_mul(d, d, d, x, precision="bf16")
    with pytest.raises(ValueError):
        fc.fused_raw(torch.ones(16), torch.ones(16), torch.ones(16), torch.ones(2, 16), False, "fp16")
    fc.check_precision(fc.MIN_D_BF16, "bf16")
    fc.check_precision(fc.MAX_D, "bf16")
    fc.check_precision(2, "fp32")


def test_cpu_bf16_path_never_loads_the_library(monkeypatch, steady_clock):
    def refuse():
        raise AssertionError("CUDA library loaded on the CPU path")

    monkeypatch.setattr(fc, "load_library", refuse)
    fc.reset_launches()
    rows = run_scaling.run(
        2048, device="cpu", batch=4, samples=2, steps=1, precision="bf16"
    )
    assert run_scaling.finite(rows[0])
    assert all(v == 0 for v in fc.LAUNCHES.values())


# --------------------------- products the "pallas" backend leaves to XLA


def _layer_case(name):
    """(JAX matrix, port matrix, x, g) of a layer whose products JAX's
    "pallas" backend sends to XLA in fp32: stacked (stack, D) diagonals,
    a per-example-noise u (B, D), and D = 2 (below pallas_supported)."""
    rng = np.random.RandomState(7)
    B = 6
    if name == "stacked13x128":
        jm, pm = JaxStackedMatrix(13, 128), StackedMatrix(13, 128)
        lead, n_in, g_lead = (8,), 13, (8,)
    elif name == "square64_per_example":
        jm, pm = JaxSquarePow2Matrix(64), SquarePow2Matrix(64)
        lead, n_in, g_lead = (), 64, (B,)
    else:
        jm, pm = JaxSquarePow2Matrix(2), SquarePow2Matrix(2)
        lead, n_in, g_lead = (), 2, ()
    D = pm.s1.shape[-1]
    params = {k: rng.randn(*lead, D).astype(np.float32) for k in ("s1", "s2", "g_mu", "g_rho")}
    with torch.no_grad():
        for k, v in params.items():
            getattr(pm, k).copy_(t(v))
    x = rng.randn(B, n_in).astype(np.float32)
    g = rng.randn(*g_lead, D).astype(np.float32)
    return jm, pm, params, x, g


@pytest.mark.parametrize("name", ["stacked13x128", "square64_per_example", "d2"])
def test_bf16_mode_leaves_xla_products_in_fp32(name, bf16_backends):
    """Under the bf16 mode the port rounds only where the JAX "pallas"
    backend reaches its kernel: these layers' products compute fp32 on
    both sides and agree within 1e-5."""
    jm, pm, params, x, g = _layer_case(name)
    want = jm.apply_given_g(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(g))
    with torch.no_grad():
        got = pm.apply_given_g(t(x), t(g))
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("layer", ["square64", "stacked13x128"])
def test_bf16_mode_leaves_per_example_noise_at_batch_1_in_fp32(layer, bf16_backends):
    """A per-example-noise layer at batch 1: JAX's u (1, D) is 2-D, so its
    "pallas" backend sends the product to XLA in fp32. The port's u
    (S, 1, D) has the shape of a shared u; the layer tells whvi_mul that it
    was drawn per example, and the product computes fp32 too. Given as
    shared noise, the same u is rounded."""
    rng = np.random.RandomState(13)
    S = 3
    if layer == "square64":
        jm, pm = JaxSquarePow2Matrix(64), SquarePow2Matrix(64)
        lead, n_in = (), 64
    else:
        jm, pm = JaxStackedMatrix(13, 128), StackedMatrix(13, 128)
        lead, n_in = (8,), 13
    D = pm.s1.shape[-1]
    params = {k: rng.randn(*lead, D).astype(np.float32) for k in ("s1", "s2", "g_mu", "g_rho")}
    with torch.no_grad():
        for k, v in params.items():
            getattr(pm, k).copy_(t(v))
    x = rng.randn(S, 1, n_in).astype(np.float32)
    eps = t(rng.randn(*pm.noise_shape(t(x), True)).astype(np.float32))
    with torch.no_grad():
        u = (pm.g_mu + pm.g_sigma() * eps).numpy()
        got = pm(t(x), eps=eps, per_example_noise=True).numpy()
        shared = pm.apply_given_g(t(x), t(u)).numpy()
    jparams = jax.tree.map(jnp.asarray, params)
    want = np.stack([np.asarray(jm.apply_given_g(jparams, jnp.asarray(x[s]), jnp.asarray(u[s])))
                     for s in range(S)])
    assert rel_err(got, want) <= 1e-5
    if layer == "square64":
        assert rel_err(shared, want) > 1e-4


# ------------------------------------------------- the whole scaling net


def _scaling_nets(D, S):
    """The scaling model of ``experiments/run_scaling.py:114-123`` in both
    packages."""
    jnet = JaxWHVIRegression(
        [
            JaxWHVILinear(D, D, lambda_=3.0, s_init="auto"),
            jax_relu,
            JaxWHVILinear(D, D, lambda_=3.0, s_init="auto"),
            jax_relu,
            JaxWHVILinear(D, 1, s_init="auto"),
        ],
        train_samples=S,
    )
    return jnet, run_scaling.build_net(D, S)


@pytest.mark.parametrize("D", [64, 2048])
def test_scaling_net_matches_jax_pallas_backend(D, bf16_backends):
    """Loss, predictions and gradients of the scaling net in bf16 mode on
    the same weights and noise as the JAX net, whose square products go
    through the Pallas kernel (interpret mode) at precision="bf16"."""
    S, B, n = 2, 8, 100
    jnet, pnet = _scaling_nets(D, S)
    rng = np.random.RandomState(D)
    jparams = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    # g_mu away from its zero init, so u = g_mu + sigma * eps is O(1)
    jparams = {
        "layers": tuple(
            dict(p, g_mu=rng.randn(*p["g_mu"].shape).astype(np.float32)) if p else p
            for p in jparams["layers"]
        ),
        "likelihood": jparams["likelihood"],
    }
    load_jax_params(pnet, jparams)
    x = rng.randn(B, D).astype(np.float32)
    y = rng.randn(B, 1).astype(np.float32)
    eps = [
        rng.randn(S, 1, *layer.matrix.g_mu.shape).astype(np.float32)
        if isinstance(layer, WHVILinear) else None
        for layer in pnet.layers
    ]

    def jax_predictions(params):
        preds = []
        for s in range(S):
            h = jnp.asarray(x)
            for layer, p, e in zip(jnet.layers, params["layers"], eps):
                if e is None:
                    h = layer.apply(p, h, None)
                else:
                    g = p["g_mu"] + jax.nn.softplus(p["g_rho"]) * e[s, 0]
                    h = layer.apply_given_g(p, h, g)
            preds.append(h)
        return jnp.stack(preds)

    def jax_loss(params):
        mnll = jnet.likelihood.mnll(params["likelihood"], jnp.asarray(y), jax_predictions(params), n)
        return mnll + jnet.kl(params)

    jparams = jax.tree.map(jnp.asarray, jparams)
    jloss, jgrads = jax.value_and_grad(jax_loss)(jparams)
    jpred = jax_predictions(jparams)

    e = [None if a is None else t(a) for a in eps]
    loss, _ = pnet.loss(t(x), t(y), n, eps=e)
    loss.backward()
    with torch.no_grad():
        pred = pnet.predict(t(x), S, eps=e)
    tol = kc.BF16_TOL
    assert rel_err(loss.detach().numpy(), jloss) <= tol
    assert rel_err(pred.numpy(), jpred) <= tol
    for layer, jg in zip(pnet.layers, jgrads["layers"]):
        if isinstance(layer, WHVILinear):
            for k in ("s1", "s2", "g_mu", "g_rho"):
                assert rel_err(getattr(layer.matrix, k).grad.numpy(), jg[k]) <= tol, k
    assert rel_err(pnet.likelihood.rho.grad.numpy(), jgrads["likelihood"]["rho"]) <= tol
    # and the JAX net did take the bf16 kernel: its fp32 product differs
    jax_whvi_op.set_whvi_mul_backend("xla")
    assert rel_err(pred.numpy(), jax_predictions(jparams)) > 4 * rel_err(pred.numpy(), jpred)


# ------------------------------------------------------------- counters


def _count_nets():
    """(name, JAX net, port net) of several layer mixes."""
    out = []
    for D in (64, 4096):
        jnet, pnet = _scaling_nets(D, 8)
        out.append((f"scaling{D}", jnet, pnet))
    out.append((
        "flagship",
        JaxWHVIRegression(jax_mlp_layers(13, 1, hidden=(128, 128)), train_samples=4),
        WHVIRegression(mlp_layers(13, 1, hidden=(128, 128)), train_samples=4),
    ))
    out.append((
        "stacked",
        JaxWHVIRegression([JaxWHVILinear(10, 40, lrt=False), jax_relu, JaxWHVILinear(40, 1)]),
        WHVIRegression([WHVILinear(10, 40, lrt=False), relu, WHVILinear(40, 1)]),
    ))
    return out


@pytest.mark.parametrize("batch", [1, 256])
def test_flop_counters_match_jax(batch):
    for name, jnet, pnet in _count_nets():
        for S in (None, 3):
            assert profiling.net_train_step_flops(pnet, batch, S) == \
                jax_profiling.net_train_step_flops(jnet, batch, S), name
    for D in (4, 128, 4096, 16384):
        for stack in (1, 8):
            for lrt in (True, False):  # the JAX counters ignore it
                assert profiling.whvi_layer_fwd_flops(D, batch, stack) == \
                    jax_profiling.whvi_layer_fwd_flops(D, batch, stack, lrt)
                assert profiling.whvi_layer_train_flops(D, batch, stack) == \
                    jax_profiling.whvi_layer_train_flops(D, batch, stack, lrt)
    for dims in ([1024], [4096, 4096], [8192, 8192]):
        for lrt in (True, False):
            assert profiling.elbo_step_flops(dims, batch, 8) == \
                jax_profiling.elbo_step_flops(dims, batch, 8, lrt)


# ----------------------------------------------------------- entry point


@pytest.mark.parametrize("D", [64, 2048])
def test_run_scaling_rows_on_the_cpu(D, steady_clock):
    previous = get_whvi_mul_precision()
    for precision in ("fp32", "bf16"):
        train = run_scaling.run(
            D, device="cpu", batch=8, samples=2, steps=1, repeats=2, precision=precision
        )
        pred = run_scaling.run(
            D, device="cpu", batch=8, samples=2, steps=1, predict=True, precision=precision
        )
        assert len(train) == 2 and len(pred) == 1
        for row in train + pred:
            assert run_scaling.finite(row), row
            assert row["D"] == D and row["precision"] == precision and row["mfu"] is None
            assert row["device"] == "cpu"
        assert set(train[0]) >= {"step_ms", "elbo_steps_per_s", "posterior_samples_per_s", "tflops"}
        assert pred[0]["mode"] == "predict" and "call_ms" in pred[0]
        assert train[0]["step_ms"] == pytest.approx(1.0)
        assert get_whvi_mul_precision() == previous


def test_run_scaling_refuses_a_time_it_cannot_resolve(monkeypatch):
    """2N steps no slower than N: host noise, not a rate to print."""
    monkeypatch.setattr(run_scaling, "_least_times", lambda fn, k: (0.5, 0.5, fn(k)))
    with pytest.raises(RuntimeError, match="host timing noise"):
        run_scaling.run(64, device="cpu", batch=4, samples=2, steps=1)
    assert get_whvi_mul_precision() == "fp32"


def test_run_scaling_times_n_and_2n_steps_in_turns(monkeypatch):
    """A slow spell of the host or the card (here the first two runs)
    falls on both N and 2N: each is the least of its TRIALS runs."""
    calls, clock = [], iter([0.0, 9.0, 9.0, 18.0] + [0.0, 1.0, 1.0, 3.0] * (run_scaling.TRIALS - 1))

    def fn(k):
        calls.append(k)
        return k

    monkeypatch.setattr(run_scaling, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    t1, t2, value = run_scaling._least_times(fn, 5)
    assert calls == [5, 10] * run_scaling.TRIALS
    assert (t1, t2, value) == (1.0, 2.0, 10)


def test_run_scaling_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_scaling.main(["--sizes", "64"])
    proc = subprocess.run(
        [sys.executable, "-m", "whvi_tpu_torch.experiments.run_scaling", "--sizes", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""


# ---------------------------------------------------------------- smoke


def _enclosing_def(lines, index):
    """The ``def`` line of the top-level function around line ``index``."""
    for line in reversed(lines[: index + 1]):
        if line.startswith("def "):
            return line
        if line and not line[0].isspace() and not line.startswith(("#", ")")):
            return None
    return None


def test_smoke_lists_every_fused_kernel():
    sys.path.insert(0, ROOT)
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)
    assert list(smoke.KERNELS) == list(fc.LAUNCHES)
    for name, (source, replaces) in smoke.KERNELS.items():
        assert os.path.exists(os.path.join(ROOT, source)), name
        path, line = replaces.split(":")
        with open(os.path.join(ROOT, path)) as f:
            lines = f.read().splitlines()
        assert _enclosing_def(lines, int(line) - 1) is not None, name
