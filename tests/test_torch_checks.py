"""The port's check CLIs and the ``ops`` and profiling names they use, on the
CPU at small sizes: ``bench/grad_check.py`` (every backend),
``bench/precision_check.py`` (its float64 oracle against the JAX C++
oracle, its fp32 and bf16-storage products against JAX's ``whvi_mul`` at
``"xla"`` / ``"highest"``, its rows), ``bench/column_lrt_check.py``,
``bench/diag_matmul.py``, ``ops.matmul_diag_left`` / ``matmul_diag_right``
/ ``kl_normal`` / ``fwht_butterfly`` against the JAX functions on the same
numpy inputs, and ``utils.profiling.trace``. Times are taken
only on a card: the timing CLIs refuse without one, and their row
functions run here with a stub timer."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whvi_tpu.ops import hadamard as jax_hadamard
from whvi_tpu.ops import kl_normal as jax_kl_normal
from whvi_tpu.ops import matmul_diag_left as jax_left
from whvi_tpu.ops import matmul_diag_right as jax_right
from whvi_tpu.ops import whvi_op as jax_whvi_op
from whvi_tpu.ops.cpu_oracle import oracle_available, whvi_mul_cpp
from whvi_tpu_torch import ops
from whvi_tpu_torch.bench import column_lrt_check, diag_matmul, grad_check, precision_check
from whvi_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)

CPU = torch.device("cpu")
OPS_TOL = 1e-6
ORACLE_TOL = 1e-12
BF16S_TOL = 2.0**-7


def stub(fn, iters):
    fn()
    return 2.0


def rel_err(got, want) -> float:
    got = np.asarray(got.double() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------- grad_check


@pytest.mark.parametrize("backend", grad_check.BACKENDS)
def test_grad_check_backend_reports_ok_on_the_cpu(backend, capsys):
    rows = grad_check.main(["--backend", backend, "--dim", "64", "--cpu"])
    assert [r["backend"] for r in rows] == [backend] and rows[0]["ok"] is True
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"tool": "grad_check", "device": "cpu"} and lines[-1]["ok"] is True
    if backend == "kernel":  # the CPU path says so, and launches nothing
        assert rows[0]["route"].startswith("cpu") and rows[0]["launches"] == {}


def test_grad_check_kernel_backend_catches_a_wrong_backward(monkeypatch):
    # the check must compare something: a backward off by a factor fails it
    real = ops.fwht_cuda.fused_bwd_raw
    monkeypatch.setattr(ops.fwht_cuda, "fused_bwd_raw",
                        lambda *a: tuple(1.001 * t for t in real(*a)))
    with pytest.raises(AssertionError, match="WhviMulFunction"):
        grad_check.check("kernel", 16, 2, CPU)


def test_check_clis_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (grad_check.main, precision_check.main, column_lrt_check.main, diag_matmul.main):
        with pytest.raises(RuntimeError, match="CUDA device"):
            main([])


# -------------------------------------------------------- precision_check


@pytest.mark.parametrize("D", [64, 1024, 4096])
def test_precision_oracle_matches_the_jax_cpp_oracle(D):
    if not oracle_available():
        pytest.skip("the JAX C++ oracle did not build here")
    s1, u, s2, x = precision_check._error_operands(D)
    want = whvi_mul_cpp(*(t.numpy().astype(np.float64) for t in (s1, u, s2, x)))
    got = precision_check.oracle(s1, u, s2, x)
    assert got.dtype == torch.float64
    assert rel_err(got, want) <= ORACLE_TOL


@pytest.mark.parametrize("D", [64, 1024])
def test_precision_products_match_jax_xla(D):
    ops_np = [t.numpy() for t in precision_check._error_operands(D)]
    backend, precision = jax_whvi_op._BACKEND, jax_hadamard.get_fwht_precision()
    jax_whvi_op.set_whvi_mul_backend("xla")
    jax_hadamard.set_fwht_precision("highest")
    try:
        want32 = jax_whvi_op.whvi_mul(*(jnp.asarray(a) for a in ops_np))
        want16 = jax_whvi_op.whvi_mul(*(jnp.asarray(a, jnp.bfloat16) for a in ops_np))
    finally:
        jax_whvi_op.set_whvi_mul_backend(backend)
        jax_hadamard.set_fwht_precision(precision)
    ops_t = [torch.from_numpy(a) for a in ops_np]
    got32 = precision_check.product(ops_t, "fp32", CPU)
    got16 = precision_check.product(ops_t, "bf16s", CPU)
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    assert rel_err(got32, np.asarray(want32)) <= OPS_TOL
    assert rel_err(got16, np.asarray(want16, np.float32)) <= BF16S_TOL


def test_precision_rows_on_the_cpu():
    rows = precision_check.rows([64, 2048], 8, 3, CPU, stub)
    assert [(r["D"], r["mode"]) for r in rows] == [
        (D, m) for D in (64, 2048) for m in precision_check.MODES]
    for r in rows:
        tol = 1e-6 if r["mode"] == "fp32" else BF16S_TOL
        assert 0 < r["rel_err_vs_f64"] <= tol
        assert r["auto_equals_fp32"] is True and r["bound_by"] == "bytes"
        assert r["hbm_frac"] == pytest.approx(r["GBps"] / 3350.0)
    assert rows[0]["bound_ms"] == 2 * rows[2]["bound_ms"] > 0  # bf16 storage moves half
    (auto,) = precision_check.auto_rows([2048], 8, 3, CPU, stub)
    assert auto["auto_equals_fp32"] is True and auto["default"] == "fp32"


def test_precision_auto_column_sees_another_default():
    ops.set_whvi_mul_precision("bf16")
    try:
        (auto,) = precision_check.auto_rows([64], 8, 1, CPU, stub)
    finally:
        ops.set_whvi_mul_precision("fp32")
    assert auto["default"] == "bf16" and auto["auto_equals_fp32"] is False


# ------------------------------------------------------- column_lrt_check

JAX_COLUMN_KEYS = {"D", "B", "keys", "explicit_loss_var", "explicit_grad_var",
                   "column_lrt_loss_var", "column_lrt_grad_var", "grad_var_reduction",
                   "loss_var_reduction"}


def test_column_lrt_check_row_on_the_cpu():
    row = column_lrt_check.row(16, 8, 4, 2, CPU)
    assert JAX_COLUMN_KEYS <= set(row) and row["device"] == "cpu"
    assert all(math.isfinite(row[k]) and row[k] >= 0 for k in JAX_COLUMN_KEYS)
    assert row["explicit_grad_var"] > 0 and row["column_lrt_grad_var"] > 0


@pytest.mark.parametrize("column_lrt", [False, True], ids=["explicit", "column_lrt"])
def test_column_lrt_variances_match_jax_at_jax_trained_parameters(column_lrt):
    """Both packages' estimators at one trained point: the JAX package
    trains ``column_lrt_check``'s D -> 1 head (D = 64, 300 epochs), the port
    loads its parameters, and each measures the loss and gradient variance
    over 64 draws of its own noise. Equal estimators agree up to the
    sampling error of 64 draws (a variance's estimate from 64 draws is
    within a factor of 2 of another's at well over 3 sd). Prints one JSON
    row."""
    from whvi_tpu.models import WHVILinear as JaxLinear
    from whvi_tpu.models import WHVIRegression as JaxRegression
    from whvi_tpu.train import TrainConfig as JaxConfig
    from whvi_tpu.train import Trainer as JaxTrainer
    from whvi_tpu_torch.convert import load_jax_params
    from whvi_tpu_torch.models import WHVILinear, WHVIRegression

    D, B, keys, epochs = 64, 64, 64, 300
    rng = np.random.RandomState(0)
    X, y = rng.randn(B, D).astype(np.float32), rng.randn(B, 1).astype(np.float32)
    layer = dict(lambda_=1e-5, s_init="auto", per_example_noise=True, column_lrt=column_lrt)
    jnet = JaxRegression([JaxLinear(D, 1, **layer)], sigma0=1.0, train_samples=1)
    trainer = JaxTrainer(jnet, JaxConfig(epochs1=0, epochs2=epochs, epochs_per_call=epochs))
    state, _ = trainer.fit(trainer.init(jax.random.PRNGKey(0)), X, y)
    lfn = jax.jit(jax.value_and_grad(
        lambda p, k: jnet.loss(p, k, jnp.asarray(X), jnp.asarray(y), n=B)[0]))
    losses, grads = zip(*(lfn(state.params, k) for k in jax.random.split(jax.random.PRNGKey(1), keys)))
    leaves = [np.stack(gs) for gs in zip(*(jax.tree.leaves(g) for g in grads))]
    want = (float(np.var(losses)), float(np.mean([np.var(a, axis=0).mean() for a in leaves])))
    net = WHVIRegression([WHVILinear(D, 1, **layer)], sigma0=1.0, train_samples=1)
    load_jax_params(net, jax.tree.map(np.asarray, state.params))
    got = column_lrt_check.grad_var(net, torch.from_numpy(X), torch.from_numpy(y),
                                    torch.Generator().manual_seed(1), keys)
    print(json.dumps({"column_lrt": column_lrt, "D": D, "jax_loss_var": want[0],
                      "port_loss_var": got[0], "jax_grad_var": want[1], "port_grad_var": got[1]}))
    for a, b in zip(got, want):
        assert 0.5 <= a / b <= 2.0, (got, want)


# ------------------------------------------------------------ ops names


def test_matmul_diag_and_kl_normal_match_jax():
    rng = np.random.RandomState(5)
    d, A = rng.randn(3, 8).astype(np.float32), rng.randn(3, 8, 8).astype(np.float32)
    td, tA = torch.from_numpy(d), torch.from_numpy(A)
    assert rel_err(ops.matmul_diag_left(td, tA), jax_left(d, A)) <= OPS_TOL
    assert rel_err(ops.matmul_diag_right(tA, td), jax_right(A, d)) <= OPS_TOL
    assert rel_err(ops.matmul_diag_left(td[0], tA[0]), np.diag(d[0]) @ A[0]) <= OPS_TOL
    mu, sd = rng.randn(6).astype(np.float32), rng.uniform(0.2, 2.0, 6).astype(np.float32)
    for args in ((float(mu[0]), float(sd[0]), 0.0, 1.0), (mu, sd, 0.3, 1.7),
                 (mu.reshape(2, 3), sd.reshape(2, 3), 0.0, 0.5)):
        want = float(jax_kl_normal(*args))
        got = ops.kl_normal(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in args))
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= OPS_TOL * max(1.0, abs(want))


def test_fwht_butterfly_is_the_ports_fwht():
    x = torch.from_numpy(np.random.RandomState(6).randn(4, 64).astype(np.float32))
    assert ops.fwht_butterfly is ops.fwht
    assert torch.equal(ops.fwht_butterfly(x), ops.fwht(x))
    assert rel_err(ops.fwht_butterfly(x), jax_hadamard.fwht_butterfly(x.numpy())) <= OPS_TOL


def test_diag_matmul_rows_on_the_cpu():
    rows = diag_matmul.rows([16, 64], 2, CPU, stub)
    for row in rows:
        assert row["match_left"] is True and row["match_right"] is True
        assert row["speedup_left"] == row["speedup_right"] == 1.0
    with pytest.raises(ValueError, match=">= 1"):
        diag_matmul.rows([0], 2, CPU, stub)


# -------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace_of_whvi_mul(tmp_path):
    s1, u, s2, x = (torch.randn(*shape) for shape in ((64,), (64,), (64,), (4, 64)))
    with trace(str(tmp_path / "tr")) as path:
        y = ops.whvi_mul(s1, u, s2, x)
    assert path == str(tmp_path / "tr" / "trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mul", "aten::stack", "aten::add", "aten::sub"} <= names
    assert y.shape == (4, 64)


@pytest.mark.parametrize("reader", ["trace", "device_profile"])
def test_profiler_readings_refuse_lost_kernel_records(tmp_path, monkeypatch, reader):
    """A block that launched the port's kernels while the profiler recorded
    none of them (as on the H100 after other processes used the card)
    raises: a trace or a device time short of the block's kernels is never
    handed on. A block that launched none passes."""
    from whvi_tpu_torch.ops import fwht_cuda
    from whvi_tpu_torch.utils.profiling import device_profile

    def run(launch):
        def block():
            ops.fwht(torch.randn(2, 16))
            if launch:  # stands for a K4 launch the profiler did not record
                fwht_cuda.LAUNCHES["fwht"] += 1

        if reader == "device_profile":
            return device_profile(block)
        with trace(str(tmp_path / "tr")):
            block()

    monkeypatch.setattr(fwht_cuda, "LAUNCHES", dict(fwht_cuda.LAUNCHES))
    run(False)
    with pytest.raises(RuntimeError, match=r"recorded 0 of the 1 kernel launches"):
        run(True)

