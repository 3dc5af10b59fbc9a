"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same numpy inputs go through ``whvi_tpu`` (its XLA expressions, its
Pallas kernels in interpret mode, and the float64 C++ oracle) and through
``whvi_tpu_torch``, whose wrappers take their plain PyTorch versions for
CPU tensors. The CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``;
the test marked ``cuda`` here skips without a card.

Tolerances: fp32 paths ``max|port - ref| / max|ref| <= 1e-5`` (identical
arithmetic up to summation order; the transform's rounding grows about
as log2 D * 2^-24); float64 paths ``<= 1e-12``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whvi_tpu.ops import build_H as jax_build_H
from whvi_tpu.ops import fwht as jax_fwht
from whvi_tpu.ops import kl_diag_normal as jax_kl_diag_normal
from whvi_tpu.ops import whvi_mul as jax_whvi_mul
from whvi_tpu.ops.cpu_oracle import fwht_cpp, oracle_available, whvi_mul_cpp
from whvi_tpu.ops.fwht_pallas import fwht_pallas, whvi_mul_pallas
from whvi_tpu.ops.hadamard import build_H_rows as jax_build_H_rows

from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops.hadamard import (
    build_H,
    build_H_rows,
    fwht,
    is_pow_of_2,
    kl_diag_normal,
    next_pow_of_2,
)
from whvi_tpu_torch.ops.whvi_op import (
    whvi_dense,
    whvi_mul,
    whvi_mul_dense_oracle,
)

torch.set_num_threads(1)

F32_TOL = 1e-5
F64_TOL = 1e-12

needs_oracle = pytest.mark.skipif(
    not oracle_available(), reason="g++ oracle unavailable"
)


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _diags(rng, D, lead=(), dtype=np.float32):
    return [rng.randn(*lead, D).astype(dtype) for _ in range(3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels")
    return torch.device("cuda")


# ------------------------------------------------------------- hadamard core


@pytest.mark.parametrize("D", [2**k for k in range(11)])
def test_build_H_matches_jax(D):
    np.testing.assert_array_equal(build_H(D).numpy(), np.asarray(jax_build_H(D)))
    n_rows = max(1, D // 4)
    np.testing.assert_array_equal(
        build_H_rows(D, n_rows).numpy(), np.asarray(jax_build_H_rows(D, n_rows))
    )


def test_pow2_helpers():
    assert [is_pow_of_2(n) for n in (0, 1, 2, 3, 16, 96)] == [
        False, True, True, False, True, False,
    ]
    assert [next_pow_of_2(n) for n in (1, 3, 13, 128, 129)] == [1, 4, 16, 128, 256]
    with pytest.raises(ValueError):
        fwht(torch.zeros(3, 12))


@needs_oracle
@pytest.mark.parametrize("D", [2, 4, 16, 128, 2048])
def test_fwht_matches_jax_and_oracle(D):
    rng = np.random.RandomState(D)
    x = rng.randn(6, D).astype(np.float32)
    assert rel_err(fwht(t(x)).numpy(), jax_fwht(jnp.asarray(x))) <= F32_TOL
    x64 = x.astype(np.float64)
    assert rel_err(fwht(t(x64)).numpy(), fwht_cpp(x64)) <= F64_TOL


@pytest.mark.parametrize("D", [16, 2048])
def test_fwht_raw_matches_pallas_interpret(D):
    rng = np.random.RandomState(D + 1)
    x = rng.randn(5, D).astype(np.float32)
    want = fwht_pallas(jnp.asarray(x), True, "fp32")
    assert rel_err(fc.fwht_raw(t(x)).numpy(), want) <= F32_TOL


def test_kl_diag_normal_matches_jax():
    rng = np.random.RandomState(3)
    mu = rng.randn(8, 16).astype(np.float32)
    sigma = np.exp(rng.randn(8, 16)).astype(np.float32)
    for mu_p, sigma_p in ((0.0, 1.0), (0.3, 3.0**0.5), (0.0, 1e-5**0.5)):
        got = kl_diag_normal(t(mu), t(sigma), mu_p, sigma_p)
        want = jax_kl_diag_normal(jnp.asarray(mu), jnp.asarray(sigma), mu_p, sigma_p)
        assert rel_err(got.numpy(), want) <= F32_TOL


# ---------------------------------------------------------------- whvi_mul


@needs_oracle
@pytest.mark.parametrize("D", [16, 128, 2048])
def test_whvi_mul_matches_pallas_and_oracle(D):
    """(D,) diagonals: the 1-factor (D <= 1024) and 2-factor Pallas paths."""
    rng = np.random.RandomState(D + 2)
    s1, u, s2 = _diags(rng, D)
    x = rng.randn(7, D).astype(np.float32)
    got = whvi_mul(t(s1), t(u), t(s2), t(x)).numpy()
    want = whvi_mul_pallas(*map(jnp.asarray, (s1, u, s2, x)), True, "fp32")
    assert rel_err(got, want) <= F32_TOL
    args64 = [a.astype(np.float64) for a in (s1, u, s2, x)]
    got64 = whvi_mul(*map(t, args64)).numpy()
    assert rel_err(got64, whvi_mul_cpp(*args64)) <= F64_TOL


# (s1/s2 lead, u lead, x shape) of the stacked matrix's products
BROADCAST_CASES = {
    "stack": ((4,), (4,), (5, 1)),
    "u_per_sample": ((4,), (3, 1, 4), (5, 1)),
    "u_per_row": ((4,), (3, 5, 4), (3, 5, 1)),
    "square_per_sample": ((), (3, 1), (3, 5)),
}


def _broadcast_inputs(case, D=16, dtype=np.float32, seed=0):
    s_lead, u_lead, x_lead = BROADCAST_CASES[case]
    rng = np.random.RandomState(seed)
    s1 = rng.randn(*s_lead, D).astype(dtype)
    s2 = rng.randn(*s_lead, D).astype(dtype)
    u = rng.randn(*u_lead, D).astype(dtype)
    x = rng.randn(*x_lead, D).astype(dtype)
    return s1, u, s2, x


@pytest.mark.parametrize("case", sorted(BROADCAST_CASES))
def test_whvi_mul_broadcast_matches_jax(case):
    s1, u, s2, x = _broadcast_inputs(case)
    got = whvi_mul(t(s1), t(u), t(s2), t(x)).numpy()
    want = jax_whvi_mul(*map(jnp.asarray, (s1, u, s2, x)))
    assert rel_err(got, want) <= F32_TOL
    # the residuals have the output's shape, as the kernel writes them
    y, i1, i2 = fc.fused_raw(t(s1), t(u), t(s2), t(x), want_residuals=True)
    assert i1.shape == i2.shape == y.shape == want.shape


@pytest.mark.parametrize("case", ["diag"] + sorted(BROADCAST_CASES))
def test_whvi_mul_function_gradcheck(case):
    if case == "diag":
        rng = np.random.RandomState(4)
        s1, u, s2 = _diags(rng, 8, dtype=np.float64)
        x = rng.randn(3, 8)
    else:
        s1, u, s2, x = _broadcast_inputs(case, D=8, dtype=np.float64)
    inputs = [t(a).requires_grad_() for a in (s1, u, s2, x)]
    assert torch.autograd.gradcheck(fc.WhviMulFunction.apply, inputs)


@pytest.mark.parametrize("case", sorted(BROADCAST_CASES))
def test_whvi_mul_grads_match_jax_vjp(case):
    s1, u, s2, x = _broadcast_inputs(case, seed=1)
    inputs = [t(a).requires_grad_() for a in (s1, u, s2, x)]
    y = whvi_mul(*inputs)
    g = np.random.RandomState(2).randn(*y.shape).astype(np.float32)
    y.backward(t(g))
    _, vjp = jax.vjp(jax_whvi_mul, *map(jnp.asarray, (s1, u, s2, x)))
    for name, mine, ref in zip(("s1", "u", "s2", "x"), inputs, vjp(jnp.asarray(g))):
        assert mine.grad.shape == ref.shape, name
        assert rel_err(mine.grad.numpy(), ref) <= F32_TOL, name


def test_fwht_function_gradcheck_and_vjp():
    x64 = torch.randn(3, 2, 16, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(fc.FwhtFunction.apply, (x64,))
    rng = np.random.RandomState(5)
    x = rng.randn(4, 32).astype(np.float32)
    g = rng.randn(4, 32).astype(np.float32)
    xt = t(x).requires_grad_()
    fc.fwht_cuda(xt).backward(t(g))
    _, vjp = jax.vjp(jax_fwht, jnp.asarray(x))
    assert rel_err(xt.grad.numpy(), vjp(jnp.asarray(g))[0]) <= F32_TOL


def test_whvi_dense_is_not_diagonal():
    # the reference's row-wise composition collapses W to a diagonal
    # matrix (SURVEY.md section 0 bug 1); the two-sided transform must not
    rng = np.random.RandomState(9)
    D = 16
    s1 = t(rng.randn(D).astype(np.float32) * 0.1 + 1.0)
    s2 = t(rng.randn(D).astype(np.float32) * 0.1 + 1.0)
    u = t(rng.randn(D).astype(np.float32) + 1.0)
    W = whvi_dense(s1, u, s2).numpy()
    assert np.abs(W - np.diag(np.diag(W))).max() > 1e-2
    x = t(rng.randn(5, D).astype(np.float32))
    assert rel_err(whvi_mul(s1, u, s2, x), whvi_mul_dense_oracle(s1, u, s2, x)) <= F32_TOL


# ------------------------------------------------- the wrappers' contract


def test_geometry_addresses_every_row():
    """Replay the fused kernel's per-row offset arithmetic in numpy on the
    geometry the wrapper builds, for the flagship's broadcast shapes."""
    D = 16
    for s_lead, u_lead, x_lead in [
        ((8,), (4, 1, 8), (4, 6, 1)),   # stacked, shared noise
        ((8,), (4, 6, 8), (6, 1)),      # stacked, per-row noise, x over S
        ((), (4, 1), (4, 6)),           # square, shared noise
        ((), (), (2, 3, 5)),            # plain (D,) diagonals
    ]:
        rng = np.random.RandomState(0)
        ops = [
            rng.randn(*lead, D).astype(np.float32)
            for lead in (x_lead, s_lead, u_lead, s_lead)
        ]
        tensors = [t(a) for a in ops]
        lead = torch.broadcast_shapes(*(a.shape[:-1] for a in tensors))
        geom = fc._geometry(lead, tensors)
        sizes = list(geom.size)
        flat = [a.reshape(-1) for a in ops]
        rows = []
        for r in range(int(np.prod(lead, dtype=np.int64))):
            off, rem = [0, 0, 0, 0], r
            for d in (3, 2, 1, 0):
                idx, rem = rem % sizes[d], rem // sizes[d]
                for k in range(4):
                    off[k] += idx * geom.stride[4 * k + d]
            x, s1, u, s2 = (flat[k][off[k]: off[k] + D] for k in range(4))
            rows.append(s1 * fwht(t(u * fwht(t(s2 * x)).numpy())).numpy())
        want = whvi_mul(*(tensors[i] for i in (1, 2, 3, 0))).numpy()
        assert rel_err(np.stack(rows).reshape(want.shape), want) <= F32_TOL


def test_cpu_path_never_loads_the_library(monkeypatch):
    def refuse():
        raise AssertionError("CUDA library loaded on the CPU path")

    monkeypatch.setattr(fc, "load_library", refuse)
    fc.reset_launches()
    s1, u, s2, x = (
        t(a).requires_grad_() for a in _broadcast_inputs("u_per_sample")
    )
    whvi_mul(s1, u, s2, x).sum().backward()
    with torch.no_grad():
        whvi_mul(s1, u, s2, x)
    xs = torch.randn(3, 16, requires_grad=True)
    fc.fwht_cuda(xs).sum().backward()
    assert all(v == 0 for v in fc.LAUNCHES.values())


@pytest.mark.parametrize(
    "D,dtype,err",
    [
        (12, torch.float32, ValueError),
        (1, torch.float32, ValueError),
        (2 * fc.MAX_D, torch.float32, ValueError),
        (16, torch.float64, TypeError),
    ],
)
def test_check_kernel_args_rejects(D, dtype, err):
    with pytest.raises(err):
        fc.check_kernel_args(D, dtype)
    fc.check_kernel_args(fc.MAX_D, torch.float32)
    fc.check_kernel_args(2, torch.float32)


@pytest.mark.cuda
def test_cuda_wrappers_raise_before_launch(cuda_device):
    fc.reset_launches()
    bad = [
        torch.zeros(4, 12, device=cuda_device),
        torch.zeros(2, 2 * fc.MAX_D, device=cuda_device),
        torch.zeros(4, 16, device=cuda_device, dtype=torch.float64),
    ]
    for x in bad:
        d = torch.ones(x.shape[-1], device=cuda_device, dtype=x.dtype)
        with pytest.raises((ValueError, TypeError)):
            fc.fused_raw(d, d, d, x, want_residuals=False)
        with pytest.raises((ValueError, TypeError)):
            fc.fwht_raw(x)
    assert all(v == 0 for v in fc.LAUNCHES.values())


# ------------------------------------------------ the kernels' alignment


def test_vector_bytes():
    assert fc.vector_bytes(2) == 8
    for D in (4, 16, 4096, fc.MAX_D):
        assert fc.vector_bytes(D) == 16


def _f32(n):
    return torch.zeros(n, dtype=torch.float32)


# (name, tensor, width, aligned): offset views, strided leading axes,
# stride-0 broadcasts and size-1 axes, whose strides are never read
ALIGN_CASES = [
    ("contiguous", lambda: _f32(5 * 16).view(5, 16), 16, True),
    ("offset 1 float", lambda: _f32(5 * 16 + 1)[1:].view(5, 16), 16, False),
    ("offset 4 floats", lambda: _f32(5 * 16 + 4)[4:].view(5, 16), 16, True),
    ("row stride 17", lambda: _f32(5 * 17).view(5, 17)[:, :16], 16, False),
    ("row stride 20", lambda: _f32(5 * 20).view(5, 20)[:, :16], 16, True),
    ("stride-0 rows", lambda: _f32(16).expand(5, 16), 16, True),
    ("stride-0 over odd rows", lambda: _f32(3 * 17).view(3, 17)[:, :16].expand(2, 3, 16), 16, False),
    ("stride-0 off base", lambda: _f32(17)[1:].expand(5, 16), 16, False),
    ("size-1 axis, odd stride", lambda: _f32(17).view(1, 17)[:, :16], 16, True),
    ("D=2, row stride 3", lambda: _f32(15).view(5, 3)[:, :2], 8, False),
    ("D=2, row stride 4", lambda: _f32(20).view(5, 4)[:, :2], 8, True),
    ("D=2, offset 2 floats", lambda: _f32(12)[2:].view(5, 2), 8, True),
]


@pytest.mark.parametrize("case", ALIGN_CASES, ids=lambda c: c[0])
def test_vector_aligned(case):
    _, make, width, aligned = case
    tensor = make()
    assert fc.vector_aligned(tensor, width) is aligned
    fc.reset_launches()
    got = fc._aligned(tensor, width)
    assert fc.REALIGNED == (0 if aligned else 1)
    assert (got is tensor) is aligned
    assert fc.vector_aligned(got, width)
    assert torch.equal(got, tensor)
    # broadcast axes stay broadcast: nothing is materialized per row
    for n, s_in, s_out in zip(tensor.shape, tensor.stride(), got.stride()):
        assert (s_in == 0) == (s_out == 0) or n == 1
    fc.reset_launches()
    assert fc.REALIGNED == 0
