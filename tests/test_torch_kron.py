"""The port's large-D diagnosis path against the JAX package, on the CPU.

The Kronecker FWHT (``fwht_factors``, ``fwht_kron``) against its JAX
counterpart and the float64 C++ oracle; the plain version of each kernel
of ``whvi_tpu_torch/ops/kron_cuda.py`` against the Pallas body it
replaces (imported from ``benchmarks/pallas_diag.py`` and
``pallas_tune.py``, run by ``pl.pallas_call(..., interpret=True)`` with
plain BlockSpecs); the wrappers' argument checks; the flop counts; the
bench entry points without a card. The kernels themselves are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Tolerances, as ``max|port - ref| / max|ref|``:

- ``EXACT`` (0): copies and the scale, the same fp32 operations.
- ``F32_TOL`` (1e-6): fp32 transforms, the same products summed in
  another order; ``F64_TOL`` (1e-12) in float64.
- ``ONE_ROUNDING_TOL`` (1e-5): ``mm1`` rounds the same fp32 value to bf16
  once, then sums in another order.
- ``BF16_PARITY_TOL`` (2.5e-4): bf16 paths with the roundings at the same
  points. The fp32 sums may run in another order (1e-7 here), and a sum
  on the other side of a bf16 rounding boundary moves the result by up to
  2.5e-4 (B=512, D=16384); placing the roundings elsewhere moves it by
  1.4e-3 or more.
- ``kc.BF16_TOL`` (2^-7): the full product against the fp32 product.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from whvi_tpu.ops import whvi_mul as jax_whvi_mul
from whvi_tpu.ops.cpu_oracle import fwht_cpp, oracle_available
from whvi_tpu.ops.hadamard import build_H as jax_build_H
from whvi_tpu.ops.hadamard import fwht_factors as jax_fwht_factors
from whvi_tpu.ops.hadamard import fwht_kron as jax_fwht_kron
from whvi_tpu.utils.profiling import fwht_flops as jax_fwht_flops
from whvi_tpu.utils.profiling import whvi_mul_flops as jax_whvi_mul_flops

from whvi_tpu_torch.ops import kron_cuda as kc
from whvi_tpu_torch.ops.hadamard import fwht, fwht_factors, fwht_kron, round_bf16
from whvi_tpu_torch.utils import profiling

torch.set_num_threads(1)

EXACT = 0.0
F32_TOL = 1e-6
F64_TOL = 1e-12
ONE_ROUNDING_TOL = 1e-5
BF16_PARITY_TOL = 2.5e-4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _load_harness(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_DIAG = _load_harness("pallas_diag")
_TUNE = _load_harness("pallas_tune")

# wrapper -> (the Pallas body it replaces, tolerance of its plain version)
BODIES = {
    "k_copy": (_DIAG.k_copy, EXACT),
    "k_scale": (_DIAG.k_scale, EXACT),
    "k_mm1": (_DIAG.k_mm1, ONE_ROUNDING_TOL),
    "k_mm2": (_DIAG.k_mm2, BF16_PARITY_TOL),
    "k_full": (_DIAG.k_full, BF16_PARITY_TOL),
    "k_cur": (_TUNE.k_cur, BF16_PARITY_TOL),
    "k_swap": (_TUNE.k_swap, BF16_PARITY_TOL),
    "k_flat": (_TUNE.k_flat, BF16_PARITY_TOL),
    "k_onecast": (_TUNE.k_onecast, BF16_PARITY_TOL),
}


def run_body(body, s1, u, s2, x, TB):
    """A Pallas body of the TPU harness over x (B, D) in tiles of TB rows,
    interpreted, with the harness's operands (u in its swapped layout)."""
    B, D = x.shape
    a, b = D // 128, 128
    vec = pl.BlockSpec((1, a, b), lambda i: (0, 0, 0))
    vec_sw = pl.BlockSpec((1, b, a), lambda i: (0, 0, 0))
    mat = lambda n: pl.BlockSpec((n, n), lambda i: (0, 0))  # noqa: E731
    tile = pl.BlockSpec((TB, a, b), lambda i: (i, 0, 0))
    y = pl.pallas_call(
        body,
        grid=(B // TB,),
        in_specs=[vec, vec_sw, vec, mat(a), mat(b), tile],
        out_specs=tile,
        out_shape=jax.ShapeDtypeStruct((B, a, b), jnp.float32),
        interpret=True,
    )(
        s2.reshape(1, a, b),
        u.reshape(a, b).T.reshape(1, b, a),
        s1.reshape(1, a, b),
        jax_build_H(a, jnp.bfloat16),
        jax_build_H(b, jnp.bfloat16),
        x.reshape(B, a, b),
    )
    return np.asarray(y).reshape(B, D)


def _inputs(D, B=16, seed=0):
    rng = np.random.RandomState(seed + D)
    s1, u, s2 = (rng.randn(D).astype(np.float32) for _ in range(3))
    return s1, u, s2, rng.randn(B, D).astype(np.float32)


# ------------------------------------------------------- Kronecker FWHT


@pytest.mark.parametrize("D", [1, 2, 128, 256, 2048, 2**14, 2**21])
@pytest.mark.parametrize("max_factor", [4, 128])
def test_fwht_factors_match_jax(D, max_factor):
    assert fwht_factors(D, max_factor) == jax_fwht_factors(D, max_factor)


def test_fwht_factors_reject():
    for D, mf in ((12, 128), (16, 3)):
        with pytest.raises(ValueError):
            fwht_factors(D, mf)
    with pytest.raises(ValueError):
        fwht_kron(torch.zeros(2, 16), precision="tf32")


@needs_oracle
@pytest.mark.parametrize("D", [2, 128, 256, 2048, 16384])
def test_fwht_kron_fp32_matches_jax_highest_and_oracle(D):
    rng = np.random.RandomState(D)
    x = rng.randn(3, D).astype(np.float32)
    got = fwht_kron(t(x))
    assert got.dtype == torch.float32
    want = jax_fwht_kron(jnp.asarray(x), precision="highest")
    assert rel_err(got.numpy(), want) <= F32_TOL
    x64 = x.astype(np.float64)
    assert rel_err(got.numpy(), fwht_cpp(x64)) <= F32_TOL
    assert rel_err(fwht_kron(t(x64)).numpy(), fwht_cpp(x64)) <= F64_TOL


@pytest.mark.parametrize("D", [2, 128, 256, 2048, 16384])
def test_fwht_kron_bf16_matches_jax(D):
    rng = np.random.RandomState(D + 1)
    x = rng.randn(2, 3, D).astype(np.float32)
    got = fwht_kron(t(x), precision="bf16").numpy()
    want = jax_fwht_kron(jnp.asarray(x), precision="bf16")
    assert rel_err(got, want) <= BF16_PARITY_TOL
    # and it does round: the fp32 transform is farther off than that
    assert rel_err(got, fwht(t(x)).numpy()) > 4 * BF16_PARITY_TOL


# ------------------------------------------- plain versions vs the bodies


@pytest.mark.parametrize("D", [256, 1024, 2048])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_plain_matches_pallas_body(name, D):
    body, tol = BODIES[name]
    s1, u, s2, x = _inputs(D)
    want = run_body(body, *map(jnp.asarray, (s1, u, s2, x)), TB=8)
    got = kc.VARIANTS[name](t(s1), t(u), t(s2), t(x), 8).numpy()
    assert rel_err(got, want) <= tol
    if name in kc.FULL_PRODUCT:
        fp32 = jax_whvi_mul(*map(jnp.asarray, (s1, u, s2, x)))
        assert rel_err(got, fp32) <= kc.BF16_TOL


# (D, B, tb) of the copy kernels' edges (tests/test_torch_cuda.py
# KRON_SHAPES): tiles of one 512-byte row, far more than the grid; 12 KB
# tiles, less than a ring stage; 24 KB tiles, a full chunk and a short
# one; two tiles of 4 MB
COPY_EDGE_SHAPES = [(128, 4096, 1), (1024, 96, 3), (2048, 48, 3), (16384, 128, 64)]


@pytest.mark.parametrize("shape", COPY_EDGE_SHAPES, ids=lambda s: f"D{s[0]}-B{s[1]}-tb{s[2]}")
@pytest.mark.parametrize("name", ["k_copy", "hbm_copy", "copy_2d", "emit_copy"])
def test_copies_plain_at_the_kernels_edges(name, shape):
    """The copies' CPU route is a fresh copy of x at every tiling, equal
    to the Pallas k_copy body run over the same tiles (where the
    interpreted grid is short)."""
    D, B, tb = shape
    s1, u, s2, x = (t(a) for a in _inputs(D, B=B, seed=3))
    y = kc.VARIANTS[name](s1, u, s2, x, tb)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr() and y.is_contiguous()
    if B // tb <= 32:
        want = run_body(_DIAG.k_copy, *map(jnp.asarray, (s1, u, s2, x)), TB=tb)
        assert rel_err(y.numpy(), want) == EXACT


@pytest.mark.parametrize("D", [256, 2048])
def test_pipelined_and_copy_floors_plain(D):
    """D2 (emit_full) computes k_full's body; D3 copies are the identity."""
    s1, u, s2, x = _inputs(D, seed=1)
    want = run_body(_DIAG.k_full, *map(jnp.asarray, (s1, u, s2, x)), TB=8)
    args = (t(s1), t(u), t(s2), t(x))
    assert rel_err(kc.emit_full(*args, 8).numpy(), want) <= BF16_PARITY_TOL
    for name in ("hbm_copy", "copy_2d", "emit_copy"):
        y = kc.VARIANTS[name](*args, 4)
        assert torch.equal(y, args[3]) and y.data_ptr() != args[3].data_ptr()


def test_kron_plain_is_not_fwht_kron_bf16():
    """The bodies' order of factors is part of what they compute: the
    most-significant-first fwht_kron rounds other intermediates."""
    s1, u, s2, x = (t(a) for a in _inputs(1024, B=8, seed=2))
    body_order = kc.kron_plain(s1, u, s2, x)
    msb_first = s1 * fwht_kron(u * fwht_kron(s2 * x, precision="bf16"), precision="bf16")
    assert rel_err(body_order.numpy(), msb_first.numpy()) > 4 * BF16_PARITY_TOL
    # mm2 is H_D(s2*x) with two roundings
    mm2 = kc.kron_plain(s1, u, s2, x, "mm2")
    assert rel_err(mm2.numpy(), fwht(round_bf16(s2 * x)).numpy()) <= kc.BF16_TOL


# ----------------------------------------------------- the wrappers' contract


def _bad_calls():
    s1, u, s2, x = (t(a) for a in _inputs(256, B=12))
    d64 = torch.ones(64)
    return [
        ("B % tb", (s1, u, s2, x, 5), ValueError),
        ("tb 0", (s1, u, s2, x, 0), ValueError),
        ("D < 128", (d64, d64, d64, torch.ones(4, 64), 2), ValueError),
        ("D > 16384", (s1, u, s2, torch.ones(2, 32768), 2), ValueError),
        ("D not 2^k", (s1, u, s2, torch.ones(4, 384), 2), ValueError),
        ("float64", (s1, u, s2, x.double(), 4), TypeError),
        ("strided", (s1, u, s2, torch.ones(512, 12).t(), 4), ValueError),
        ("3-D", (s1, u, s2, x[:, None], 4), ValueError),
        ("misaligned", (s1, u, s2, _misaligned(12, 256), 4), ValueError),
    ]


def _misaligned(B, D):
    """A contiguous (B, D) view that starts 4 bytes past a 16-byte
    boundary: it passes every check but the alignment."""
    x = torch.randn(B * D + 1)[1:].view(B, D)
    assert x.is_contiguous() and x.data_ptr() % kc.ALIGN == 4
    return x


@pytest.mark.parametrize("name", list(kc.VARIANTS))
def test_wrappers_refuse(name):
    fn = kc.VARIANTS[name]
    for what, args, err in _bad_calls():
        if name == "hbm_copy" and what in ("B % tb", "tb 0"):
            continue  # untiled
        with pytest.raises(err):
            fn(*args)
    if name not in ("hbm_copy", "copy_2d", "emit_copy"):
        s1, u, s2, x = (t(a) for a in _inputs(256, B=12))
        with pytest.raises(ValueError):
            fn(s1[:128], u, s2, x, 4)
        with pytest.raises(TypeError):
            fn(s1, u.double(), s2, x, 4)


@pytest.mark.parametrize("name", list(kc.VARIANTS))
def test_wrappers_refuse_misaligned_operands(name):
    """The kernels read x and the diagonals as float4 and by TMA bulk
    copies: an operand off a 16-byte boundary is refused on every device,
    before any launch."""
    fn = kc.VARIANTS[name]
    s1, u, s2, x = (t(a) for a in _inputs(256, B=8))
    kc.reset_launches()
    with pytest.raises(ValueError, match="16-byte boundary"):
        fn(s1, u, s2, _misaligned(8, 256), 4)
    if name not in ("hbm_copy", "copy_2d", "emit_copy"):  # they read no diagonal
        for i in range(3):
            diags = [s1, u, s2]
            diags[i] = torch.randn(257)[1:]
            with pytest.raises(ValueError, match="16-byte boundary"):
                fn(*diags, x, 4)
    assert all(v == 0 for v in kc.LAUNCHES.values())
    x = _misaligned(8, 256).clone()  # the same values, aligned: taken
    assert fn(s1, u, s2, x, 4).shape == x.shape


def test_cpu_path_never_loads_the_library(monkeypatch):
    def refuse():
        raise AssertionError("CUDA library loaded on the CPU path")

    monkeypatch.setattr(kc, "load_library", refuse)
    kc.reset_launches()
    s1, u, s2, x = (t(a) for a in _inputs(128, B=8))
    for name, fn in kc.VARIANTS.items():
        assert fn(s1, u, s2, x, 4).shape == x.shape
    assert all(v == 0 for v in kc.LAUNCHES.values())
    assert set(kc.LAUNCHES) == set(kc.VARIANTS)


def test_smoke_lists_every_kernel():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert list(chip_smoke.KRON_KERNELS) == list(kc.VARIANTS)
    for source, replaces in chip_smoke.KRON_KERNELS.values():
        assert os.path.exists(os.path.join(ROOT, source))
        path, line = replaces.split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def ")


# ------------------------------------------------------- counts and entries


@pytest.mark.parametrize("D", [1, 2, 128, 256, 4096, 16384])
@pytest.mark.parametrize("batch", [1, 512])
def test_flop_counts_match_jax(D, batch):
    assert profiling.fwht_flops(D, batch) == jax_fwht_flops(D, batch)
    assert profiling.whvi_mul_flops(D, batch) == jax_whvi_mul_flops(D, batch)


def test_spec_constants_are_the_h100_data_sheet():
    assert profiling.H100_HBM_GBPS == 3350.0
    assert profiling.H100_PEAK_BF16_FLOPS == 989e12
    assert profiling.H100_PEAK_TF32_FLOPS == 495e12
    assert profiling.H100_PEAK_FP32_FLOPS == 67e12


@pytest.mark.parametrize("module", ["kernel_diag", "kernel_tune", "kernel_check"])
def test_bench_entry_points_refuse_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run")
    mod = importlib.import_module(f"whvi_tpu_torch.bench.{module}")
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main([])
    proc = subprocess.run(
        [sys.executable, "-m", f"whvi_tpu_torch.bench.{module}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
