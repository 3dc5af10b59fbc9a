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

from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import kron_cuda as kc
from whvi_tpu_torch.ops.hadamard import factor_H, fwht, fwht_factors, fwht_kron, round_bf16
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
# one; two tiles of 4 MB; 2048 chunks of 16 KB, every block of the
# persistent grid around its ring more than once; 128 tiles (fewer than
# the 132 SMs) of 16 chunks each; one tile of the whole batch, less than a
# stage
COPY_EDGE_SHAPES = [
    (128, 4096, 1), (1024, 96, 3), (2048, 48, 3), (16384, 128, 64),
    (1024, 8192, 8), (16384, 512, 4), (256, 8, 8),
]


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


# (D, B, tb) of k_scale's edges: one-row tiles (32, and far more than
# the SMs); tiles that are not a multiple of a block's 8 x 256 float4s a
# round (3 rows of 1024 and of 2048); one tile of the whole batch
SCALE_EDGE_SHAPES = [(128, 32, 1), (128, 4096, 1), (1024, 96, 3), (2048, 48, 3), (16384, 8, 8)]


@pytest.mark.parametrize("shape", SCALE_EDGE_SHAPES, ids=lambda s: f"D{s[0]}-B{s[1]}-tb{s[2]}")
def test_scale_plain_at_the_kernels_edges(shape):
    """k_scale's CPU route is x * s1 bit for bit at every tiling, equal to
    the Pallas k_scale body run over the same tiles (where the interpreted
    grid is short)."""
    D, B, tb = shape
    s1, u, s2, x = (t(a) for a in _inputs(D, B=B, seed=4))
    y = kc.k_scale(s1, u, s2, x, tb)
    assert torch.equal(y, x * s1) and y.is_contiguous()
    if B // tb <= 32:
        want = run_body(_DIAG.k_scale, *map(jnp.asarray, (s1, u, s2, x)), TB=tb)
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


@pytest.mark.parametrize("D", [128, 1024, 2048, 16384])
def test_kron_plain_is_fused_plain_bf16_from_2048(D):
    """From D = 2048 the bodies' product is K1's bf16 mode (two factors,
    the same four roundings); below it K1 contracts one factor H_D and
    rounds twice, so k_swap keeps a two-factor schedule of its own."""
    s1, u, s2, x = (t(a) for a in _inputs(D, B=8, seed=5))
    err = rel_err(kc.kron_plain(s1, u, s2, x).numpy(),
                  fc.fused_plain(s1, u, s2, x, False, "bf16")[0].numpy())
    if D >= 2048:
        assert err <= BF16_PARITY_TOL
    else:
        assert err > BF16_PARITY_TOL


def _stages(v, order):
    """Radix-2 stages of the Hadamard transform of each row of v (B, D) in
    the given order, stage s pairing e and e + 2^s as the kernels do."""
    B, D = v.shape
    for s in order:
        pair = v.reshape(B, -1, 2, 2**s)
        v = torch.stack((pair[:, :, 0] + pair[:, :, 1], pair[:, :, 0] - pair[:, :, 1]), 2)
    return v.reshape(B, D)


def swap_schedule(s1, u, s2, x):
    """kron_swap_kernel's order in PyTorch: radix-2 stages (0-6 are H_128,
    7.. H_a), the second transform's downwards, and a bf16 rounding
    wherever the kernel rounds its registers."""
    L = x.shape[1].bit_length() - 1
    v = _stages(round_bf16(x * s2), range(7))
    v = _stages(round_bf16(v), range(7, L))
    v = _stages(round_bf16(v * u), range(L - 1, 6, -1))
    v = _stages(round_bf16(v), range(6, -1, -1))
    return v * s1


@pytest.mark.parametrize("D", [128, 256, 2048])
def test_swap_schedule_matches_pallas_body(D):
    s1, u, s2, x = _inputs(D, B=16, seed=6)
    got = swap_schedule(t(s1), t(u), t(s2), t(x)).numpy()
    assert rel_err(got, kc.kron_plain(t(s1), t(u), t(s2), t(x)).numpy()) <= BF16_PARITY_TOL
    want = run_body(_TUNE.k_swap, *map(jnp.asarray, (s1, u, s2, x)), TB=4)
    assert rel_err(got, want) <= BF16_PARITY_TOL


@pytest.mark.parametrize("D", [256, 2048])
def test_cur_and_onecast_bodies_agree_bit_for_bit(D):
    """k_onecast's casts sit where k_cur's _dotg casts its operand anyway,
    so the two TPU bodies compute one function: the port launches one
    kernel for both. k_swap's body, the same chain with the axes swapped,
    agrees with them."""
    s1, u, s2, x = map(jnp.asarray, _inputs(D, B=8, seed=3))
    cur, onecast, swap = (run_body(body, s1, u, s2, x, TB=4)
                          for body in (_TUNE.k_cur, _TUNE.k_onecast, _TUNE.k_swap))
    assert np.array_equal(cur, onecast)
    assert rel_err(cur, swap) <= BF16_PARITY_TOL


def cur_schedule(s1, u, s2, x):
    """kron_cur_kernel's order in PyTorch, derived from the I/O window as
    the kernel derives it: H_128's stages 0-6 in the plain order (whether
    in registers or by lane shuffles); then H_a's stages whose bits the
    I/O window holds in registers (from bit kTop + 2, kTop its thread bits,
    L - log2 R), then those on warps (7 .. kTop + 1), which the kernel runs
    after an exchange; the second transform in reverse; a bf16 rounding
    wherever the kernel rounds its registers."""
    L = x.shape[1].bit_length() - 1
    top = L - (4 if L < 13 else 5)
    io_ha = max(top + 2, 7)
    h_a = [*range(io_ha, L), *range(7, io_ha)]
    v = _stages(round_bf16(x * s2), range(7))
    v = _stages(round_bf16(v), h_a)
    v = _stages(round_bf16(v * u), reversed(h_a))
    v = _stages(round_bf16(v), range(6, -1, -1))
    return v * s1


@pytest.mark.parametrize("D", [128, 512, 2048, 8192])
def test_cur_schedule_matches_pallas_body(D):
    s1, u, s2, x = _inputs(D, B=16, seed=7)
    got = cur_schedule(t(s1), t(u), t(s2), t(x)).numpy()
    assert rel_err(got, kc.kron_plain(t(s1), t(u), t(s2), t(x)).numpy()) <= BF16_PARITY_TOL
    want = run_body(_TUNE.k_cur, *map(jnp.asarray, (s1, u, s2, x)), TB=4)
    assert rel_err(got, want) <= BF16_PARITY_TOL


@pytest.mark.parametrize("D", [256, 2048])
def test_full_and_flat_bodies_agree_bit_for_bit(D):
    """k_flat's TPU body is k_full's statement for statement (and
    make_emit_full's inner is the same chain under an emit_pipeline), so
    the port launches one kernel for k_full, k_flat and emit_full."""
    s1, u, s2, x = map(jnp.asarray, _inputs(D, B=8, seed=4))
    full, flat = (run_body(body, s1, u, s2, x, TB=4) for body in (_DIAG.k_full, _TUNE.k_flat))
    assert np.array_equal(full, flat)


def flat_schedule(s1, u, s2, x, contractions=4):
    """kron_full_kernel<contractions>'s group view in PyTorch: x's groups
    of 16384 elements (the last one padded with zero rows) as 128 x 128
    tiles, the first `contractions` of four 128 x 128 products (1: k_mm1,
    2: k_mm2, 4: the whole product), H_128 on the right and the left
    factor I (x) H_a (kc.left_factor) on the left, the diagonals tiled over
    the group's 128 / a rows, and a bf16 rounding wherever the kernel
    rounds."""
    B, D = x.shape
    n = B * D
    groups = -(-n // 16384)
    v = torch.cat([(x * s2).reshape(-1), torch.zeros(groups * 16384 - n)]).reshape(groups, 128, 128)
    H = factor_H(128, torch.float32, x.device)
    G = kc.left_factor(D // 128)
    tiled = lambda d: d.reshape(-1, 128).repeat(128 * 128 // D, 1)  # noqa: E731
    v = round_bf16(v) @ H
    if contractions >= 2:
        v = G @ round_bf16(v)
    if contractions == 4:
        v = G @ round_bf16(v * tiled(u))
        v = (round_bf16(v) @ H) * tiled(s1)
    return v.reshape(-1)[:n].reshape(B, D)


@pytest.mark.parametrize("shape", [(128, 200), (512, 16), (2048, 16), (16384, 8)],
                         ids=lambda s: f"D{s[0]}-B{s[1]}")
def test_flat_schedule_matches_pallas_body(shape):
    D, B = shape
    s1, u, s2, x = _inputs(D, B=B, seed=8)
    got = flat_schedule(t(s1), t(u), t(s2), t(x)).numpy()
    assert rel_err(got, kc.kron_plain(t(s1), t(u), t(s2), t(x)).numpy()) <= BF16_PARITY_TOL
    want = run_body(_DIAG.k_full, *map(jnp.asarray, (s1, u, s2, x)), TB=8)
    assert rel_err(got, want) <= BF16_PARITY_TOL


@pytest.mark.parametrize("shape", [(128, 200), (2048, 16), (16384, 8)],
                         ids=lambda s: f"D{s[0]}-B{s[1]}")
@pytest.mark.parametrize("contractions", [1, 2])
def test_flat_schedule_prefix_matches_pallas_body(contractions, shape):
    """k_mm1 and k_mm2 launch kron_full_kernel<1> and <2>: the group view's
    first one or two products against kron_plain and the interpreted TPU
    bodies k_mm1 / k_mm2 (a partial group at D=128, B=200)."""
    D, B = shape
    s1, u, s2, x = _inputs(D, B=B, seed=9)
    tol = ONE_ROUNDING_TOL if contractions == 1 else BF16_PARITY_TOL
    got = flat_schedule(t(s1), t(u), t(s2), t(x), contractions).numpy()
    plain = kc.kron_plain(t(s1), t(u), t(s2), t(x), f"mm{contractions}").numpy()
    assert rel_err(got, plain) <= tol
    body = _DIAG.k_mm1 if contractions == 1 else _DIAG.k_mm2
    want = run_body(body, *map(jnp.asarray, (s1, u, s2, x)), TB=8)
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("L", range(7, 15))
def test_left_factor_is_kron_of_identity_and_h_a(L):
    a = 2 ** (L - 7)
    want = np.kron(np.eye(128 // a), np.asarray(jax_build_H(a, jnp.float32)))
    assert np.array_equal(kc.left_factor(a).numpy(), want)


def test_tile_offset_is_the_wgmma_128_byte_swizzle():
    """whvi_full.cu's tile layout: each 128 x 128 bf16 element at its own
    2-byte slot of the 32 KB tile, and every slot the 128-byte swizzle
    (16-byte group bits 4-6 XOR row bits 7-9) of the plain row-major
    address of two 64-column halves, as wgmma's descriptors read it."""
    m = torch.arange(128)[:, None].expand(128, 128)
    j = torch.arange(128)[None, :].expand(128, 128)
    off = kc.tile_offset(m, j)
    assert sorted(off.reshape(-1).tolist()) == list(range(0, kc.TILE_BYTES, 2))
    plain = (j // 64) * (kc.TILE_BYTES // 2) + m * 128 + (j % 64) * 2
    assert torch.equal(off, plain ^ (((plain >> 7) & 7) << 4))
    assert kc.tile_offset(5, 70) == 16384 + 5 * 128 + ((0 ^ 5) << 4) + 6 * 2


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
