"""The column head's rows on bf16 storage: ``fwht_cuda.column_plain``,
``ColumnFunction`` and ``ColumnMatrix.column_given_g`` against the chain
they replace, against the JAX package, and the column kernel's host side.

The chain is ``ColumnMatrix.column_given_g`` as fp32 storage still runs it
(``s1[..., :n_rows, None] * fwht(H_rows * g[..., None, :]) * s2``, then
``[..., :n]``), written out here. On the CPU every path computes the same
products and the same reductions at the same shapes, so the forward and
the gradients of ``g``, ``s1`` and ``s2`` are held bit for bit
(``torch.equal``), in bf16 and fp32 storage. Against JAX's bf16
``column_given_g`` / ``apply_given_g`` (backend ``"xla"``, FWHT at
``"highest"``: matmuls where the port sums in butterfly order) the
outputs are held within ``2^-7`` of their max, the bf16 nets' bound.

The host side of the kernel (strides, geometry, alignment) runs on CPU
tensors with the ctypes entry replaced by a numpy emulation of its C
contract (``csrc/whvi_column.cu``: the per-row offsets of
``fwht_core.cuh``'s ``row_offsets``, the refusal of misaligned rows, the
three modes' roundings). The kernel itself runs on the card
(``tests/test_torch_cuda.py``).
"""

import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

import whvi_tpu.ops.hadamard as jax_hadamard
import whvi_tpu.ops.whvi_op as jax_whvi_op
from whvi_tpu.models.weights import ColumnMatrix as JaxColumnMatrix

from whvi_tpu_torch.models.weights import ColumnMatrix
from whvi_tpu_torch.ops import fwht_cuda as fc

torch.set_num_threads(1)

BF16 = torch.bfloat16
JAX_TOL = 2.0**-7  # the port's bf16 column against JAX's, of the max


def _tensor(rng, shape, dtype):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _matrix(n, dtype, replicas, rng, transposed=True):
    m = ColumnMatrix(n, transposed=transposed, dtype=dtype)
    D = m.D_adj
    lead = () if replicas is None else (replicas,)
    for name in ("s1", "s2", "g_mu", "g_rho"):
        setattr(m, name, nn.Parameter(_tensor(rng, lead + (D,), dtype) * 0.5))
    m.replicas = replicas
    return m


def _chain(m, g):
    """``column_given_g`` as fp32 storage runs it (the chain the column
    kernel replaces on bf16 storage)."""
    n_rows = m.H_rows.shape[0]
    rank = g.dim() + 1
    rows = (
        m._view(m.s1[..., :n_rows, None], rank)
        * fc.fwht_cuda(m.H_rows * g[..., None, :])
        * m._view(m.s2, rank)
    )
    return rows.reshape(g.shape[:-1] + (n_rows * m.D_adj,))[..., : m.n]


def _grads(fn, m, g, cot):
    """``fn(g)`` and the gradients of ``g``, ``s1``, ``s2`` for ``cot``."""
    g = g.clone().requires_grad_()
    m.zero_grad(set_to_none=True)
    out = fn(g)
    out.backward(cot)
    return out.detach(), g.grad, m.s1.grad.clone(), m.s2.grad.clone()


# (n, replicas, g's leading axes): D_adj = 16 and 128, n below and at
# D_adj; one column a sample (S, 1), the LRT's one a batch row (S, B), and
# replicas (R, S, 1) / (R, S, B)
CASES = [
    (16, None, (4, 1)),
    (13, None, (4, 1)),
    (128, None, (3, 5)),
    (100, None, (3, 5)),
    (16, 3, (3, 4, 1)),
    (128, 2, (2, 3, 5)),
    (100, 3, (3, 2, 4)),
]


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-R{c[1]}-{c[2]}")
def test_column_function_is_the_chain_bit_for_bit(case, dtype):
    """ColumnFunction (with the ``[..., :n]`` slice where n < D_adj)
    against autograd over the chain: forward, and the gradients of g, s1
    and s2."""
    n, replicas, lead = case
    rng = np.random.RandomState(n + len(lead))
    m = _matrix(n, dtype, replicas, rng)
    g = _tensor(rng, lead + (m.D_adj,), dtype)
    cot = _tensor(rng, lead + (n,), dtype)

    def function(g):
        col = fc.ColumnFunction.apply(m._view(m.s1, g.dim()), g, m._view(m.s2, g.dim()))
        return col[..., :n]

    want = _grads(lambda g: _chain(m, g), m, g, cot)
    got = _grads(function, m, g, cot)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert got[2][..., 1:].abs().sum() == 0  # ds1 lives at element 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-R{c[1]}-{c[2]}")
def test_bf16_column_given_g_is_the_chain_bit_for_bit(case):
    """The bf16 ColumnMatrix (column_head: the Function under autograd,
    column_raw under no_grad) against the chain; fp32 still runs the
    chain."""
    n, replicas, lead = case
    rng = np.random.RandomState(2 * n + len(lead))
    m = _matrix(n, BF16, replicas, rng)
    g = _tensor(rng, lead + (m.D_adj,), BF16)
    cot = _tensor(rng, lead + (n,), BF16)
    want = _grads(lambda g: _chain(m, g), m, g, cot)
    got = _grads(m.column_given_g, m, g, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(m.column_given_g(g), want[0])
    m32 = _matrix(n, torch.float32, replicas, rng)
    g32 = g.float()
    assert torch.equal(m32.column_given_g(g32), _chain(m32, g32))


def test_column_plain_is_the_chain_and_its_residual_the_transform():
    rng = np.random.RandomState(3)
    m = _matrix(128, BF16, 2, rng)
    g = _tensor(rng, (2, 4, 6, 128), BF16)
    s1, s2 = m._view(m.s1, 4), m._view(m.s2, 4)
    with torch.no_grad():
        y, t = fc.column_plain(s1, g, s2, True)
        assert torch.equal(y, _chain(m, g)) and torch.equal(t, fc.fwht_plain(g))
        assert fc.column_plain(s1, g, s2, False)[1] is None
        assert torch.equal(fc.column_raw(s1, g, s2, False)[0], y)


@pytest.fixture
def xla_highest():
    """JAX's bf16 storage path: backend "xla", FWHT at "highest"."""
    backend, precision = jax_whvi_op._BACKEND, jax_hadamard._DEFAULT_PRECISION
    jax_whvi_op.set_whvi_mul_backend("xla")
    jax_hadamard.set_fwht_precision("highest")
    yield
    jax_whvi_op.set_whvi_mul_backend(backend)
    jax_hadamard.set_fwht_precision(precision)


@pytest.mark.parametrize("transposed", [True, False], ids=["row", "column"])
@pytest.mark.parametrize("n, lead", [(16, (4, 1)), (100, (3, 5)), (128, (3, 5))])
def test_bf16_column_matches_jax(xla_highest, n, lead, transposed):
    """The port's bf16 column_given_g and apply_given_g against JAX's for
    the same parameters, g and x, within 2^-7 of the max."""
    rng = np.random.RandomState(n)
    m = _matrix(n, BF16, None, rng, transposed)
    g = _tensor(rng, lead + (m.D_adj,), BF16)
    rows = 7 if lead[-1] == 1 else lead[-1]  # a column a sample, or one a batch row
    x = _tensor(rng, lead[:-1] + (rows, n if transposed else 1), BF16)
    jm = JaxColumnMatrix(n, transposed=transposed)
    params = {k: jnp.asarray(getattr(m, k).detach().float().numpy(), jnp.bfloat16)
              for k in ("s1", "s2", "g_mu", "g_rho")}
    jg = jnp.asarray(g.float().numpy(), jnp.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    with torch.no_grad():
        pairs = [(m.column_given_g(g), jm.column_given_g(params, jg)),
                 (m.apply_given_g(x, g), jm.apply_given_g(params, jx, jg))]
    for got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= JAX_TOL * np.abs(want).max()


# ---------------------------------------------- the wrapper's host side


def _to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _to_bf16(x):
    """float32 -> bf16 bits, round to nearest even (finite values)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _rn(x):
    return _to_f32(_to_bf16(x))


def _fwht32(v):
    """The butterflies in the plain version's order, float32."""
    D = v.shape[-1]
    h = 1
    while h < D:
        w = v.reshape(-1, D // (2 * h), 2, h)
        v = np.stack((w[:, :, 0] + w[:, :, 1], w[:, :, 0] - w[:, :, 1]), axis=2).reshape(-1, D)
        h *= 2
    return v


def _row_offsets(sizes, strides, n_rows):
    """``(n_rows, 4)`` element offsets of each row's start in the four
    operands, as ``fwht_core.cuh``'s ``row_offsets`` takes them from a
    geometry: the innermost dim first."""
    offs = np.zeros((n_rows, 4), np.int64)
    for row in range(n_rows):
        r = row
        for d in (3, 2, 1, 0):
            if sizes[d] == 1:
                continue
            r, idx = divmod(r, sizes[d])
            offs[row] += idx * strides[:, d]
    return offs


class EmulatedColumnEntry:
    """``column_bf16s`` and ``column_nop`` of ``csrc/whvi_column.cu`` in
    numpy over host pointers: the same arguments, checks, per-row offsets
    and roundings; records its calls."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _rows(ptr, offsets, count):
        return np.stack([
            np.ctypeslib.as_array((ctypes.c_uint16 * count).from_address(ptr + 2 * int(o)))
            for o in offsets
        ])

    def column_bf16s(self, mode, x, s1, s2, res, out0, out1, out2, n_rows, log2d, geom, stream):
        geom = geom._obj
        D = 1 << log2d
        if mode not in (0, 1, 2) or not 1 <= log2d <= 14 or n_rows < 0:
            return 1
        if not (x and s1 and s2 and out0) or (mode > 0 and not out1) or (mode == 2 and not (res and out2)):
            return 1
        width = min(2 * D, 16)
        needed = [x, s2, out0] + ([out1] if mode > 0 else []) + ([res, out2] if mode == 2 else [])
        if any(p % width for p in needed):
            return 1
        sizes = list(geom.size)
        strides = np.array(list(geom.stride)).reshape(4, 4)
        if any(sizes[d] > 1 and (strides[k, d] * 2) % width for k in (0, 2, 3) for d in range(4)):
            return 1
        self.calls.append((mode, n_rows, D, sizes, strides.copy()))
        offs = _row_offsets(sizes, strides, n_rows)
        inp = _to_f32(self._rows(x, offs[:, 0], D))
        s = _to_f32(self._rows(s1, offs[:, 1], 1))
        d2 = _to_f32(self._rows(s2, offs[:, 2], D))
        if mode < 2:
            t = _rn(_fwht32(inp))
            outs = [_to_bf16(_rn(s * t) * d2), _to_bf16(t)][: mode + 1]
        else:
            t = _to_f32(self._rows(res, offs[:, 3], D))
            da = _rn(inp * d2)
            outs = [_to_bf16(_fwht32(_rn(da * s))), _to_bf16(da * t), _to_bf16(inp * _rn(s * t))]
        for ptr, o in zip((out0, out1, out2), outs):
            dst = np.ctypeslib.as_array((ctypes.c_uint16 * (n_rows * D)).from_address(ptr))
            dst[:] = o.reshape(-1)
        return 0

    def column_nop(self, n_rows, log2d, stream):
        return 0


@pytest.fixture
def entry(monkeypatch):
    """The wrappers' launch path on CPU tensors: the library replaced by
    the emulation, the CUDA device context and stream by stand-ins."""
    lib = EmulatedColumnEntry()
    monkeypatch.setattr(fc, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    fc.reset_launches()
    return lib


# (D, s lead, g lead): (D,) diagonals over one column a sample and the
# LRT's rows; replica views over (R, S, 1) and (R, S, B); D = 2 and 4,
# where a row is narrower than 16 bytes
HOST_SHAPES = [
    (16, (), (4, 1)),
    (128, (), (3, 5)),
    (128, (3, 1, 1), (3, 2, 1)),
    (64, (2, 1, 1), (2, 3, 4)),
    (2, (), (5,)),
    (4, (2, 1), (2, 3)),
]


@pytest.mark.parametrize("shape", HOST_SHAPES, ids=lambda s: f"D{s[0]}-{s[1]}-{s[2]}")
def test_launch_path_matches_plain_through_the_c_contract(entry, shape):
    """The three modes through the wrapper's launch path and the emulated
    entry equal the plain versions bit for bit; one launch each, counted
    under its mode; the geometry collapses broadcast axes to stride 0."""
    D, s_lead, g_lead = shape
    rng = np.random.RandomState(D)
    s1, s2 = (_tensor(rng, s_lead + (D,), BF16) for _ in range(2))
    g = _tensor(rng, g_lead + (D,), BF16)
    y, = fc._launch_column(0, g, s1, s2)
    y_res, t = fc._launch_column(1, g, s1, s2)
    ref_y, ref_t = fc.column_plain(s1, g, s2, True)
    assert torch.equal(y, ref_y) and torch.equal(y_res, ref_y) and torch.equal(t, ref_t)
    gy = _tensor(rng, y.shape, BF16)
    got = fc._launch_column(2, gy, s1, s2, t)
    for a, b in zip(got, fc.column_bwd_plain(s1, s2, gy, t)):
        assert a.shape == y.shape and torch.equal(a, b)
    assert [c[0] for c in entry.calls] == [0, 1, 2]
    assert fc.LAUNCHES["column_y_bf16s"] == fc.LAUNCHES["column_res_bf16s"] == 1
    assert fc.LAUNCHES["column_bwd_bf16s"] == 1 and fc.LAUNCHES["fwht_bf16s"] == 0
    mode, n_rows, _, sizes, strides = entry.calls[0]
    assert n_rows == y.numel() // D
    if not s_lead:  # (D,) diagonals: stride 0 over every row
        assert all(strides[k, d] == 0 for k in (1, 2) for d in range(4))


def test_launch_path_realigns_rows_but_not_s1(entry):
    """g and s2 off 16 bytes are copied (REALIGNED) before the entry, which
    refuses misaligned rows; s1, read one element a row, is passed as it
    is, even off by one element."""
    D = 64
    rng = np.random.RandomState(1)
    g = _tensor(rng, (4 * D + 1,), BF16)[1:].view(4, D)
    s2 = _tensor(rng, (D + 1,), BF16)[1:]
    s1 = _tensor(rng, (D + 1,), BF16)[1:]
    assert not fc.vector_aligned(g, 16) and not fc.vector_aligned(s2, 16)
    y, t = fc._launch_column(1, g, s1, s2)
    assert fc.REALIGNED == 2
    ref = fc.column_plain(s1, g, s2, True)
    assert torch.equal(y, ref[0]) and torch.equal(t, ref[1])
    lib = entry
    geom = fc._geometry(g.shape[:-1], (g, s1[..., :1], s2, g))
    out = torch.empty(4, D, dtype=BF16)
    good = [g.clone(), s1, s2.clone()]
    args = lambda x, a, b: (0, x.data_ptr(), a.data_ptr(), b.data_ptr(), None,  # noqa: E731
                            out.data_ptr(), None, None, 4, 6, ctypes.byref(geom), 0)
    assert lib.column_bf16s(*args(*good)) == 0
    assert lib.column_bf16s(*args(g, s1, good[2])) == 1  # g's rows off 16 bytes
    assert lib.column_bf16s(*args(good[0], s1, s2)) == 1  # s2 off 16 bytes


def test_wrappers_refuse_what_the_kernel_does_not_take(entry):
    rng = np.random.RandomState(2)
    s1, s2, g = (_tensor(rng, (3, 16), BF16) for _ in range(3))
    with pytest.raises(TypeError):
        fc._launch_column(0, g.float(), s1.float(), s2.float())  # fp32 storage
    with pytest.raises(TypeError):
        fc.column_raw(s1, g.float(), s2, False)  # mixed storage
    with pytest.raises(ValueError):
        fc._launch_column(0, g[:, :12].contiguous(), s1[:, :12], s2[:, :12])  # D not a power of 2
    with pytest.raises(ValueError):
        fc._launch_column(0, g, s1, s2[:, :8])  # widths differ
    with pytest.raises(ValueError):
        fc._launch_column(0, g.t().contiguous().t(), s1, s2)  # strided last axis
    assert entry.calls == [] and all(v == 0 for v in fc.LAUNCHES.values())


def test_column_given_g_asserts_one_row_of_h():
    """D_adj = next_pow_of_2(n) >= n, so one row of H survives; a matrix
    whose H_rows had two would not be the column the kernel computes."""
    m = ColumnMatrix(16, transposed=True, dtype=BF16)
    m.H_rows = torch.ones(2, 16, dtype=BF16)
    with pytest.raises(AssertionError):
        m.column_given_g(torch.zeros(1, 16, dtype=BF16))


@pytest.mark.parametrize("leads", [
    [(8, 1), (), ()],
    [(3, 2, 4), (3, 1, 1), (3, 1, 1)],
    [(4, 64, 1), (8,), (4, 1, 8), (8,)],
    [(2, 0, 3), (1, 1), (3,)],
    [(5,), (7, 1), (1,)],
])
def test_geometry_addresses_every_row_of_the_broadcast(leads):
    """The geometry of operands broadcast to their common leading shape
    gives, through the kernel's row offsets, the start of every row of
    each operand expanded to it; a broadcast axis has stride 0."""
    ops = [torch.arange(math.prod(lead) * 4).reshape(*lead, 4) for lead in leads]
    ops = (ops * 4)[:4]
    lead = torch.broadcast_shapes(*(t.shape[:-1] for t in ops))
    geom = fc._geometry(lead, ops)
    n_rows = math.prod(lead)
    offs = _row_offsets(list(geom.size), np.array(list(geom.stride)).reshape(4, 4), n_rows)
    for k, t in enumerate(ops):
        starts = t.expand(*lead, 4).reshape(n_rows, 4)[:, 0].numpy()
        assert np.array_equal(offs[:, k], starts)


def test_launch_column_refuses_shapes_that_do_not_broadcast(entry):
    rng = np.random.RandomState(3)
    g, s1, s2 = (_tensor(rng, shape, BF16) for shape in ((3, 16), (2, 16), (16,)))
    with pytest.raises(RuntimeError):
        fc._launch_column(0, g, s1, s2)
    assert entry.calls == [] and all(v == 0 for v in fc.LAUNCHES.values())
