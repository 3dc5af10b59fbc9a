"""K3's reduce mode on the CPU: its plain version, the rule that decides
which products take it, and its runs of rows.

``fused_bwd_sums_raw`` takes the plain version for CPU tensors; the kernel
itself is held against it on the card (``tests/test_torch_cuda.py``). The
plain version is today's composition, K3's plain product on the swapped
operands and then ``_input_grads``, so they agree bit for bit. The
emulation of the kernel's runs sums the same products in another order,
hence the fp32 tolerance there.
"""

import math

import pytest
import torch

from whvi_tpu_torch.ops import fwht_cuda as fc

TOL = 1e-5  # the same rounded products, summed in another order
S, B = 2, 3


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


def _operands(D, kind, seed=0, dtype=torch.float32):
    """(s1, u, s2, x) of a product the reduce mode takes (``kind``)."""
    gen = torch.Generator().manual_seed(seed)
    s1, s2 = _randn(gen, D, dtype=dtype), _randn(gen, D, dtype=dtype)
    if kind == "shared-u":
        return s1, _randn(gen, D, dtype=dtype), s2, _randn(gen, B, D, dtype=dtype)
    u = _randn(gen, S, 1, D, dtype=dtype)
    if kind == "per-sample-u":
        return s1, u, s2, _randn(gen, S, B, D, dtype=dtype)
    return s1, u, s2, _randn(gen, B, D, dtype=dtype).expand(S, B, D)  # "x-expanded"


def _cotangent(s1, u, s2, x, precision="fp32", seed=1):
    _, i1, i2 = fc.fused_raw(s1, u, s2, x, True, precision)
    g = torch.randn(i1.shape, generator=torch.Generator().manual_seed(seed)).to(x.dtype)
    return g, i1, i2


KINDS = ("shared-u", "per-sample-u", "x-expanded")


@pytest.mark.parametrize("want_dx", [True, False], ids=["dx", "no-dx"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D", [4, 64, 2048, 8192])
def test_plain_reduce_mode_is_the_old_composition(D, kind, want_dx):
    s1, u, s2, x = _operands(D, kind)
    assert fc.sums_group(s1, u, s2, x) is not None
    for precision in ("fp32", "bf16"):
        g, i1, i2 = _cotangent(s1, u, s2, x, precision)
        got = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, want_dx, precision)
        dx, w1, t2 = fc.fused_bwd_raw(s1, u, s2, g, precision)
        want = fc._input_grads((True,) * 4, s1, u, s2, x, g, i1, i2, dx, w1, t2)
        assert (got[0] is None) == (not want_dx)
        if want_dx:
            assert torch.equal(got[0], dx)
        for a, b, op in zip(got[1:], want[:3], (s1, u, s2)):
            assert a.shape == op.shape
            assert torch.equal(a, b)


def _expand(t, shape):
    return t.expand(shape) if t.shape != shape else t


@pytest.mark.parametrize(
    "shape",
    [(4, (), (33,)), (64, (4, 1), (4, 64)), (2048, (8, 1), (8, 256)), (8192, (64, 1), (64, 256)),
     (8192, (), (5,)), (16, (3, 1), (3, 6))],
    ids=lambda s: f"D{s[0]}-u{s[1]}-x{s[2]}",
)
def test_runs_of_rows_sum_to_the_plain_reductions(shape):
    """The kernel's partition of the rows: runs of ``_sums_run`` rows that
    each lie within one row of ``u``, partial sums a run, then each sum
    over its runs in order; against the plain reductions."""
    D, u_lead, x_lead = shape
    gen = torch.Generator().manual_seed(2)
    s1, s2 = _randn(gen, D), _randn(gen, D)
    u, x = _randn(gen, *u_lead, D), _randn(gen, *x_lead, D)
    group = fc.sums_group(s1, u, s2, x)
    g, i1, i2 = _cotangent(s1, u, s2, x)
    rows = g.numel() // D
    run = fc._sums_run(rows, group, D)
    assert group % run == 0 and rows % group == 0
    _, w1, t2 = fc.fused_plain(s2, u, s1, g, True)
    products = [(a * b).reshape(rows // run, run, D) for a, b in ((g, i2), (w1, i1), (_expand(x, g.shape), t2))]
    part = [p[:, 0].clone() for p in products]  # the kernel's accumulators, a row at a time
    for i in range(1, run):
        for acc, p in zip(part, products):
            acc += p[:, i]
    ds1, ds2 = part[0].sum(0), part[2].sum(0)
    du = part[1].reshape(rows // group, group // run, D).sum(1).reshape(u.shape)
    want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, False)
    for got, ref in zip((ds1, du, ds2), want[1:]):
        assert got.shape == ref.shape
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= TOL


def test_runs_fill_the_card_at_the_cells_shape():
    """At (64, 256, 8192) with u (64, 1, 8192) a run is 64 rows: 256 runs,
    one block each, and a run never crosses a sample."""
    run = fc._sums_run(64 * 256, 256, 8192)
    assert run == 64 and 64 * 256 // run == fc.SUMS_BLOCKS
    assert fc._sums_run(8 * 256, 256, 4096) == 8  # the scaling shape: 256 blocks
    assert fc._sums_run(33, 33, 16) == 1  # too few rows for a run: one row each


def _case(D, s_lead, u_lead, x_lead, dtype=torch.float32, x_expand=None):
    gen = torch.Generator().manual_seed(3)
    s1, s2 = _randn(gen, *s_lead, D, dtype=dtype), _randn(gen, *s_lead, D, dtype=dtype)
    u, x = _randn(gen, *u_lead, D, dtype=dtype), _randn(gen, *x_lead, D, dtype=dtype)
    if x_expand is not None:
        x = x.expand(*x_expand, D)
    return s1, u, s2, x


RULE = {
    # taken: (D,) diagonals, u shared or one a sample, any x
    "square": (_case(64, (), (), (8,)), 8),
    "square-u-one-row": (_case(64, (), (1, 1), (4, 8)), 32),
    "scaling": (_case(4096, (), (8, 1), (256,), x_expand=(8, 256)), 256),
    "harness": (_case(8192, (), (4, 1), (4, 16)), 16),
    "diagonals-with-leading-ones": (_case(128, (1, 1), (4, 1), (4, 16)), 16),
    # refused
    "stacked": (_case(16, (8,), (4, 1, 8), (4, 64, 1)), None),
    "stacked-per-row-u": (_case(16, (8,), (4, 64, 8), (64, 1)), None),
    "per-example-u": (_case(128, (), (4, 64), (4, 64)), None),
    "per-example-u-batch-1": (_case(128, (), (4, 1), (4, 1)), None),
    "replicated": (_case(64, (3, 1, 1), (3, 4, 1), (3, 4, 8)), None),
    "bf16-storage": (_case(64, (), (4, 1), (4, 8), dtype=torch.bfloat16), None),
    "D16384": (_case(16384, (), (2, 1), (2, 2)), None),
    "u-over-an-outer-axis": (_case(64, (), (4, 1, 1), (4, 2, 8)), None),
}


@pytest.mark.parametrize("name", sorted(RULE))
def test_sums_group_rule(name):
    operands, group = RULE[name]
    assert fc.sums_group(*operands) == group


def test_the_cpu_backward_keeps_the_plain_composition(monkeypatch):
    """On CPU tensors WhviMulFunction's backward runs K3's plain version and
    _input_grads, as before, even where the reduce mode would take the
    operands on a card."""
    s1, u, s2, x = (t.requires_grad_() for t in _operands(64, "per-sample-u"))
    calls = []
    real = fc.fused_bwd_raw
    monkeypatch.setattr(fc, "fused_bwd_raw", lambda *a: calls.append(1) or real(*a))
    fc.WhviMulFunction.apply(s1, u, s2, x).sum().backward()
    assert calls == [1] and math.isfinite(s1.grad.sum().item())
