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


# ------------------------------------------------------------ the stacked form
#
# A StackedMatrix's product: s1, s2 (stack, D), u (S, 1, stack, D) or one
# (stack, D) row for all, x (S, N, 1, D) broadcast over the stack axis,
# outputs (S, N, stack, D).


def _stacked(D, stack, u_lead, x_lead=(S, 8, 1), dtype=torch.float32, s_lead=None, device=None):
    """(s1, u, s2, x) of a stacked product; ``device="meta"`` for shapes alone."""
    s_lead = (stack,) if s_lead is None else s_lead
    if device == "meta":
        return tuple(torch.empty(*lead, D, dtype=dtype, device="meta")
                     for lead in (s_lead, u_lead, s_lead, x_lead))
    gen = torch.Generator().manual_seed(4)
    return tuple(_randn(gen, *lead, D, dtype=dtype) for lead in (s_lead, u_lead, s_lead, x_lead))


STACKED_RULE = {
    # taken: (group, stack), group the leading rows that share a row of u
    "stack1-trailing-one": (_stacked(2048, 1, (S, 1, 1)), (8, 1)),
    "stack2": (_stacked(2048, 2, (S, 1, 2)), (8, 2)),
    "stack6": (_stacked(2048, 6, (S, 1, 6)), (8, 6)),
    "stack7": (_stacked(2048, 7, (S, 1, 7)), (8, 7)),
    "stack8-D512": (_stacked(512, 8, (S, 1, 8)), (8, 8)),
    "stack1-D4096": (_stacked(4096, 1, (S, 1, 1)), (8, 1)),
    "stack2-u-shared": (_stacked(2048, 2, (2,)), (S * 8, 2)),
    "stack8-u-shared-with-ones": (_stacked(512, 8, (1, 1, 8)), (S * 8, 8)),
    "stack1-u-shared": (_stacked(4096, 1, (1,)), (S * 8, 1)),
    "x-its-own-block": (_stacked(512, 8, (S, 1, 8), x_lead=(S, 8, 8)), (8, 8)),
    # refused
    "per-row-u": (_stacked(2048, 2, (S, 8, 2)), None),
    "per-row-u-batch-1": (_stacked(2048, 2, (S, 1, 2), x_lead=(S, 1, 1)), None),
    "replicated": (_stacked(512, 8, (3, S, 1, 8), x_lead=(3, S, 8, 1), s_lead=(3, 1, 1, 8)), None),
    "bf16-storage": (_stacked(2048, 2, (S, 1, 2), dtype=torch.bfloat16), None),
    "D16384": (_stacked(16384, 1, (S, 1, 1), device="meta"), None),
    "u-shared-across-blocks": (_stacked(512, 8, (S, 1, 1)), None),
    "square": (_case(64, (), (4, 1), (4, 8)), None),
}


@pytest.mark.parametrize("name", sorted(STACKED_RULE))
def test_sums_stacked_rule(name):
    operands, want = STACKED_RULE[name]
    assert fc.sums_stacked(*operands) == want


@pytest.mark.parametrize("name", sorted(RULE))
def test_every_square_case_keeps_its_answer(name):
    """The backward asks the square rule first: each of its cases keeps the
    square form's answer, and only a refused one reaches the stacked rule."""
    operands, group = RULE[name]
    mode = fc._reduce_mode(*operands)
    if group is not None:
        assert mode == (group, None)
    else:
        assert mode == fc.sums_stacked(*operands)
    assert (mode is not None) == (name in ("stacked",) or group is not None)


@pytest.mark.parametrize("name", sorted(STACKED_RULE))
def test_the_stacked_form_runs_in_the_fp32_precision_alone(name):
    """The stacked form has no bf16 instance: in the bf16 precision only the
    square rule's answer stands."""
    operands, stacked = STACKED_RULE[name]
    square = fc.sums_group(*operands)
    assert fc._reduce_mode(*operands) == (stacked if square is None else (square, None))
    assert fc._reduce_mode(*operands, "bf16") == (None if square is None else (square, None))


COUNTERS = {
    "square": (RULE["harness"][0], "fp32", "fused_bwd_sums"),
    "square-bf16": (RULE["harness"][0], "bf16", "fused_bwd_sums_bf16"),
    "stacked": (STACKED_RULE["stack7"][0], "fp32", "fused_bwd_sums_stacked"),
    "stacked-bf16": (STACKED_RULE["stack7"][0], "bf16", "fused_bwd_bf16"),
    "per-example-u": (RULE["per-example-u"][0], "fp32", "fused_bwd"),
    "per-row-u-bf16": (STACKED_RULE["per-row-u"][0], "bf16", "fused_bwd_bf16"),
    "bf16-storage": (RULE["bf16-storage"][0], "fp32", "fused_bwd_bf16s"),
    "D16384": (STACKED_RULE["D16384"][0], "fp32", "fused_bwd"),
}


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_bwd_counter_names_the_backwards_k3_launch(name):
    operands, precision, want = COUNTERS[name]
    assert fc.bwd_counter(*operands, precision) == want
    assert want in fc.LAUNCHES and fc.KERNEL_SPANS[want] == "whvi.kernel." + want


# The DeepSeek-V2-Lite cell's stacked maps at S = 4 samples of N = 4096
# sample-token rows: (D, stack), u one a sample
CELL_STACKED = {
    "q_proj": (2048, 2), "kv_a_proj_with_mqa": (2048, 1), "kv_b_proj": (512, 8),
    "router": (2048, 1), "shared_gate_up": (2048, 2), "shared_down": (4096, 1),
    "dense_gate_up": (2048, 6), "lm_head": (2048, 7),
}


def _slot_rows(n_runs, run, stack):
    """The output rows of each slot, (n_runs, run), as the stacked kernel
    walks them: slot j stack + k takes rows (j run + i) stack + k."""
    slot = torch.arange(n_runs)[:, None]
    k, j = slot % stack, slot // stack
    return (j * run + torch.arange(run)) * stack + k


@pytest.mark.parametrize("name", sorted(CELL_STACKED))
def test_stacked_runs_at_the_cells_shapes(name):
    """A run keeps to one stack block and one sample, the runs cover every
    output row once, and they fill at least SUMS_BLOCKS blocks."""
    D, stack = CELL_STACKED[name]
    N = 4096
    ops = _stacked(D, stack, (4, 1, stack), x_lead=(4, N, 1), device="meta")
    assert fc.sums_group(*ops) is None
    group, got_stack = fc.sums_stacked(*ops)
    assert (group, got_stack) == (N, stack)
    rows = 4 * N * stack
    run = fc._sums_run(rows, group, D)
    assert group % run == 0
    n_runs = rows // run
    slot_rows = _slot_rows(n_runs, run, stack)
    assert torch.equal(slot_rows.flatten().sort().values, torch.arange(rows))
    sample, block = slot_rows // (N * stack), slot_rows % stack
    assert bool((sample == sample[:, :1]).all()) and bool((block == block[:, :1]).all())
    L = int(math.log2(D))
    slots_per_block = 256 // (1 << (L - 4)) if L < 12 else 1
    assert n_runs // slots_per_block >= fc.SUMS_BLOCKS


STACKED_PLAIN = [
    (16, 1, (S, 1, 1)), (16, 3, (S, 1, 3)), (64, 8, (S, 1, 8)), (64, 2, (2,)),
    (512, 8, (S, 1, 8)), (2048, 7, (S, 1, 7)),
]


@pytest.mark.parametrize("shape", STACKED_PLAIN, ids=lambda s: f"D{s[0]}-stack{s[1]}-u{s[2]}")
def test_plain_stacked_reduce_mode_is_autograd_of_the_product(shape):
    """fused_bwd_sums_plain on a stacked product equals autograd of
    fused_plain: ds1, du and ds2, and dx once summed over the stack axis."""
    D, stack, u_lead = shape
    s1, u, s2, x = _stacked(D, stack, u_lead, x_lead=(S, 5, 1))
    assert fc.sums_stacked(s1, u, s2, x) is not None
    g, i1, i2 = _cotangent(s1, u, s2, x)
    dx, ds1, du, ds2 = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
    leaves = [t.clone().requires_grad_() for t in (s1, u, s2, x)]
    fc.fused_plain(*leaves, False)[0].backward(g)
    assert dx.shape == g.shape
    for got, leaf in zip((ds1, du, ds2, dx.sum_to_size(x.shape)), leaves):
        assert got.shape == leaf.shape
        assert ((got - leaf.grad).abs().max() / leaf.grad.abs().max()).item() <= TOL


@pytest.mark.parametrize("shape", [(16, 3, (S, 1, 3)), (64, 8, (S, 1, 8)), (64, 2, (2,)),
                                   (8, 5, (1, 1, 5)), (2048, 2, (S, 1, 2))],
                         ids=lambda s: f"D{s[0]}-stack{s[1]}-u{s[2]}")
def test_stacked_runs_sum_to_the_plain_reductions(shape):
    """The stacked kernel's partition: slots j stack + k over rows (j run +
    i) stack + k, partial sums a slot, then the second pass's order (each
    block's runs, and for du each sample's); against the plain reductions."""
    D, stack, u_lead = shape
    s1, u, s2, x = _stacked(D, stack, u_lead, x_lead=(S, 12, 1))
    group, _ = fc.sums_stacked(s1, u, s2, x)
    g, i1, i2 = _cotangent(s1, u, s2, x)
    rows = g.numel() // D
    run = fc._sums_run(rows, group, D)
    n_runs, n_groups = rows // run, rows // (group * stack)
    _, w1, t2 = fc.fused_plain(s2, u, s1, g, True)
    products = [(a * b).reshape(rows, D) for a, b in ((g, i2), (w1, i1), (x.expand(g.shape), t2))]
    slot_rows = _slot_rows(n_runs, run, stack)
    part = [p[slot_rows[:, 0]].clone() for p in products]
    for i in range(1, run):
        for acc, p in zip(part, products):
            acc += p[slot_rows[:, i]]
    per = n_runs // stack  # runs a block; the second pass adds them in slot order
    ds1, ds2 = (p.reshape(per, stack, D).sum(0) for p in (part[0], part[2]))
    du = part[1].reshape(n_groups, per // n_groups, stack, D).sum(1).reshape(u.shape)
    want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, False)
    for got, ref in zip((ds1, du, ds2), want[1:]):
        assert got.shape == ref.shape
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= TOL


def test_the_cpu_backward_of_a_stacked_product_keeps_the_plain_composition(monkeypatch):
    """On CPU tensors a stacked product's backward also runs K3's plain
    version and _input_grads, where the stacked form would take it on a card."""
    s1, u, s2, x = (t.requires_grad_() for t in _stacked(64, 8, (S, 1, 8)))
    calls = []
    real = fc.fused_bwd_raw
    monkeypatch.setattr(fc, "fused_bwd_raw", lambda *a: calls.append(1) or real(*a))
    fc.WhviMulFunction.apply(s1, u, s2, x).sum().backward()
    assert calls == [1] and math.isfinite(s1.grad.sum().item()) and x.grad.shape == x.shape
