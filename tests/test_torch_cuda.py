"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX; there ``tests/conftest.py`` (which configures JAX) is left
out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance of the flagship kernels: ``max|kernel - plain| / max|plain| <=
1e-5`` (fp32; the backward's reductions sum in another order). Their fp32
forward adds in the plain version's order with the diagonal products
never fused into an add, so it is also held bit for bit. The tolerances
of their bf16 mode and of the large-D kernels are stated below; on bf16
storage every forward and the backward are held bit for bit.
"""

import ctypes
import os

import pytest
import torch

from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import kron_cuda as kc
from whvi_tpu_torch.ops.whvi_op import whvi_mul

pytestmark = pytest.mark.cuda

TOL = 1e-5

# every width the kernels take: each register round and exchange boundary
# of csrc/fwht_core.cuh is crossed, and row counts that leave part of the
# last block idle
WIDTHS = [2**k for k in range(1, 15)]

# (D, s1/s2 lead, u lead, x lead): (D,) diagonals over the whole range,
# then the flagship's stacked and square broadcast shapes
SHAPES = [
    *((D, (), (), (33 if D <= 1024 else 3,)) for D in WIDTHS),
    (16, (8,), (4, 1, 8), (4, 64, 1)),
    (16, (8,), (4, 64, 8), (64, 1)),
    (128, (), (4, 1), (4, 64)),
    (128, (), (4, 64), (4, 64)),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _operands(dev, D, s_lead, u_lead, x_lead, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [
        torch.randn(*lead, D, device=dev, generator=gen)
        for lead in (s_lead, u_lead, s_lead, x_lead)
    ]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[0]}-{s[2]}")
def test_fused_forward_matches_plain(dev, shape):
    s1, u, s2, x = _operands(dev, *shape)
    for want_residuals in (False, True):
        got = fc.fused_raw(s1, u, s2, x, want_residuals)
        ref = fc.fused_plain(s1, u, s2, x, want_residuals)
        for a, b in zip(got, ref):
            if b is None:
                assert a is None
            else:
                assert a.shape == b.shape == got[0].shape
                assert a.is_contiguous()
                assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[0]}-{s[2]}")
def test_whvi_mul_backward_matches_plain_autograd(dev, shape):
    ops = _operands(dev, *shape, seed=1)
    mine = [a.clone().requires_grad_() for a in ops]
    ref = [a.clone().requires_grad_() for a in ops]
    fc.reset_launches()
    y = whvi_mul(*mine)
    g = torch.randn_like(y)
    y.backward(g)
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res": 1, fc.bwd_counter(*ops): 1}
    fc.fused_plain(*ref, False)[0].backward(g)
    for a, b in zip(mine, ref):
        assert a.grad.shape == b.shape
        assert rel_err(a.grad, b.grad) <= TOL


def test_fp32_at_the_scaling_shape(dev):
    """run_scaling's product: u (8, 1, 4096) over x (256, 4096) expanded to
    (8, 256, 4096), never materialised. Forward bit for bit, backward
    within TOL of the plain version's autograd."""
    gen = torch.Generator(device=dev).manual_seed(3)
    D, S, B = 4096, 8, 256
    s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
    u = torch.randn(S, 1, D, device=dev, generator=gen)
    x0 = torch.randn(B, D, device=dev, generator=gen)
    x = x0.expand(S, B, D)
    for a, b in zip(fc.fused_raw(s1, u, s2, x, True), fc.fused_plain(s1, u, s2, x, True)):
        assert torch.equal(a, b)
    mine, ref = ([a.clone().requires_grad_() for a in (s1, u, s2, x0)] for _ in range(2))
    fc.reset_launches()
    y = whvi_mul(*mine[:3], mine[3].expand(S, B, D))
    g = torch.randn(y.shape, device=dev, generator=gen)
    y.backward(g)
    assert fc.LAUNCHES["fused_res"] == 1 and fc.LAUNCHES["fused_bwd_sums"] == 1 and fc.REALIGNED == 0
    fc.fused_plain(*ref[:3], ref[3].expand(S, B, D), False)[0].backward(g)
    for a, b in zip(mine, ref):
        assert rel_err(a.grad, b.grad) <= TOL


# ------------------------------------------------------ K3's reduce mode
#
# Tolerance TOL (or fc.bf16_tol in the bf16 precision): the kernel forms
# the plain version's rounded products and sums them in another order
# (runs of rows, then the runs in order). dx is K3's, bit for bit.

# (D, u lead, x lead, x expanded to): the eligible SHAPES, the scaling
# product and the c5-largeD cell's two layers at (64, 256, 8192)
SUMS_SHAPES = [
    *((D, (), (33 if D <= 1024 else 3,), None) for D in WIDTHS if D <= fc.SUMS_MAX_D),
    (128, (4, 1), (4, 64), None),
    (4096, (8, 1), (256,), (8, 256)),
    (8192, (64, 1), (256,), (64, 256)),
    (8192, (64, 1), (64, 256), None),
]


def _sums_case(dev, D, u_lead, x_lead, x_to, seed=0, precision="fp32"):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
    u = torch.randn(*u_lead, D, device=dev, generator=gen)
    x = torch.randn(*x_lead, D, device=dev, generator=gen)
    x = x if x_to is None else x.expand(*x_to, D)
    _, i1, i2 = fc.fused_raw(s1, u, s2, x, True, precision)
    g = torch.randn(i1.shape, device=dev, generator=gen)
    return s1, u, s2, x, g, i1, i2


@pytest.mark.parametrize("precision", fc.PRECISIONS)
@pytest.mark.parametrize("shape", SUMS_SHAPES, ids=lambda s: f"D{s[0]}-u{s[1]}-x{s[2]}")
def test_reduce_mode_matches_plain_and_k3(dev, shape, precision):
    if precision == "bf16" and shape[0] < fc.MIN_D_BF16:
        pytest.skip("the bf16 precision takes D >= 4")
    s1, u, s2, x, g, i1, i2 = _sums_case(dev, *shape, precision=precision)
    want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, True, precision)
    fc.reset_launches()
    got = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True, precision)
    again = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True, precision)
    counter = fc.bwd_counter(s1, u, s2, x, precision)
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {counter: 2}
    assert torch.equal(got[0], fc.fused_bwd_raw(s1, u, s2, g, precision)[0])  # K3's dx
    D = shape[0]
    tols = (TOL,) * 3 if precision == "fp32" else (fc.bf16_tol(D), fc.bf16_tol(D, 1), fc.bf16_tol(D))
    for a, b, tol in zip(got[1:], want[1:], tols):
        assert a.shape == b.shape
        assert rel_err(a, b) <= tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit for bit
    assert fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, False, precision)[0] is None


def test_reduce_mode_refuses_what_it_does_not_take(dev):
    s1, u, s2, x = _operands(dev, *SHAPES[-1])  # a per-example u
    _, i1, i2 = fc.fused_raw(s1, u, s2, x, True)
    with pytest.raises(ValueError, match="reduce mode"):
        fc.fused_bwd_sums_raw(s1, u, s2, x, torch.randn_like(i1), i1, i2, True)


def test_reduce_mode_keeps_w1_and_t2_out_of_memory(dev, monkeypatch):
    """One backward at the c5-largeD cell's product: its peak allocation
    lies below the old path's (K3, then PyTorch's products) by at least
    w1's and t2's bytes, which the reduce mode never stores."""
    s1, u, s2, x, g, _, _ = _sums_case(dev, *SUMS_SHAPES[-1])

    def peak():
        leaves = [t.clone().requires_grad_() for t in (s1, u, s2, x)]
        y = whvi_mul(*leaves)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y.backward(g)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    fc.reset_launches()
    new = peak()
    assert fc.LAUNCHES["fused_bwd_sums"] == 1 and fc.LAUNCHES["fused_bwd"] == 0
    monkeypatch.setattr(fc, "sums_group", lambda *a: None)
    old = peak()
    assert fc.LAUNCHES["fused_bwd"] == 1
    assert old - new >= 2 * g.numel() * g.element_size()


# ------------------------------------------ the stacked form of the reduce mode
#
# (D, stack): the DeepSeek-V2-Lite cell's stacked maps (q_proj 2, kv_a_proj
# and the router 1, kv_b_proj 8 at D = 512, the shared down map 1 at 4096,
# the dense gate/up 6, lm_head 7), then the flagship's first layer and the
# widest D, at N = 256 rows of each of 4 samples: u (4, 1, stack, D) or one
# (stack, D) row, x (4, N, 1, D) broadcast over the stack axis.
STACKED_SHAPES = [(2048, 2), (2048, 1), (512, 8), (4096, 1), (2048, 6), (2048, 7), (16, 8),
                  (8192, 2)]


def _stacked_case(dev, D, stack, u_shared=False, N=256, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, s2 = (torch.randn(stack, D, device=dev, generator=gen) for _ in range(2))
    u = torch.randn(*(() if u_shared else (4, 1)), stack, D, device=dev, generator=gen)
    x = torch.randn(4, N, 1, D, device=dev, generator=gen)
    _, i1, i2 = fc.fused_raw(s1, u, s2, x, True)
    g = torch.randn(i1.shape, device=dev, generator=gen)
    return s1, u, s2, x, g, i1, i2


def _check_stacked(dev, D, stack, u_shared, N):
    """The reduce mode at a stacked product: its stacked form (or the square
    one at a shared stack of 1, a (D,) row in all but name) within TOL of
    its plain version, dx K3's, three launches and no other, bit for bit."""
    s1, u, s2, x, g, i1, i2 = _stacked_case(dev, D, stack, u_shared, N)
    mode = fc._reduce_mode(s1, u, s2, x)
    assert mode == ((4 * N, stack) if u_shared else (N, stack)) or (
        stack == 1 and u_shared and mode == (4 * N, None))
    counter = fc.bwd_counter(s1, u, s2, x)
    fc.reset_launches()
    got = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
    again = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
    no_dx = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, False)
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {counter: 3}
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit for bit
    assert no_dx[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], no_dx[1:]))
    del again, no_dx
    assert torch.equal(got[0], fc.fused_bwd_raw(s1, u, s2, g)[0])  # K3's dx
    want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, True)
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape
        assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("u_shared", [False, True], ids=["u-per-sample", "u-shared"])
@pytest.mark.parametrize("shape", STACKED_SHAPES, ids=lambda s: f"D{s[0]}-stack{s[1]}")
def test_stacked_reduce_mode_matches_plain_and_k3(dev, shape, u_shared):
    _check_stacked(dev, *shape, u_shared, N=256)


@pytest.mark.parametrize("shape", [(2048, 7), (2048, 2), (512, 8)],
                         ids=["lm_head", "q_proj", "kv_b_proj"])
def test_stacked_reduce_mode_at_the_cells_rows(dev, shape):
    """The cell's own N = 4096 rows a sample, where a run walks 16 times the
    rows it walks at N = 256 (lm_head: 128 against 8)."""
    D, stack = shape
    assert fc._sums_run(4 * 4096 * stack, 4096, D) > fc._sums_run(4 * 256 * stack, 256, D)
    _check_stacked(dev, D, stack, False, N=4096)


@pytest.mark.parametrize("shape", [(2048, 2), (512, 8), (16, 8)], ids=lambda s: f"D{s[0]}-stack{s[1]}")
def test_stacked_backward_through_whvi_mul(dev, shape):
    """A StackedMatrix's product through autograd: K2, then the stacked form
    (one launch), its gradients within TOL of the plain version's autograd;
    x's gradient summed over the stack axis."""
    D, stack = shape
    ops = _stacked_case(dev, D, stack, seed=1)[:4]
    mine, ref = ([a.clone().requires_grad_() for a in ops] for _ in range(2))
    fc.reset_launches()
    y = whvi_mul(*mine)
    g = torch.randn_like(y)
    y.backward(g)
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res": 1,
                                                           "fused_bwd_sums_stacked": 1}
    fc.fused_plain(*ref, False)[0].backward(g)
    for a, b in zip(mine, ref):
        assert a.grad.shape == b.shape
        assert rel_err(a.grad, b.grad) <= TOL


def test_stacked_reduce_mode_keeps_w1_and_t2_out_of_memory(dev, monkeypatch):
    """One backward at lm_head's (stack 7, D 2048) product: its peak
    allocation lies below the old path's (K3, then PyTorch's products) by at
    least w1's and t2's bytes, which the stacked form never stores."""
    s1, u, s2, x, g, _, _ = _stacked_case(dev, 2048, 7)

    def peak():
        leaves = [t.clone().requires_grad_() for t in (s1, u, s2, x)]
        y = whvi_mul(*leaves)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y.backward(g)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    fc.reset_launches()
    new = peak()
    assert fc.LAUNCHES["fused_bwd_sums_stacked"] == 1 and fc.LAUNCHES["fused_bwd"] == 0
    monkeypatch.setattr(fc, "_reduce_mode", lambda *a: None)
    old = peak()
    assert fc.LAUNCHES["fused_bwd"] == 1
    assert old - new >= 2 * g.numel() * g.element_size()


def test_stacked_reduce_mode_refuses_what_it_does_not_take(dev):
    """Per-row u, the bf16 precision and D = 16384 keep K3 with PyTorch's
    sums."""
    s1, u, s2, x, g, i1, i2 = _stacked_case(dev, 512, 8)
    with pytest.raises(ValueError, match="reduce mode"):
        fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True, "bf16")
    leaves = [t.clone().requires_grad_() for t in (s1, u, s2, x)]
    fc.reset_launches()
    fc.WhviMulFunction.apply(*leaves, "bf16").backward(g)
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res_bf16": 1,
                                                           "fused_bwd_bf16": 1}
    u = torch.randn(4, 256, 8, 512, device=dev)
    with pytest.raises(ValueError, match="reduce mode"):
        fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
    big = [torch.randn(*lead, 16384, device=dev) for lead in ((1,), (4, 1, 1), (1,), (4, 2, 1))]
    assert fc._reduce_mode(*big) is None


def test_dsv2_net_step_takes_a_reduce_mode_for_every_map(dev):
    """A small DeepSeek-V2 WHVI net's Trainer.train_step (every map D <=
    8192): no K3 with PyTorch's sums, the stacked maps in the stacked form;
    loss and gradients within chip_smoke's card-against-CPU tolerances."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as smoke
    finally:
        sys.path.remove(root)
    from whvi_tpu_torch.models.deepseek_v2 import DeepseekV2WHVI
    from whvi_tpu_torch.train import TrainConfig, Trainer

    S, B, T = 2, 2, 16
    seq = torch.randint(0, smoke.DSV2_SMOKE["vocab_size"], (B, T + 1),
                        generator=torch.Generator().manual_seed(0))
    torch.manual_seed(1)
    start = DeepseekV2WHVI(smoke.DSV2_SMOKE, train_samples=S, eval_samples=S).state_dict()
    out = {}
    for device in ("cpu", dev):
        net = DeepseekV2WHVI(smoke.DSV2_SMOKE, train_samples=S, eval_samples=S)
        trainer = Trainer(net, TrainConfig(lr0=1e-2), device=device)
        state = trainer.init(2)
        net.load_state_dict(start)
        eps = [e.to(device) for e in net.draw_noise((S, B * T), torch.Generator().manual_seed(3))]
        fc.reset_launches()
        metrics = trainer.train_step(state, seq[:, :-1].to(device), seq[:, 1:].to(device), B * T,
                                     True, eps=eps)
        out[str(device)] = (float(metrics["loss"]),
                            {k: p.grad.cpu() for k, p in net.named_parameters()})
    assert fc.LAUNCHES["fused_bwd"] == 0 and fc.LAUNCHES["fused_bwd_sums_stacked"] > 0
    (card, card_grads), (plain, plain_grads) = out[str(dev)], out["cpu"]
    assert abs(card - plain) / abs(plain) <= smoke.SLICE_TOL
    for k, want in plain_grads.items():
        if want.abs().max() > 0:
            assert rel_err(card_grads[k], want) <= smoke.SLICE_GRAD_TOL, k


def test_no_grad_product_is_the_y_only_launch(dev):
    s1, u, s2, x = _operands(dev, *SHAPES[len(WIDTHS)])
    fc.reset_launches()
    with torch.no_grad():
        whvi_mul(s1.requires_grad_(), u, s2, x)
    assert fc.LAUNCHES["fused_y"] == 1 and fc.LAUNCHES["fused_res"] == 0


@pytest.mark.parametrize("shape", [(64, 2), (7, 3, 16), (4, 1, 1, 128), (2, 16384)])
def test_fwht_forward_and_backward_match_plain(dev, shape):
    x = torch.randn(*shape, device=dev).requires_grad_()
    fc.reset_launches()
    y = fc.fwht_cuda(x)
    assert rel_err(y, fc.fwht_plain(x.detach())) <= TOL
    g = torch.randn_like(y)
    y.backward(g)
    assert rel_err(x.grad, fc.fwht_plain(g)) <= TOL
    assert fc.LAUNCHES["fwht"] == 2


@pytest.mark.parametrize("D", WIDTHS)
def test_fwht_forward_is_the_plain_version_bit_for_bit(dev, D):
    x = torch.randn(37 if D <= 1024 else 3, D, device=dev)
    assert torch.equal(fc.fwht_raw(x), fc.fwht_plain(x))


def test_misaligned_operands_are_copied_once(dev):
    """x 4 bytes past a 16-byte boundary and a diagonal read through an odd
    leading stride: each copied to an aligned allocation (REALIGNED), then
    one launch that matches the plain version."""
    D, B = 256, 7
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B * D + 1, device=dev, generator=gen)[1:].view(B, D)
    u = torch.randn(B, D + 3, device=dev, generator=gen)[:, :D]  # row stride 259
    s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
    assert not fc.vector_aligned(x, 16) and not fc.vector_aligned(u, 16)
    fc.reset_launches()
    got = fc.fused_raw(s1, u, s2, x, True)
    assert fc.REALIGNED == 2 and fc.LAUNCHES["fused_res"] == 1
    for a, b in zip(got, fc.fused_plain(s1, u, s2, x, True)):
        assert torch.equal(a, b)
    y = fc.fwht_raw(x)
    assert fc.REALIGNED == 3 and torch.equal(y, fc.fwht_plain(x))
    torch.cuda.synchronize()  # no launch faulted the context


# ------------------------------------------------ K1-K3 in their bf16 mode
#
# Tolerance fc.bf16_tol(D, transform): the kernel sums in butterfly order,
# the plain version in matmul order, so a bf16 rounding may flip; the
# first transform's (i1, the u gradient) and the second's (y, i2, the
# others). y also within kc.BF16_TOL of the fp32 product.

# (D, u lead, x rows, samples x is expanded over): (D,) diagonals over the
# bf16 mode's range, then the scaling path's u (8, 1, D) over x (256, D)
# expanded to (8, 256, D)
BF16_SHAPES = [
    *((D, (), 64 if D <= 4096 else 5, None) for D in WIDTHS if D >= fc.MIN_D_BF16),
    (1024, (8, 1), 256, 8),
    (4096, (8, 1), 256, 8),
]


def _bf16_operands(dev, D, u_lead, rows, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
    u = torch.randn(*u_lead, D, device=dev, generator=gen)
    x0 = torch.randn(rows, D, device=dev, generator=gen)
    return s1, u, s2, x0


def _expand(x0, samples):
    return x0 if samples is None else x0.expand(samples, *x0.shape)


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: f"D{s[0]}-{s[1]}")
def test_bf16_forward_matches_plain(dev, shape):
    D, u_lead, rows, samples = shape
    s1, u, s2, x0 = _bf16_operands(dev, *shape[:3])
    x = _expand(x0, samples)
    tols = (fc.bf16_tol(D), fc.bf16_tol(D, transform=1), fc.bf16_tol(D))
    fc.reset_launches()
    for want_residuals in (False, True):
        got = fc.fused_raw(s1, u, s2, x, want_residuals, "bf16")
        ref = fc.fused_plain(s1, u, s2, x, want_residuals, "bf16")
        for a, b, tol in zip(got, ref, tols):
            if b is None:
                assert a is None
            else:
                assert a.shape == b.shape == got[0].shape and a.is_contiguous()
                assert rel_err(a, b) <= tol
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_y_bf16": 1, "fused_res_bf16": 1}
    fp32 = fc.fused_plain(s1, u, s2, x, False)[0]
    assert rel_err(got[0], fp32) <= kc.BF16_TOL


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: f"D{s[0]}-{s[1]}")
def test_bf16_backward_matches_plain(dev, shape):
    D, u_lead, rows, samples = shape
    ops = _bf16_operands(dev, *shape[:3], seed=1)
    leaves = [a.clone().requires_grad_() for a in ops]
    fc.reset_launches()
    y = whvi_mul(*leaves[:3], _expand(leaves[3], samples), precision="bf16")
    g = torch.randn_like(y)
    y.backward(g)
    k3 = fc.bwd_counter(*ops[:3], _expand(ops[3], samples), "bf16")
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res_bf16": 1, k3: 1}
    s1, u, s2, x0 = ops
    ref = fc.vjp_plain(s1, u, s2, _expand(x0, samples), g, "bf16")
    for i, (leaf, r) in enumerate(zip(leaves, ref)):
        r = r.sum_to_size(leaf.shape)
        assert leaf.grad.shape == r.shape
        assert rel_err(leaf.grad, r) <= fc.bf16_tol(D, transform=1 if i == 1 else 2)


def test_bf16_mode_refuses_widths_outside_the_kernel(dev):
    fc.reset_launches()
    for D in (2, 2 * fc.MAX_D):
        d = torch.ones(D, device=dev)
        with pytest.raises(ValueError):
            fc.fused_raw(d, d, d, torch.ones(3, D, device=dev), False, "bf16")
    assert all(v == 0 for v in fc.LAUNCHES.values())


def test_mixed_devices_and_strided_rows_raise(dev):
    d = torch.ones(16, device=dev)
    with pytest.raises(ValueError):
        fc.fused_raw(d, d, d.cpu(), torch.ones(3, 16, device=dev), False)
    with pytest.raises(ValueError):
        fc.fused_raw(d, d, d, torch.ones(16, 3, device=dev).t(), False)
    with pytest.raises(ValueError):
        fc.fwht_raw(torch.ones(16, 3, device=dev).t())


# ---------------------------------------------- K1-K4 on bf16 storage
#
# Every tensor bf16, each op rounded to bf16 and each transform summed in
# fp32 in the plain version's order: the forwards (y, i1, i2, the bare
# transform) equal the plain versions bit for bit, and so does the
# backward against vjp_plain (the same kernel on the swapped operands,
# then the same PyTorch reductions).

BF16S_SHAPES = [
    *SHAPES,
    (4096, (), (8, 1), (8, 256)),
    (8192, (), (8, 1), (8, 256)),
    # 2048 distinct rows of x under stacked (8, D) diagonals and a u per outer row
    (4096, (8,), (256, 1), (256, 8)),
    (8192, (8,), (256, 1), (256, 8)),
    (16384, (), (), (512,)),  # K1's large-D shape
]


def _bf16s_operands(dev, D, s_lead, u_lead, x_lead, seed=0):
    return [a.to(torch.bfloat16) for a in _operands(dev, D, s_lead, u_lead, x_lead, seed)]


@pytest.mark.parametrize("shape", BF16S_SHAPES, ids=lambda s: f"D{s[0]}-{s[2]}-{s[3]}")
def test_bf16_storage_forward_is_the_plain_version_bit_for_bit(dev, shape):
    s1, u, s2, x = _bf16s_operands(dev, *shape)
    fc.reset_launches()
    for want_residuals in (False, True):
        got = fc.fused_raw(s1, u, s2, x, want_residuals)
        ref = fc.fused_plain(s1, u, s2, x, want_residuals)
        for a, b in zip(got, ref):
            if b is None:
                assert a is None
            else:
                assert a.dtype == torch.bfloat16 and a.shape == b.shape and a.is_contiguous()
                assert torch.equal(a, b)
    want = {"fused_y_bf16s": 1, "fused_res_bf16s": 1}
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | want and fc.REALIGNED == 0


@pytest.mark.parametrize("shape", BF16S_SHAPES, ids=lambda s: f"D{s[0]}-{s[2]}-{s[3]}")
def test_bf16_storage_backward_is_vjp_plain_bit_for_bit(dev, shape):
    ops = _bf16s_operands(dev, *shape, seed=1)
    leaves = [a.clone().requires_grad_() for a in ops]
    fc.reset_launches()
    y = whvi_mul(*leaves)
    g = torch.randn(y.shape, device=dev).to(torch.bfloat16)
    y.backward(g)
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res_bf16s": 1, "fused_bwd_bf16s": 1}
    for leaf, r in zip(leaves, fc.vjp_plain(*ops, g)):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, r.sum_to_size(leaf.shape))


@pytest.mark.parametrize("D", WIDTHS)
def test_bf16_storage_fwht_is_the_plain_version_bit_for_bit(dev, D):
    x = torch.randn(37 if D <= 1024 else 3, D, device=dev).to(torch.bfloat16)
    fc.reset_launches()
    y = fc.fwht_raw(x)
    assert y.dtype == torch.bfloat16 and torch.equal(y, fc.fwht_plain(x))
    g = torch.randn_like(x)
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(fc.fwht_cuda(xg), xg, g)
    assert torch.equal(dx, fc.fwht_plain(g))
    assert fc.LAUNCHES["fwht_bf16s"] == 3 and fc.LAUNCHES["fwht"] == 0


def test_bf16_storage_misaligned_operands_are_copied_once(dev):
    """x 2 bytes past a 16-byte boundary and u read through an odd row
    stride: copied to aligned allocations (REALIGNED), then one launch
    equal to the plain version."""
    D, B = 256, 7
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B * D + 1, device=dev, generator=gen).to(torch.bfloat16)[1:].view(B, D)
    u = torch.randn(B, D + 3, device=dev, generator=gen).to(torch.bfloat16)[:, :D]
    s1, s2 = (torch.randn(D, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
    assert not fc.vector_aligned(x, 16) and not fc.vector_aligned(u, 16)
    fc.reset_launches()
    got = fc.fused_raw(s1, u, s2, x, True)
    assert fc.REALIGNED == 2 and fc.LAUNCHES["fused_res_bf16s"] == 1
    for a, b in zip(got, fc.fused_plain(s1, u, s2, x, True)):
        assert torch.equal(a, b)
    assert torch.equal(fc.fwht_raw(x), fc.fwht_plain(x)) and fc.REALIGNED == 3
    torch.cuda.synchronize()


def test_bf16_storage_entries_refuse_misaligned_operands_and_the_bf16_precision(dev):
    """whvi_fused_bf16s refuses any operand whose rows are off 16 bytes (a
    base pointer, or a leading stride it reads through) and the bf16
    precision (the Pallas kernels have no bf16-storage form); fwht_bf16s
    refuses x or y off 16 bytes: cudaErrorInvalidValue, nothing launched,
    nothing written, the context intact."""
    lib = fc.load_library()
    D, B = 256, 8
    s1, u, s2, x = _bf16s_operands(dev, D, (), (), (B,))
    y, i1, i2 = (torch.zeros_like(x) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    invalid_value = 1  # cudaErrorInvalidValue

    def fused(ptrs, geom, bf16=0):
        return lib.whvi_fused_bf16s(*ptrs, 1, bf16, B, 8, ctypes.byref(geom), stream)

    geom = fc._geometry(x.shape[:-1], (x, s1, u, s2))
    ptrs = [t.data_ptr() for t in (x, s1, u, s2, y, i1, i2)]
    assert fused(ptrs, geom, bf16=1) == invalid_value
    for k in range(7):
        for off in (2, 4, 8):
            bad = list(ptrs)
            bad[k] += off
            assert fused(bad, geom) == invalid_value
    odd = fc._geometry(x.shape[:-1], (x, s1, u, s2))
    odd.stride[4 * 2 + 3] = D + 1  # u read through a row stride of D + 1 elements
    odd.size[3] = B
    assert fused(ptrs, odd) == invalid_value
    for off in (2, 4, 8):
        assert lib.fwht_bf16s(x.data_ptr() + off, y.data_ptr(), B, 8, stream) == invalid_value
        assert lib.fwht_bf16s(x.data_ptr(), y.data_ptr() + off, B, 8, stream) == invalid_value
    torch.cuda.synchronize()
    assert not y.any() and not i1.any() and not i2.any()
    assert fused(ptrs, geom) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, fc.fused_plain(s1, u, s2, x, False)[0])


def test_bf16_storage_wrappers_refuse_the_bf16_precision(dev):
    s1, u, s2, x = _bf16s_operands(dev, 64, (), (), (4,))
    fc.reset_launches()
    with pytest.raises(ValueError):
        fc.fused_raw(s1, u, s2, x, False, "bf16")
    with pytest.raises(ValueError):
        whvi_mul(s1, u, s2, x, precision="bf16")
    with pytest.raises(TypeError):
        fc.fused_raw(s1, u, s2, x.float(), False)
    assert all(v == 0 for v in fc.LAUNCHES.values())


# ---------------------------------------- the column head on bf16 storage
#
# (D, s lead, g lead): the smoke's shapes (the column head (8, 1, D) at D
# = 4096 and 8192, the column LRT's rows (8, 256, 4096), 8 replicas, D = 2
# and 16384), then every width at a few rows.
COLUMN_SHAPES = [
    (4096, (), (8, 1)),
    (8192, (), (8, 1)),
    (4096, (), (8, 256)),
    (4096, (8, 1, 1), (8, 8, 1)),
    (128, (8, 1, 1), (8, 4, 64)),
    (2, (), (8, 1)),
    (16384, (), (8, 1)),
    *((D, (), (3, 5)) for D in WIDTHS),
]


def _column_operands(dev, D, s_lead, g_lead, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, s2 = (torch.randn(*s_lead, D, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
    g = torch.randn(*g_lead, D, device=dev, generator=gen).to(torch.bfloat16)
    return s1, g, s2


@pytest.mark.parametrize("shape", COLUMN_SHAPES, ids=lambda s: f"D{s[0]}-{s[1]}-{s[2]}")
def test_column_modes_are_the_plain_version_bit_for_bit(dev, shape):
    """The column kernel's three modes against column_plain and
    column_bwd_plain, torch.equal, one launch each."""
    s1, g, s2 = _column_operands(dev, *shape)
    fc.reset_launches()
    y = fc.column_raw(s1, g, s2, False)[0]
    y_res, t = fc.column_raw(s1, g, s2, True)
    ref_y, ref_t = fc.column_plain(s1, g, s2, True)
    assert y.dtype == torch.bfloat16 and y.is_contiguous() and t.is_contiguous()
    assert torch.equal(y, ref_y) and torch.equal(y_res, ref_y) and torch.equal(t, ref_t)
    gy = torch.randn(y.shape, device=dev).to(torch.bfloat16)
    got = fc.column_bwd_raw(s1, s2, gy, t)
    for a, b in zip(got, fc.column_bwd_plain(s1, s2, gy, t)):
        assert a.shape == y.shape and torch.equal(a, b)
    torch.cuda.synchronize()
    want = {"column_y_bf16s": 1, "column_res_bf16s": 1, "column_bwd_bf16s": 1}
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | want and fc.REALIGNED == 0


@pytest.mark.parametrize("shape", COLUMN_SHAPES[:5], ids=lambda s: f"D{s[0]}-{s[1]}-{s[2]}")
def test_column_head_gradients_are_the_chain_bit_for_bit(dev, shape):
    """ColumnFunction on the card (two launches) against autograd over the
    chain it replaces (K4 and PyTorch's ops), forward and the gradients of
    g, s1 and s2."""
    s1, g, s2 = _column_operands(dev, *shape, seed=1)
    cot = torch.randn(torch.broadcast_shapes(g.shape, s1.shape), device=dev).to(torch.bfloat16)
    results = []
    for column in (True, False):
        leaves = [a.clone().requires_grad_() for a in (s1, g, s2)]
        fc.reset_launches()
        if column:
            out = fc.column_head(*leaves)
        else:  # ColumnMatrix.column_given_g's chain, its replica views
            s2_rows = leaves[2] if s2.dim() == 1 else leaves[2][..., None, :]
            out = (leaves[0][..., :1, None] * fc.fwht_cuda(g.new_ones(1, g.shape[-1])
                   * leaves[1][..., None, :]) * s2_rows).squeeze(-2)
        out.backward(cot)
        results.append((out.detach(), *(a.grad for a in leaves)))
        if column:
            assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {
                "column_res_bf16s": 1, "column_bwd_bf16s": 1}
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_column_entry_refuses_misaligned_operands_and_null_pointers(dev):
    """column_bf16s refuses in, s2, res or an output off 16 bytes (a base
    pointer or a leading stride read through) and a null pointer its mode
    needs: cudaErrorInvalidValue, nothing launched, nothing written. s1 is
    read one element a row and may lie anywhere. column_nop launches."""
    lib = fc.load_library()
    D, B = 256, 8
    s1, g, s2 = _column_operands(dev, D, (), (B,))
    t = fc.column_raw(s1, g, s2, True)[1]
    outs = [torch.zeros_like(g) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream
    invalid_value = 1  # cudaErrorInvalidValue
    geom = fc._geometry(g.shape[:-1], (g, s1[..., :1], s2, t))
    base = [g.data_ptr(), s1.data_ptr(), s2.data_ptr(), t.data_ptr(), *(o.data_ptr() for o in outs)]

    def call(ptrs, mode=2, geometry=geom):
        return lib.column_bf16s(mode, *ptrs, B, 8, ctypes.byref(geometry), stream)

    for k in (0, 2, 3, 4, 5, 6):
        for off in (2, 4, 8):
            bad = list(base)
            bad[k] += off
            assert call(bad) == invalid_value
        bad = list(base)
        bad[k] = None
        assert call(bad) == invalid_value
    odd = fc._geometry(g.shape[:-1], (g, s1[..., :1], s2, t))
    odd.stride[4 * 2 + 3] = D + 1  # s2 read through a row stride of D + 1 elements
    odd.size[3] = B
    assert call(base, geometry=odd) == invalid_value
    assert call(base, mode=3) == invalid_value
    torch.cuda.synchronize()
    assert not any(o.any() for o in outs)
    shifted = list(base)
    shifted[1] += 2  # s1_0 one element on: allowed
    assert call(shifted, mode=0) == 0
    torch.cuda.synchronize()
    assert torch.equal(outs[0], fc.column_plain(s1[1:2].expand(D), g, s2, False)[0])
    assert lib.column_nop(B, 8, stream) == 0 and lib.column_nop(0, 8, stream) == invalid_value
    torch.cuda.synchronize()


# ------------------------------------------ the large-D diagnosis kernels
#
# Tolerances: kc.tol(name, D) against the plain version (0 for the
# copies and the scale; the bf16 roundings of the products may land on
# the other side of a rounding boundary when the fp32 sums run in another
# order), kc.BF16_TOL for the full product against the fp32 whvi_mul.

# (D, B, tb): every a = D / 128 regime, groups that the tile fills, part
# fills (tb not a multiple of the 16384 / D rows a group holds) or
# exceeds, and one block's tile of the whole batch; then the edges of the
# copies' designs: 4096 tiles of one 512-byte row (far more than the
# persistent grid), 12 KB tiles (less than a 16 KB ring stage), 24 KB
# tiles (a full chunk and a short one each), and two 8 MB tiles (two
# blocks for k_copy, the whole grid for copy_2d); 2048 chunks of 16 KB
# (emit_copy's blocks each around their ring of 4 stages more than once);
# the smoke's shape, 128 tiles (fewer than the SMs) of 16 chunks; one tile
# of the whole batch, less than a stage; tiles wider than the persistent
# grids need (TB = 64 and 256 of the TPU harness at D = 16384 and 8192),
# and at D = 128 one tile of the batch, 16 of k_swap's 32-row blocks; the
# two widths left, so that every instance of the row kernels (L = 7..14)
# runs: D = 512, k_cur's row in one warp with no exchange, and D = 4096,
# one row a block; 133 groups of one row, the wgmma kernel's persistent
# grid one group past a full wave of 132 SMs
KRON_SHAPES = [
    (128, 320, 160),
    (256, 64, 8),
    (1024, 48, 24),
    (2048, 32, 1),
    (8192, 16, 4),
    (16384, 8, 2),
    (16384, 4, 4),
    (128, 4096, 1),
    (1024, 96, 3),
    (2048, 48, 3),
    (16384, 512, 256),
    (1024, 8192, 8),
    (16384, 512, 4),
    (256, 8, 8),
    (16384, 512, 64),
    (8192, 256, 256),
    (128, 512, 512),
    (512, 64, 8),
    (4096, 32, 4),
    (16384, 133, 7),
]


def _kron_operands(dev, D, B, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, u, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(3))
    return s1, u, s2, torch.randn(B, D, device=dev, generator=gen)


@pytest.mark.parametrize("shape", KRON_SHAPES, ids=lambda s: f"D{s[0]}-B{s[1]}-tb{s[2]}")
@pytest.mark.parametrize("name", list(kc.VARIANTS))
def test_kron_kernel_matches_plain(dev, name, shape):
    D, B, tb = shape
    s1, u, s2, x = _kron_operands(dev, D, B)
    kc.reset_launches()
    y = kc.VARIANTS[name](s1, u, s2, x, tb)
    torch.cuda.synchronize()
    assert kc.LAUNCHES[name] == 1 and sum(kc.LAUNCHES.values()) == 1
    ref = kc.plain(name, s1, u, s2, x)
    assert y.shape == ref.shape == x.shape and y.is_contiguous()
    assert rel_err(y, ref) <= kc.tol(name, D)
    if kc.tol(name, D) == 0:  # the copies and the scale
        assert torch.equal(y, ref)
    if name in kc.FULL_PRODUCT:
        assert rel_err(y, fc.fused_plain(s1, u, s2, x, False)[0]) <= kc.BF16_TOL


@pytest.mark.parametrize("shape", [(16384, 512, 4), (8192, 256, 256), (128, 512, 512)],
                         ids=lambda s: f"D{s[0]}-B{s[1]}-tb{s[2]}")
def test_cur_and_onecast_are_one_kernel(dev, shape):
    """k_onecast's TPU body computes k_cur's bit for bit, so both wrappers
    launch kron_cur_kernel: equal outputs, one launch each, each under its
    own counter."""
    D, B, tb = shape
    s1, u, s2, x = _kron_operands(dev, D, B, seed=1)
    kc.reset_launches()
    cur = kc.k_cur(s1, u, s2, x, tb)
    assert kc.LAUNCHES["k_cur"] == 1 and sum(kc.LAUNCHES.values()) == 1
    onecast = kc.k_onecast(s1, u, s2, x, tb)
    assert kc.LAUNCHES["k_onecast"] == 1 and sum(kc.LAUNCHES.values()) == 2
    torch.cuda.synchronize()
    assert torch.equal(cur, onecast)
    assert rel_err(cur, kc.kron_plain(s1, u, s2, x)) <= kc.tol("k_cur", D)


@pytest.mark.parametrize("shape", [(16384, 512, 4), (8192, 256, 256), (128, 512, 512)],
                         ids=lambda s: f"D{s[0]}-B{s[1]}-tb{s[2]}")
def test_full_flat_and_emit_full_are_one_kernel(dev, shape):
    """k_flat's TPU body is k_full's, and make_emit_full runs it under a
    pipeline, so all three wrappers launch kron_full_kernel: equal outputs,
    one launch each, each under its own counter."""
    D, B, tb = shape
    s1, u, s2, x = _kron_operands(dev, D, B, seed=2)
    kc.reset_launches()
    ys = []
    for i, name in enumerate(("k_full", "k_flat", "emit_full")):
        ys.append(kc.VARIANTS[name](s1, u, s2, x, tb))
        assert kc.LAUNCHES[name] == 1 and sum(kc.LAUNCHES.values()) == i + 1
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])
    assert rel_err(ys[0], kc.kron_plain(s1, u, s2, x)) <= kc.tol("k_full", D)


@pytest.mark.parametrize("name", ["k_mm1", "k_mm2", "k_full"])
def test_wgmma_kernel_does_not_read_the_row_tile(dev, name):
    """kron_full_kernel checks tb and does not use it: its persistent grid
    walks groups of 16384 elements whatever the tile, so every tile gives
    the same bits (D = 8192, 2 rows a group; D = 16384, one)."""
    for D, B in ((8192, 256), (16384, 132)):
        s1, u, s2, x = _kron_operands(dev, D, B, seed=3)
        ys = [kc.VARIANTS[name](s1, u, s2, x, tb) for tb in (1, 4, B)]
        torch.cuda.synchronize()
        assert all(torch.equal(ys[0], y) for y in ys[1:])
        assert rel_err(ys[0], kc.plain(name, s1, u, s2, x)) <= kc.tol(name, D)


def test_kron_kernels_refuse_what_they_do_not_take(dev):
    s1, u, s2, x = _kron_operands(dev, 256, 12)
    d64 = torch.ones(64, device=dev)
    bad = [
        ((s1, u, s2, x, 5), ValueError),  # B % tb
        ((s1, u, s2, x, 0), ValueError),
        ((d64, d64, d64, torch.ones(4, 64, device=dev), 2), ValueError),  # D < 128
        ((s1, u, s2, torch.ones(4, 384, device=dev), 2), ValueError),  # not 2^k
        ((s1, u, s2, x.double(), 4), TypeError),
        ((s1, u, s2, torch.ones(512, 12, device=dev).t(), 4), ValueError),
        ((s1, u, s2, x[:, None], 4), ValueError),
        # contiguous, 4 bytes past a 16-byte boundary: a launch would fault
        # with a misaligned float4 access or TMA bulk copy
        ((s1, u, s2, torch.randn(12 * 256 + 1, device=dev)[1:].view(12, 256), 4), ValueError),
    ]
    assert bad[-1][0][3].data_ptr() % kc.ALIGN == 4
    kc.reset_launches()
    for name, fn in kc.VARIANTS.items():
        for args, err in bad:
            if name == "hbm_copy" and args[4] in (5, 0):
                continue  # untiled: tb is not read
            with pytest.raises(err):
                fn(*args)
        if name not in ("hbm_copy", "copy_2d", "emit_copy"):
            with pytest.raises(ValueError):
                fn(s1[:128], u, s2, x, 4)  # a diagonal of the wrong length
            with pytest.raises(ValueError):
                fn(s1, u, s2.cpu(), x, 4)  # mixed devices
            with pytest.raises(ValueError):
                fn(s1, torch.randn(257, device=dev)[1:], s2, x, 4)  # misaligned
    assert all(v == 0 for v in kc.LAUNCHES.values())
    torch.cuda.synchronize()  # no launch faulted the context


def test_pipe_entry_refuses_misaligned_operands(dev):
    """kron_pipe_f32 (emit_copy) itself refuses x or y off a 16-byte
    boundary (its bulk copies and float4 reads would fault there):
    cudaErrorInvalidValue, nothing launched, the context intact. The
    wrappers refuse such operands before they reach it."""
    lib = fc.load_library()
    x = _kron_operands(dev, 256, 8)[3]
    y = torch.zeros_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    X, Y = x.data_ptr(), y.data_ptr()

    def call(xp, yp):
        return lib.kron_pipe_f32(xp, yp, 8, 8, 4, stream)

    invalid_value = 1  # cudaErrorInvalidValue
    for off in (4, 8, 12):
        assert call(X + off, Y) == invalid_value
        assert call(X, Y + off) == invalid_value
        assert call(X + off, Y + off) == invalid_value
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros_like(x))  # nothing was written
    assert call(X, Y) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, x)


def test_full_entry_refuses_misaligned_operands_and_bad_tilings(dev):
    """kron_full_f32 (k_mm1 and k_mm2 at 1 and 2 contractions; k_full,
    k_flat, emit_full at 4) itself refuses another count of contractions,
    x, y or s2 off a 16-byte boundary (its bulk copies and vector reads
    would fault there), s1 or u off it at 4 contractions (the only count
    that reads them), a row tile that does not divide B, and D outside
    [128, 16384]: cudaErrorInvalidValue, nothing launched, the context
    intact. At 1 and 2 it takes s1 and u off the boundary. The wrappers
    refuse all of these before they reach it."""
    lib = fc.load_library()
    s1, u, s2, x = _kron_operands(dev, 256, 8)
    y = torch.zeros_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in (x, s1, u, s2, y)]

    def call(p=ptrs, B=8, log2d=8, tb=4, contractions=4):
        return lib.kron_full_f32(*p, B, log2d, tb, contractions, stream)

    invalid_value = 1  # cudaErrorInvalidValue
    for contractions in (0, 3, 5, -1):
        assert call(contractions=contractions) == invalid_value
    for off in (4, 8, 12):
        for contractions in (1, 2, 4):
            for i in (0, 3, 4) if contractions < 4 else range(5):  # x, s2, y (and s1, u)
                p = list(ptrs)
                p[i] += off
                assert call(p, contractions=contractions) == invalid_value
    for B, log2d, tb in ((8, 8, 3), (8, 8, 0), (8, 6, 4), (8, 15, 4), (-8, 8, 4)):
        for contractions in (1, 2, 4):
            assert call(B=B, log2d=log2d, tb=tb, contractions=contractions) == invalid_value
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros_like(x))  # nothing was written
    assert call() == 0
    torch.cuda.synchronize()
    assert torch.equal(y, kc.k_full(s1, u, s2, x, 4))
    # 1 and 2 contractions read neither s1 nor u: taken off the boundary
    for contractions, name in ((1, "k_mm1"), (2, "k_mm2")):
        y.zero_()
        p = [ptrs[0], ptrs[1] + 4, ptrs[2] + 4, ptrs[3], ptrs[4]]
        assert call(p, contractions=contractions) == 0
        torch.cuda.synchronize()
        assert torch.equal(y, kc.VARIANTS[name](s1, u, s2, x, 4))


def test_stage_and_hbm_entries_refuse_misaligned_operands(dev):
    """kron_stage_f32 refuses x, y, or a diagonal its stage reads (s1 for
    the scale, all three for the full product in the row layouts) off a
    16-byte boundary, and copy_hbm_f32 x or y (its bulk copies and float4
    reads would fault there): cudaErrorInvalidValue, nothing launched, the
    context intact. The wrappers refuse such operands before they reach
    them. mm1, mm2 and the full product in the flat layout are
    kron_full_f32's: kron_stage_f32 refuses them."""
    lib = fc.load_library()
    s1, u, s2, x = _kron_operands(dev, 256, 8)
    y = torch.zeros_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    X, Y, S1, U, S2 = (a.data_ptr() for a in (x, y, s1, u, s2))
    calls = [(stage, "flat") for stage in ("copy", "scale")]
    calls += [("full", layout) for layout in ("cur", "swap", "onecast")]
    reads = {"copy": (), "scale": (0,), "full": (0, 1, 2)}

    def stage(stage_, layout, xp, yp, diagonals=(S1, U, S2)):
        return lib.kron_stage_f32(xp, *diagonals, yp, 8, 8, 4, kc._STAGES[stage_],
                                  kc._LAYOUTS[layout], stream)

    invalid_value = 1  # cudaErrorInvalidValue
    for stage_ in ("mm1", "mm2", "full"):
        assert stage(stage_, "flat", X, Y) == invalid_value
    for off in (4, 8, 12):
        assert lib.copy_hbm_f32(X + off, Y, x.numel(), stream) == invalid_value
        assert lib.copy_hbm_f32(X, Y + off, x.numel(), stream) == invalid_value
        for stage_, layout in calls:
            assert stage(stage_, layout, X + off, Y) == invalid_value
            assert stage(stage_, layout, X, Y + off) == invalid_value
            for i in reads[stage_]:
                diagonals = [S1, U, S2]
                diagonals[i] += off
                assert stage(stage_, layout, X, Y, diagonals) == invalid_value
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros_like(x))  # nothing was written
    assert lib.copy_hbm_f32(X, Y, x.numel(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, x)
    # a stage that does not read a diagonal takes it off the boundary
    assert stage("copy", "flat", X, Y, (S1 + 4, U + 4, S2 + 4)) == 0
    assert stage("full", "swap", X, Y) == 0
    torch.cuda.synchronize()
    assert rel_err(y, kc.kron_plain(s1, u, s2, x)) <= kc.tol("k_swap", 256)
