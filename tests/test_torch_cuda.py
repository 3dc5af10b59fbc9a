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
of their bf16 mode and of the large-D kernels are stated below.
"""

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
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res": 1, "fused_bwd": 1}
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
    assert fc.LAUNCHES["fused_res"] == 1 and fc.LAUNCHES["fused_bwd"] == 1 and fc.REALIGNED == 0
    fc.fused_plain(*ref[:3], ref[3].expand(S, B, D), False)[0].backward(g)
    for a, b in zip(mine, ref):
        assert rel_err(a.grad, b.grad) <= TOL


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
    assert fc.LAUNCHES == dict.fromkeys(fc.LAUNCHES, 0) | {"fused_res_bf16": 1, "fused_bwd_bf16": 1}
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
