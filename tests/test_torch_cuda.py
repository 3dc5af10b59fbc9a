"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX; there ``tests/conftest.py`` (which configures JAX) is left
out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: ``max|kernel - plain| / max|plain| <= 1e-5`` (fp32; the
butterflies add in the plain version's order, the backward's reductions
sum in another).
"""

import pytest
import torch

from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops.whvi_op import whvi_mul

pytestmark = pytest.mark.cuda

TOL = 1e-5

# (D, s1/s2 lead, u lead, x lead): (D,) diagonals over the whole range,
# then the flagship's stacked and square broadcast shapes
SHAPES = [
    (2, (), (), (33,)),
    (4, (), (), (33,)),
    (1024, (), (), (5,)),
    (16384, (), (), (3,)),
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
                assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[0]}-{s[2]}")
def test_whvi_mul_backward_matches_plain_autograd(dev, shape):
    ops = _operands(dev, *shape, seed=1)
    mine = [a.clone().requires_grad_() for a in ops]
    ref = [a.clone().requires_grad_() for a in ops]
    fc.reset_launches()
    y = whvi_mul(*mine)
    g = torch.randn_like(y)
    y.backward(g)
    assert fc.LAUNCHES == {"fused_y": 0, "fused_res": 1, "fused_bwd": 1, "fwht": 0}
    fc.fused_plain(*ref, False)[0].backward(g)
    for a, b in zip(mine, ref):
        assert a.grad.shape == b.shape
        assert rel_err(a.grad, b.grad) <= TOL


def test_no_grad_product_is_the_y_only_launch(dev):
    s1, u, s2, x = _operands(dev, *SHAPES[4])
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


def test_mixed_devices_and_strided_rows_raise(dev):
    d = torch.ones(16, device=dev)
    with pytest.raises(ValueError):
        fc.fused_raw(d, d, d.cpu(), torch.ones(3, 16, device=dev), False)
    with pytest.raises(ValueError):
        fc.fused_raw(d, d, d, torch.ones(16, 3, device=dev).t(), False)
    with pytest.raises(ValueError):
        fc.fwht_raw(torch.ones(16, 3, device=dev).t())
