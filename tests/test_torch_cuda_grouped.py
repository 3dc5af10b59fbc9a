"""The grouped WHVI product's kernels (``csrc/whvi_grouped.cu``) against its
plain version, and the DeepSeek-V2 WHVI net's step, on the card.

Every test needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_grouped.py

The fp32 forward adds in the plain version's order with every diagonal
product rounded once, so ``y``, ``i1`` and ``i2`` equal it bit for bit, and
so does ``dx`` where ``x`` is not gathered; the sums run in another order
(``1e-5`` of their largest element), as does ``dx`` summed atomically into
gathered rows. The bf16 mode is held to ``fwht_cuda.bf16_tol``.
"""

import pytest
import torch
import torch.nn.functional as F

from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import grouped as gr
from whvi_tpu_torch.ops.whvi_op import whvi_mul_grouped

pytestmark = pytest.mark.cuda

TOL = 1e-5
# the cell's routed shape: 8 experts held x 4 samples, about 1536 rows an
# expert of 98304 choices, uneven, one segment empty; and small ones across
# the widths, each with an empty segment and rows past the last
CELL = (2048, 8, 4, [480, 0, 310, 402, 390, 377, 351, 402] + [380 + 7 * i for i in range(24)], 98304)
SHAPES = [CELL] + [(D, 2, 3, [5, 0, 9, 1, 0, 3], 40) for D in (4, 16, 128, 512, 1024, 4096)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def operands(dev, D, E, P, counts, M, gather, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    offsets = F.pad(torch.cumsum(torch.tensor(counts, device=dev), 0), (1, 0))
    s1, s2 = (torch.randn(E, D, device=dev, generator=gen) * D**-0.5 for _ in range(2))
    u = torch.randn(E * P, D, device=dev, generator=gen)
    if gather:
        x = torch.randn(M // 6 + 1, D, device=dev, generator=gen)
        index = torch.randint(0, x.shape[0], (M,), device=dev, generator=gen)
    else:
        x, index = torch.randn(M, D, device=dev, generator=gen), None
    g = torch.randn(M, D, device=dev, generator=gen)
    return s1, u, s2, x, offsets, index, g


def cpu(*ts):
    return [None if t is None else t.cpu() for t in ts]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[0]}")
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_grouped_kernels_match_plain(dev, shape, gather, precision):
    D, E, P, counts, M = shape
    ops = operands(dev, D, E, P, counts, M, gather)
    s1, u, s2, x, offsets, index, g = ops
    count = sum(counts)
    fc.reset_launches()
    y1 = gr.grouped_raw(s1, u, s2, x, offsets, index, False, precision)[0]
    y, i1, i2 = gr.grouped_raw(s1, u, s2, x, offsets, index, True, precision)
    want = gr.grouped_plain(*cpu(s1, u, s2, x, offsets, index), True, precision)
    assert torch.equal(y, y1) and torch.all(y[count:] == 0)
    for got, ref, k in zip((y, i1, i2), want, (2, 1, 2)):
        if precision == "fp32":
            assert torch.equal(got[:count].cpu(), ref[:count])
        else:
            assert rel_err(got[:count].cpu(), ref[:count]) <= fc.bf16_tol(D, k)
    dx, ds1, du, ds2 = gr.grouped_bwd_raw(s1, u, s2, x, offsets, index, g, i1, i2, precision)
    ref = gr.grouped_bwd_plain(*cpu(s1, u, s2, x, offsets, index, g, i1, i2), precision)
    for got, want_t, k in zip((dx, ds1, du, ds2), ref, (2, 2, 1, 2)):
        bound = TOL if precision == "fp32" else fc.bf16_tol(D, k)
        assert rel_err(got.cpu(), want_t) <= bound
    if precision == "fp32" and not gather:
        assert torch.equal(dx[:count].cpu(), ref[0][:count]) and torch.all(dx[count:] == 0)
    suffix = "_bf16" if precision == "bf16" else ""
    assert fc.LAUNCHES[f"fused_grouped_y{suffix}"] == 1
    assert fc.LAUNCHES[f"fused_grouped_res{suffix}"] == 1
    assert fc.LAUNCHES[f"fused_grouped_bwd_sums{suffix}"] == 1


def test_grouped_sums_repeat_bit_for_bit(dev):
    D, E, P, counts, M = CELL
    s1, u, s2, x, offsets, index, g = operands(dev, D, E, P, counts, M, False, seed=1)
    y, i1, i2 = gr.grouped_raw(s1, u, s2, x, offsets, None, True)
    first = gr.grouped_bwd_raw(s1, u, s2, x, offsets, None, g, i1, i2)
    again = gr.grouped_bwd_raw(s1, u, s2, x, offsets, None, g, i1, i2)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_all_rows_in_one_segment_and_none_in_any(dev):
    D = 256
    for counts in ([0, 0, 37, 0], [0, 0, 0, 0]):
        s1, u, s2, x, offsets, index, g = operands(dev, D, 2, 2, counts, 50, True, seed=2)
        y, i1, i2 = gr.grouped_raw(s1, u, s2, x, offsets, index, True)
        want = gr.grouped_plain(*cpu(s1, u, s2, x, offsets, index), True)
        assert torch.equal(y.cpu(), want[0])
        got = gr.grouped_bwd_raw(s1, u, s2, x, offsets, index, g, i1, i2)
        ref = gr.grouped_bwd_plain(*cpu(s1, u, s2, x, offsets, index, g, want[1], want[2]))
        for a, b in zip(got, ref):
            assert torch.allclose(a.cpu(), b, rtol=TOL, atol=TOL * float(b.abs().max().clamp_min(1)))


def test_grouped_autograd_reads_nothing_to_the_host(dev):
    D, E, P, counts, M = CELL
    s1, u, s2, x, offsets, index, g = operands(dev, D, E, P, counts, M, True, seed=3)
    leaves = [t.requires_grad_(True) for t in (s1, u, s2, x)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = whvi_mul_grouped(*leaves, offsets, index)
        grads = torch.autograd.grad(y, leaves, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(t).all() for t in grads)


def test_grouped_refuses_what_it_does_not_take(dev):
    D, E, P, counts, M = (8192, 2, 2, [1, 2, 3, 4], 12)
    s1, u, s2, x, offsets, index, g = operands(dev, D, E, P, counts, M, False)
    with pytest.raises(ValueError):
        gr.grouped_raw(s1, u, s2, x, offsets, None, False)
    with pytest.raises(TypeError):
        gr.grouped_raw(*(t[:, :16].bfloat16().contiguous() for t in (s1, u, s2, x)), offsets, None,
                       False)


TINY = {
    "hidden_size": 64, "num_hidden_layers": 3, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "intermediate_size": 96, "moe_intermediate_size": 48, "n_routed_experts": 4,
    "first_expert": 0, "published": {"n_routed_experts": 8}, "num_experts_per_tok": 2,
    "n_shared_experts": 1, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "norm_topk_prob": False, "num_attention_heads": 4, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32, "q_lora_rank": None,
    "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "vocab_size": 256, "lambda": 1.0, "s_init": "auto",
}


def test_net_step_on_the_card_matches_the_cpu_and_reads_nothing_to_the_host(dev):
    """The tiny net's ``Trainer.train_step`` on the card (K2/K3, the grouped
    kernels, SDPA) against the same step on the CPU (the plain versions):
    its loss, mnll, kl and every gradient; the card's step under
    ``set_sync_debug_mode("error")``."""
    from whvi_tpu_torch.models.deepseek_v2 import DeepseekV2WHVI
    from whvi_tpu_torch.train import TrainConfig, Trainer

    out = {}
    gen = torch.Generator().manual_seed(4)
    seq = torch.randint(0, 256, (2, 17), generator=gen)
    torch.manual_seed(5)
    start = DeepseekV2WHVI(TINY, train_samples=2, eval_samples=2).state_dict()
    for device in ("cpu", "cuda"):
        net = DeepseekV2WHVI(TINY, train_samples=2, eval_samples=2)
        trainer = Trainer(net, TrainConfig(lr0=1e-2), device=device)
        state = trainer.init(6)
        net.load_state_dict(start)  # the same parameters on both devices
        eps = net.draw_noise((2, 32), torch.Generator().manual_seed(7))
        eps = [e.to(device) for e in eps]
        x, y = seq[:, :-1].to(device), seq[:, 1:].to(device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = trainer.train_step(state, x, y, 32, True, eps=eps)
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out[device] = (metrics, {k: p.grad.cpu() for k, p in net.named_parameters()})
    for k in ("loss", "mnll", "kl"):
        a, b = float(out["cuda"][0][k]), float(out["cpu"][0][k])
        assert abs(a - b) <= 1e-5 * abs(b), k
    for k, g in out["cpu"][1].items():
        assert rel_err(out["cuda"][1][k], g) <= 1e-4, k
