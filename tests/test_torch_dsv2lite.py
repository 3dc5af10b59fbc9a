"""DeepSeek-V2 with WHVI projections (``whvi_tpu_torch.models.deepseek_v2``)
and the grouped WHVI product (``whvi_tpu_torch.ops.grouped``) on the CPU, at
a tiny size: the net against the benchmark's plain reference
(``portbench/reference/deepseek_v2.py``), the expert layer's share against
the uncut layer, the grouped product against a loop of ``whvi_mul``, the
routing, YaRN, and the net through ``Trainer``.

The tiny configuration keeps every kind of layer: hidden 64, 4 heads at 16 +
8 / 16 with a latent of 32, a dense layer and two MoE layers of 8 routed
experts (top 2, 4 held here) of width 48 (one square block of 64 each, as an
expert is at the published widths) and one shared expert, vocabulary 256.
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from portbench.reference import deepseek_v2 as reference
from whvi_tpu_torch.models.deepseek_v2 import (
    ROUTED_ROWS, DeepseekV2WHVI, MoE, softmax_scale, yarn_inv_freq,
)
from whvi_tpu_torch.ops import set_whvi_mul_precision, whvi_mul, whvi_mul_grouped
from whvi_tpu_torch.ops.grouped import grouped_plain
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.utils.profiling import recording, span_summary

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
S, B, T = 2, 2, 16
TOL = 2e-5  # fp32: the same butterflies; attention, the expert sums and the losses in another order


@torch.no_grad()
def seeded_net(config=TINY, seed=0, **kw):
    """The net with every parameter random: ``g_mu ~ N(0, 0.5^2)``, so that
    the products carry signal, and the norms' weights near 1."""
    net = DeepseekV2WHVI(config, train_samples=S, eval_samples=S, **kw)
    gen = torch.Generator().manual_seed(seed)
    net.reset_parameters(gen)
    for name, p in net.named_parameters():
        if name.endswith("g_mu"):
            p.normal_(generator=gen).mul_(0.5)
        elif name.endswith("norm.weight") or name.endswith("layernorm.weight"):
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return net


def batch(seed=1, vocab=256):
    gen = torch.Generator().manual_seed(seed)
    seq = torch.randint(0, vocab, (B, T + 1), generator=gen)
    return seq[:, :-1], seq[:, 1:]


def noise(net, seed=2):
    return net.draw_noise((S, B * T), torch.Generator().manual_seed(seed))


def gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_net_matches_reference_loss_and_every_gradient():
    net = seeded_net()
    x, y = batch()
    eps = noise(net)
    loss, aux = net.loss(x, y, B * T, eps=eps)
    loss.backward()
    forced = [layer.mlp.last_topk for layer in net.layers if isinstance(layer.mlp, MoE)]
    params = {k: p.detach() for k, p in net.named_parameters()}
    names = {n: e for (n, _), e in zip(net.whvi_layers(), eps)}
    ref_loss, ref_mnll, ref_kl, grads, miss = reference.reference_grads(
        TINY, params, x, y, names, B * T, forced, margin=1e-4)
    assert miss == 0
    assert abs(float(loss.detach()) - ref_loss) <= TOL * abs(ref_loss)
    assert abs(float(aux["mnll"]) - ref_mnll) <= TOL * abs(ref_mnll)
    assert abs(float(aux["kl"]) - ref_kl) <= TOL * abs(ref_kl)
    for k, p in net.named_parameters():
        assert gap(p.grad, grads[k]) <= 1e-4, k


def test_reference_routes_as_the_net_on_its_own():
    net = seeded_net(seed=3)
    x, y = batch(4)
    eps = noise(net, 5)
    with torch.no_grad():
        net.loss(x, y, B * T, eps=eps)
    forced = [layer.mlp.last_topk for layer in net.layers if isinstance(layer.mlp, MoE)]
    params = {k: p.detach() for k, p in net.named_parameters()}
    names = {n: e for (n, _), e in zip(net.whvi_layers(), eps)}
    own = reference.reference_grads(TINY, params, x, y, names, B * T, None)
    taken = reference.reference_grads(TINY, params, x, y, names, B * T, forced, margin=1e-4)
    assert taken[4] == 0 and abs(own[0] - taken[0]) <= TOL * abs(own[0])


def _layer_params(moe, prefix):
    return {f"{prefix}.{k}": p.detach() for k, p in moe.named_parameters()}


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two cards' shares (experts 0-3 and 4-7 of 8) of one MoE layer, the
    shared experts counted once, against the reference's layer with all 8
    held."""
    uncut = {**TINY, "n_routed_experts": 8}
    whole = seeded_net(uncut, seed=6).layers[1].mlp
    shares = []
    for first in (0, 4):
        cfg = {**TINY, "first_expert": first}
        share = MoE(cfg, f"share{first}")
        with torch.no_grad():
            share.gate.load_state_dict(whole.gate.state_dict())
            share.shared_experts.load_state_dict(whole.shared_experts.state_dict())
            for j in range(4):
                share.experts[j].load_state_dict(whole.experts[first + j].state_dict())
        shares.append(share)
    gen = torch.Generator().manual_seed(7)
    h = torch.randn(S, B * T, 64, generator=gen)
    whole_eps = {m: m.draw_eps((S, B * T), gen) for m in whole.modules() if hasattr(m, "draw_eps")}
    named = {n: whole_eps[m] for n, m in whole.named_modules() if m in whole_eps}

    def share_noise(share, first):
        out = {share.gate: whole_eps[whole.gate]}
        for a, b in zip(share.shared_experts.modules(), whole.shared_experts.modules()):
            if b in whole_eps:
                out[a] = whole_eps[b]
        for j in range(4):
            for a, b in zip(share.experts[j].modules(), whole.experts[first + j].modules()):
                if b in whole_eps:
                    out[a] = whole_eps[b]
        return out

    with torch.no_grad():
        outs = [sh(h, share_noise(sh, f)) for sh, f in zip(shares, (0, 4))]
        shared = shares[0].shared_experts(h, share_noise(shares[0], 0))
        total = outs[0] + outs[1] - shared
        params = _layer_params(whole, "mlp")
        eps = {f"mlp.{n}": e for n, e in named.items()}
        for s in range(S):
            for b in range(B):
                rows = slice(b * T, (b + 1) * T)
                want, miss = reference.moe(uncut, params, "mlp", h[s, rows], eps, s)
                assert gap(total[s, rows], want) <= TOL


def _segments(counts):
    return F.pad(torch.cumsum(torch.tensor(counts), 0), (1, 0))


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_grouped_product_matches_a_loop_of_whvi_mul(gather, precision):
    """Uneven and empty segments, rows past the last one, forward and
    backward: the grouped product (its plain version on the CPU) against
    ``whvi_mul`` a segment."""
    E, P, D = 3, 2, 32
    gen = torch.Generator().manual_seed(8)
    counts = [5, 0, 3, 0, 7, 1]
    offsets = _segments(counts)
    M = int(offsets[-1]) + 4
    s1, s2 = (torch.randn(E, D, generator=gen).requires_grad_(True) for _ in range(2))
    u = torch.randn(E * P, D, generator=gen).requires_grad_(True)
    if gather:
        x = torch.randn(9, D, generator=gen).requires_grad_(True)
        index = torch.randint(0, 9, (M,), generator=gen)
    else:
        x = torch.randn(M, D, generator=gen).requires_grad_(True)
        index = None
    g = torch.randn(M, D, generator=gen)
    y = whvi_mul_grouped(s1, u, s2, x, offsets, index, precision=precision)
    want = []
    for k in range(E * P):
        a, b = int(offsets[k]), int(offsets[k + 1])
        rows = x[a:b] if index is None else x[index[a:b]]
        want.append(whvi_mul(s1[k // P], u[k], s2[k // P], rows, precision=precision))
    want = torch.cat(want + [torch.zeros(M - int(offsets[-1]), D)])
    assert torch.equal(y, want)
    got = torch.autograd.grad(y, (s1, u, s2, x), g)
    ref = torch.autograd.grad(want, (s1, u, s2, x), g)
    for a, b in zip(got, ref):
        assert gap(a, b) <= 1e-5
    assert torch.all(got[1][[1, 3]] == 0)  # an empty segment's u has no gradient


def test_grouped_residuals_are_the_transforms():
    E, D = 2, 16
    gen = torch.Generator().manual_seed(9)
    s1, s2, u = torch.randn(E, D, generator=gen), torch.randn(E, D, generator=gen), torch.randn(E, D, generator=gen)
    x = torch.randn(6, D, generator=gen)
    y, i1, i2 = grouped_plain(s1, u, s2, x, _segments([4, 2]), None, True)
    from whvi_tpu_torch.ops import fwht
    assert torch.equal(i1[:4], fwht(s2[0] * x[:4])) and torch.equal(i2[4:], fwht(u[1] * i1[4:]))
    assert torch.equal(y, s1[torch.tensor([0] * 4 + [1] * 2)] * i2)


def test_routing_keeps_every_choice_of_a_held_expert():
    """No choice is dropped however skewed the routing: every row's choices
    of experts held here are in the segments, at the row's own place, and
    every other choice is outside them."""
    cfg = {**TINY, "n_routed_experts": 4, "first_expert": 2}
    moe = MoE(cfg, "route-test")
    N = 40
    scores = torch.rand(S, N, 8)
    scores[:, :, 3] += 10  # every row takes expert 3 first
    scores[:, : N // 2, 5] += 5  # half the rows expert 5 second, the others expert 0
    scores[:, N // 2:, 0] += 5
    offsets, src, weights = moe.route(torch.softmax(scores, -1))
    idx = moe.last_topk.view(S, N, 2)
    held = (idx >= 2) & (idx < 6)
    assert int(offsets[-1]) == int(held.sum())
    counts = (offsets[1:] - offsets[:-1]).view(4, S)
    assert counts[1].tolist() == [N, N]  # expert 3: every row of both samples
    assert counts[3].tolist() == [N // 2, N // 2]
    for g in range(4 * S):
        rows = src[offsets[g]: offsets[g + 1]]
        e, s = 2 + g // S, g % S
        assert torch.equal(rows.sort().values, (s * N + (idx[s] == e).any(-1).nonzero()[:, 0]).sort().values)
    assert src.shape == (S * N * 2,)


def test_yarn_against_the_published_formula():
    d, theta, factor, L = 64, 10000.0, 40.0, 4096
    cfg = {**TINY, "qk_rope_head_dim": d, "qk_nope_head_dim": 128}
    # c(r) = d ln(L / (2 pi r)) / (2 ln theta): floor(c(32)) = 10, ceil(c(1)) = 23
    assert math.floor(d * math.log(L / (2 * math.pi * 32)) / (2 * math.log(theta))) == 10
    assert math.ceil(d * math.log(L / (2 * math.pi)) / (2 * math.log(theta))) == 23
    want = []
    for i in range(d // 2):
        own = theta ** (-2 * i / d)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want.append(own * (1 - ramp) + own / factor * ramp)
    got = yarn_inv_freq(cfg)
    assert torch.allclose(got.double(), torch.tensor(want, dtype=torch.float64), rtol=1e-6, atol=0)
    assert got[10] == pytest.approx(theta ** (-20 / 64), rel=1e-6)
    assert got[23] == pytest.approx(theta ** (-46 / 64) / factor, rel=1e-6)
    mscale = 0.1 * 0.707 * math.log(40.0) + 1.0
    assert softmax_scale(cfg) == pytest.approx(192**-0.5 * mscale**2, rel=1e-12)
    assert torch.equal(reference.inv_freq(cfg), got)


def test_trainer_trains_and_predicts_the_net():
    net = seeded_net(seed=11)
    trainer = Trainer(net, TrainConfig(lr0=1e-2), device="cpu")
    state = trainer.init(12)
    x, y = batch(13)
    losses = [float(trainer.train_step(state, x, y, B * T, True)["loss"]) for _ in range(4)]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    logits = trainer.predict(x.float(), torch.Generator().manual_seed(14))
    assert logits.shape == (S, B * T, 256) and torch.isfinite(logits).all()


def test_spans_and_the_routed_rows_tally():
    net = seeded_net(seed=18)
    x, y = batch(19)
    with recording():
        net.loss(x, y, B * T, eps=noise(net, 20))[0].backward()
    summary = span_summary()
    for name in ("whvi.model.attention", "whvi.model.moe", "whvi.model.route",
                 "whvi.model.experts", "whvi.op.whvi_mul_grouped", "whvi.op.whvi_mul_grouped_bwd"):
        assert summary["spans"][name]["count"] >= 1, name
    rows = summary["moe"]["ROUTED_ROWS"]
    assert set(rows) == {"layers.1.mlp", "layers.2.mlp"}
    for layer in ("layers.1.mlp", "layers.2.mlp"):
        idx = dict(net.named_modules())[layer].last_topk
        assert rows[layer] == [int((idx == e).sum()) for e in range(4)]
        assert rows[layer] == ROUTED_ROWS[layer].tolist() or sum(rows[layer]) > 0
    worst = max(max(r) / (sum(r) / len(r)) for r in rows.values())
    assert summary["moe"]["MAX_OVER_MEAN"] == pytest.approx(worst)


def test_control_precision_moves_the_loss():
    net = seeded_net(seed=21)
    x, y = batch(22)
    eps = noise(net, 23)
    with torch.no_grad():
        fp32 = float(net.loss(x, y, B * T, eps=eps)[1]["mnll"])
        set_whvi_mul_precision("bf16")
        try:
            bf16 = float(net.loss(x, y, B * T, eps=eps)[1]["mnll"])
        finally:
            set_whvi_mul_precision("fp32")
    assert fp32 != bf16
