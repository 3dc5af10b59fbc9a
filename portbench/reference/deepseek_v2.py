"""The plain reference of DeepSeek-V2 with WHVI projections (configuration
``dsv2lite-whvi``): plain ``torch`` in float32 with TF32 off, written from
the published model (the ``deepseek_v2`` modelling code's equations) and
the WHVI product, importing nothing of the measured program.

A WHVI map ``n_in -> n_out`` with parameters ``s1, s2, g_mu, g_rho`` of
shape ``(D,)`` (square, ``n_in == n_out == D``) or ``(stack, D)``
(stacked: ``D`` the next power of two of ``n_in``, ``stack = ceil(n_out /
D)``) and one sample's noise ``eps`` of that shape is ``x -> (s1 *
fwht(u * fwht(s2 * pad(x))))``, blocks concatenated and cut to ``n_out``,
``u = g_mu + softplus(g_rho) eps``; the butterflies are
:func:`portbench.reference.fwht.fwht`.

The model, one (sample, sequence) at a time:

- ``h = embed_tokens[ids]``; each layer ``h += attn(norm(h))``, ``h +=
  mlp(norm(h))``; logits ``lm_head(norm(h))``; norms
  ``w x / sqrt(mean x^2 + eps)``.
- Attention (MLA, no ``q_lora``): per head ``q = [q_nope, rope(q_pe)]``,
  ``k = [k_nope, rope(k_pe)]`` with one ``k_pe`` for all heads from
  ``kv_a_proj_with_mqa``, ``k_nope`` and ``v`` from ``kv_b_proj`` of the
  normed latent; ``softmax(q k^T scale + causal mask) v`` written out,
  in blocks of query rows; RoPE in DeepSeek's layout (each interleaved
  pair gathered into halves, then ``x cos + rotate_half(x) sin``), YaRN's
  inverse frequencies and softmax scale from their published formulas.
- Dense layer: ``down(silu(gate x) * up x)``. MoE layer: router ``softmax``
  over all ``published`` experts, greedy top-k, weights not renormalised,
  times ``routed_scaling_factor``; the experts held here (``first_expert``
  .. ``+ n_routed_experts``), a Python loop over them with index gathers,
  each its rows' SwiGLU times the weight; plus the shared experts'
  SwiGLU on every row.
- ``mnll = -(n / (S B T)) sum log softmax(logits)[target]``, ``kl`` the sum
  over every WHVI matrix of ``KL(N(g_mu, softplus(g_rho)^2) || N(0,
  lambda))``.

Departures from the published model, the same in the program: WHVI
posteriors in place of dense weights (the embedding and the norms' weights
stay point estimates); the experts not held here and their share of the
output left out; the vocabulary cut to its first ``vocab_size`` ids; no
sequence auxiliary loss. Routing can be forced: ``forced`` gives each MoE
layer's chosen experts (the program's), and the reference then takes those
in place of its own top-k, counting in ``route_miss`` the rows whose own
choice differs where its k-th and (k+1)-th scores lie ``margin`` apart or
more.

Parameters are a dict under the program's module names
(``layers.<i>.self_attn.q_proj.matrix.s1``, ``embed_tokens``,
``layers.<i>.input_layernorm.weight``, ..), noise a dict of ``(S, 1) +
shape`` tensors under the WHVI maps' names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.fwht import fwht

QUERY_BLOCK = 256  # query rows a block of the written-out softmax


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(cfg: dict) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope dims, in float32: ``theta^(-2i
    / d)`` (``extra``) blended into ``extra / factor`` (``inter``) across the
    correction range ``[floor(c(beta_fast)), ceil(c(beta_slow))]``, ``c(r) =
    d ln(L / (2 pi r)) / (2 ln theta)``, ``L`` the original context:
    ``inter (1 - mask) + extra mask`` with ``mask = 1 - clamp((i - lo) / (hi
    - lo), 0, 1)``."""
    d, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    power = theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    extra, inter = 1.0 / power, 1.0 / (rs["factor"] * power)
    c = lambda r: d * math.log(rs["original_max_position_embeddings"] / (r * 2 * math.pi)) / (
        2 * math.log(theta))
    lo, hi = max(math.floor(c(rs["beta_fast"])), 0), min(math.ceil(c(rs["beta_slow"])), d - 1)
    hi = hi + 0.001 if lo == hi else hi
    mask = 1.0 - ((torch.arange(d // 2, dtype=torch.float32) - lo) / (hi - lo)).clamp(0, 1)
    return inter * (1 - mask) + extra * mask


def scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * yarn_mscale(
        rs["factor"], rs["mscale_all_dim"]) ** 2


def _rope(x, cos, sin):
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1) * sin


def linear(p, name, x, eps_s, n_in, n_out):
    """The WHVI map ``name`` of one sample's noise ``eps_s`` on ``x (rows,
    n_in)``."""
    s1, s2 = p[name + ".matrix.s1"], p[name + ".matrix.s2"]
    u = p[name + ".matrix.g_mu"] + F.softplus(p[name + ".matrix.g_rho"]) * eps_s
    D = _pow2(n_in)
    xp = F.pad(x, (0, D - n_in))
    if s1.dim() == 1:
        return (s1 * fwht(u * fwht(s2 * xp)))[..., :n_out]
    out = s1 * fwht(u * fwht(s2 * xp[..., None, :]))
    return out.reshape(*out.shape[:-2], -1)[..., :n_out]


def norm(p, name, x, cfg):
    return p[name + ".weight"] * (x / torch.sqrt(x.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"]))


def swiglu(p, name, x, eps, s, n_in, width):
    g = linear(p, name + ".gate_proj", x, eps[name + ".gate_proj"][s, 0], n_in, width)
    u = linear(p, name + ".up_proj", x, eps[name + ".up_proj"][s, 0], n_in, width)
    return linear(p, name + ".down_proj", F.silu(g) * u, eps[name + ".down_proj"][s, 0], width, n_in)


def attention(cfg, p, name, x, eps, s):
    """MLA on one sequence ``x (T, hidden)`` of sample ``s``."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    T = x.shape[0]
    e = lambda k: eps[f"{name}.{k}"][s, 0]
    q = linear(p, name + ".q_proj", x, e("q_proj"), H, nh * (dn + dr)).view(T, nh, dn + dr)
    ckv = linear(p, name + ".kv_a_proj_with_mqa", x, e("kv_a_proj_with_mqa"), H, r + dr)
    latent = norm(p, name + ".kv_a_layernorm", ckv[:, :r], cfg)
    kv = linear(p, name + ".kv_b_proj", latent, e("kv_b_proj"), r, nh * (dn + dv)).view(T, nh, dn + dv)
    freqs = torch.outer(torch.arange(T, dtype=torch.float32, device=x.device), inv_freq(cfg).to(x.device))
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = torch.cat([freqs, freqs], -1).cos() * m, torch.cat([freqs, freqs], -1).sin() * m
    q = torch.cat([q[..., :dn], _rope(q[..., dn:].transpose(0, 1), cos, sin).transpose(0, 1)], -1)
    k_pe = _rope(ckv[:, r:], cos, sin)
    k = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(T, nh, dr)], -1)
    v = kv[..., dn:]
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))  # (heads, T, .)
    outs = []
    for a in range(0, T, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, T)
        logits = q[:, a:b] @ k.transpose(1, 2) * scale(cfg)
        later = torch.arange(T, device=x.device)[None, :] > torch.arange(a, b, device=x.device)[:, None]
        logits = logits.masked_fill(later, float("-inf"))
        outs.append(torch.softmax(logits, dim=-1) @ v)
    out = torch.cat(outs, dim=1).transpose(0, 1).reshape(T, nh * dv)
    return linear(p, name + ".o_proj", out, e("o_proj"), nh * dv, H)


def moe(cfg, p, name, x, eps, s, forced=None, margin=0.0):
    """The MoE layer on one sequence's rows ``x (T, hidden)`` of sample
    ``s``: ``(out, route_miss)``; ``forced (T, k)`` the experts to take."""
    H, width = cfg["hidden_size"], cfg["moe_intermediate_size"]
    routed, k = cfg["published"]["n_routed_experts"], cfg["num_experts_per_tok"]
    first, held = cfg.get("first_expert", 0), cfg["n_routed_experts"]
    scores = torch.softmax(linear(p, name + ".gate", x, eps[name + ".gate"][s, 0], H, routed), -1)
    own = torch.topk(scores.detach(), k + 1, dim=-1)
    chosen = own.indices[:, :k] if forced is None else forced
    clear = (own.values[:, k - 1] - own.values[:, k]) >= margin
    same = torch.sort(own.indices[:, :k], -1).values == torch.sort(chosen, -1).values
    miss = int((clear & ~same.all(-1)).sum())
    weight = scores.gather(-1, chosen) * float(cfg["routed_scaling_factor"])
    out = torch.zeros_like(x)
    for j in range(held):
        hit = chosen == first + j
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        w = (weight * hit)[rows].sum(-1)
        y = swiglu(p, f"{name}.experts.{j}", x[rows], eps, s, H, width)
        out = out.index_add(0, rows, y * w[:, None])
    shared = swiglu(p, name + ".shared_experts", x, eps, s, H, width * cfg["n_shared_experts"])
    return out + shared, miss


def sequence_logits(cfg, p, ids, eps, s, forced=None, margin=0.0):
    """``(logits (T, vocab), route_miss)`` of one sequence ``ids (T,)`` under
    sample ``s``; ``forced`` a list of ``(T, k)`` a MoE layer, or None."""
    H = cfg["hidden_size"]
    h = p["embed_tokens"][ids]
    misses, m = 0, 0
    for i in range(cfg["num_hidden_layers"]):
        name = f"layers.{i}"
        h = h + attention(cfg, p, name + ".self_attn", norm(p, name + ".input_layernorm", h, cfg), eps, s)
        x = norm(p, name + ".post_attention_layernorm", h, cfg)
        if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0:
            out, miss = moe(cfg, p, name + ".mlp", x, eps, s, None if forced is None else forced[m], margin)
            misses, m = misses + miss, m + 1
        else:
            out = swiglu(p, name + ".mlp", x, eps, s, H, cfg["intermediate_size"])
        h = h + out
    logits = linear(p, "lm_head", norm(p, "norm", h, cfg), eps["lm_head"][s, 0], H, cfg["vocab_size"])
    return logits, misses


def kl_total(cfg, p):
    """The sum over every WHVI matrix of ``KL(N(g_mu, sigma^2) || N(0,
    lambda))``, ``sigma = softplus(g_rho)``."""
    lam, total = float(cfg["lambda"]), 0.0
    for key in sorted(k for k in p if k.endswith(".matrix.g_mu")):
        mu, sigma = p[key], F.softplus(p[key[: -len("g_mu")] + "g_rho"])
        total = total + torch.sum(0.5 * math.log(lam) - torch.log(sigma)
                                  + (sigma * sigma + mu * mu) / (2 * lam) - 0.5)
    return total


def reference_grads(cfg, params, ids, targets, eps, n, forced=None, margin=0.0):
    """``(loss, mnll, kl, grads, route_miss)`` of the negative ELBO at
    ``params`` on ``ids``, ``targets (B, T)`` with noise ``eps`` (``(S, 1) +
    shape`` a WHVI map): one (sample, sequence) at a time, each adding its
    share of the mnll's gradient, so the memory held is one sequence's.
    ``forced``: a list of ``(S, B T, k)`` chosen experts a MoE layer, or
    None for the reference's own."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # fp32
    try:
        leaves = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
        eps = {k: v.float() for k, v in eps.items()}
        S = next(iter(eps.values())).shape[0]
        B, T = ids.shape
        mnll, misses = 0.0, 0
        for s in range(S):
            for b in range(B):
                f = None if forced is None else [c.reshape(S, B, T, -1)[s, b] for c in forced]
                logits, miss = sequence_logits(cfg, leaves, ids[b].long(), eps, s, f, margin)
                logp = torch.log_softmax(logits, dim=-1).gather(-1, targets[b].long()[:, None])
                share = -(n / (S * B * T)) * logp.sum()
                share.backward()
                mnll += float(share.detach())
                misses += miss
        kl = kl_total(cfg, leaves)
        kl.backward()
        grads = {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in leaves.items()}
        kl = float(kl.detach())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return mnll + kl, mnll, kl, grads, misses
