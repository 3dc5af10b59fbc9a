"""DeepSeek-V2 with a WHVI posterior over every projection (PyTorch).

The architecture of DeepSeek-V2 (arXiv:2405.04434; the ``deepseek_v2``
``config.json`` keys): a token embedding, decoder layers of multi-head
latent attention (MLA) and a SwiGLU MLP, dense in the first
``first_k_dense_replace`` layers and a mixture of experts after them, RMSNorm
before each and at the end, and the LM head. Every linear map is a
:class:`~whvi_tpu_torch.models.layers.WHVILinear` (``q_proj``,
``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``, the router, every
expert's ``gate_proj``, ``up_proj`` and ``down_proj``, the shared experts,
the dense MLP and ``lm_head``), with the prior variance ``lambda`` and the
``s_init`` of the configuration; non-square maps take the stacked form.
The embedding table and the norms' weights are point estimates, as WHVI's
``S1`` and ``S2`` are.

Layout: activations are ``(S, N, width)``, ``S`` MC samples over ``N = B
T`` tokens of ``B`` packed sequences of ``T``. Every WHVI matrix draws one
``eps`` a sample, shared by all the batch's tokens (``(S, 1, ..)``), so
a sequence's tokens see one weight sample, as attention needs.

- RMSNorm: ``w * x / sqrt(mean(x^2) + eps)``.
- MLA without ``q_lora``: ``q = q_proj(h)`` split per head into
  ``qk_nope_head_dim`` and ``qk_rope_head_dim``; ``kv_a_proj_with_mqa(h)``
  into the ``kv_lora_rank`` latent, normed and mapped by ``kv_b_proj`` to
  each head's ``k_nope`` and ``v``, and one rope key shared by all heads.
  RoPE turns the rope dims of q and k, in DeepSeek's layout (the
  interleaved pairs gathered into halves, then ``x cos + rotate_half(x)
  sin``), with YaRN's frequencies (:func:`yarn_inv_freq`); causal
  attention through ``scaled_dot_product_attention`` in fp32 with the
  softmax scale of :func:`softmax_scale`, then ``o_proj``.
- The MoE layer (:class:`MoE`) holds ``n_routed_experts`` of the router's
  ``published["n_routed_experts"]`` outputs (experts ``first_expert`` ..),
  as one card of an expert-parallel deployment does: it routes every
  (sample, token) row over all of them (softmax, greedy top-k, weights not
  renormalised, times ``routed_scaling_factor``), keeps the choices that
  name an expert held here, sorts them into segments by (expert, sample)
  on the device, runs gate, up and down as grouped WHVI products
  (:func:`whvi_tpu_torch.ops.whvi_mul_grouped`) and adds each row's
  outputs back weighted by its score; the shared experts (one SwiGLU of
  ``n_shared_experts`` times the expert width) see every row. What the
  absent experts would add is left out. Nothing in the step reads a device
  value to the host, no choice is dropped and nothing is padded to a
  capacity: the routed rows' buffers have the static length of all choices,
  and the kernels stop at the count the segment table holds. The routed
  part is recomputed in the backward, so those buffers live one layer at a
  time.
- The loss is the MC ELBO of a softmax over the (sliced) vocabulary:
  ``mnll + kl``, ``kl`` summed over every WHVI matrix held here. No
  sequence auxiliary loss (the configuration gives it no coefficient).

Spans: ``whvi.model.attention``, ``whvi.model.moe`` and inside it
``whvi.model.route`` (router, top-k and sort) and ``whvi.model.experts``.
Each MoE layer adds its rows a held expert to a device tally,
:data:`ROUTED_ROWS`, which ``utils.profiling.span_summary()`` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from whvi_tpu_torch.models.layers import WHVILinear
from whvi_tpu_torch.models.likelihoods import CategoricalLikelihood
from whvi_tpu_torch.ops.whvi_op import whvi_mul_grouped
from whvi_tpu_torch.utils.profiling import span

__all__ = ["DeepseekV2WHVI", "MLA", "MoE", "RMSNorm", "ROUTED_ROWS", "SwiGLU",
           "softmax_scale", "yarn_inv_freq"]

# Rows routed to each expert held here since the tally was made, by MoE
# layer (its module name): (experts held,) int64 on the layer's device,
# added to on the device every forward.
ROUTED_ROWS: dict = {}


# ------------------------------------------------------------------- YaRN
def _yarn_correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(config: dict) -> torch.Tensor:
    """The rope dims' inverse frequencies, ``(qk_rope_head_dim / 2,)``
    float32, as DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` computes
    them: ``base^(-2i/d)`` below YaRN's correction range, that over
    ``factor`` above it, a linear blend inside; plain RoPE without
    ``rope_scaling``."""
    dim, base = config["qk_rope_head_dim"], float(config["rope_theta"])
    exponent = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base**exponent)
    rs = config.get("rope_scaling")
    if not rs:
        return extra
    factor, max_pos = rs["factor"], rs["original_max_position_embeddings"]
    inter = 1.0 / (factor * base**exponent)
    low = max(math.floor(_yarn_correction_dim(rs["beta_fast"], dim, base, max_pos)), 0)
    high = min(math.ceil(_yarn_correction_dim(rs["beta_slow"], dim, base, max_pos)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp  # 1 where a dim keeps its own frequency
    return inter * (1 - mask) + extra * mask


def _rope_mscale(config: dict) -> float:
    """YaRN's scale of cos and sin: ``mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)``."""
    rs = config.get("rope_scaling")
    if not rs:
        return 1.0
    return _yarn_mscale(rs["factor"], rs["mscale"]) / _yarn_mscale(rs["factor"], rs["mscale_all_dim"])


def softmax_scale(config: dict) -> float:
    """``q_head_dim^-0.5``, times ``mscale(factor, mscale_all_dim)^2`` under
    YaRN."""
    scale = (config["qk_nope_head_dim"] + config["qk_rope_head_dim"]) ** -0.5
    rs = config.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        scale *= _yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope(x, cos, sin):
    """RoPE in DeepSeek-V2's layout on ``x (.., T, d)``: the interleaved
    pairs ``(x[2i], x[2i + 1])`` gathered into halves, then ``x cos +
    rotate_half(x) sin`` with ``cos, sin (T, d)``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rotated = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * cos + rotated * sin


# ------------------------------------------------------------------ blocks
def _whvi(n_in, n_out, config, device, dtype) -> WHVILinear:
    return WHVILinear(n_in, n_out, lambda_=config["lambda"], s_init=config["s_init"],
                      device=device, dtype=dtype)


class RMSNorm(nn.Module):
    """``weight * x / sqrt(mean(x^2) + eps)`` over the last axis; the weight
    is a point estimate."""

    def __init__(self, dim: int, eps: float, *, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps))


class SwiGLU(nn.Module):
    """``down_proj(silu(gate_proj(x)) * up_proj(x))``, three WHVI maps."""

    def __init__(self, hidden: int, width: int, config: dict, *, device=None, dtype=torch.float32):
        super().__init__()
        self.gate_proj = _whvi(hidden, width, config, device, dtype)
        self.up_proj = _whvi(hidden, width, config, device, dtype)
        self.down_proj = _whvi(width, hidden, config, device, dtype)

    def forward(self, x, noise: dict):
        gate = self.gate_proj(x, eps=noise[self.gate_proj])
        up = self.up_proj(x, eps=noise[self.up_proj])
        return self.down_proj(F.silu(gate) * up, eps=noise[self.down_proj])


class MLA(nn.Module):
    """Multi-head latent attention without ``q_lora`` (see the module
    docstring) on ``h (S, B T, hidden)`` of ``B`` sequences of ``T``."""

    def __init__(self, config: dict, *, device=None, dtype=torch.float32):
        super().__init__()
        c = config
        self.heads, self.nope, self.rope_dim = (
            c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"])
        self.v_dim, self.rank = c["v_head_dim"], c["kv_lora_rank"]
        H, nh = c["hidden_size"], self.heads
        self.q_proj = _whvi(H, nh * (self.nope + self.rope_dim), c, device, dtype)
        self.kv_a_proj_with_mqa = _whvi(H, self.rank + self.rope_dim, c, device, dtype)
        self.kv_a_layernorm = RMSNorm(self.rank, c["rms_norm_eps"], device=device, dtype=dtype)
        self.kv_b_proj = _whvi(self.rank, nh * (self.nope + self.v_dim), c, device, dtype)
        self.o_proj = _whvi(nh * self.v_dim, H, c, device, dtype)
        self.scale = softmax_scale(c)
        self.mscale = _rope_mscale(c)
        self.register_buffer("inv_freq", yarn_inv_freq(c).to(device), persistent=False)

    def _cos_sin(self, T: int, dtype):
        freqs = torch.outer(torch.arange(T, device=self.inv_freq.device, dtype=torch.float32),
                            self.inv_freq)
        emb = torch.cat((freqs, freqs), dim=-1)
        return (emb.cos() * self.mscale).to(dtype), (emb.sin() * self.mscale).to(dtype)

    def forward(self, h, T: int, noise: dict):
        S, N, _ = h.shape
        B, nh = N // T, self.heads
        q = self.q_proj(h, eps=noise[self.q_proj]).reshape(S * B, T, nh, -1).transpose(1, 2)
        q_nope, q_pe = q.split([self.nope, self.rope_dim], dim=-1)
        ckv = self.kv_a_proj_with_mqa(h, eps=noise[self.kv_a_proj_with_mqa])
        latent, k_pe = ckv.split([self.rank, self.rope_dim], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent), eps=noise[self.kv_b_proj])
        kv = kv.reshape(S * B, T, nh, -1).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        cos, sin = self._cos_sin(T, h.dtype)
        q_pe = rope(q_pe, cos, sin)
        k_pe = rope(k_pe.reshape(S * B, 1, T, self.rope_dim), cos, sin)
        q = torch.cat((q_nope, q_pe), dim=-1)
        k = torch.cat((k_nope, k_pe.expand(-1, nh, -1, -1)), dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=self.scale)
        out = out.transpose(1, 2).reshape(S, N, nh * self.v_dim)
        return self.o_proj(out, eps=noise[self.o_proj])


class MoE(nn.Module):
    """The experts of one card: ``n_routed_experts`` of the router's
    ``published["n_routed_experts"]`` outputs, from ``first_expert``, plus
    the shared experts (see the module docstring). ``last_topk`` holds the
    newest forward's chosen experts, ``(S N, top_k)`` router indices on the
    device."""

    def __init__(self, config: dict, name: str, *, device=None, dtype=torch.float32):
        super().__init__()
        c = config
        H, width = c["hidden_size"], c["moe_intermediate_size"]
        self.name = name
        self.routed = c.get("published", {}).get("n_routed_experts", c["n_routed_experts"])
        self.held, self.first = c["n_routed_experts"], c.get("first_expert", 0)
        if not 0 <= self.first <= self.routed - self.held:
            raise ValueError(f"experts {self.first}..{self.first + self.held - 1} of {self.routed}")
        self.top_k, self.factor = c["num_experts_per_tok"], float(c["routed_scaling_factor"])
        if c.get("scoring_func", "softmax") != "softmax" or c.get("norm_topk_prob"):
            raise ValueError("the router takes a softmax and top-k weights not renormalised")
        self.gate = _whvi(H, self.routed, c, device, dtype)
        self.experts = nn.ModuleList(
            SwiGLU(H, width, c, device=device, dtype=dtype) for _ in range(self.held))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            if getattr(self.experts[0], proj).matrix.dims[3] != 1:
                raise ValueError(f"an expert's {proj} must be one square block (stack 1)")
        self.shared_experts = SwiGLU(H, width * c["n_shared_experts"], c, device=device,
                                     dtype=dtype)
        self.last_topk = None

    def segments(self, idx):
        """``(offsets, order)`` of the choices ``idx (S, N, top_k)`` (router
        indices): the flat choices sorted by segment ``(expert held,
        sample)``, ``offsets (G + 1,)`` the segment table, ``G = held *
        S``; the choices of experts not held follow, outside every
        segment. Static shapes, on the device."""
        S = idx.shape[0]
        local = idx - self.first
        held = (local >= 0) & (local < self.held)
        sample = torch.arange(S, device=idx.device).view(S, 1, 1)
        G = self.held * S
        key, order = torch.sort(torch.where(held, local * S + sample, G).flatten(), stable=True)
        return torch.searchsorted(key, torch.arange(G + 1, device=key.device)), order

    def route(self, scores):
        """``(offsets, src, weights)`` of the rows' top-k choices over
        ``scores (S, N, routed)``: the segments of :meth:`segments`, each
        choice's token row ``src`` in ``S N`` and its routing weight. The
        layer's tally of rows a held expert grows on the device."""
        S, N, _ = scores.shape
        weights, idx = torch.topk(scores, self.top_k, dim=-1)
        self.last_topk = idx.detach().reshape(S * N, self.top_k)
        offsets, order = self.segments(idx)
        with torch.no_grad():
            rows = ROUTED_ROWS.get(self.name)
            if rows is None or rows.device != idx.device or rows.numel() != self.held:
                rows = ROUTED_ROWS[self.name] = torch.zeros(self.held, dtype=torch.int64,
                                                            device=idx.device)
            rows.add_((offsets[1:] - offsets[:-1]).view(self.held, S).sum(1))
        src = torch.div(order, self.top_k, rounding_mode="floor")
        return offsets, src, weights.flatten()[order] * self.factor

    def _products(self, proj: str, noise: dict):
        """``(s1, u, s2)`` of the held experts' ``proj``: ``(E, D)``, ``(E S,
        D)`` (segment ``e S + s``), ``(E, D)``."""
        layers = [getattr(e, proj) for e in self.experts]
        s1 = torch.stack([m.matrix.s1[0] for m in layers])
        s2 = torch.stack([m.matrix.s2[0] for m in layers])
        u = torch.stack([m.matrix.g_mu[0] + F.softplus(m.matrix.g_rho[0]) * noise[m][:, 0, 0]
                         for m in layers])
        return s1, u.flatten(0, 1), s2

    def _routed(self, x, weights, offsets, src, noise):
        """The held experts' weighted outputs summed into each row of ``x (S
        N, hidden)``."""
        first = self.experts[0]
        gate, up, down = first.gate_proj, first.up_proj, first.down_proj
        xin = F.pad(x, (0, gate.matrix.dims[2])) if gate.matrix.dims[2] else x
        g = whvi_mul_grouped(*self._products("gate_proj", noise), xin, offsets, src)
        u = whvi_mul_grouped(*self._products("up_proj", noise), xin, offsets, src)
        h = F.silu(g[:, : gate.n_out]) * u[:, : up.n_out]
        h = F.pad(h, (0, down.matrix.dims[2])) if down.matrix.dims[2] else h
        y = whvi_mul_grouped(*self._products("down_proj", noise), h, offsets)[:, : down.n_out]
        return torch.zeros_like(x).index_add(0, src, y * weights[:, None])

    def forward(self, h, noise: dict):
        with span("whvi.model.moe"):
            S, N, H = h.shape
            with span("whvi.model.route"):
                scores = self.gate(h, eps=noise[self.gate]).softmax(dim=-1)
                offsets, src, weights = self.route(scores)
            with span("whvi.model.experts"):
                x = h.reshape(S * N, H)
                if torch.is_grad_enabled():  # recomputed in the backward
                    routed = checkpoint(self._routed, x, weights, offsets, src, noise,
                                        use_reentrant=False, preserve_rng_state=False)
                else:
                    routed = self._routed(x, weights, offsets, src, noise)
            return routed.view(S, N, H) + self.shared_experts(h, noise)


class DecoderLayer(nn.Module):
    def __init__(self, config: dict, i: int, *, device=None, dtype=torch.float32):
        super().__init__()
        c, H = config, config["hidden_size"]
        self.input_layernorm = RMSNorm(H, c["rms_norm_eps"], device=device, dtype=dtype)
        self.self_attn = MLA(c, device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(H, c["rms_norm_eps"], device=device, dtype=dtype)
        if i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0:
            self.mlp = MoE(c, f"layers.{i}.mlp", device=device, dtype=dtype)
        else:
            self.mlp = SwiGLU(H, c["intermediate_size"], c, device=device, dtype=dtype)

    def forward(self, h, T: int, noise: dict):
        with span("whvi.model.attention"):
            h = h + self.self_attn(self.input_layernorm(h), T, noise)
        return h + self.mlp(self.post_attention_layernorm(h), noise)


class DeepseekV2WHVI(nn.Module):
    """The network of a ``deepseek_v2`` configuration with WHVI
    projections and a categorical likelihood over the vocabulary, with
    :class:`~whvi_tpu_torch.models.networks.WHVINetwork`'s interface
    (``loss``, ``kl``, ``predict``, ``draw_noise``, ``reset_parameters``,
    ``train_samples``, ``eval_samples``, ``replicas``), so that
    ``Trainer.train_step`` and ``Trainer.predict`` run it.

    ``config``: the published keys (``hidden_size``, ``num_hidden_layers``,
    ``vocab_size``, the MLA, MoE and RoPE keys), ``lambda`` and ``s_init``
    for every WHVI matrix, and the card's cut: ``n_routed_experts`` held
    here from ``first_expert`` of ``published["n_routed_experts"]``.
    Inputs are token ids ``x (B, T)`` (integers, or floats holding them, as
    ``Trainer.predict`` casts them), targets ``y (B, T)``; the forward gives
    logits ``(S, B T, vocab_size)``. ``eps`` is one tensor a WHVI matrix in
    :meth:`whvi_layers`' order, ``(S, 1) + shape``."""

    replicas = None

    def __init__(self, config: dict, train_samples: int = 1, eval_samples: int = 16, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        c = self.config = config
        H, V = c["hidden_size"], c["vocab_size"]
        if c.get("q_lora_rank"):
            raise ValueError("MLA with a q_lora_rank is not built")
        self.embed_tokens = nn.Parameter(torch.empty(V, H, device=device, dtype=dtype))
        self.layers = nn.ModuleList(
            DecoderLayer(c, i, device=device, dtype=dtype) for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(H, c["rms_norm_eps"], device=device, dtype=dtype)
        self.lm_head = _whvi(H, V, c, device, dtype)
        self.likelihood = CategoricalLikelihood()
        self.train_samples, self.eval_samples = train_samples, eval_samples
        self._maps = [(n, m) for n, m in self.named_modules() if isinstance(m, WHVILinear)]
        self.reset_parameters()

    def whvi_layers(self) -> list:
        """``(name, WHVILinear)`` of every WHVI matrix, in ``eps``'s order."""
        return list(self._maps)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, replica=None):
        """The embedding ``N(0, 1)``, the norms' weights 1, every WHVI matrix
        its own initialisation (``WHVILinear.reset_parameters``)."""
        if replica is not None:
            raise ValueError("the net takes no replicas")
        self.embed_tokens.normal_(generator=generator)
        for m in self.modules():
            if isinstance(m, (RMSNorm, WHVILinear)):
                m.reset_parameters(generator)

    def kl(self, lambdas=None) -> torch.Tensor:
        """The sum of every WHVI matrix's KL term."""
        if lambdas is not None:
            raise ValueError("the net takes no prior variance overrides")
        with span("whvi.model.kl"):
            return sum(m.kl() for _, m in self.whvi_layers())

    def draw_noise(self, lead, generator=None, dtype=torch.float32, device=None) -> list:
        """One ``eps (S, 1) + shape`` a WHVI matrix for inputs of ``lead =
        (S, N)`` rows, drawn from ``generator`` in :meth:`whvi_layers`'
        order."""
        return [m.draw_eps(lead, generator, dtype, device) for _, m in self.whvi_layers()]

    def forward(self, x, generator=None, eps=None, n_samples: int | None = None):
        """Logits ``(S, B T, vocab)`` of token ids ``x (B, T)`` under ``S``
        samples (``eps``'s, else ``n_samples``, else ``train_samples``)."""
        ids = x.long()
        B, T = ids.shape
        N = B * T
        if eps is None:
            S = self.train_samples if n_samples is None else n_samples
            eps = self.draw_noise((S, N), generator, self.embed_tokens.dtype,
                                  self.embed_tokens.device)
        layers = self.whvi_layers()
        if len(eps) != len(layers):
            raise ValueError(f"eps must have one entry a WHVI matrix ({len(layers)}), got {len(eps)}")
        noise = {m: e for (_, m), e in zip(layers, eps)}
        S = eps[0].shape[0]
        h = F.embedding(ids.reshape(N), self.embed_tokens).expand(S, N, -1)
        for i, layer in enumerate(self.layers):
            with span(f"whvi.model.layer{i}"):
                h = layer(h, T, noise)
        return self.lm_head(self.norm(h), eps=noise[self.lm_head])

    def predict(self, x, n_samples: int, generator=None, eps=None):
        """``(S, B T, vocab)`` MC logits of ``x (B, T)``. The Model layer's
        span ``whvi.model.predict`` covers it."""
        with span("whvi.model.predict"):
            return self(x, generator, eps, n_samples)

    def loss(self, x, y, n, generator=None, n_samples: int | None = None, ignore_kl: bool = False,
             kl_scale: float = 1.0, weights=None, eps=None, lambdas=None):
        """``(loss, {"mnll", "kl"})``, ``loss = mnll + kl_scale kl``, ``mnll =
        -(n / (S B T)) sum log p(y | logits)``: ``WHVINetwork.loss``'s
        contract for token ids ``x`` and next tokens ``y (B, T)``."""
        if weights is not None:
            raise ValueError("packed sequences take no row weights")
        with span("whvi.model.loss"):
            S = self.train_samples if n_samples is None else n_samples
            logits = self.predict(x, S, generator, eps)
            mnll = self.likelihood.mnll(y.reshape(-1), logits, n)
            kl = self.kl(lambdas)
            loss = mnll if ignore_kl else mnll + kl_scale * kl
            return loss, {"mnll": mnll, "kl": kl}
