"""The arithmetic of the ``lm_train`` loop (the DeepSeek-V2 WHVI net): the
model FLOPs of a train step and the least bytes of the grouped WHVI
product, from a configuration file's keys and the step's shapes.

FLOPs: every WHVI map counts its butterflies as
:func:`portbench.counts.whvi_product_flops` a block a row-sample (a square
map one block, a stacked map ``ceil(n_out / D)`` blocks of ``D``, the next
power of two of ``n_in``); the routed experts' maps count once for every
(row, sample, expert held here) the router sent a row to; attention counts
``QK^T`` and ``PV`` at their causal half, ``T^2 (d_qk + d_v)`` a head, a
sequence and a sample. Norms, RoPE, softmaxes, SwiGLU's products, the
routing and the likelihood are not counted. A train step is three times the
forward.
"""

from __future__ import annotations

from portbench import counts


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def map_flops(n_in: int, n_out: int) -> int:
    """Butterfly FLOPs of one row-sample through a WHVI map ``n_in -> n_out``."""
    D = _pow2(n_in)
    stack = 1 if n_in == n_out == D else -(-n_out // D)
    return stack * counts.whvi_product_flops(D)


def _is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def forward_flops(cfg: dict, B: int, T: int, S: int, routed_rows: float) -> float:
    """Model FLOPs of a forward of ``B`` sequences of ``T`` tokens under ``S``
    samples; ``routed_rows`` the (row, sample) choices of an expert held
    here, summed over the MoE layers."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    width, routed = cfg["moe_intermediate_size"], cfg["published"]["n_routed_experts"]
    attention = (map_flops(H, nh * (dn + dr)) + map_flops(H, r + dr)
                 + map_flops(r, nh * (dn + dv)) + map_flops(nh * dv, H))
    swiglu = lambda w: 2 * map_flops(H, w) + map_flops(w, H)
    per_row = map_flops(H, cfg["vocab_size"])
    for i in range(cfg["num_hidden_layers"]):
        per_row += attention
        if _is_moe(cfg, i):
            per_row += map_flops(H, routed) + swiglu(width * cfg["n_shared_experts"])
        else:
            per_row += swiglu(cfg["intermediate_size"])
    scores = S * B * nh * T * T * (dn + dr + dv) * cfg["num_hidden_layers"]
    return S * B * T * per_row + routed_rows * swiglu(width) + scores


def train_step_flops(cfg: dict, B: int, T: int, S: int, routed_rows: float) -> float:
    """Three times :func:`forward_flops` (the backward twice the forward)."""
    return 3 * forward_flops(cfg, B, T, S, routed_rows)


def grouped_op_bytes(rows: int, D: int, segments: int, itemsize: int = 4) -> int:
    """The grouped product's least bytes, forward and backward through
    autograd: ``x``, ``y``, ``i1``, ``i2``, ``g`` and ``dx`` once a routed
    row, ``s1`` and ``s2`` once a segment."""
    return itemsize * (6 * rows * D + 2 * segments * D)
