"""The grouped WHVI product's share of its HBM bound, forward and backward
through autograd at the cell's routed shape (the segments of a checked
step's first MoE layer, ``x`` gathered from the hidden rows as the experts'
gate and up take it): its least bytes (``x``, ``y``, ``i1``, ``i2``, ``g``
and ``dx`` once a routed row, ``s1`` and ``s2`` once a segment;
``portbench/loops/lm_counts.py``) over 3.35 TB/s, over the time CUDA events
measure for it, in percent. Nothing off a card."""


def read(ctx):
    op = ctx.get("expert_op")
    if not op:
        return None
    return 100.0 * op["least_s"] / op["measured_s"]
