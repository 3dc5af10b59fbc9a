"""The train step's model FLOPs (``portbench/loops/lm_counts.py``: every
WHVI map's butterflies, the routed experts' once a routed row, attention's
``QK^T`` and ``PV`` at their causal half; three times the forward) over the
measured window's time a step and the card's float32 peak (67 TFLOP/s), in
percent."""


def read(ctx):
    return 100.0 * ctx["flops_per_unit"] / ctx["unit_s"] / ctx["peak_flops"]
