"""The train step's model FLOPs (butterfly count, three times the forward)
over the measured window's time a step and the chips' float32 peak
(67 TFLOP/s a card), in percent."""


def read(ctx):
    return 100.0 * ctx["flops_per_unit"] / ctx["unit_s"] / ctx["peak_flops"]
