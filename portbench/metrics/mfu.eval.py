"""A test-set score's model FLOPs (butterfly count of the forward over all
its chunks) over the measured window's time a score and the chip's float32
peak (67 TFLOP/s), in percent."""


def read(ctx):
    return 100.0 * ctx["flops_per_unit"] / ctx["unit_s"] / ctx["peak_flops"]
