"""The public ``whvi_mul``'s share of its HBM bound in a predict cell, its
forward under ``no_grad`` at the cell's widest square product: its
interface bytes over 3.35 TB/s, over the time CUDA events measure for it,
in percent."""


def read(ctx):
    op = ctx.get("whvi_op")
    if not op:
        return None
    return 100.0 * op["least_s"] / op["measured_s"]
