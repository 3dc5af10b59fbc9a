"""Host milliseconds a step inside ``Optimizer.step`` (the Loop layer), from
the traced window's ``Optimizer.step#...`` spans, as the port's
``utils.profiling.device_profile`` reads ``optimizer_host_us``."""


def read(ctx):
    if "optimizer_host_s" not in ctx:
        return None
    return ctx["optimizer_host_s"] / ctx["units"] * 1e3
