"""Device events (kernels, copies, memsets) a predictive call of the traced
window of ``c5-largeD.eval``'s kind (one call a score): the launches the
Model layer's ops make."""


def read(ctx):
    if "device_events" not in ctx:
        return None
    return ctx["device_events"] / ctx["units"]
