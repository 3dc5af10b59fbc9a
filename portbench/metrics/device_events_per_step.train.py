"""Device events (kernels, copies, memsets) a train step of the traced
window: the launches the Model layer's ops make."""


def read(ctx):
    if "device_events" not in ctx:
        return None
    return ctx["device_events"] / ctx["units"]
