"""Device events (kernels, copies, memsets) a call of the traced window, a
test-set score of all its chunks: the launches the Model layer's ops
make."""


def read(ctx):
    if "device_events" not in ctx:
        return None
    return ctx["device_events"] / ctx["units"]
