"""The share of the traced window of train steps in which no device event
ran, in percent: 100 (1 - busy / window), busy the union of the device
events' intervals."""


def read(ctx):
    if "busy_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
