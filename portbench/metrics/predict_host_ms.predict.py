"""Host milliseconds a predictive call in the port's ``whvi.model.predict`` and
``whvi.model.likelihood`` spans (the Model layer: the net's forward over the
samples and the likelihood's predictive answer), inclusive, from
``utils.profiling.span_summary()`` over the traced window; nothing where the
port records no span."""

from whvi_tpu_torch.utils import profiling

SPANS = ("whvi.model.predict", "whvi.model.likelihood")


def read(ctx):
    summary = getattr(profiling, "span_summary", None)
    if summary is None:  # a port without spans
        return None
    spans = summary()["spans"]
    missing = [name for name in SPANS if name not in spans]
    if missing:
        raise RuntimeError(f"the traced window recorded no {missing} span")
    return sum(spans[name]["total_s"] for name in SPANS) / ctx["units"] * 1e3
