"""Host milliseconds a step in the port's ``whvi.model.loss`` span (the Model
layer's forward: predict, likelihood and KL), inclusive, from
``utils.profiling.span_summary()`` over the traced window; nothing where the
port records no span.

In the train cells the device sets the pace: once the launch queue is full
the host waits inside the spans, so the reading follows the device's time a
step, not the host's own (``tools/span_cost.py``'s ``issue`` mode reads
that)."""

from whvi_tpu_torch.utils import profiling

SPAN = "whvi.model.loss"


def read(ctx):
    summary = getattr(profiling, "span_summary", None)
    if summary is None:  # a port without spans
        return None
    spans = summary()["spans"]
    if SPAN not in spans:
        raise RuntimeError(f"the traced window recorded no {SPAN} span")
    return spans[SPAN]["total_s"] / ctx["units"] * 1e3
