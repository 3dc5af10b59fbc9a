"""Host milliseconds a step in the port's ``whvi.model.moe`` spans (the
Model layer's MoE layers: routing, the routed experts' products and the
shared experts, on the main thread, the backward not included), inclusive,
from ``utils.profiling.span_summary()`` over the traced window; nothing
where the port records no such span."""

from whvi_tpu_torch.utils import profiling

SPAN = "whvi.model.moe"


def read(ctx):
    summary = getattr(profiling, "span_summary", None)
    if summary is None:
        return None
    spans = summary()["spans"]
    if SPAN not in spans:
        return None
    return spans[SPAN]["total_s"] / ctx["units"] * 1e3
