"""Host microseconds a call of the Op layer's wrappers, their own code: the
self time of the port's spans ``whvi.op.whvi_mul``, ``whvi.op.whvi_mul_bwd``
(the backward up to its kernel) and ``whvi.op.column`` (checks, shapes,
allocations and autograd; the launches' ``whvi.kernel.*`` spans and the
backward's batch reductions, ``whvi.op.input_grads``, left out) over their
calls, from ``utils.profiling.span_summary()`` over the traced window;
nothing where the port records no span. On a card each such call launches
one kernel; on a CPU none.

In the train cells the device sets the pace: where a wrapper's own code
issues PyTorch ops and the launch queue is full, the host waits inside it,
so the reading holds some of the device's time (``tools/span_cost.py``'s
``issue`` mode reads the host's own)."""

from whvi_tpu_torch.utils import profiling

SPANS = ("whvi.op.whvi_mul", "whvi.op.whvi_mul_bwd", "whvi.op.column")


def read(ctx):
    summary = getattr(profiling, "span_summary", None)
    if summary is None:  # a port without spans
        return None
    spans = summary()["spans"]
    ops = [spans[name] for name in SPANS if name in spans]
    if not ops:
        raise RuntimeError(f"the traced window recorded none of the spans {SPANS}")
    return sum(s["self_s"] for s in ops) / sum(s["count"] for s in ops) * 1e6
