"""The share of the traced window's K3 launches that took its reduce mode,
square or stacked, in the language-model cell, in percent: the
``fused_bwd_sums*`` launches over those and the ``fused_bwd*`` ones (K3 with
PyTorch's batch reductions after it), from the port's launch counters as
``utils.profiling.span_summary()`` reads them over the window (the grouped
expert product's ``fused_grouped_*`` launches are neither). 0 where the port
has no reduce mode (its counters are absent); nothing where the window
launched no K3 at all (a CPU run)."""

from whvi_tpu_torch.utils import profiling


def read(ctx):
    summary = getattr(profiling, "span_summary", None)
    if summary is None:  # a port without spans or counters
        return None
    launches = summary()["launches"]
    k3 = sum(n for name, n in launches.items() if name.startswith("fused_bwd"))
    if k3 == 0:
        return None
    sums = sum(n for name, n in launches.items() if name.startswith("fused_bwd_sums"))
    return 100.0 * sums / k3
