"""The load of the experts held here over the traced window: the most rows
any one of a MoE layer's held experts was sent over that layer's mean, the
worst layer's, from the layers' device tallies as
``utils.profiling.span_summary()`` reads them (``moe.MAX_OVER_MEAN``); 1
is an even load. Nothing where the port keeps no tally."""

from whvi_tpu_torch.utils import profiling


def read(ctx):
    summary = getattr(profiling, "span_summary", None)
    if summary is None:
        return None
    return summary().get("moe", {}).get("MAX_OVER_MEAN")
