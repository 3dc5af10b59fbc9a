"""The reduction of a ``torch.profiler`` trace of the timed loop to what the
per-layer readers and the result's ``breakdown`` read.

Device time is the device's own events (kernels, copies, memsets), as the
port's ``utils.profiling.device_profile`` reads them (its rule, copied
here: ``key_averages``' device totals count a kernel again under every op
and annotation that encloses it, so they are not read). Busy time is the
union of the events' intervals inside the window, so events that overlap
count once. An idle gap is an interval of the window in which no device
event ran; it is named by the innermost host operation that was running
at its middle, on the thread that launched the work ("(host between
ops)" where none was: Python between two operations).
"""

from __future__ import annotations

import bisect
import collections
import contextlib

import torch

WINDOW_SPAN = "portbench.window"


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)


@contextlib.contextmanager
def profiled(sync):
    """Profile the block, CPU and, where there is a card, CUDA activity;
    the block runs inside a span named :data:`WINDOW_SPAN` that ends after
    ``sync()``. Yields a dict that holds the profile as ``"prof"`` once the
    block has ended."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = {}
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield out
            sync()
    out["prof"] = prof


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_profile(prof, top: int = 10) -> dict:
    """From a profile taken by :func:`profiled`: ``window_s`` (the span's
    length), ``busy_s`` (the union of device events inside it),
    ``device_events``, ``device_s_by_name``, ``optimizer_host_s`` (host time
    inside ``Optimizer.step``), ``device_ops`` and ``idle_gaps`` (the
    ``top`` of each, ``[name, seconds]``), and ``port_kernels``, the
    device events of the port's kernels (the ``whvi::`` namespace)."""
    events = list(prof.events())
    span = next(e for e in events if e.name == WINDOW_SPAN and not _is_device(e))
    w0, w1 = span.time_range.start, span.time_range.end
    device, by_name = [], collections.Counter()
    for e in events:
        if _is_device(e):
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                device.append((a, b))
                by_name[e.name] += (b - a) / 1e6
    merged = _merge(device)
    busy_us = sum(b - a for a, b in merged)
    host = [
        e for e in events
        if not _is_device(e) and e.thread == span.thread and e.name != WINDOW_SPAN
        and e.time_range.end > w0 and e.time_range.start < w1
    ]
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = collections.Counter()
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_at(host, starts, (a + b) / 2)] += (b - a) / 1e6
    optimizer_us = sum(
        e.cpu_time_total for e in prof.key_averages() if e.key.startswith("Optimizer.step#")
    )
    return {
        "port_kernels": sum("whvi::" in e.name for e in events if _is_device(e)),
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_events": len(device),
        "device_s_by_name": dict(by_name),
        "optimizer_host_s": optimizer_us / 1e6,
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(top)],
    }


def _host_at(host, starts, t, look_back: int = 400) -> str:
    """The name of the innermost host event running at ``t`` (the latest
    to start among those that cover it), or ``"(host between ops)"``."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - look_back) : i]):
        if e.time_range.end >= t:
            return e.name
    return "(host between ops)"


def check_complete(reduced: dict, launched: int) -> None:
    """Raise where the profile holds fewer of the port's kernels than the
    window launched: the profiler lost device activity, and every reading
    of it would fall short (the port's ``utils.profiling`` rule)."""
    if reduced["port_kernels"] < launched:
        raise RuntimeError(
            f"torch.profiler recorded {reduced['port_kernels']} of the {launched} launches of "
            "the port's kernels in the traced window"
        )
