"""Counting and timing on one NVIDIA H100.

Counterpart of :mod:`whvi_tpu.utils.profiling`:

- :func:`fwht_flops`, :func:`whvi_mul_flops`, the layer and network
  counts (:func:`whvi_layer_fwd_flops`, :func:`whvi_layer_train_flops`,
  :func:`net_train_step_flops`, :func:`elbo_step_flops`): the matmul flops
  of the Kronecker-factor formulation, as the JAX package counts them.
  The butterfly kernels do other work (adds only), so a rate computed
  from these counts is a flop-equivalent rate;
- the H100's published peaks (NVIDIA's data sheet, SXM part, dense, at
  its 700 W limit). They are spec, not measurements, and a card set to a
  lower power limit runs below them;
- :func:`cuda_ms`: kernel time from CUDA events, which takes the place of
  the JAX package's ``chain_time`` (difference timing of on-device
  chains, needed only behind the TPU's remote dispatch);
- :func:`device_profile`: what ``torch.profiler`` reads over a window of
  work: the device's own time and events, the busy share, host time in
  ``Optimizer.step``;
- :func:`trace`: a ``torch.profiler`` Chrome trace of a block, the
  counterpart of the JAX ``trace`` (a ``jax.profiler`` trace);
- :func:`span`: the port's own spans at its layer boundaries (Loop,
  Model, Op, Kernel, Mesh), on while a ``torch.profiler`` session records
  (as ranges on its timeline) or inside
  :func:`recording`; :func:`span_summary` sums them by name, with the
  launch and collective counters over the same interval;
- :func:`card`, :func:`require_cuda`: what the measuring code states
  beside its numbers, and its refusal to run without a card.

The JAX package's ``Benchmark`` (a runner of ``benchmark_*`` methods) is
used by none of its benchmarks or experiments and has no counterpart.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Callable, Iterator

import torch

__all__ = [
    "H100_HBM_GBPS",
    "H100_PEAK_BF16_FLOPS",
    "H100_PEAK_TF32_FLOPS",
    "card",
    "cuda_ms",
    "device_profile",
    "elbo_step_flops",
    "fwht_flops",
    "net_train_step_flops",
    "recording",
    "require_cuda",
    "reset_spans",
    "span",
    "span_summary",
    "trace",
    "whvi_layer_fwd_flops",
    "whvi_layer_train_flops",
    "whvi_mul_flops",
]

# NVIDIA H100 SXM, data sheet (spec, not measured)
H100_HBM_GBPS = 3350.0  # HBM3, GB/s
H100_PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
H100_PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
H100_PEAK_FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores


def fwht_flops(D: int, batch: int) -> int:
    """Matmul flops of one Kronecker-factor FWHT of a ``(batch, D)``
    operand: factor ``f_i`` is a ``(batch * D / f_i, f_i) @ (f_i, f_i)``
    contraction, ``2 * batch * D * f_i`` flops. Elementwise work is not
    counted."""
    from whvi_tpu_torch.ops.hadamard import fwht_factors

    return 2 * batch * D * sum(fwht_factors(D))


def whvi_mul_flops(D: int, batch: int) -> int:
    """Matmul flops of one product ``s1 * H(u * H(s2 * x))`` of a
    ``(batch, D)`` operand: two FWHTs."""
    return 2 * fwht_flops(D, batch)


def whvi_layer_fwd_flops(D: int, batch: int, stack: int = 1) -> int:
    """Matmul flops of one forward pass through one WHVI layer, per MC
    sample: one fused product of each of ``stack`` blocks. ``W_bar(u)`` is
    linear in ``u``, so the LRT's mean and noise products merge into one
    (``models/weights.py``): the LRT does not change the count, and the
    JAX counters' ``lrt`` argument, which they ignore, is left out."""
    return whvi_mul_flops(D, batch) * stack


def whvi_layer_train_flops(D: int, batch: int, stack: int = 1) -> int:
    """Matmul flops of one train step through one WHVI layer, per MC
    sample: twice the forward (H is constant, so the backward is one more
    product, on the swapped diagonals; the diagonals' gradients are
    elementwise reductions)."""
    return 2 * whvi_layer_fwd_flops(D, batch, stack)


def net_train_step_flops(net, batch: int, n_samples: int | None = None) -> int:
    """Matmul flops of one ELBO train step of a ``WHVINetwork``, from the
    types of its layers' matrices: square, stacked and padded matrices
    count, column matrices (O(n), no matmul), activations and the layers
    without a ``matrix`` (``Dense``, ``Parallel``) do not, as in JAX."""
    from whvi_tpu_torch.models.weights import (
        PaddedSquareMatrix,
        SquarePow2Matrix,
        StackedMatrix,
    )

    S = net.train_samples if n_samples is None else n_samples
    total = 0
    for layer in net.layers:
        m = getattr(layer, "matrix", None)
        if isinstance(m, (SquarePow2Matrix, PaddedSquareMatrix)):
            total += whvi_layer_train_flops(m.D, batch)
        elif isinstance(m, StackedMatrix):
            D_in, _, _, stack = m.dims
            total += whvi_layer_train_flops(D_in, batch, stack)
    return S * total


def elbo_step_flops(square_dims, batch: int, n_samples: int) -> int:
    """Matmul flops of one ELBO train step of a WHVI MLP whose Bayesian
    layers are the square ``D x D`` of ``square_dims`` (the scaling
    model); its column output layer is O(D) and not counted."""
    return n_samples * sum(whvi_layer_train_flops(D, batch) for D in square_dims)


def cuda_ms(fn: Callable[[], object], reps: int = 20, rounds: int = 7) -> float:
    """Median milliseconds per call of ``fn`` on the current card, warm:
    CUDA events around ``reps`` calls, ``rounds`` times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_profile(fn: Callable[[], object], top: int = 0) -> dict:
    """What ``torch.profiler`` reads over one call of ``fn``, the card
    (where there is one) synchronized before and after it:

    - ``wall_s``: host-clock seconds of the call;
    - ``device_us`` and ``device_events``: the summed time and the count of
      the device's own events (kernels, copies, memsets). ``key_averages``'
      device totals are not read: they count a kernel again under each op
      and annotation that encloses it (about 3x on a scaling step);
    - ``busy_share``: ``device_us`` over ``wall_s``;
    - ``top``: the ``top`` event names with the most device time,
      ``[name, us]`` each;
    - ``optimizer_host_us``: host time inside ``Optimizer.step``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    launched = _port_launches()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    events, names = 0, []
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            events += 1
            names.append(e.name)
    _check_kernel_events(names, _port_launches() - launched, "device_profile")
    device_us = sum(by_name.values())
    return {
        "wall_s": wall,
        "device_us": device_us,
        "device_events": events,
        "busy_share": device_us / 1e6 / wall,
        "top": [[name, us] for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "optimizer_host_us": sum(
            e.cpu_time_total for e in prof.key_averages() if e.key.startswith("Optimizer.step#")
        ),
    }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block and write its ``torch.profiler`` Chrome trace, CPU
    activities and, where there is a card, CUDA activities (kernels by
    their symbol), to ``log_dir/trace.json``; yields that path. The card
    is synchronized before the block and at its end, so the trace holds
    the block's kernels. Open it in ``chrome://tracing`` or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    launched = _port_launches()
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    _check_kernel_events(names, _port_launches() - launched, f"trace {path}")


def _port_launches() -> int:
    """Launches of the port's K1-K4 so far (``fwht_cuda.LAUNCHES``)."""
    from whvi_tpu_torch.ops import fwht_cuda

    return sum(fwht_cuda.LAUNCHES.values())


def _check_kernel_events(names: list, launched: int, what: str) -> None:
    """Raise where ``torch.profiler`` recorded fewer of the port's kernels
    (symbols in the ``whvi::`` namespace) than the block launched: the
    profiler lost device activity, and its reading would be short of it.
    On an H100 (PyTorch 2.11) this happens in a process after processes it
    spawned on the same card ran, a mesh's ranks for example, profiled or
    not; a fresh process records them all."""
    seen = sum("whvi::" in n for n in names)
    if seen < launched:
        raise RuntimeError(
            f"{what}: torch.profiler recorded {seen} of the {launched} kernel launches of the "
            "port in the block (device activity lost; profile in a fresh process)"
        )


def require_cuda() -> None:
    """Raise unless a CUDA device is there: a measurement never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device: torch.cuda.is_available() is False")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------- spans
#
# The port's own spans, at the layer boundaries (``whvi.<layer>.<what>``).
# Off, ``span`` checks ``_ON`` and hands back the name's shared no-op: no
# clock read, no allocation, no profiler range. On (a torch.profiler
# session records, or a ``recording()`` block is open), each span adds its
# inclusive and self time to ``_TOTALS`` and, under the profiler, lies on
# its timeline as a range of torch's ``RecordFunction``. A session runs
# from the moment spans turn on until they turn off, and a new one starts
# afresh.

_ON = False  # a session is open: _PROFILING or _RECORDING
_PROFILING = False  # a torch.profiler session records
_RECORDING = 0  # open recording() blocks
_SESSION = 0  # sessions started so far; a span open across a new start is dropped
_TOTALS: dict = {}  # name -> [count, inclusive s, self s], this session's
_COUNTS: list = [None, None]  # the counters at the session's start and end
_LOCK = threading.Lock()
_THREAD = threading.local()  # .stack: one [children's seconds] a span open on the thread
# The profiler's range: torch's C++ RecordFunction, entered without the
# two dispatcher calls of ``torch.profiler.record_function`` (1.4 against
# 13.7 µs a range under the profiler, CPU). The class is private (checked
# on PyTorch 2.11 and 2.13); where a torch lacks it, ``record_function``.
_RANGE = (
    getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)
    or torch.profiler.record_function
)


def _stack() -> list:
    try:
        return _THREAD.stack
    except AttributeError:
        _THREAD.stack = []
        return _THREAD.stack


def _decorated(name: str, fn: Callable) -> Callable:
    """``fn`` run inside the span ``name`` whenever spans are on."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        if not _ON:
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)

    return inner


class _NoSpan:
    """The shared no-op of one span name, handed out while spans are off."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        return _decorated(self.name, fn)


class _NoSpans(dict):
    def __missing__(self, name: str) -> _NoSpan:
        off = self[name] = _NoSpan(name)
        return off


_OFF = _NoSpans()


class _Span:
    """One span while spans are on (see :func:`span`)."""

    __slots__ = ("name", "_range", "_frame", "_session", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _PROFILING:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self._frame = [0.0]
        _stack().append(self._frame)
        self._session = _SESSION
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc) -> bool:
        took = time.perf_counter() - self._t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1][0] += took
        if self._range is not None:
            self._range.__exit__(None, None, None)
        with _LOCK:
            if self._session == _SESSION:
                total = _TOTALS.get(self.name)
                if total is None:
                    total = _TOTALS[self.name] = [0, 0.0, 0.0]
                total[0] += 1
                total[1] += took
                total[2] += took - self._frame[0]
        return False

    def __call__(self, fn: Callable) -> Callable:
        return _decorated(self.name, fn)


def span(name: str):
    """The span ``name`` (``whvi.<layer>.<what>``), a context manager;
    ``@span(name)`` on a function spans each of its calls.

    Off (no ``torch.profiler`` session records and no :func:`recording`
    block is open) it is one check of a flag and a shared no-op. On, it
    adds its count, inclusive time and self time (inclusive less the
    spans it encloses on the same thread) to :func:`span_summary`, and
    while a ``torch.profiler`` session records it is a range of that name
    on the profiler's timeline (torch's ``RecordFunction``, as
    ``record_function`` makes, entered directly). Spans on other threads
    (autograd's device threads) count alike, each thread nesting its
    own."""
    if not _ON:
        return _OFF[name]
    return _Span(name)


def _counters() -> dict:
    """The port's counters now, from the modules that hold them where they
    are loaded (a module not loaded has counted nothing): kernel launches by
    name (``fwht_cuda.LAUNCHES``, ``kron_cuda.LAUNCHES``), operands
    realigned (``fwht_cuda.REALIGNED``), collectives by kind
    (``parallel.mesh.COLLECTIVES``), and copies of the MoE layers' device
    tallies of rows a held expert (``models.deepseek_v2.ROUTED_ROWS``;
    copied on the device, not read)."""
    out = {"launches": {}, "realigned": 0, "collectives": {}, "moe": {}}
    fwht = sys.modules.get("whvi_tpu_torch.ops.fwht_cuda")
    kron = sys.modules.get("whvi_tpu_torch.ops.kron_cuda")
    mesh = sys.modules.get("whvi_tpu_torch.parallel.mesh")
    model = sys.modules.get("whvi_tpu_torch.models.deepseek_v2")
    if model is not None:
        out["moe"] = {name: rows.clone() for name, rows in model.ROUTED_ROWS.items()}
    for module in (kron, fwht):
        if module is not None:
            out["launches"].update(module.LAUNCHES)
    if fwht is not None:
        out["realigned"] = fwht.REALIGNED
    if mesh is not None:
        out["collectives"] = dict(mesh.COLLECTIVES)
    return out


def _switch(profiling: bool | None = None, recording: int = 0) -> None:
    """Spans on or off as a profiler session or a recording() block starts
    or ends; a new session starts from zero and reads the counters."""
    global _ON, _PROFILING, _RECORDING, _SESSION, _TOTALS
    with _LOCK:
        if profiling is not None:
            _PROFILING = profiling
        _RECORDING += recording
        was, _ON = _ON, _PROFILING or _RECORDING > 0
        if _ON and not was:
            _SESSION += 1
            _TOTALS = {}
            _COUNTS[:] = [_counters(), None]
        elif was and not _ON:
            _COUNTS[1] = _counters()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans on for the block without ``torch.profiler`` (and without its
    host cost): :func:`span_summary` then sums the block's spans. Blocks
    nest; the outermost one is the session."""
    _switch(recording=1)
    try:
        yield
    finally:
        _switch(recording=-1)


def reset_spans() -> None:
    """Zero the session's span totals and read its counters afresh."""
    global _SESSION, _TOTALS
    with _LOCK:
        _SESSION += 1
        _TOTALS = {}
        now = _counters()
        _COUNTS[:] = [now, None if _ON else now]


def _delta(end: dict, start: dict) -> dict:
    return {k: v - start.get(k, 0) for k, v in end.items() if v - start.get(k, 0)}


def _moe(end: dict, start: dict) -> dict:
    """``{"ROUTED_ROWS": {layer: rows a held expert}, "MAX_OVER_MEAN"}`` of
    the tallies' change (a tally made inside the interval counts whole):
    the most rows an expert took over its layer's mean, the worst layer's
    (None where no row was routed)."""
    rows = {}
    for name, now in end.items():
        before = start.get(name)
        same = before is not None and before.device == now.device and before.shape == now.shape
        changed = (now - before if same else now).tolist()
        if any(changed):
            rows[name] = changed
    worst = max((max(r) * len(r) / sum(r) for r in rows.values()), default=None)
    return {"ROUTED_ROWS": rows, "MAX_OVER_MEAN": worst}


def span_summary() -> dict:
    """The newest session's spans (the open one, or the last to end: a
    ``torch.profiler`` session, or the outermost :func:`recording` block)
    and the counters over the same interval:

    - ``spans``: ``{name: {"count", "total_s", "self_s"}}``, inclusive and
      self seconds on the host clock;
    - ``launches``: kernel launches by counter name, ``realigned``:
      operands the kernels' wrappers copied to an aligned allocation, and
      ``collectives``: the mesh's collectives by kind, each the change of
      the port's counter (only those that changed);
    - ``moe``: ``ROUTED_ROWS``, the rows routed to each expert held here by
      MoE layer, and ``MAX_OVER_MEAN``, the worst layer's most loaded
      expert over its mean, from the layers' device tallies (read here, on
      the host, and nowhere in a step)."""
    with _LOCK:
        spans = {
            name: {"count": c, "total_s": t, "self_s": s} for name, (c, t, s) in _TOTALS.items()
        }
        start, end = _COUNTS
    if start is None:
        return {"spans": spans, "launches": {}, "realigned": 0, "collectives": {},
                "moe": _moe({}, {})}
    end = end or _counters()
    return {
        "spans": spans,
        "launches": _delta(end["launches"], start["launches"]),
        "realigned": end["realigned"] - start["realigned"],
        "collectives": _delta(end["collectives"], start["collectives"]),
        "moe": _moe(end["moe"], start["moe"]),
    }


def _watch_profiler() -> None:
    """Turn spans on and off with every ``torch.profiler`` session: wrap
    the setter that ``torch.autograd.profiler`` calls as a session starts
    and stops recording (its ``_run_on_profiler_start`` / ``_stop``). The
    setter is private (checked on PyTorch 2.11 and 2.13); where a torch
    lacks it, spans stay off under the profiler, and the benchmark's span
    readers raise on a traced window that recorded none."""
    from torch.autograd import profiler as autograd_profiler

    setter = getattr(autograd_profiler, "_set_is_profiler_enabled", None)
    if setter is None or getattr(setter, "whvi_spans", False):
        return

    def set_is_profiler_enabled(enable: bool) -> None:
        setter(enable)
        _switch(profiling=bool(enable))

    set_is_profiler_enabled.whvi_spans = True
    autograd_profiler._set_is_profiler_enabled = set_is_profiler_enabled
    if autograd_profiler._is_profiler_enabled:
        _switch(profiling=True)


_watch_profiler()
