"""The port's spans and counters (``utils.profiling.span``,
``recording``, ``span_summary``) on the CPU: off they record nothing and
enter no profiler range; on, under ``torch.profiler`` or ``recording()``,
they count, time and nest by thread, lie on the profiler's timeline around
the ops they enclose, start afresh with each session, and read the port's
launch, realignment and collective counters over the same interval; the
benchmark's eight span readers report in their cells of a tiny benchmark
root. One test needs a card: the backward's spans on autograd's device
thread. The file imports neither JAX nor the JAX package."""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import sys
import threading
import time
import types

import pytest
import torch

from portbench import harness, run as runner
from portbench.tests.tiny import make_root
from tools import span_cost
from whvi_tpu_torch.models import WHVIRegression, mlp_layers
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops import whvi_mul
from whvi_tpu_torch.parallel import mesh as mesh_module
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.utils import profiling
from whvi_tpu_torch.utils.profiling import recording, reset_spans, span, span_summary

torch.set_num_threads(1)

SPAN_METRICS = {
    "c5-largeD.train": ("step_host_ms.train", "forward_host_ms.train", "backward_host_ms.train",
                        "whvi_mul_host_us.train"),
    "c4-mnist.eval": ("predict_host_ms.eval", "whvi_mul_host_us.eval"),
    "c5-largeD.eval": ("predict_host_ms.predict", "whvi_mul_host_us.predict"),
}
MESH_CELL = "c5-largeD.train-mesh1x4"


def operands(D=16, S=2, B=4, grad=False):
    g = torch.Generator().manual_seed(D)
    shapes = ((D,), (S, 1, D), (D,), (S, B, D))
    return [torch.randn(*s, generator=g).requires_grad_(grad) for s in shapes]


def host_events(prof) -> dict:
    """The profile's host ranges of the port's spans by name (the last of
    each; a range's copy on the device's timeline left out)."""
    return {e.name: e for e in prof.events()
            if e.name.startswith("whvi.") and str(e.device_type).endswith("CPU")}


@pytest.fixture
def spy(monkeypatch):
    """The name of every profiler range the spans enter, entered for
    real."""
    entered, real = [], profiling._RANGE

    def enter(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_RANGE", enter)
    return entered


def test_off_spans_record_nothing_and_enter_no_range(spy):
    with recording():
        with span("whvi.test.before"):
            pass
    before = span_summary()
    assert not profiling._ON
    off = span("whvi.test.off")
    assert off is span("whvi.test.off")  # the name's shared no-op
    for _ in range(100):
        with span("whvi.test.off"):
            whvi_mul(*operands())
    decorated = span("whvi.test.decorated")(lambda x: x + 1)
    assert decorated(1) == 2
    assert span_summary() == before and spy == []


def test_nested_spans_count_inclusive_and_self_time(spy):
    with torch.profiler.profile():
        with span("whvi.test.outer"):
            time.sleep(0.02)
            for _ in range(2):
                with span("whvi.test.inner"):
                    time.sleep(0.03)
    spans = span_summary()["spans"]
    outer, inner = spans["whvi.test.outer"], spans["whvi.test.inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert inner["total_s"] == pytest.approx(inner["self_s"]) and inner["total_s"] >= 0.06
    assert outer["total_s"] >= 0.08 and outer["total_s"] > inner["total_s"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0.02 <= outer["self_s"] < 0.03 + 0.5 * inner["total_s"]
    assert spy == ["whvi.test.outer"] + ["whvi.test.inner"] * 2


def test_spans_lie_on_the_trace_timeline_around_their_ops(tmp_path):
    s1, u, s2, x = operands()
    with profiling.trace(str(tmp_path / "tr")) as path:
        with span("whvi.test.block"):
            whvi_mul(s1, u, s2, x)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def inside(inner, outer):
        return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])

    block = next(e for e in events if e["name"] == "whvi.test.block")
    op = next(e for e in events if e["name"] == "whvi.op.whvi_mul")
    muls = [e for e in events if e["name"] == "aten::mul"]
    assert inside(op, block) and muls and all(inside(m, op) for m in muls)
    assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 1


def test_train_step_spans_nest_as_the_layers():
    torch.manual_seed(0)
    net = WHVIRegression(mlp_layers(16, 1, hidden=(16, 16)), train_samples=2)
    trainer = Trainer(net, TrainConfig())
    state = trainer.init(0)
    x, y = torch.randn(8, 16), torch.randn(8, 1)
    trainer.train_step(state, x, y, 8, True)
    with torch.profiler.profile() as prof:
        for _ in range(2):
            trainer.train_step(state, x, y, 8, True)
    spans = span_summary()["spans"]
    for name in ("whvi.loop.train_step", "whvi.model.loss", "whvi.model.backward",
                 "whvi.model.predict", "whvi.model.kl", "whvi.model.likelihood",
                 "whvi.op.whvi_mul", "whvi.op.whvi_mul_bwd", "whvi.op.input_grads",
                 "whvi.op.column"):
        square = "whvi_mul" in name or "input_grads" in name
        assert spans[name]["count"] == 2 * (2 if square else 1), name
    for i in range(5):  # WHVI, relu, WHVI, relu, the column head
        assert spans[f"whvi.model.layer{i}"]["count"] == 2
    step = spans["whvi.loop.train_step"]
    parts = sum(spans[n]["total_s"] for n in ("whvi.model.loss", "whvi.model.backward"))
    assert step["self_s"] == pytest.approx(step["total_s"] - parts, rel=1e-6)
    # on the CPU autograd runs the backward on this thread: the op's
    # backward lies inside whvi.model.backward, on the profiler's timeline,
    # and its batch reductions follow it, outside the wrapper's span
    events = host_events(prof)
    backward, bwd = events["whvi.model.backward"], events["whvi.op.whvi_mul_bwd"]
    grads = events["whvi.op.input_grads"]
    assert backward.time_range.start <= bwd.time_range.start
    assert bwd.time_range.end <= grads.time_range.start
    assert grads.time_range.end <= backward.time_range.end


def test_backward_on_another_thread_counts_apart_from_the_waiting_span():
    """As on a card, where autograd's device thread runs the backward
    while the main thread waits inside ``whvi.model.backward``: the op's
    backward span counts on its own thread, and the waiting span's self
    time is all of it."""
    s1, u, s2, x = operands(grad=True)
    loss = whvi_mul(s1, u, s2, x).sum()
    with recording():
        with span("whvi.model.backward"):
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(timeout=60)
    assert not worker.is_alive() and x.grad is not None
    spans = span_summary()["spans"]
    assert spans["whvi.op.whvi_mul_bwd"]["count"] == 1
    wait = spans["whvi.model.backward"]
    assert wait["self_s"] == wait["total_s"] >= spans["whvi.op.whvi_mul_bwd"]["total_s"]


def test_spans_fall_back_to_record_function(monkeypatch):
    """Where a torch lacks the direct ``RecordFunction`` binding the spans
    enter ``torch.profiler.record_function``, and lie on the timeline
    alike."""
    monkeypatch.setattr(profiling, "_RANGE", torch.profiler.record_function)
    with torch.profiler.profile() as prof:
        with span("whvi.test.outer"):
            whvi_mul(*operands())
    events = host_events(prof)
    outer, op = events["whvi.test.outer"], events["whvi.op.whvi_mul"]
    assert outer.time_range.start <= op.time_range.start
    assert op.time_range.end <= outer.time_range.end
    assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 1


def test_recording_sums_spans_without_the_profiler(spy):
    s1, u, s2, x = operands()
    with recording():
        with recording():  # nested blocks are one session
            whvi_mul(s1, u, s2, x)
        whvi_mul(s1, u, s2, x)
        assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 2
    whvi_mul(s1, u, s2, x)  # off again
    assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 2
    assert spy == [] and not torch.autograd.profiler._is_profiler_enabled


def test_each_session_starts_afresh():
    s1, u, s2, x = operands()
    with torch.profiler.profile():
        for _ in range(3):
            whvi_mul(s1, u, s2, x)
    assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 3
    with torch.profiler.profile():
        for _ in range(2):
            whvi_mul(s1, u, s2, x)
    assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 2
    with recording():
        whvi_mul(s1, u, s2, x)
        reset_spans()
        assert span_summary()["spans"] == {}
        whvi_mul(s1, u, s2, x)
    assert span_summary()["spans"]["whvi.op.whvi_mul"]["count"] == 1


class StubLibrary:
    """The kernels' C entries, launching nothing: the wrappers' host side
    on CPU tensors."""

    def whvi_fused_f32(self, *args):
        return 0

    def column_bf16s(self, *args):
        return 0


@pytest.fixture
def stub_launches(monkeypatch):
    monkeypatch.setattr(fc, "load_library", StubLibrary)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def test_counter_deltas_are_the_counters_changes(stub_launches, monkeypatch):
    monkeypatch.setattr(fc, "LAUNCHES", dict(fc.LAUNCHES))
    monkeypatch.setattr(fc, "REALIGNED", fc.REALIGNED)
    monkeypatch.setattr(mesh_module, "COLLECTIVES", collections.Counter())
    s1, u, s2, x = operands()
    shifted = torch.empty(x.numel() + 1)[1:].view_as(x).copy_(x)  # off 16 bytes
    g = torch.randn(2, 4, 16, dtype=torch.bfloat16)
    d1, d2 = (torch.randn(16, dtype=torch.bfloat16) for _ in range(2))
    fc.LAUNCHES["fused_res"] += 5  # before the session: not in its deltas
    launches, realigned = dict(fc.LAUNCHES), fc.REALIGNED
    with recording():
        fc._launch_fused(s1, u, s2, x, True, "fp32", "fused_res")
        fc._launch_fused(s1, u, s2, shifted, True, "fp32", "fused_res")
        fc._launch_column(0, g, d1, d2)
        mesh_module.COLLECTIVES["all_reduce"] += 1
    fc._launch_fused(s1, u, s2, x, False, "fp32", "fused_y")  # after it: not either
    summary = span_summary()
    changed = {k: fc.LAUNCHES[k] - launches[k] for k in launches}
    changed["fused_y"] -= 1
    assert summary["launches"] == {k: n for k, n in changed.items() if n}
    assert summary["launches"] == {"fused_res": 2, "column_y_bf16s": 1}
    assert summary["realigned"] == fc.REALIGNED - realigned == 1
    assert summary["collectives"] == {"all_reduce": 1}
    spans = summary["spans"]
    assert spans["whvi.kernel.fused_res"]["count"] == 2
    assert spans["whvi.kernel.column_y_bf16s"]["count"] == 1


def test_spans_from_many_threads_lose_no_update():
    threads, each = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with span("whvi.test.outer"):
                    with span("whvi.test.inner"):
                        pass

        with recording():
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    spans = span_summary()["spans"]
    assert spans["whvi.test.outer"]["count"] == spans["whvi.test.inner"]["count"] == threads * each
    outer = spans["whvi.test.outer"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - spans["whvi.test.inner"]["total_s"])


# ------------------------------------------------------- the benchmark's readers


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("spans")))


def check_span_metrics(result, cell):
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    span_metrics = {m for names in SPAN_METRICS.values() for m in names}
    wanted = SPAN_METRICS["c5-largeD.train" if cell == MESH_CELL else cell]
    assert set(metrics) & span_metrics == set(wanted)
    for name in wanted:
        assert math.isfinite(metrics[name]) and metrics[name] > 0, name
    if "step_host_ms.train" in metrics:
        assert metrics["step_host_ms.train"] >= (
            metrics["forward_host_ms.train"] + metrics["backward_host_ms.train"]
        )


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_cell_reports_its_span_metrics(root, cell):
    result = harness.run_cell(root, cell, 2**31 + 5, 0.2, True, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"], result["checks"]
    check_span_metrics(result, cell)


def test_traced_mesh_cell_reports_its_span_metrics(root):
    """Rank 0 of the mesh cell over four gloo ranks reads its own spans."""
    result, _ = runner.on_mesh(harness.mesh_rank, 4, "gloo", "cpu", root, MESH_CELL,
                               2**31 + 13, 0.2, True, time.perf_counter(), None)
    assert result["correct"], result["checks"]
    check_span_metrics(result, MESH_CELL)


def test_span_readers_read_nothing_without_spans(root, monkeypatch):
    """A program without ``span_summary`` (the port before its spans)
    gives the readers nothing to read, and they raise nothing."""
    monkeypatch.delattr(profiling, "span_summary")
    cell = harness.Cell(root, "c5-largeD.train")
    for names in SPAN_METRICS.values():
        for name in names:
            assert cell.reader(name)({"units": 3}) is None


def test_span_readers_raise_where_a_traced_window_recorded_no_span(root):
    """A profiler session that recorded none of a reader's spans (the hook
    on the profiler did not take) is a fault, not a missing reading."""
    with torch.profiler.profile():
        torch.ones(4).sum()
    assert span_summary()["spans"] == {}
    cell = harness.Cell(root, "c5-largeD.train")
    for names in SPAN_METRICS.values():
        for name in names:
            with pytest.raises(RuntimeError, match="recorded no"):
                cell.reader(name)({"units": 3})


@pytest.mark.parametrize("launches,share", [
    ({"fused_res": 4, "fused_bwd_sums": 2}, 100.0),  # both square layers take the reduce mode
    ({"fused_res": 4, "fused_bwd": 2}, 0.0),  # a port without it: its counters absent
    ({"fused_bwd_sums_bf16": 1, "fused_bwd": 1, "fused_bwd_bf16s": 2}, 25.0),
    ({"fused_y": 3}, None),  # no K3 launched (a CPU run launches nothing)
    (None, None),  # a port without span_summary
], ids=["all", "parent", "mixed", "no-k3", "no-summary"])
def test_bwd_sums_share_reads_the_launch_counters(root, monkeypatch, launches, share):
    if launches is None:
        monkeypatch.delattr(profiling, "span_summary")
    else:
        summary = {"spans": {}, "launches": launches, "realigned": 0, "collectives": {}}
        monkeypatch.setattr(profiling, "span_summary", lambda: summary)
    cell = harness.Cell(root, "c5-largeD.train")
    assert cell.reader("bwd_sums_share.train")({"units": 3}) == share


@pytest.mark.parametrize("launches,share", [
    # the parent: only the 5 square o_proj maps take the reduce mode; the
    # routed experts' grouped K3 counts as neither
    ({"fused_bwd_sums": 5, "fused_bwd": 35, "fused_grouped_bwd_sums": 12}, 12.5),
    # the stacked form: all but the D = 16384 dense down map
    ({"fused_bwd_sums": 5, "fused_bwd_sums_stacked": 34, "fused_bwd": 1,
      "fused_grouped_bwd_sums": 12}, 97.5),
    ({"fused_bwd_sums_bf16": 3, "fused_bwd_bf16": 1}, 75.0),
    ({"fused_grouped_bwd_sums": 12}, None),  # no K3 launched
    (None, None),  # a port without span_summary
], ids=["parent", "stacked", "bf16", "no-k3", "no-summary"])
def test_bwd_sums_share_lm_train_reads_the_launch_counters(monkeypatch, launches, share):
    if launches is None:
        monkeypatch.delattr(profiling, "span_summary")
    else:
        summary = {"spans": {}, "launches": launches, "realigned": 0, "collectives": {}}
        monkeypatch.setattr(profiling, "span_summary", lambda: summary)
    cell = harness.Cell(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dsv2lite-whvi.train-t1024")
    assert cell.reader("bwd_sums_share.lm_train")({"units": 10}) == share


def test_span_cost_rows_on_the_cpu(root):
    rows = span_cost.run(root, ["c5-largeD.train", "c4-mnist.eval"], 0.05, 1, 2**31 + 3,
                         torch.device("cpu"), warm_s=0.0)
    assert [(r["cell"], r["mode"]) for r in rows] == [
        (c, m) for c in ("c5-largeD.train", "c4-mnist.eval") for m in span_cost.MODES
    ]
    assert all(r["units"] > 0 and r["units_per_s"] > 0 for r in rows)
    by = {(r["cell"], r["mode"]): r for r in rows}
    assert "spans_ms" not in by["c5-largeD.train", "off"]
    for mode in ("recording", "profiler", "issue"):
        step, _ = by["c5-largeD.train", mode]["spans_ms"]["whvi.loop.train_step"]
        assert step > 0 and by["c5-largeD.train", mode]["launches"] == 0  # none on the CPU
        assert by["c4-mnist.eval", mode]["spans_ms"]["whvi.model.predict"][0] > 0
    assert by["c4-mnist.eval", "profiler"]["idle_share"] == 1  # no device events here


# ------------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_backward_spans_on_autograd_device_thread(card):
    """On a card autograd runs the backward on its device thread: the op's
    backward span is recorded there, inside the main thread's
    ``whvi.model.backward`` in time, and the kernel launches count."""
    s1, u, s2, x = (t.to(card).requires_grad_(True) for t in operands(D=256, B=64))
    for _ in range(2):
        loss = whvi_mul(s1, u, s2, x).sum()
        with torch.profiler.profile() as prof:
            with span("whvi.model.backward"):
                loss.backward()
            torch.cuda.synchronize()
    summary = span_summary()
    assert summary["launches"] == {"fused_bwd_sums": 1}  # the reduce mode takes u (S, 1, D)
    assert summary["spans"]["whvi.kernel.fused_bwd_sums"]["count"] == 1
    events = host_events(prof)
    backward, bwd = events["whvi.model.backward"], events["whvi.op.whvi_mul_bwd"]
    assert bwd.thread != backward.thread
    assert backward.time_range.start <= bwd.time_range.start
    assert bwd.time_range.end <= backward.time_range.end
