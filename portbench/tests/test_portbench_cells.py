"""The harness end to end on the CPU at tiny widths: the result's line, the
check against the reference, the faults it must catch, and cells made of
new files alone."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, run as runner
from portbench.tests.tiny import PORTBENCH, make_root, write

REPO = os.path.dirname(PORTBENCH)
CELLS = ("c5-largeD.train", "c4-mnist.eval", "c5-largeD.eval")
TRAIN_FAULTS = ("control_bf16", "unchanged_step", "half_batch")
EVAL_FAULTS = ("control_bf16", "half_samples", "altered_answer")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("portbench")))


def run(root, name, trace=False, fault=None, seed=2**31 + 7):
    return harness.run_cell(
        root, name, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(), fault
    )


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_and_reports_its_metrics(root, name):
    cell = harness.Cell(root, name)
    result = run(root, name)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(keys[5:-1]) <= {"worst_leaf", "setup_phases"}
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["checks"]) == set(cell.limits) - {"class_margin"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_per_layer_metrics(root, name):
    result = run(root, name, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    # on the CPU only what the profile's host side and the counts give
    mfu = [m for m in metrics if m.startswith("mfu.")]
    assert len(mfu) == 1 and 0 < metrics[mfu[0]]["value"] <= 100
    assert not [m for m in metrics if m.startswith("whvi_op_roofline.")]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize(
    "name,fault",
    [("c5-largeD.train", f) for f in TRAIN_FAULTS]
    + [(c, f) for c in ("c4-mnist.eval", "c5-largeD.eval") for f in EVAL_FAULTS]
    + [("c5-largeD.eval", "no_spread")],
)
def test_fault_turns_correct_false(root, name, fault):
    result = run(root, name, fault=fault)
    assert not result["correct"], result["checks"]
    assert run(root, name)["correct"]  # the fault is gone after its run


def test_new_config_traffic_and_metric_from_new_files(tmp_path):
    extra = {"name": "tiny-wide.eval-twice", "config": "tiny-wide", "traffic": "eval-twice",
             "chips": 1, "why": "a cell made of new files alone"}
    root = make_root(str(tmp_path), [extra])
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-wide", "source": "tests", "why": "new",
                             "file": "portbench/configs/tiny-wide.json", "reduced": []})
    bench["per_layer"].append({"name": "calls_counted.eval", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "Loop",
                               "moves": "predict_rows_per_s", "workloads": [extra["name"]]})
    for metric in bench["end_to_end"]:  # the rate of the mix it copies, and the tail
        if metric["name"] in ("predict_rows_per_s", "eval_call_ms_p95"):
            metric["workloads"].append(extra["name"])
    write(root, "BENCHMARK.json", bench)
    cfg = dict(json.load(open(os.path.join(root, "portbench/configs/c5-largeD.json"))))
    cfg["layers"] = [{"n_in": 32, "n_out": 32, "lambda": 3.0, "s_init": "auto"}, "relu",
                     {"n_in": 32, "n_out": 1, "lambda": 1e-05, "s_init": "auto"}]
    cfg["data"] = {"kind": "normal", "n_in": 32, "n_out": 1}
    write(root, "portbench/configs/tiny-wide.json", cfg)
    traffic = json.load(open(os.path.join(root, "portbench/traffic/eval.json")))
    write(root, "portbench/traffic/eval-twice.json", {**traffic, "checked_calls": 2})
    write(root, "portbench/limits/tiny-wide.eval-twice.json",
          json.load(open(os.path.join(root, "portbench/limits/c5-largeD.eval.json"))))
    write(root, "portbench/metrics/calls_counted.eval.py",
          "def read(ctx):\n    return ctx['units']\n")
    result = run(root, extra["name"], trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_counted.eval"] == {"value": 3, "unit": "calls"}
    assert set(result["metrics"]) == {"calls_counted.eval"}  # the others name their cells
    plain = run(root, extra["name"])
    assert "predict_rows_per_s" in plain["metrics"] and "eval_call_ms_p95" in plain["metrics"]


def test_new_kind_of_loop_and_bf16_config_from_new_files(tmp_path):
    """A mix of a kind no file had, with its loop, over a configuration
    stored in bfloat16: new files and entries alone."""
    extra = {"name": "tiny-bf16.twice", "config": "tiny-bf16", "traffic": "twice",
             "chips": 1, "why": "a new kind of loop over a bfloat16 configuration"}
    root = make_root(str(tmp_path), [extra])
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-bf16", "source": "tests", "why": "new",
                             "file": "portbench/configs/tiny-bf16.json", "reduced": []})
    for metric in bench["end_to_end"]:  # the rate of the mix it copies, and the tail
        if metric["name"] in ("predict_rows_per_s", "eval_call_ms_p95"):
            metric["workloads"].append(extra["name"])
    write(root, "BENCHMARK.json", bench)
    cfg = json.load(open(os.path.join(root, "portbench/configs/c5-largeD.json")))
    write(root, "portbench/configs/tiny-bf16.json", {**cfg, "dtype": "bfloat16"})
    traffic = json.load(open(os.path.join(root, "portbench/traffic/eval.json")))
    write(root, "portbench/traffic/twice.json", {**traffic, "kind": "twice"})
    # the new kind: the eval loop over twice the rows, in two chunks
    write(root, "portbench/loops/twice.py", (
        "from portbench import harness\n"
        "def run(cell, seed, seconds, trace, device, mesh, t_start):\n"
        "    cell.config = {**cell.config, 'eval_rows': 2 * cell.config['eval_rows']}\n"
        "    cell.traffic = {**cell.traffic, 'chunk_rows': cell.config['eval_rows'] // 2}\n"
        "    return harness.plugin(cell.root, 'loops', 'eval').run(\n"
        "        cell, seed, seconds, trace, device, mesh, t_start)\n"
    ))
    # bfloat16 storage against the float32 reference: rounding's own limits
    write(root, f"portbench/limits/{extra['name']}.json", {"mean_gap": 0.5, "spread_gap": 0.5})
    result = run(root, extra["name"])
    assert result["correct"], result["checks"]
    assert 0 < result["checks"]["mean_gap"]["value"]  # bfloat16 does not round like float32
    assert set(result["metrics"]) == {"predict_rows_per_s", "eval_call_ms_p95", "peak_mem_gib",
                                      "setup_s"}
    assert harness.Cell(root, extra["name"]).loop.__file__.endswith("twice.py")
    assert harness.plugin(root, "loops", "twice") is harness.Cell(root, extra["name"]).loop


def test_run_refuses_without_a_card_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "c4-mnist.eval", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and ``portbench/`` the run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, torch; torch.cuda.is_available = lambda: True; "
        "torch.cuda.device_count = lambda: 4; "
        "from portbench import run; sys.exit(run.main(['--workload', 'c4-mnist.eval', "
        "'--seed', '1', '--seconds', '1']))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "whvi_tpu_torch" in proc.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    result = harness.run_cell(REPO, name, 11, 1.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]


MESH = {"name": "c5-largeD.train-mesh1x4", "config": "c5-largeD", "traffic": "train-mesh1x4",
        "chips": 4, "why": "the sample mesh"}


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_mesh_cell_over_four_gloo_ranks(mesh_root, fault):
    """The mesh cell's ranks on the CPU (gloo): correct, and the gradient
    exchange left out turns it false."""
    result, loaded = runner.on_mesh(harness.mesh_rank, 4, "gloo", "cpu", mesh_root, MESH["name"],
                                    2**31 + 9, 0.2, False, time.perf_counter(), fault)
    assert loaded == []
    assert result["correct"] is (fault is None), result["checks"]


def planting_rank(device, *args):
    """:func:`portbench.harness.mesh_rank` on a rank that loads a module
    named as part of the JAX stack (rank 2)."""
    import torch.distributed as dist

    if dist.get_rank() == 2:
        sys.modules["jaxlib.x"] = sys.modules[__name__]
    return harness.mesh_rank(device, *args)


def test_mesh_run_refused_where_a_rank_loaded_the_jax_stack(mesh_root, capsys):
    result, loaded = runner.on_mesh(planting_rank, 4, "gloo", "cpu", mesh_root, MESH["name"],
                                    2**31 + 11, 0.2, False, time.perf_counter(), None)
    assert loaded == ["jaxlib"] and "jaxlib" not in harness.forbidden_modules()
    assert result["correct"]  # rank 0 alone would have printed it
    assert runner.report(result, 0.0, loaded) == 4
    out, err = capsys.readouterr()
    assert out == "" and "jaxlib" in err
