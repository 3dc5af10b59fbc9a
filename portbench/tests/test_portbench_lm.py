"""The ``lm_train`` cell (``dsv2lite-whvi.train-t1024``) end to end on the
CPU, at a tiny size: its own root with the repository's benchmark files and
the configuration and mix cut to widths the CPU runs in seconds, under the
real names (so the real cell's limits hold it)."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import FOLDERS, PORTBENCH, write

CELL = "dsv2lite-whvi.train-t1024"
TINY = {
    "hidden_size": 64, "num_hidden_layers": 3, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "intermediate_size": 96, "moe_intermediate_size": 48, "n_routed_experts": 4,
    "first_expert": 0, "published": {"n_routed_experts": 8}, "num_experts_per_tok": 2,
    "n_shared_experts": 1, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "norm_topk_prob": False, "num_attention_heads": 4, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32, "q_lora_rank": None,
    "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "vocab_size": 256, "lambda": 1.0, "s_init": "auto",
    "likelihood": {"kind": "categorical"}, "dtype": "float32", "precision": "fp32",
    "train_samples": 2, "eval_samples": 2,
    "optimizer": {"lr0": 0.001, "gamma": 0.0005, "p": 0.3},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("portbench_lm") / "root")
    for sub in FOLDERS:
        shutil.copytree(os.path.join(PORTBENCH, sub), os.path.join(root, "portbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    write(root, "portbench/configs/dsv2lite-whvi.json", TINY)
    with open(os.path.join(PORTBENCH, "traffic", "lm-train-t1024.json")) as f:
        mix = json.load(f)
    mix.update(batch=2, seq_len=16, batches=3, chunk_steps=2, warm_s=0.05, trace_units=2)
    write(root, "portbench/traffic/lm-train-t1024.json", mix)
    shutil.copy(os.path.join(os.path.dirname(PORTBENCH), "BENCHMARK.json"), root)
    return root


def run(root, trace=False, fault=None, seed=2**31 + 11):
    return harness.run_cell(root, CELL, seed, 0.3, trace, torch.device("cpu"),
                            time.perf_counter(), fault)


def test_cell_is_correct_and_reports_its_metrics(root):
    cell = harness.Cell(root, CELL)
    result = run(root)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert set(result["checks"]) == set(cell.limits) - {"route_margin"}
    assert result["checks"]["route_miss"]["value"] == 0
    assert {m["name"] for m in cell.per_layer} == {
        "expert_op_roofline.lm_train", "moe_host_ms.lm_train", "expert_load_max_over_mean.lm_train",
        "device_idle_share.lm_train", "mfu.lm_train"}


def test_traced_run_reads_the_cells_per_layer_metrics(root):
    result = run(root, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    # on the CPU no timed op (and no device event in the idle share)
    assert set(metrics) == {"moe_host_ms.lm_train", "expert_load_max_over_mean.lm_train",
                            "mfu.lm_train", "device_idle_share.lm_train"}
    assert 0 < metrics["mfu.lm_train"]["value"] <= 100
    assert metrics["moe_host_ms.lm_train"]["value"] > 0
    assert metrics["expert_load_max_over_mean.lm_train"]["value"] >= 1


@pytest.mark.parametrize("fault", ["control_bf16", "unchanged_step", "half_batch"])
def test_fault_turns_correct_false(root, fault):
    result = run(root, fault=fault)
    assert not result["correct"], result["checks"]
