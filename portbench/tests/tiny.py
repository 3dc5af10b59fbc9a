"""A benchmark root at tiny widths for the CPU tests: the repository's
traffic mixes, loops, likelihoods, metric readers and limits, with
configurations cut to widths the CPU runs in a moment, under the names of
the real cells (so the real cells' limits hold them)."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
FOLDERS = ("traffic", "loops", "likelihoods", "reference/likelihoods", "metrics", "limits")

TINY_CONFIGS = {
    "c5-largeD": {
        "layers": [
            {"n_in": 16, "n_out": 16, "lambda": 3.0, "s_init": "auto"}, "relu",
            {"n_in": 16, "n_out": 16, "lambda": 3.0, "s_init": "auto"}, "relu",
            {"n_in": 16, "n_out": 1, "lambda": 1e-05, "s_init": "auto"},
        ],
        "likelihood": {"kind": "gaussian", "sigma0": 1.0},
        "dtype": "float32", "precision": "fp32",
        "train_samples": 4, "eval_samples": 4, "batch": 8, "n": 8, "eval_rows": 8,
        "optimizer": {"lr0": 0.001, "gamma": 0.0005, "p": 0.3},
        "data": {"kind": "normal", "n_in": 16, "n_out": 1},
    },
    "c4-mnist": {
        "layers": [
            {"n_in": 12, "n_out": 16, "lambda": 3.0, "s_init": "auto"}, "relu",
            {"n_in": 16, "n_out": 16, "lambda": 3.0, "s_init": "auto"}, "relu",
            {"n_in": 16, "n_out": 3, "lambda": 1.0, "s_init": "auto"},
        ],
        "likelihood": {"kind": "categorical"},
        "dtype": "float32", "precision": "fp32",
        "train_samples": 1, "eval_samples": 4, "batch": 8, "n": 64, "eval_rows": 32,
        "optimizer": {"lr0": 0.001, "gamma": 0.0005, "p": 0.3},
        "data": {"kind": "prototypes", "n_in": 12, "classes": 3, "noise": 2.0},
    },
}


def make_root(path: str, extra_workloads=(), warm_s: float = 0.05) -> str:
    """A root under ``path`` with the repository's ``BENCHMARK.json`` (its
    workloads and ``extra_workloads``), the files of :data:`FOLDERS`, and the
    tiny configurations; returns it."""
    root = os.path.join(path, "root")
    for sub in FOLDERS:
        shutil.copytree(os.path.join(PORTBENCH, sub), os.path.join(root, "portbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(root, "portbench", "configs"))
    for name, cfg in TINY_CONFIGS.items():
        write(root, f"portbench/configs/{name}.json", cfg)
    for name in os.listdir(os.path.join(root, "portbench", "traffic")):
        mix = os.path.join(root, "portbench", "traffic", name)
        with open(mix) as f:
            traffic = json.load(f)
        traffic.update(warm_s=warm_s, trace_units=3)
        if "chunk_rows" in traffic:  # a few chunks of the tiny rows, the last one short
            traffic["chunk_rows"] = 12
        write(root, f"portbench/traffic/{name}", traffic)
    with open(os.path.join(os.path.dirname(PORTBENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] += list(extra_workloads)
    write(root, "BENCHMARK.json", bench)
    return root


def write(root: str, rel: str, obj) -> None:
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)
