"""The port's figure and notebook generators on the CPU:
``bench/make_figures.py`` (the toy fan's and the reliability figure's data
at cut epochs written as JSON, the crossover's refusal to time on the CPU,
the sampler figure from a study JSON) and
``experiments/make_toy_notebook.py`` (its code cells compile and import
neither JAX nor the JAX package)."""

import ast
import json
import math

import pytest
import torch

from whvi_tpu_torch.bench import make_figures
from whvi_tpu_torch.experiments import make_toy_notebook

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_toy_fan_data_is_written_as_json(tmp_path):
    out = make_figures.fig_toy_fan(str(tmp_path), CPU, epochs=(1, 2))
    with open(out["data"]) as f:
        data = json.load(f)
    assert data["epochs"] == [1, 2] and data["device"] == "cpu" and data["gap"] == [0.6, 1.4]
    assert len(data["x"]) == 240 and len(data["train_x"]) == len(data["train_y"]) == 128
    for key in ("with_kl", "no_kl"):
        assert len(data[key]["mean"]) == len(data[key]["sd"]) == 240
        assert all(math.isfinite(v) and v > 0 for v in data[key]["sd"])
        assert data["gap_sd"][key] > 0
    assert out["png"] is None or out["png"].endswith("toy_fan.png")


def test_main_writes_only_the_asked_figure(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(make_figures, "fig_toy_fan",
                        lambda out_dir, device, quick: calls.append((out_dir, device.type, quick)))
    make_figures.main(["--cpu", "--quick", "--only", "toy_fan", "--out-dir", str(tmp_path)])
    assert calls == [(str(tmp_path), "cpu", True)]


def test_reliability_data_names_its_synthetic_source(tmp_path, monkeypatch):
    monkeypatch.delenv("WHVI_DATA_DIR", raising=False)
    out = make_figures.fig_reliability(str(tmp_path), CPU, quick=True, epochs=(1, 1))
    with open(out["data"]) as f:
        data = json.load(f)
    assert data["source"] in ("synthetic", "yacht") and data["n_splits"] == 4
    assert data["reliability_raw"] and data["reliability_cal"]
    assert math.isfinite(data["temperature_mean"])


def test_crossover_refuses_to_time_on_the_cpu_and_rescue_needs_a_study(tmp_path):
    crossover = make_figures.fig_crossover(str(tmp_path), CPU)
    assert crossover["data"] is None and "card" in crossover["reason"]
    rescue = make_figures.fig_sampler_rescue(str(tmp_path), None)
    assert rescue["data"] is None and "--study" in rescue["reason"]


def test_sampler_rescue_reads_a_port_study(tmp_path):
    row = {"epochs": 12, "identity_mass": {"ess_min_overall": 2.5},
           "adapted_mass": {"ess_min_overall": 4.0},
           "tempering": {"n_rungs": 16, "ess_scaling": {
               "draws_quarter": 400, "ess_quarter": 50.0, "draws_full": 1600, "ess_full": 210.0}}}
    study = tmp_path / "study.json"
    study.write_text(json.dumps({"mixed_lambda": {"epochs_10": {"epochs": 10},
                                                  "epochs_12": row, "verdict": "x"}}))
    out = make_figures.fig_sampler_rescue(str(tmp_path), str(study))
    with open(out["data"]) as f:
        data = json.load(f)
    assert data["epochs"] == 12
    assert [ess for _, ess in data["ess"]] == [2.5, 4.0, 50.0, 210.0]


def _imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_notebook_cells_compile_and_import_only_the_port(device):
    code = [src for kind, src in make_toy_notebook.cells(device) if kind == "code"]
    assert code and all(kind in ("code", "markdown") for kind, _ in make_toy_notebook.cells())
    for i, src in enumerate(code):
        compile(src, f"cell {i}", "exec")
    imports = set().union(*(_imports(src) for src in code))
    assert not any(n == "jax" or n.startswith(("jax.", "whvi_tpu.")) or n == "whvi_tpu"
                   for n in imports), imports
    assert {"whvi_tpu_torch.models", "whvi_tpu_torch.train", "torch"} <= imports
    assert f"DEVICE = torch.device({device!r})" in code[0]


def test_notebook_runs_on_the_card_unless_asked_for_the_cpu():
    code = [src for kind, src in make_toy_notebook.cells() if kind == "code"]
    assert "DEVICE = torch.device('cuda')" in code[0]


def test_notebook_is_written_where_nbformat_imports(tmp_path):
    nbformat = pytest.importorskip("nbformat")
    path = make_toy_notebook.main(["--out", str(tmp_path / "toy.ipynb")])
    nb = nbformat.read(path, as_version=4)
    nbformat.validate(nb)
    assert len(nb.cells) == len(make_toy_notebook.cells())
    assert make_toy_notebook.OUT.endswith("docs/toy_example_torch.ipynb")
