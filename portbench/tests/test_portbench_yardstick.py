"""The yardstick on the CPU: what the benchmark imports and reads, the
counts and statistics, and the reference against the port's CPU path."""

from __future__ import annotations

import ast
import math
import os
import subprocess
import sys

import pytest
import torch

from portbench import counts, harness, program
from portbench.reference import fwht, kl_total, layer_specs, reference_grads
from portbench.reference.nets import forward
from portbench.tests.tiny import PORTBENCH, TINY_CONFIGS

REPO = os.path.dirname(PORTBENCH)

JAX_STACK = {"jax", "jaxlib", "flax", "whvi_tpu"}


def _sources():
    for base, _, files in os.walk(PORTBENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def _imports(path: str) -> set:
    """The top-level names of every module a source imports (the part of a
    dotted name before its first dot, compared whole)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names.add("<dynamic>")
    return names


def test_nothing_imports_the_jax_stack_and_the_reference_not_the_port():
    seen = {}
    for path in _sources():
        seen[path] = _imports(path)
        assert not seen[path] & JAX_STACK, path
        assert "<dynamic>" not in seen[path], path
    reference = [p for p in seen if os.sep + "reference" + os.sep in p]
    assert len(reference) == 7
    for path in reference:
        assert seen[path] <= {"__future__", "math", "torch", "portbench"}, path
    # the port's name starts with the JAX package's: whole names only
    assert "whvi_tpu_torch" in seen[os.path.join(PORTBENCH, "program.py")]


def test_nothing_reads_the_jax_benchmarks():
    banned = ("benchmarks" + "/", "bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_")
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert not any(b in text for b in banned), path


def test_a_run_loads_nothing_of_the_jax_stack():
    code = (
        "import time, tempfile, torch\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import make_root\n"
        "root = make_root(tempfile.mkdtemp())\n"
        "for name in ('c5-largeD.train', 'c4-mnist.eval'):\n"
        "    r = harness.run_cell(root, name, 5, 0.1, True, torch.device('cpu'), time.perf_counter())\n"
        "    assert r['correct']\n"
        "print(harness.forbidden_modules())\n"
    )
    repo = os.path.dirname(PORTBENCH)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "whvi_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_flops_by_hand_at_D_8():
    # a product at D = 8: two transforms of 8 * 3 adds, three diagonals of 8
    assert counts.whvi_product_flops(8) == 2 * 8 * 3 + 3 * 8 == 72
    assert counts.column_flops(8) == 16
    specs = layer_specs({"layers": [
        {"n_in": 8, "n_out": 8, "lambda": 1.0}, "relu",
        {"n_in": 5, "n_out": 16, "lambda": 1.0},  # stacked: 2 blocks of D = 8
        "relu", {"n_in": 16, "n_out": 1, "lambda": 1.0},  # a column of 16
    ]})
    assert [s["kind"] for s in specs] == ["square", "relu", "stacked", "relu", "column"]
    # 2 rows x 3 samples: 72 + 2 * 72 + 2 * 16 a row-sample
    assert counts.forward_flops(specs, 2, 3) == 6 * (72 + 144 + 32) == 1488
    assert counts.train_step_flops(specs, 2, 3) == 3 * 1488


def test_bytes_by_hand_at_D_8():
    # x (6, 8), u (3, 8), s1 and s2 (8,), float32
    fwd = 4 * (6 * 8 + 3 * 8 + 2 * 8 + 6 * 8)  # s1, u, s2, x in; y out
    assert counts.whvi_mul_bytes(6, 8, 3, 4, train=False) == fwd == 544
    # and backward: g in; dx, du, ds1, ds2 out
    both = fwd + 4 * (6 * 8 + 6 * 8 + 3 * 8 + 2 * 8)
    assert counts.whvi_mul_bytes(6, 8, 3, 4, train=True) == both == 1088


def test_rate_and_p95_over_every_call():
    assert counts.rate(700, 256 * 64, 10.0) == 700 * 256 * 64 / 10.0
    calls = [1.0] * 95 + [50.0] * 5
    assert counts.p95(calls) == 1.0  # 95 of 100 at or below
    assert counts.p95(calls + [50.0]) == 50.0  # one stall more reaches the tail
    assert counts.p95([3.0]) == 3.0
    assert counts.p95(list(range(1, 21))) == 19
    with pytest.raises(ValueError):
        counts.p95([])


def test_fwht_is_the_sylvester_matrix():
    D = 16
    i = torch.arange(D)
    bits = torch.bitwise_and(i[:, None], i[None, :])
    H = (-1.0) ** torch.tensor([[bin(int(v)).count("1") for v in row] for row in bits],
                               dtype=torch.float64)
    x = torch.randn(3, D, dtype=torch.float64)
    assert torch.allclose(fwht(x), x @ H)


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_reference_matches_the_port_on_the_cpu(name):
    cfg = TINY_CONFIGS[name]
    specs = layer_specs(cfg)
    kind = cfg["likelihood"]["kind"]
    lik = harness.plugin(REPO, "likelihoods", kind)
    ref_lik = harness.plugin(REPO, "reference/likelihoods", kind)
    gen = torch.Generator().manual_seed(3)
    state = {"g_mu_std": 1.0, "g_rho": [-2.0, 0.0]}  # a state with spread, as the eval cells
    params = harness.make_params(specs, gen, "cpu", torch.float32, state)
    params.update(lik.params(cfg["likelihood"], "cpu", torch.float32))
    net = program.build_net(cfg, lik, "cpu")
    program.load_params(net, params)
    S, rows = 5, 6
    eps = harness.noise_views(specs, torch.randn(S, harness.noise_width(specs), generator=gen))
    x = torch.randn(rows, cfg["layers"][0]["n_in"], generator=gen)
    ref = forward(specs, params, x, eps)
    got = net.predict(x, S, eps=eps)
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert math.isclose(float(net.kl()), float(kl_total(specs, params)), rel_tol=1e-6)
    y = (torch.randn(rows, 1, generator=gen) if cfg["likelihood"]["kind"] == "gaussian"
         else torch.randint(0, 3, (rows,), generator=gen).float())
    loss, aux = net.loss(x, y, 40, n_samples=S, eps=eps)
    loss.backward()
    r_loss, r_mnll, _, grads = reference_grads(ref_lik, cfg, specs, params, x, y, eps, 40, block=2)
    assert math.isclose(float(loss), r_loss, rel_tol=1e-5)
    assert math.isclose(float(aux["mnll"]), r_mnll, rel_tol=1e-5)
    for key, p in program.param_map(net).items():
        assert torch.allclose(p.grad, grads[key], rtol=1e-4, atol=1e-6), key
    with torch.no_grad():
        dev, host = lik.answer(net.likelihood.predict(got))
    gaps = lik.gaps(dev, host, ref_lik.predict(cfg["likelihood"], params, ref),
                    {"class_margin": 0.01})
    assert gaps and max(gaps.values()) < 1e-4, gaps
