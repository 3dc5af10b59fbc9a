"""The trainer and the UCI protocol on the port's meshes, in a 4-rank gloo
world on the CPU (``torch_parallel_worlds.train_world``).

- ``Trainer(mesh=)`` at (1, 4), (2, 2) and (4, 1): a two-phase fit of 37
  rows at batch 10 (rounded up to the data-shard multiple, 12 at four
  shards, with weight-0 pads) and the evaluation of 11 rows (padded to the
  data multiple), against the one-device trainer at the rounded batch on
  the same seed: parameters and metrics within 1e-5.
- ``Trainer(replicas=8, split_mesh=)``: two replicas a rank, against the
  unsharded stack: parameters and metrics within 1e-6; checkpoints written
  once, and a resumed stack equal to the finished one.
- ``evaluate_bayesian_regression(split_mesh=)`` (calibrated) and
  ``evaluate_config_grid(split_mesh=)`` against their unsharded stacks;
  ``evaluate_bayesian_regression(mesh=)``, the sequential protocol on the
  (2, 2) mesh, against one device's.
- The refusals the JAX package makes (``whvi_tpu/train/trainer.py:143-150``,
  :456-460, ``whvi_tpu/evaluation.py:359-364``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parallel_worlds as w
from whvi_tpu_torch.evaluation import evaluate_bayesian_regression, evaluate_config_grid
from whvi_tpu_torch.models import WHVILinear
from whvi_tpu_torch.parallel.distributed import spawn
from whvi_tpu_torch.train import Trainer

torch.set_num_threads(1)

FIT_TOL = 1e-5
STACK_TOL = 1e-6


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn(w.train_world, w.WORLD, "gloo", "cpu", str(tmp_path_factory.mktemp("mesh")))


def _fit_net():
    net = w.build_net("shared")
    net.layers[-1] = WHVILinear(16, 1, 1e-5)
    return net


@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_mesh_trainer_fit_and_eval_match_one_device(world, layout):
    got = world[0][("fit", layout)]
    d = layout[0]
    rounded = -(-w.FIT_BATCH // d) * d  # the batch the mesh trains at
    trainer = Trainer(_fit_net(), w.fit_config(rounded), "cpu")
    state = trainer.init(w.SEED)
    state, logs = trainer.fit(state, *w.fit_data())
    metrics = trainer.evaluate(*w.fit_data(11, seed=22), torch.Generator().manual_seed(7))
    assert got["step"] == state.step == 3 * -(-w.FIT_ROWS // rounded)
    assert abs(got["loss"] - logs[-1]["loss"]) <= FIT_TOL * abs(logs[-1]["loss"])
    assert rel_err(got["params"], w.flat_params(trainer.net)) <= FIT_TOL
    assert sorted(got["metrics"]) == sorted(metrics)
    for k, v in metrics.items():
        assert abs(got["metrics"][k] - v) <= FIT_TOL * max(abs(v), 1.0), k
    assert all(np.array_equal(r[("fit", layout)]["params"], got["params"]) for r in world)


def test_split_mesh_stack_matches_unsharded_stack(world):
    got = world[0]["stack"]
    Xs, ys = w.stack_data(8)
    trainer = Trainer(_fit_net(), w.fit_config(8), "cpu", replicas=8)
    state = trainer.init([100 + r for r in range(8)])
    state, logs = trainer.fit(state, Xs, ys)
    metrics = trainer.metrics(ys[:, :6], trainer.predict(Xs[:, :6], torch.Generator().manual_seed(8)))
    for g, p in zip(got["params"], trainer.net.parameters()):
        assert rel_err(g, p.detach()) <= STACK_TOL
    assert abs(got["loss"] - logs[-1]["loss"]) <= STACK_TOL * abs(logs[-1]["loss"])
    for k, v in metrics.items():
        assert got["metrics"][k].shape == (8,)
        assert rel_err(got["metrics"][k], v) <= STACK_TOL, k


def test_split_mesh_checkpoints_and_resume(world):
    got = world[0]["stack"]
    assert got["files"] == sorted(f"ckpt-{e}.npz{x}" for e in (2, 3) for x in ("", ".meta.json"))
    assert got["resumed_step"] == 3 * 3
    for a, b in zip(got["resumed"], got["params"]):
        assert torch.equal(a, b)


def _close(got: dict, want: dict, keys, tol):
    for k in keys:
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1.0), k


def test_protocol_on_split_mesh_matches_unsharded(world):
    got = world[0]["protocol"]
    want = evaluate_bayesian_regression(*w.protocol_data(), w.PROTOCOL, device="cpu")
    assert got["vmapped_splits"] and len(got["splits"]) == w.PROTOCOL.n_splits
    keys = ("rmse_mean", "rmse_sd", "mnll_mean", "pred_mnll_per_point_mean",
            "coverage95_mean", "temperature_mean", "coverage95_cal_mean")
    _close(got, want, keys, STACK_TOL)
    for g, s in zip(got["splits"], want["splits"]):
        _close(g, s, ("rmse", "mnll", "temperature"), STACK_TOL)


def test_protocol_on_mesh_matches_one_device(world):
    got = world[0]["protocol_mesh"]
    config = w.MESH_PROTOCOL
    want = evaluate_bayesian_regression(
        *w.protocol_data(), dataclasses.replace(config, vmap_splits=False), device="cpu"
    )
    assert "vmapped_splits" not in got and len(got["splits"]) == config.n_splits
    _close(got, want, ("rmse_mean", "mnll_mean", "pred_mnll_per_point_mean"), FIT_TOL)


def test_grid_on_split_mesh_matches_unsharded(world):
    got = world[0]["grid"]
    want = evaluate_config_grid(*w.protocol_data(), w.GRID_BASE, w.GRID, device="cpu")
    assert got["stack_size"] == want["stack_size"] == 8
    for g, c in zip(got["configs"], want["configs"]):
        _close(g, c, ("rmse_mean", "mnll_mean", "pred_mnll_per_point_mean"), STACK_TOL)
        assert g["config_overrides"] == c["config_overrides"]


@pytest.mark.parametrize(
    "what, text",
    [
        ("mesh_with_replicas", "mutually exclusive"),
        ("split_mesh_without_replicas", "split_mesh requires replicas"),
        ("hyper_with_mesh", "not supported with the mesh loss"),
        ("split_mesh_sequential", "split_mesh requires the vmapped-splits protocol"),
        ("replicas_not_split", "6 does not split over 4 shards"),
        ("eval_samples", "n_samples=6 not divisible by sample shards 4"),
    ],
)
def test_refusals(world, what, text):
    message = world[0]["refusals"][what]
    assert message is not None and text in message, message
