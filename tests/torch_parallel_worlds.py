"""The mesh tests' worlds: what every rank of a 4-rank gloo world on the
CPU runs for ``tests/test_torch_parallel*.py``, and the nets and data the
tests build on both sides.

Spawned ranks import this module by name, so it imports only numpy,
torch and the port: a test module imports JAX under ``tests/conftest.py``'s
8-device setting, which no rank should load. Each world returns a dict of
results keyed by case (rank 0's, plus what every rank must agree on); the
tests compute the one-device references in their own process and assert
case by case.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from whvi_tpu_torch.experiments import run_scaling
from whvi_tpu_torch.evaluation import ProtocolConfig, evaluate_bayesian_regression, evaluate_config_grid
from whvi_tpu_torch.mcmc import HMCConfig, NUTSConfig, PTConfig, hmc_sample_chains, make_whvi_g_log_posterior, nuts_sample_chains, pt_sample_chains
from whvi_tpu_torch.models import (
    HeteroscedasticGaussianLikelihood,
    Parallel,
    WHVILinear,
    WHVINetwork,
    WHVIRegression,
    relu,
)
from whvi_tpu_torch.ops import get_whvi_mul_precision, set_whvi_mul_precision
from whvi_tpu_torch.parallel import make_mesh, make_sharded_predict, make_sharded_train_step, sharded_loss_fn
from whvi_tpu_torch.parallel.mesh import COLLECTIVES, make_split_mesh, reset_collectives
from whvi_tpu_torch.train import TrainConfig, Trainer

WORLD = 4
LAYOUTS = [(1, 4), (2, 2), (4, 1)]  # (data, sample)
S, B, N = 8, 8, 100  # MC samples, batch rows, dataset size in the MNLL
SEED = 3
KL_SCALE = 0.5
# "shared" and "per_example": 13 -> 16 (stacked) -> 16 -> 2 (stacked);
# "weighted": per-example noise and three weight-0 rows; "column": a
# per-row column LRT head 16 -> 1; "bf16": shared noise under the bf16
# operand precision (its 16 x 16 layer takes the bf16 kernel's rounding);
# "bf16s": shared noise on bf16 storage (every parameter, input and noise
# bfloat16) in the fp32 precision
CASES = ("shared", "per_example", "weighted", "column", "bf16", "bf16s")


def dtype(case: str) -> torch.dtype:
    return torch.bfloat16 if case == "bf16s" else torch.float32


def build_net(case: str, seed: int = SEED) -> WHVINetwork:
    """The case's net, random weights from ``seed``, away from the init's
    zero means."""
    pe = case in ("per_example", "weighted", "column")
    kw = dict(per_example_noise=pe, column_lrt=pe, dtype=dtype(case))
    head = WHVILinear(16, 1, 1e-5, **kw) if case == "column" else WHVILinear(16, 2, 1e-5, **kw)
    net = WHVIRegression(
        [WHVILinear(13, 16, 3.0, **kw), relu, WHVILinear(16, 16, 3.0, **kw), relu, head],
        train_samples=S, eval_samples=S, dtype=dtype(case),
    )
    gen = torch.Generator().manual_seed(seed)
    net.reset_parameters(gen)
    with torch.no_grad():
        for layer in net.layers[::2]:
            layer.matrix.g_mu.normal_(0.0, 0.5, generator=gen)
    return net


def batch(case: str):
    """``x (B, 13)``, ``y (B, n_out)`` and the weights (None, or three
    padding rows of weight 0)."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(B, 13).astype(np.float32)).to(dtype(case))
    y = torch.from_numpy(rng.randn(B, 1 if case == "column" else 2).astype(np.float32)).to(dtype(case))
    w = (torch.arange(B) < B - 3).float() if case == "weighted" else None
    return x, y, w


def given_eps(net) -> list:
    """Global per-layer noise from numpy (the JAX comparison's): the shapes
    ``net.draw_noise`` gives, in the net's storage dtype."""
    rng = np.random.RandomState(12)
    dt = next(net.parameters()).dtype
    return [
        None if e is None else torch.from_numpy(rng.randn(*e.shape).astype(np.float32)).to(dt)
        for e in net.draw_noise((S, B))
    ]


def split_head_net(seed: int = SEED) -> WHVINetwork:
    """A heteroscedastic split head, ``Parallel([mean, noise])``, for the
    noise freeze."""
    net = WHVINetwork(
        [WHVILinear(13, 16, 3.0), relu,
         Parallel([WHVILinear(16, 1, 1e-5), WHVILinear(16, 1, 1.0)])],
        HeteroscedasticGaussianLikelihood(sigma0=0.3), train_samples=S, eval_samples=S,
    )
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net


def flat_params(net) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def raises(fn) -> str | None:
    """The message of the ``ValueError`` that ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _equal_on_every_rank(mesh, t: torch.Tensor) -> bool:
    """Whether ``t`` is bitwise the same on every rank: each rank's copy
    against the gathered copy of rank 0."""
    copies = mesh.gather(t[None], {0: mesh.axis_names})
    return all(torch.equal(c, copies[0]) for c in copies)


# ----------------------------------------------------------- loss, step, predict


def _reduced_dtypes(mesh, fn):
    """``fn()`` and the dtypes of the tensors it all-reduced over ``mesh``."""
    seen, plain = [], mesh.all_reduce

    def all_reduce(t, *args, **kwargs):
        seen.append(str(t.dtype))
        return plain(t, *args, **kwargs)

    mesh.all_reduce = all_reduce
    try:
        return fn(), seen
    finally:
        del mesh.all_reduce


def loss_world(device) -> dict:
    out = {}
    for layout in LAYOUTS:
        mesh = make_mesh(*layout)
        for case in CASES:
            previous = get_whvi_mul_precision()
            set_whvi_mul_precision("bf16" if case == "bf16" else "fp32")
            try:
                net = build_net(case)
                x, y, w = batch(case)
                reset_collectives()
                (loss, aux), reduced = _reduced_dtypes(mesh, lambda: sharded_loss_fn(net, mesh, S)(
                    x, y, N, torch.Generator().manual_seed(5), kl_scale=KL_SCALE, weights=w
                ))
                collectives = COLLECTIVES["all_reduce"]
                grads = [p.grad.clone() for p in net.parameters()]
                pred = make_sharded_predict(net, mesh, S)
                y_hat = pred.gather(pred(x, torch.Generator().manual_seed(6)))
                eps = given_eps(net)
                net.zero_grad()
                loss_eps, _ = sharded_loss_fn(net, mesh, S)(x, y, N, kl_scale=KL_SCALE, weights=w, eps=eps)
                y_hat_eps = pred.gather(pred(x, eps=eps))
            finally:
                set_whvi_mul_precision(previous)
            out[(layout, case)] = dict(
                loss=float(loss), mnll=float(aux["mnll"]), grads=grads, y_hat=y_hat,
                loss_eps=float(loss_eps), y_hat_eps=y_hat_eps, collectives=collectives,
                reduced=reduced,
                same_loss=_equal_on_every_rank(mesh, loss.reshape(1)),
            )
        # k steps at once against k steps, the phase flag, the parameters
        x, y, _ = batch("per_example")
        step = make_sharded_train_step(build_net("per_example"), mesh, TrainConfig())
        state = step.init(SEED)
        rho0 = step.trainer.net.likelihood.rho.detach().clone()
        step(state, x, y, N, False)
        frozen = torch.equal(step.trainer.net.likelihood.rho.detach(), rho0)
        metrics = step.scan(state, x, y, N, True, 3)
        one = make_sharded_train_step(build_net("per_example"), mesh, TrainConfig())
        state1 = one.init(SEED)
        for k in range(4):
            m1 = one(state1, x, y, N, k > 0)
        params = flat_params(step.trainer.net)
        out[(layout, "steps")] = dict(
            scan_loss=metrics["loss"], step_loss=float(m1["loss"]), params=params,
            params_k_steps=flat_params(one.trainer.net), rho_frozen=frozen,
            same_params=_equal_on_every_rank(mesh, params),
        )
        # the noise freeze: the noise branch stays at its init for 2 steps
        xs, ys = x, y[:, :1]
        step = make_sharded_train_step(split_head_net(), mesh, TrainConfig(noise_freeze_steps=2))
        state = step.init(SEED)
        branch = step.trainer.net.layers[-1].branches[1].matrix.g_mu
        noise = [branch.detach().clone()]
        for _ in range(3):
            step(state, xs, ys, N, True)
            noise.append(branch.detach().clone())
        out[(layout, "freeze")] = dict(noise=noise, params=flat_params(step.trainer.net))
    mesh = make_mesh(2, 2)
    try:  # the entry point's rows, train and predict; its refusal of a time
        # (taken on every rank alike) fails its own test, not the world
        out["run_scaling"] = [
            row for predict in (False, True)
            for row in run_scaling.run(64, device=device, batch=8, samples=4, steps=4,
                                       predict=predict, mesh=mesh)
        ]
    except RuntimeError as e:
        if "host timing noise" not in str(e):
            raise
        out["run_scaling"] = str(e)
    out["refusals"] = {
        "n_samples": raises(lambda: sharded_loss_fn(build_net("shared"), make_mesh(1, 4), 6)),
        "mesh_size": raises(lambda: make_mesh(4, 2)),
        "freeze_without_split_head": raises(
            lambda: make_sharded_train_step(build_net("shared"), mesh, TrainConfig(noise_freeze_steps=2))
        ),
    }
    return out


# ----------------------------------------------------------- trainer, protocol

FIT_ROWS, FIT_BATCH = 37, 10  # rows a data shard count of 4 does not divide


def fit_data(n: int = FIT_ROWS, d: int = 13, seed: int = 21):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, :1] * 0.7 + 0.3 * rng.randn(n, 1)).astype(np.float32)
    return X, y


def fit_config(batch_size: int = FIT_BATCH) -> TrainConfig:
    return TrainConfig(batch_size=batch_size, epochs1=1, epochs2=2, epochs_per_call=1,
                       kl_warmup_steps=3, checkpoint_every=1)


def stack_data(R: int, n: int = 24):
    rng = np.random.RandomState(31)
    X = rng.randn(R, n, 13).astype(np.float32)
    y = (X[..., :1] + 0.3 * rng.randn(R, n, 1)).astype(np.float32)
    return X, y


def protocol_data(n: int = 60, seed: int = 41):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    y = (X @ rng.randn(5) + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y


PROTOCOL = ProtocolConfig(
    n_splits=8, hidden=(16, 16), batch_size=16, epochs1=1, epochs2=2, epochs_per_call=1,
    checkpoint_every=1, train_samples=4, eval_samples=8, calibrate=True,
)
# the sequential protocol ("auto" with a mesh), each split on the (2, 2) mesh
MESH_PROTOCOL = ProtocolConfig(
    n_splits=2, hidden=(16, 16), batch_size=16, epochs1=1, epochs2=2, epochs_per_call=1,
    train_samples=4, eval_samples=8,
)
GRID = [{"lambda_hidden": 1.0}, {"lambda_hidden": 3.0, "sigma0": 0.5}]
GRID_BASE = ProtocolConfig(
    n_splits=4, hidden=(16, 16), batch_size=16, epochs1=1, epochs2=1, epochs_per_call=1,
    train_samples=2, eval_samples=4,
)


def train_world(device, tmp: str) -> dict:
    out = {}
    X, y = fit_data()
    Xt, yt = fit_data(11, seed=22)
    for layout in LAYOUTS:
        net = build_net("shared")
        net.layers[-1] = WHVILinear(16, 1, 1e-5)
        trainer = Trainer(net, fit_config(), mesh=make_mesh(*layout))
        state = trainer.init(SEED)
        state, logs = trainer.fit(state, X, y)
        metrics = trainer.evaluate(Xt, yt, torch.Generator().manual_seed(7))
        out[("fit", layout)] = dict(params=flat_params(trainer.net), metrics=metrics,
                                    loss=logs[-1]["loss"], step=state.step)
    # the split-mesh stack: 8 replicas over 4 ranks, one over the others
    Xs, ys = stack_data(8)
    mesh = make_split_mesh()
    net = build_net("shared")
    net.layers[-1] = WHVILinear(16, 1, 1e-5)
    trainer = Trainer(net, fit_config(8), replicas=8, split_mesh=mesh)
    state = trainer.init([100 + r for r in range(8)])
    state, logs = trainer.fit(state, Xs, ys, ckpt_dir=os.path.join(tmp, "stack"))
    y_hat = trainer.predict(Xs[:, :6], torch.Generator().manual_seed(8))
    out["stack"] = dict(
        params=[trainer.gather_replicas(p.detach()) for p in trainer.net.parameters()],
        metrics=trainer.metrics(ys[:, :6], y_hat), loss=logs[-1]["loss"],
        files=sorted(os.listdir(os.path.join(tmp, "stack"))),
    )
    # resume: a new stack restores the last checkpoint and trains no more
    net = build_net("shared")
    net.layers[-1] = WHVILinear(16, 1, 1e-5)
    again = Trainer(net, fit_config(8), replicas=8, split_mesh=mesh)
    state = again.init([100 + r for r in range(8)])
    state, _ = again.fit(state, Xs, ys, ckpt_dir=os.path.join(tmp, "stack"))
    out["stack"]["resumed"] = [again.gather_replicas(p.detach()) for p in again.net.parameters()]
    out["stack"]["resumed_step"] = state.step
    Xp, yp = protocol_data()
    out["protocol"] = evaluate_bayesian_regression(
        Xp, yp, PROTOCOL, ckpt_dir=os.path.join(tmp, "protocol"), device=device, split_mesh=mesh
    )
    out["grid"] = evaluate_config_grid(Xp, yp, GRID_BASE, GRID, device=device, split_mesh=mesh)
    mesh22 = make_mesh(2, 2)
    out["protocol_mesh"] = evaluate_bayesian_regression(
        Xp, yp, MESH_PROTOCOL, device=device, mesh=mesh22
    )
    out["refusals"] = {
        "mesh_with_replicas": raises(lambda: Trainer(build_net("shared"), replicas=4, mesh=mesh22)),
        "split_mesh_without_replicas": raises(lambda: Trainer(build_net("shared"), split_mesh=mesh)),
        "hyper_with_mesh": raises(lambda: Trainer(build_net("shared"), fit_config(), mesh=mesh22).fit(
            None, X, y[:, 0], hyper={"kl_warmup_steps": np.zeros(1)})),
        "split_mesh_sequential": raises(lambda: evaluate_bayesian_regression(
            Xp, yp, ProtocolConfig(vmap_splits=False), device=device, split_mesh=mesh)),
        "replicas_not_split": raises(lambda: Trainer(build_net("shared"), replicas=6, split_mesh=mesh)),
        "eval_samples": raises(lambda: Trainer(
            WHVIRegression([WHVILinear(13, 1)], train_samples=4, eval_samples=6), mesh=make_mesh(1, 4))),
    }
    return out


# ------------------------------------------------------------------ samplers


def g_posterior():
    """A small WHVI net's g posterior (6 -> 8 -> 1, per-example noise off),
    on 24 rows."""
    torch.manual_seed(SEED)
    net = WHVIRegression([WHVILinear(6, 8, 1.0, bias=True), relu, WHVILinear(8, 1, 1.0)],
                         sigma0=0.3)
    with torch.no_grad():
        for layer in net.layers[::2]:
            layer.matrix.g_mu.normal_(0.0, 0.5)
    rng = np.random.RandomState(51)
    X = rng.randn(24, 6).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.2 * rng.randn(24)).astype(np.float32)
    return make_whvi_g_log_posterior(net, X, y)


def gaussian(q):
    """A correlated 3-d Gaussian, for the dense metric."""
    prec = torch.tensor([[2.0, 0.9, 0.0], [0.9, 1.0, 0.3], [0.0, 0.3, 1.5]])
    x = q["x"]
    return -0.5 * torch.sum(torch.sum(x[..., None, :] * prec, -1) * x, -1)


SAMPLERS = {
    "hmc": (hmc_sample_chains, HMCConfig(n_samples=6, n_warmup=6, n_leapfrog=4)),
    "nuts": (nuts_sample_chains, NUTSConfig(n_samples=5, n_warmup=5, max_tree_depth=3)),
    "pt": (pt_sample_chains, PTConfig(n_samples=5, n_warmup=5, n_rungs=3, n_leapfrog=4)),
    "hmc_dense": (hmc_sample_chains, HMCConfig(n_samples=6, n_warmup=12, n_leapfrog=4,
                                               dense_mass=True)),
}


def sampler_run(name: str, mesh=None, n_chains: int = WORLD):
    fn, cfg = SAMPLERS[name]
    if name == "hmc_dense":
        lp, init = gaussian, {"x": torch.zeros(3)}
    else:
        lp, init = g_posterior()
    return fn(lp, init, torch.Generator().manual_seed(61), cfg, n_chains=n_chains, mesh=mesh)


def mcmc_world(device) -> dict:
    out = {}
    for layout in ((1, 4), (2, 2)):
        mesh = make_mesh(*layout)
        for name in SAMPLERS:
            samples, stats = sampler_run(name, mesh)
            out[(layout, name)] = (samples, stats)
    out["refusals"] = {"n_chains": raises(lambda: sampler_run("hmc", make_mesh(1, 4), 6))}
    return out
