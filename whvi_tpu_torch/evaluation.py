"""UCI Bayesian-regression evaluation protocol (PyTorch).

Counterpart of :mod:`whvi_tpu.evaluation`, itself the counterpart of the
reference's ``evaluate_bayesian_regression_dnn``: standardize X,
``n_splits`` random 90/10 train/test splits, the net ``n_in -> 128 -> 128
-> n_out`` with ReLU, prior variance 3 on hidden layers and 1e-5 on the
last, batch 64, two-phase training (500 + 50000 epochs), 1 training MC
sample, 64 eval samples, a checkpoint directory per configuration, and
mean/sd of test error and MNLL over the splits; with ``calibrate`` a
predictive-variance temperature fitted on a held-out part of each train
split (:mod:`whvi_tpu_torch.calibration`).

The splits train either one after another (``vmap_splits=False``) or, by
default, as one replica-stacked fit (``vmap_splits`` True or "auto"): the
``n_splits`` shape-identical nets become the replicas of one net
(:func:`whvi_tpu_torch.models.networks.stack_replicas`), so each step
launches the kernels of one split for all of them. :func:`evaluate_config_grid`
stacks a whole grid of shape-preserving configurations the same way.

Seeds, as the JAX package's keys: split ``s`` is initialized from seed
``seed * 1000 + s``, evaluated with seed ``s`` and calibrated with seed
``100000 + s``. The JAX package draws every replica's noise from that
replica's key, so its two paths agree bit for bit; here the stacked path
draws the whole stack's noise from one generator (replica 0's seeds),
since a generator a replica would mean a launch a replica. The two paths
therefore agree on the same noise and in distribution, not bit for bit.

Entry points run on the card: ``device=None`` means ``"cuda"``, and
without a card they raise unless the caller asks for ``"cpu"``.

Meshes (:mod:`whvi_tpu_torch.parallel`): ``mesh=`` trains each split
through the ``(data, sample)`` sharded loss (the sequential protocol:
``vmap_splits`` "auto" means False with a mesh); ``split_mesh=`` shards
the stacked splits' replica axis over the ranks. Every rank runs the
protocol and returns the whole result; rank 0 writes the checkpoints.

Left out: the JAX package's dispatch-length guard
(``_dispatch_chunk_bound``), which works around a remote TPU worker and
changes only logging and checkpoint cadence, never results.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable

import numpy as np
import torch

from whvi_tpu_torch.models.layers import Parallel, WHVILinear, relu
from whvi_tpu_torch.models.likelihoods import (
    GaussianLikelihood,
    HeteroscedasticGaussianLikelihood,
    _inv_softplus,
)
from whvi_tpu_torch.models.networks import WHVINetwork
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.utils.profiling import require_cuda

__all__ = [
    "ProtocolConfig",
    "evaluate_bayesian_regression",
    "evaluate_config_grid",
    "standardize",
]


def standardize(X_train: np.ndarray, *rest: np.ndarray):
    """Fit mean/std on ``X_train``, apply to all (the reference fits on the
    full X; pass ``rest=()`` and call with the full X to reproduce it)."""
    mu = X_train.mean(axis=0, keepdims=True)
    sd = X_train.std(axis=0, keepdims=True) + 1e-8
    out = [(X_train - mu) / sd]
    out.extend((r - mu) / sd for r in rest)
    return out if rest else out[0]


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """The protocol's settings, field for field and default for default
    the JAX package's (``whvi_tpu/evaluation.py:83-166``), so a
    configuration hashes to the same ``cfg-{hash}`` directory name.
    ``vmap_splits`` selects the replica-stacked fit (True or "auto") or
    the sequential loop (False); ``epochs_per_call`` is the number of
    epochs between host reads of the metrics."""

    n_splits: int = 8
    test_frac: float = 0.1
    hidden: tuple = (128, 128)
    lambda_hidden: float = 3.0
    lambda_last: float = 1e-5
    sigma0: float = 1.0
    batch_size: int = 64
    epochs1: int = 500
    epochs2: int = 50000
    train_samples: int = 1
    eval_samples: int = 64
    checkpoint_every: int = 5000
    epochs_per_call: int = 2500
    s_init: float | str = "auto"
    kl_warmup_frac: float = 0.2  # fraction of total steps; 0 disables
    scale_reference_exact: bool = False  # standardize on the full X
    # a split-prior [mean, raw_sigma] head: mean branch under lambda_last,
    # noise branch under lambda_noise
    heteroscedastic: bool = False
    lambda_noise: float = 1.0
    # share of the steps with the noise branch frozen (split head only)
    noise_freeze_frac: float = 0.5
    # train on standardized targets, report metrics in original units
    normalize_y: bool = False
    per_example_noise: bool = False
    column_lrt: bool = False  # per-row LRT on column heads (needs per_example_noise)
    rect_mode: str = "stack"  # non-square layers: "stack" or "pad"
    bias: bool = False
    ignore_kl: bool = False
    vmap_splits: bool | str = "auto"
    # post-hoc temperature fitted on calib_frac of each train split
    calibrate: bool = False
    calib_frac: float = 0.1
    calib_mode: str = "quantile"  # or "nll"
    calib_pooled: bool = False  # one tau on all splits' calibration z-scores
    seed: int = 0


def _device(device) -> torch.device:
    """``device``, ``"cuda"`` when None; raises for a CUDA device without
    a card (no quiet fall back to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        require_cuda()
    return device


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _build_net(config: ProtocolConfig, n_in: int, n_out: int) -> WHVINetwork:
    """The protocol's network (the single-config protocol's and the
    grid's), as ``whvi_tpu/evaluation.py:169-239`` builds it: the
    reference MLP with ``s_init``, ``per_example_noise`` and
    ``column_lrt`` on every WHVI layer, and with ``heteroscedastic`` a
    split-prior head, ``Parallel([mean head at lambda_last, noise head at
    lambda_noise])``, under a heteroscedastic likelihood."""
    kw = dict(
        rect_mode=config.rect_mode,
        bias=config.bias,
        s_init=config.s_init,
        per_example_noise=config.per_example_noise,
        column_lrt=config.column_lrt,
    )
    dims = [n_in, *config.hidden]
    layers: list = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers += [WHVILinear(a, b, lambda_=config.lambda_hidden, **kw), relu]
    head = WHVILinear(dims[-1], n_out, lambda_=config.lambda_last, **kw)
    if config.heteroscedastic:
        head = Parallel([head, WHVILinear(dims[-1], n_out, lambda_=config.lambda_noise, **kw)])
        likelihood = HeteroscedasticGaussianLikelihood(sigma0=config.sigma0)
    else:
        likelihood = GaussianLikelihood(config.sigma0)
    return WHVINetwork(
        layers + [head],
        likelihood,
        train_samples=config.train_samples,
        eval_samples=config.eval_samples,
    )


def _hashed_dir(ckpt_dir: str | None, prefix: str, key) -> str | None:
    """``ckpt_dir/{prefix}-{hash of repr(key)}``: one directory per
    configuration (the JAX package's names), so that resume never restores
    another configuration's checkpoint."""
    if not ckpt_dir:
        return None
    digest = hashlib.sha256(repr(key).encode()).hexdigest()[:10]
    return os.path.join(ckpt_dir, f"{prefix}-{digest}")


def _make_splits(X, y, config: ProtocolConfig, n: int, n_test: int) -> list:
    """Every split's data, all permutations drawn from one
    ``RandomState(config.seed)`` (the JAX package's order)."""
    rng = np.random.RandomState(config.seed)
    splits = []
    for _ in range(config.n_splits):
        perm = rng.permutation(n)
        test_idx, train_idx = perm[:n_test], perm[n_test:]
        if config.calibrate:
            n_cal = max(1, int(round(len(train_idx) * config.calib_frac)))
            cal_idx, train_idx = train_idx[:n_cal], train_idx[n_cal:]
        else:
            cal_idx = np.zeros((0,), np.int64)
        X_tr, X_te, X_cal = X[train_idx], X[test_idx], X[cal_idx]
        y_tr, y_te, y_cal = y[train_idx], y[test_idx], y[cal_idx]
        if not config.scale_reference_exact:
            X_tr, X_te, X_cal = standardize(X_tr, X_te, X_cal)
        if config.normalize_y:
            mu_y = y_tr.mean(axis=0, keepdims=True)
            sd_y = y_tr.std(axis=0, keepdims=True) + 1e-8
            y_tr_fit, y_te_fit, y_cal_fit = ((v - mu_y) / sd_y for v in (y_tr, y_te, y_cal))
        else:
            mu_y = sd_y = None
            y_tr_fit, y_te_fit, y_cal_fit = y_tr, y_te, y_cal
        splits.append(dict(
            X_tr=X_tr, X_te=X_te, X_cal=X_cal, y_tr_fit=y_tr_fit, y_te=y_te,
            y_te_fit=y_te_fit, y_cal_fit=y_cal_fit, mu_y=mu_y, sd_y=sd_y,
        ))
    return splits


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _hetero_rmse(net, y_hat, y_te_fit) -> np.ndarray:
    """RMSE of the MC mean of a split head's mean columns, per replica when
    ``y_hat`` carries one."""
    mean, _ = net.likelihood.split(y_hat)
    pred = _host(mean.mean(dim=-3))
    return np.sqrt(np.mean((pred - y_te_fit) ** 2, axis=(-2, -1)))


def _to_original_units(metrics: dict, y_hat: np.ndarray, mu_y, sd_y, y_te) -> dict:
    """One split's metrics from normalized targets converted back to the
    original units: RMSE of the back-transformed MC mean, MNLL plus ``n
    sum_d log sd_d`` (per point: plus ``sum_d log sd_d``); coverage is
    affine-invariant and kept."""
    y_hat_orig = y_hat * sd_y[None] + mu_y[None]
    log_sd_total = float(np.sum(np.log(sd_y)))
    out = dict(metrics)
    out["rmse"] = float(np.sqrt(np.mean((y_hat_orig.mean(axis=0) - y_te) ** 2)))
    out["mnll"] = metrics["mnll"] + len(y_te) * log_sd_total
    out["mnll_per_point"] = metrics["mnll_per_point"] + log_sd_total
    if "pred_mnll_per_point" in metrics:
        out["pred_mnll_per_point"] = metrics["pred_mnll_per_point"] + log_sd_total
    return out


def _check_calibratable(net, mode: str) -> None:
    """Refuse, before any split trains, what the calibration after the fit
    would refuse: a likelihood without two moments, or a ``calib_mode``
    that ``calibration.fit_temperature_from_z`` does not take."""
    from whvi_tpu_torch import calibration

    calibration.check_calib_mode(mode)
    if not isinstance(net.likelihood, (GaussianLikelihood, HeteroscedasticGaussianLikelihood)):
        raise ValueError(
            "calibrate=True needs a Gaussian-family likelihood "
            "whose .predict returns two-moment (mean, sd); got "
            f"{type(net.likelihood).__name__} (classification "
            "temperature lives in calibration.fit_logit_temperature)"
        )


def evaluate_bayesian_regression(
    X: np.ndarray,
    y: np.ndarray,
    config: ProtocolConfig = ProtocolConfig(),
    ckpt_dir: str | None = None,
    log_fn: Callable[[dict], None] | None = None,
    device=None,
    mesh=None,
    split_mesh=None,
) -> dict:
    """Run the full protocol on ``device`` (the card unless ``"cpu"`` is
    asked for); returns mean/sd of RMSE and MNLL across splits plus
    per-split details, with the JAX package's keys. ``mesh``: train every
    split through the sharded MC-ELBO (``train_samples`` and
    ``eval_samples`` must split over its ``sample`` axis); ``split_mesh``:
    shard the stacked splits (``n_splits`` a multiple of its size)."""
    device = _device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    y = y if y.ndim > 1 else y[:, None]
    n, n_in = X.shape
    n_out = y.shape[1]
    n_test = max(1, int(round(n * config.test_frac)))
    if config.scale_reference_exact:
        X = standardize(X)

    net = _build_net(config, n_in, n_out)
    total = config.epochs1 + config.epochs2
    n_tr = n - n_test
    if config.calibrate:
        # the calibration rows come out of the train rows: the warm-up and
        # freeze fractions are of the steps actually trained
        n_tr -= max(1, int(round(n_tr * config.calib_frac)))
        _check_calibratable(net, config.calib_mode)
    # as the epoch runner rounds the batch up to the data-shard multiple,
    # which can lower the batch count the warm-up and freeze are counted in
    d = mesh.shape["data"] if mesh is not None else 1
    steps_per_epoch = -(-n_tr // (-(-min(config.batch_size, n_tr) // d) * d))
    tcfg = TrainConfig(
        batch_size=config.batch_size,
        epochs1=config.epochs1,
        epochs2=config.epochs2,
        epochs_per_call=config.epochs_per_call,
        checkpoint_every=config.checkpoint_every,
        ignore_kl=config.ignore_kl,
        kl_warmup_steps=int(total * steps_per_epoch * config.kl_warmup_frac),
        noise_freeze_steps=int(total * steps_per_epoch * config.noise_freeze_frac)
        if config.heteroscedastic
        else 0,
    )
    ckpt_dir = _hashed_dir(ckpt_dir, "cfg", sorted(dataclasses.asdict(config).items()))
    splits = _make_splits(X, y, config, n, n_test)
    stacked = config.vmap_splits if isinstance(config.vmap_splits, bool) else mesh is None
    if split_mesh is not None and not stacked:
        raise ValueError(
            "split_mesh requires the vmapped-splits protocol (don't combine it "
            "with mesh= or vmap_splits=False)"
        )
    if stacked:
        return _run_stacked_protocol(
            net, tcfg, config, splits, total, ckpt_dir, log_fn, device, mesh, split_mesh
        )

    trainer = Trainer(net, tcfg, device=device, mesh=mesh)
    results, cal_inputs, cal_rows = [], [], []
    for split, d in enumerate(splits):
        state = trainer.init(config.seed * 1000 + split)
        split_dir = os.path.join(ckpt_dir, f"split-{split}") if ckpt_dir else None
        t0 = time.time()
        state, _ = trainer.fit(state, d["X_tr"], d["y_tr_fit"], ckpt_dir=split_dir, log_fn=log_fn)
        wall = time.time() - t0
        # one test-set forward for the metrics, the split head's RMSE, the
        # normalize_y conversions and calibration
        y_hat_te = trainer.predict(d["X_te"], _generator(device, split))
        metrics = trainer.metrics(d["y_te_fit"], y_hat_te)
        if config.heteroscedastic and "rmse" not in metrics:
            metrics["rmse"] = float(_hetero_rmse(net, y_hat_te, d["y_te_fit"]))
        if config.normalize_y:
            y_hat = net.likelihood.split(y_hat_te)[0] if config.heteroscedastic else y_hat_te
            metrics = _to_original_units(metrics, _host(y_hat), d["mu_y"], d["sd_y"], d["y_te"])
        entry = {
            "split": split,
            "rmse": metrics["rmse"],
            "mnll": metrics["mnll"],
            "mnll_per_point": metrics["mnll_per_point"],
            "wall_s": wall,
            "epochs_per_s": total / max(wall, 1e-9),
        }
        if "pred_mnll_per_point" in metrics:
            entry["pred_mnll_per_point"] = metrics["pred_mnll_per_point"]
        if "coverage95" in metrics:
            entry["coverage95"] = float(metrics["coverage95"])
        if config.calibrate:
            y_hat_cal = trainer.predict(d["X_cal"], _generator(device, 100000 + split))
            m_c, s_c = net.likelihood.predict(y_hat_cal)
            m_t, s_t = net.likelihood.predict(y_hat_te)
            cal_inputs.append(
                (d["y_cal_fit"], _host(m_c), _host(s_c), d["y_te_fit"], _host(m_t), _host(s_t))
            )
            if not config.calib_pooled:
                # a per-split tau needs no other split: computed now, so the
                # streamed entry carries it
                cal_rows.append(_calibrate_splits(cal_inputs[-1:], config)[0])
                entry["temperature"], entry["coverage95_cal"], _ = cal_rows[-1]
        results.append(entry)
        if log_fn:
            log_fn(entry)

    cal = None
    if config.calibrate:
        if config.calib_pooled:
            cal = _calibrate_splits(cal_inputs, config)
            for entry, (tau, cov_cal, _) in zip(results, cal):
                entry["temperature"] = tau
                entry["coverage95_cal"] = cov_cal
        else:
            cal = cal_rows
    out = _aggregate(results)
    if cal is not None:
        _attach_reliability(out, [z for _, _, z in cal], [z / tau for tau, _, z in cal])
        out["calib_pooled"] = bool(config.calib_pooled)
    return out


def _calibrate_splits(cal_inputs: list, config) -> list:
    """``[(tau, tempered coverage95, raw test z-scores), ...]`` from each
    split's ``(y_cal, m_c, s_c, y_te, m_t, s_t)``; with
    ``config.calib_pooled`` one tau fitted on every split's calibration
    z-scores (z is scale-free, so pooling across splits is exact)."""
    from scipy.stats import norm

    from whvi_tpu_torch import calibration

    z_cals = [
        calibration._z(np.asarray(y_c), np.asarray(m_c), np.asarray(s_c)).reshape(-1)
        for y_c, m_c, s_c, _, _, _ in cal_inputs
    ]
    z_tes = [
        calibration._z(np.asarray(y_t), np.asarray(m_t), np.asarray(s_t)).reshape(-1)
        for _, _, _, y_t, m_t, s_t in cal_inputs
    ]
    if config.calib_pooled:
        tau = calibration.fit_temperature_from_z(np.concatenate(z_cals), mode=config.calib_mode)
        taus = [tau] * len(cal_inputs)
    else:
        taus = [calibration.fit_temperature_from_z(z, mode=config.calib_mode) for z in z_cals]
    zcrit = norm.ppf(0.975)
    return [
        (tau, float(np.mean(np.abs(z) <= zcrit * tau)), z)
        for tau, z in zip(taus, z_tes)
    ]


def _attach_reliability(out: dict, raw_z_pool, cal_z_pool) -> None:
    """Pooled 10-bin reliability tables (test z-scores across splits),
    raw and tempered, plus temperature/coverage aggregates."""
    from whvi_tpu_torch import calibration

    results = out["splits"]
    taus = np.array([r["temperature"] for r in results])
    cov = np.array([r["coverage95_cal"] for r in results])
    out["temperature_mean"] = float(taus.mean())
    out["temperature_sd"] = float(taus.std())
    out["coverage95_cal_mean"] = float(cov.mean())
    out["coverage95_cal_sd"] = float(cov.std())
    out["reliability_raw"] = calibration.table_from_z(np.concatenate(raw_z_pool))
    out["reliability_cal"] = calibration.table_from_z(np.concatenate(cal_z_pool))


def _aggregate(results: list) -> dict:
    rmses = np.array([r["rmse"] for r in results])
    mnlls = np.array([r["mnll"] for r in results])
    mnllpp = np.array([r["mnll_per_point"] for r in results])
    out = {
        "rmse_mean": float(rmses.mean()),
        "rmse_sd": float(rmses.std()),
        "mnll_mean": float(mnlls.mean()),
        "mnll_sd": float(mnlls.std()),
        "mnll_per_point_mean": float(mnllpp.mean()),
        "mnll_per_point_sd": float(mnllpp.std()),
        "splits": results,
    }
    if all("pred_mnll_per_point" in r for r in results):
        pp = np.array([r["pred_mnll_per_point"] for r in results])
        out["pred_mnll_per_point_mean"] = float(pp.mean())
        out["pred_mnll_per_point_sd"] = float(pp.std())
    if all("coverage95" in r for r in results):
        cov = np.array([r["coverage95"] for r in results])
        out["coverage95_mean"] = float(cov.mean())
        out["coverage95_sd"] = float(cov.std())
    return out


def _stacked_entry(metrics: dict, r: int, split: int, wall: float, R: int, total: int) -> dict:
    """Replica ``r``'s result row. Its times are the whole stack's wall
    shared out, and named so (``_amortized``): no replica trained alone."""
    entry = {
        "split": split,
        "rmse": float(metrics["rmse"][r]),
        "mnll": float(metrics["mnll"][r]),
        "mnll_per_point": float(metrics["mnll_per_point"][r]),
        "wall_s_amortized": wall / R,
        "epochs_per_s_amortized": total / max(wall / R, 1e-9),
    }
    for k in ("pred_mnll_per_point", "coverage95"):
        if k in metrics:
            entry[k] = float(metrics[k][r])
    return entry


def _run_stacked_protocol(
    net, tcfg, config, splits, total, ckpt_dir, log_fn, device, mesh=None, split_mesh=None,
) -> dict:
    """All ``n_splits`` fits as one replica-stacked two-phase run
    (``whvi_tpu/evaluation.py:657-800``): the splits are the replicas of
    one net, with their data, parameters and Adam moments stacked on a
    leading axis (over ``split_mesh``'s ranks when given). Checkpoints
    hold the whole stack, under ``ckpt_dir/stacked``."""
    K = config.n_splits
    ys_te_fit = np.stack([d["y_te_fit"] for d in splits])
    trainer = Trainer(net, tcfg, device=device, replicas=K, mesh=mesh, split_mesh=split_mesh)
    state = trainer.init([config.seed * 1000 + s for s in range(K)])
    t0 = time.time()
    state, _ = trainer.fit(
        state,
        np.stack([d["X_tr"] for d in splits]),
        np.stack([d["y_tr_fit"] for d in splits]),
        ckpt_dir=os.path.join(ckpt_dir, "stacked") if ckpt_dir else None,
        log_fn=log_fn,
    )
    wall = time.time() - t0
    # one test-set forward for the metrics and everything after them (this
    # rank's replicas under a split mesh; y_hat_all every replica's)
    y_hat_te = trainer.predict(np.stack([d["X_te"] for d in splits]), _generator(device, 0))
    metrics = trainer.metrics(ys_te_fit, y_hat_te)
    y_hat_all = trainer.gather_replicas(y_hat_te)
    if config.heteroscedastic and "rmse" not in metrics:
        metrics["rmse"] = _hetero_rmse(net, y_hat_all, ys_te_fit)
    if config.normalize_y:
        y_hat = _host(net.likelihood.split(y_hat_all)[0] if config.heteroscedastic else y_hat_all)
        per_split = [
            _to_original_units(
                {k: v[s] for k, v in metrics.items()}, y_hat[s],
                splits[s]["mu_y"], splits[s]["sd_y"], splits[s]["y_te"],
            )
            for s in range(K)
        ]
        metrics = {k: np.array([m[k] for m in per_split]) for k in metrics}

    cal = None
    if config.calibrate:
        y_hat_cal = trainer.predict(
            np.stack([d["X_cal"] for d in splits]), _generator(device, 100000)
        )
        m_c, s_c = (_host(trainer.gather_replicas(t)) for t in net.likelihood.predict(y_hat_cal))
        m_t, s_t = (_host(trainer.gather_replicas(t)) for t in net.likelihood.predict(y_hat_te))
        cal = _calibrate_splits(
            [
                (splits[s]["y_cal_fit"], m_c[s], s_c[s], ys_te_fit[s], m_t[s], s_t[s])
                for s in range(K)
            ],
            config,
        )

    results = []
    for s in range(K):
        entry = _stacked_entry(metrics, s, s, wall, K, total)
        if cal is not None:
            entry["temperature"], entry["coverage95_cal"], _ = cal[s]
        results.append(entry)
        if log_fn:
            log_fn(entry)
    out = _aggregate(results)
    if cal is not None:
        _attach_reliability(out, [z for _, _, z in cal], [z / tau for tau, _, z in cal])
        out["calib_pooled"] = bool(config.calib_pooled)
    out["vmapped_splits"] = True
    out["protocol_wall_s"] = wall
    return out


# --------------------------------------------------------- config-stacked grid

# Override keys a config grid may sweep: the shape-preserving scalars.
# Anything else changes the net's parameters or the step, and belongs in
# a separate grid.
_GRID_KEYS = frozenset(
    {
        "sigma0",
        "lambda_hidden",
        "lambda_last",
        "lambda_noise",
        "kl_warmup_frac",
        "noise_freeze_frac",
        "seed",
    }
)


def evaluate_config_grid(
    X: np.ndarray,
    y: np.ndarray,
    base: ProtocolConfig,
    overrides: list,
    ckpt_dir: str | None = None,
    log_fn: Callable[[dict], None] | None = None,
    device=None,
    split_mesh=None,
) -> dict:
    """Run a whole grid of configurations as one replica-stacked protocol
    fit on ``device`` (the card unless ``"cpu"`` is asked for), its
    replicas sharded over ``split_mesh``'s ranks when given.

    ``overrides``: one dict a configuration, keys from ``_GRID_KEYS``,
    values replacing ``base``'s. Replica ``r = c * n_splits + s`` is split
    ``s`` of configuration ``c``: its prior variances enter the KL as
    per-replica tensors, its warm-up and freeze as per-replica step
    counts (the trainer's ``hyper``), its ``sigma0`` and ``seed`` at
    init. The splits are drawn once from ``base.seed`` and shared by
    every configuration (a ``seed`` override varies the init only).

    Returns ``{"configs": [per-configuration aggregates], "protocol_wall_s",
    "stack_size", "n_configs", "vmapped_splits"}``. ``calibrate`` and
    ``normalize_y`` are not supported here (run them as single configs).
    """
    for o in overrides:
        bad = set(o) - _GRID_KEYS
        if bad:
            raise ValueError(
                f"config grid can only sweep shape-preserving scalars "
                f"{sorted(_GRID_KEYS)}; got {sorted(bad)}"
            )
    if base.calibrate or base.normalize_y:
        raise ValueError(
            "calibrate/normalize_y are per-split post-processing paths "
            "not supported in the stacked grid; run them as single "
            "configs"
        )
    if base.heteroscedastic and any("sigma0" in o for o in overrides):
        raise ValueError(
            "per-config sigma0 is init+static for the heteroscedastic "
            "likelihood (its split() shift); sweep it homoscedastic or "
            "as separate runs"
        )
    device = _device(device)
    cfgs = [dataclasses.replace(base, **o) for o in overrides]
    C, K = len(cfgs), base.n_splits
    R = C * K

    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    y = y if y.ndim > 1 else y[:, None]
    n, n_in = X.shape
    n_out = y.shape[1]
    n_test = max(1, int(round(n * base.test_frac)))
    if base.scale_reference_exact:
        X = standardize(X)

    net = _build_net(base, n_in, n_out)
    total = base.epochs1 + base.epochs2
    n_tr = n - n_test
    steps_per_epoch = -(-n_tr // min(base.batch_size, n_tr))
    tcfg = TrainConfig(
        batch_size=base.batch_size,
        epochs1=base.epochs1,
        epochs2=base.epochs2,
        epochs_per_call=base.epochs_per_call,
        checkpoint_every=base.checkpoint_every,
        ignore_kl=base.ignore_kl,
        # warm-up and freeze ride the per-replica hyper below
    )
    trainer = Trainer(net, tcfg, device=device, replicas=R, split_mesh=split_mesh)

    splits = _make_splits(X, y, dataclasses.replace(base, calibrate=False), n, n_test)
    Xs_tr = np.tile(np.stack([d["X_tr"] for d in splits]), (C, 1, 1))
    ys_tr = np.tile(np.stack([d["y_tr_fit"] for d in splits]), (C, 1, 1))
    Xs_te = np.tile(np.stack([d["X_te"] for d in splits]), (C, 1, 1))
    ys_te = np.tile(np.stack([d["y_te"] for d in splits]), (C, 1, 1))

    def rep(vals):  # (C,) config scalars -> (R,) replica array
        return np.repeat(np.asarray(vals, np.float32), K)

    hyper = {
        "kl_warmup_steps": rep(
            [int(total * steps_per_epoch * c.kl_warmup_frac) for c in cfgs]
        )
    }
    if base.heteroscedastic:
        hyper["noise_freeze_steps"] = rep(
            [int(total * steps_per_epoch * c.noise_freeze_frac) for c in cfgs]
        )
    # per-layer prior variances: hidden WHVI layers lambda_hidden, the head
    # lambda_last (and lambda_noise on a split head's noise branch)
    last = len(net.layers) - 1
    lam_tree = []
    for i, layer in enumerate(net.layers):
        if isinstance(layer, Parallel):
            lam_tree.append(
                (rep([c.lambda_last for c in cfgs]), rep([c.lambda_noise for c in cfgs]))
            )
        elif isinstance(layer, WHVILinear):
            key = "lambda_last" if i == last else "lambda_hidden"
            lam_tree.append(rep([getattr(c, key) for c in cfgs]))
        else:
            lam_tree.append(None)
    hyper["lambdas"] = tuple(lam_tree)

    state = trainer.init([c.seed * 1000 + s for c in cfgs for s in range(K)])
    if any("sigma0" in o for o in overrides):
        # the homoscedastic sigma0 is init only: each replica's rho set to
        # its configuration's (Adam's state is zero at init)
        with torch.no_grad():
            net.likelihood.rho.copy_(
                trainer.replica_part(torch.as_tensor(rep([_inv_softplus(c.sigma0) for c in cfgs])))
            )

    t0 = time.time()
    state, _ = trainer.fit(
        state, Xs_tr, ys_tr, log_fn=log_fn, hyper=hyper,
        ckpt_dir=_hashed_dir(
            ckpt_dir, "grid", [sorted(dataclasses.asdict(c).items()) for c in cfgs]
        ),
    )
    wall = time.time() - t0
    y_hat = trainer.predict(Xs_te, _generator(device, 0))
    metrics = trainer.metrics(ys_te, y_hat)
    if base.heteroscedastic and "rmse" not in metrics:
        metrics["rmse"] = _hetero_rmse(net, trainer.gather_replicas(y_hat), ys_te)

    out_configs = []
    for c_i, o in enumerate(overrides):
        results = []
        for s in range(K):
            entry = _stacked_entry(metrics, c_i * K + s, s, wall, R, total)
            results.append(entry)
            if log_fn:
                log_fn(dict(entry, config=c_i))
        agg = _aggregate(results)
        agg["config_overrides"] = dict(o)
        out_configs.append(agg)
    return {
        "configs": out_configs,
        "protocol_wall_s": wall,
        "stack_size": R,
        "n_configs": C,
        "vmapped_splits": True,
    }
