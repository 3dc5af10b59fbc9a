"""Bayesian MNIST classifier with WHVI layers on one NVIDIA H100
(BASELINE config 4), with the golden-sampler check of its VI moments.

Counterpart of ``experiments/run_mnist.py``::

    python -m whvi_tpu_torch.experiments.run_mnist
        [--data auto|mnist|digits|wine|breast_cancer|synthetic]
        [--require-mnist] [--width 1024] [--epochs1 2] [--epochs2 18]
        [--batch 256] [--train-samples 1] [--eval-samples 16]
        [--lambda-hidden 3] [--lambda-last 1] [--bias] [--subset 0]
        [--seed 0] [--calibrate] [--hmc] [--cpu]

Model: ``WHVILinear(n_in, W)``, relu, ``WHVILinear(W, W)``, relu,
``WHVILinear(W, classes)``, all ``s_init="auto"``, priors
``lambda_hidden`` / ``lambda_last``, a softmax likelihood; at W = 1024 on
MNIST's 784 inputs the first and last layers are stacked matrices (one
block of D_in 1024) and the middle one square. Two-phase ELBO training,
KL warm-up over 0.3 of the steps, then test accuracy of the mean class
probabilities over ``eval_samples`` MC samples.

Data: ``mnist`` reads the IDX files (``whvi_tpu_torch.data.mnist``);
``digits``, ``wine`` and ``breast_cancer`` are scikit-learn's bundled
sets, which need scikit-learn (absent on the machine with the card: run
them with ``--cpu``); ``synthetic`` is ``synthetic_classification(seed=
--seed)`` at MNIST's shapes (the JAX script always uses seed 0; the
default seed gives the same rows). ``auto`` (the default) takes MNIST if
its files are there (or fails with ``--require-mnist``), else digits as
the JAX script does, or synthetic where scikit-learn is missing.

``--calibrate`` holds 10% of the (seeded-shuffled) train rows out, fits a
softmax logit temperature on them (``whvi_tpu_torch.calibration``) and
reports test NLL and ECE raw and tempered. ``--hmc`` freezes the trained
net, runs 4-chain NUTS (400 warm-up + 500 draws, tree depth 6) over the g
posterior of the first 256 training rows
(``whvi_tpu_torch.mcmc.make_whvi_g_log_posterior``), and compares the last
layer's NUTS moments with its variational ``(g_mu, softplus(g_rho))``.

Output: on the card the first line names it and its power limit; then
one JSON line per chunk of epochs and a last line with the JAX script's
keys (``experiment, source, width, test_accuracy, wall_s, epochs_per_s``,
the calibration keys, ``hmc``) plus ``device``; ``hmc`` also carries the
sampler's ``wall_s``, ``draws_per_s`` and ``grad_evals_per_s``. :func:`run`
takes its device; :func:`main` runs on the card unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.data import (
    load_digits_classification,
    load_mnist,
    load_sklearn_classification,
    mnist_available,
    synthetic_classification,
)
from whvi_tpu_torch.models import WHVIClassification, WHVILinear, relu
from whvi_tpu_torch.train import TrainConfig, Trainer

__all__ = ["accuracy", "build_net", "hmc_check", "load_data", "main", "run"]

DATA = ("auto", "mnist", "digits", "wine", "breast_cancer", "synthetic")


@torch.no_grad()
def accuracy(net, X, y, generator, n_samples=16, batch=2048) -> float:
    """Share of rows whose most probable class, under the mean of
    ``n_samples`` MC softmaxes, is the label; rows in chunks of ``batch``."""
    device = next(net.parameters()).device
    correct = 0
    for i in range(0, len(X), batch):
        xb = torch.as_tensor(X[i : i + batch], device=device)
        probs = net.likelihood.predict(net.predict(xb, n_samples, generator))
        pred = probs.argmax(-1).cpu().numpy()
        correct += int(np.sum(pred == y[i : i + batch]))
    return correct / len(X)


def _sklearn_available() -> bool:
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


def load_data(data: str, seed: int, require_mnist: bool = False):
    """``(source, (X_tr, y_tr), (X_te, y_te))`` for ``--data``."""
    if data == "auto":
        if mnist_available():
            data = "mnist"
        elif require_mnist:
            raise SystemExit("MNIST IDX files not found")
        else:  # real data beats synthetic
            data = "digits" if _sklearn_available() else "synthetic"
    if data == "mnist":
        return data, *load_mnist()
    if data == "digits":
        return data, *load_digits_classification(seed=seed)
    if data in ("wine", "breast_cancer"):
        return data, *load_sklearn_classification(data, seed=seed)
    if data == "synthetic":
        return data, *synthetic_classification(seed=seed)
    raise ValueError(f"unknown data {data!r}; have {DATA}")


def build_net(n_in: int, n_classes: int, *, width: int = 1024, lambda_hidden: float = 3.0,
              lambda_last: float = 1.0, bias: bool = False, train_samples: int = 1,
              eval_samples: int = 16) -> WHVIClassification:
    """The model of the module docstring, on the CPU; at the defaults and
    ``(784, 10)``, BASELINE config 4."""
    kw = dict(s_init="auto", bias=bias)
    return WHVIClassification(
        [
            WHVILinear(n_in, width, lambda_=lambda_hidden, **kw),
            relu,
            WHVILinear(width, width, lambda_=lambda_hidden, **kw),
            relu,
            WHVILinear(width, n_classes, lambda_=lambda_last, **kw),
        ],
        train_samples=train_samples,
        eval_samples=eval_samples,
    )


def hmc_check(net, X, y, *, device, seed: int = 2, n_samples: int = 500, n_warmup: int = 400,
              max_tree_depth: int = 6, n_chains: int = 4) -> dict:
    """The golden-sampler check of the JAX script (``--hmc``): NUTS over
    the g posterior of ``(X, y)`` with every other parameter frozen; the
    sampler must pass its convergence gates before its comparison with VI
    means anything. VI's sd is expected below NUTS's marginal sd by the
    mean-field deficit (``run_vi_vs_hmc``'s analytic tier), and VI's mean
    should correlate with NUTS's. Returns the ``hmc`` row."""
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import rates
    from whvi_tpu_torch.mcmc import NUTSConfig, ess, make_whvi_g_log_posterior, nuts_sample_chains
    from whvi_tpu_torch.mcmc import split_rhat
    from whvi_tpu_torch.mcmc.nuts import gradient_evaluations

    logp, init = make_whvi_g_log_posterior(net, X, y)
    cfg = NUTSConfig(n_samples=n_samples, n_warmup=n_warmup, max_tree_depth=max_tree_depth)
    generator = torch.Generator(device=device).manual_seed(seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    samples, stats = nuts_sample_chains(logp, init, generator, cfg, n_chains=n_chains)
    sync()
    wall = time.perf_counter() - t0
    last = max(init)
    gs = samples[last]
    rhat = float(split_rhat(gs).max())
    n_eff = float(ess(gs).min())
    divs = int(stats["divergences"].sum())
    layer = logp.static.layers[last].matrix
    vi_mu = layer.g_mu.detach().reshape(-1).cpu().numpy()
    vi_sd = layer.g_sigma().detach().reshape(-1).cpu().numpy()
    hmc_mu = gs.mean((0, 1)).reshape(-1).cpu().numpy()
    hmc_sd = gs.std((0, 1), correction=0).reshape(-1).cpu().numpy()
    return {
        "sampler": f"nuts-{n_chains}chain",
        "rhat_max": rhat,
        "ess_min": n_eff,
        "divergences": divs,
        "converged": rhat < 1.05 and n_eff > 100 and divs == 0,
        "mu_corr_vi_hmc": float(np.corrcoef(hmc_mu, vi_mu)[0, 1]),
        "hmc_sd_mean": float(hmc_sd.mean()),
        "vi_sd_mean": float(vi_sd.mean()),
        "sd_ratio_vi_over_hmc": float(np.mean(vi_sd / (hmc_sd + 1e-12))),
        "criterion": "valid only if converged; expect sd_ratio < 1 (mean-field deficit, see "
        "run_vi_vs_hmc) and mu_corr well above 0",
        **rates(n_chains, n_samples + n_warmup, gradient_evaluations(cfg), wall),
    }


def _calibration(net, X_cal, y_cal, X_te, y_te, eval_samples, device) -> dict:
    """The JAX script's ``--calibrate`` keys: a softmax logit temperature
    fitted on the held-out rows, test NLL and ECE raw and tempered."""
    from whvi_tpu_torch.calibration import (
        expected_calibration_error,
        fit_logit_temperature,
        tempered_mc_probs,
    )

    @torch.no_grad()
    def logits(X, seed):
        generator = torch.Generator(device=device).manual_seed(seed)
        return net.predict(torch.as_tensor(X, device=device), eval_samples, generator).cpu().numpy()

    cal_logits, te_logits = logits(X_cal, 3), logits(X_te, 4)
    fit = fit_logit_temperature(cal_logits, y_cal, return_info=True)
    tau = fit["tau"]

    def nll(p):
        return float(-np.mean(np.log(p[np.arange(len(y_te)), y_te.astype(int)] + 1e-12)))

    p_raw, p_cal = tempered_mc_probs(te_logits, 1.0), tempered_mc_probs(te_logits, tau)
    out = {"logit_temperature": round(tau, 3), "tau_at_edge": bool(fit["tau_at_edge"])}
    if fit["tau_at_edge"]:
        out["logit_temperature_raw"] = round(fit["tau_raw"], 3)
    out["test_nll_raw"] = round(nll(p_raw), 4)
    out["test_nll_cal"] = round(nll(p_cal), 4)
    out["test_ece_raw"] = round(expected_calibration_error(p_raw, y_te), 4)
    out["test_ece_cal"] = round(expected_calibration_error(p_cal, y_te), 4)
    return out


def run(
    *,
    device,
    data: str = "synthetic",
    width: int = 1024,
    epochs1: int = 2,
    epochs2: int = 18,
    batch: int = 256,
    train_samples: int = 1,
    eval_samples: int = 16,
    lambda_hidden: float = 3.0,
    lambda_last: float = 1.0,
    bias: bool = False,
    subset: int = 0,
    seed: int = 0,
    require_mnist: bool = False,
    calibrate: bool = False,
    hmc: bool = False,
    log_fn=None,
):
    """Train and evaluate on ``device``; returns ``(row, trainer, logs)``."""
    device = torch.device(device)
    source, (X_tr, y_tr), (X_te, y_te) = load_data(data, seed, require_mnist)
    if subset:
        X_tr, y_tr = X_tr[:subset], y_tr[:subset]
    net = build_net(X_tr.shape[1], int(y_tr.max()) + 1, width=width, lambda_hidden=lambda_hidden,
                    lambda_last=lambda_last, bias=bias, train_samples=train_samples,
                    eval_samples=eval_samples)
    # the calibration holdout comes out before the warm-up arithmetic,
    # which counts the train rows' steps
    if calibrate:
        perm = np.random.RandomState(seed).permutation(len(X_tr))
        X_tr, y_tr = X_tr[perm], y_tr[perm]
        n_cal = max(1, len(X_tr) // 10)
        X_cal, y_cal = X_tr[:n_cal], y_tr[:n_cal]
        X_tr, y_tr = X_tr[n_cal:], y_tr[n_cal:]
    total = epochs1 + epochs2
    steps_per_epoch = -(-len(X_tr) // batch)
    cfg = TrainConfig(
        batch_size=batch,
        epochs1=epochs1,
        epochs2=epochs2,
        epochs_per_call=max(1, total // 10),
        kl_warmup_steps=int(0.3 * total * steps_per_epoch),
    )
    trainer = Trainer(net, cfg, device=device)
    state = trainer.init(seed)
    t0 = time.perf_counter()
    state, logs = trainer.fit(state, X_tr, y_tr, log_fn=log_fn)
    wall = time.perf_counter() - t0
    generator = torch.Generator(device=device).manual_seed(1)
    acc = accuracy(trainer.net, X_te, y_te, generator, eval_samples)
    row = {
        "experiment": "mnist",
        "source": source,
        "width": width,
        "test_accuracy": acc,
        "wall_s": round(wall, 1),
        "epochs_per_s": round(total / max(wall, 1e-9), 2),
        "device": device_name(device),
    }
    if calibrate:
        row.update(_calibration(trainer.net, X_cal, y_cal, X_te, y_te, eval_samples, device))
    if hmc:
        row["hmc"] = hmc_check(trainer.net, X_tr[:256], y_tr[:256], device=device)
    return row, trainer, logs


def main(argv=None):
    """Runs on ``cuda:0`` (``--cpu``: on the CPU); returns :func:`run`'s
    ``(row, trainer, logs)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", choices=DATA, default="auto",
                    help="auto: MNIST IDX files if present, else scikit-learn's digits (else "
                    "synthetic where scikit-learn is missing); digits, wine and breast_cancer "
                    "need scikit-learn, which the machine with the card lacks: run them with --cpu")
    ap.add_argument("--require-mnist", action="store_true",
                    help="with --data auto, fail when the MNIST files are missing")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--epochs1", type=int, default=2)
    ap.add_argument("--epochs2", type=int, default=18)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--train-samples", type=int, default=1)
    ap.add_argument("--eval-samples", type=int, default=16)
    ap.add_argument("--lambda-hidden", type=float, default=3.0)
    ap.add_argument("--lambda-last", type=float, default=1.0)
    ap.add_argument("--bias", action="store_true", help="deterministic bias on every WHVI layer")
    ap.add_argument("--calibrate", action="store_true",
                    help="hold 10%% of train out, fit a softmax logit temperature on it, report "
                    "test NLL/ECE raw vs tempered")
    ap.add_argument("--hmc", action="store_true", help="golden-sampler check (4-chain NUTS)")
    ap.add_argument("--subset", type=int, default=0, help="train subset size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        header("run_mnist")
        device = torch.device("cuda", 0)
    row, trainer, logs = run(
        device=device, data=args.data, width=args.width,
        epochs1=args.epochs1, epochs2=args.epochs2, batch=args.batch,
        train_samples=args.train_samples, eval_samples=args.eval_samples,
        lambda_hidden=args.lambda_hidden, lambda_last=args.lambda_last, bias=args.bias,
        subset=args.subset, seed=args.seed, require_mnist=args.require_mnist,
        calibrate=args.calibrate, hmc=args.hmc, log_fn=emit,
    )
    emit(row)
    return row, trainer, logs


if __name__ == "__main__":
    main()
