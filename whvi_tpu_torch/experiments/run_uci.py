"""UCI regression experiments on one NVIDIA H100: the reference's
per-dataset runners.

Counterpart of ``experiments/run_uci.py``::

    python -m whvi_tpu_torch.experiments.run_uci yacht [--cpu]
        [--splits 8] [--epochs1 500] [--epochs2 50000] [--grid JSON] ...
    python -m whvi_tpu_torch.experiments.run_uci --list

One CLI for run_boston, run_concrete, run_energy, run_yacht, run_kin8nm,
run_naval (and protein, diabetes, linnerud) with the reference protocol's
defaults (8 x 90/10 splits, the 128-128 ReLU WHVI MLP, 500 + 50000
epochs) through :func:`whvi_tpu_torch.evaluation.evaluate_bayesian_regression`,
or a whole grid of configurations through ``evaluate_config_grid``. The
files are read from ``$WHVI_DATA_DIR`` or ``<repo>/data/``
(:mod:`whvi_tpu_torch.data.uci`).

Every flag of the JAX script but ``--prng`` (a JAX key implementation).
The splits train as one replica-stacked fit unless
``--sequential-splits``. It runs on the card, and without one refuses,
unless ``--cpu`` asks for the CPU.

Output: the first line names the card and its power limit (or the CPU);
then, unless ``--quiet``, one JSON line per chunk of epochs and per
split; the last line is the aggregate without the per-split rows, plus
``dataset`` and ``device``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.data.uci import UCI_DATASETS, dataset_info, load_uci
from whvi_tpu_torch.evaluation import (
    ProtocolConfig,
    evaluate_bayesian_regression,
    evaluate_config_grid,
)

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", nargs="?", choices=sorted(UCI_DATASETS))
    ap.add_argument("--list", action="store_true", help="show availability")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--splits", type=int, default=8)
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default checkpoints/torch/<dataset>)")
    ap.add_argument("--s-init", default="auto")
    ap.add_argument("--kl-warmup-frac", type=float, default=0.2)
    ap.add_argument("--heteroscedastic", action="store_true",
                    help="input-dependent noise head (BASELINE protein/kin8nm config)")
    ap.add_argument("--normalize-y", action="store_true")
    ap.add_argument("--lambda-hidden", type=float, default=3.0,
                    help="prior variance of the hidden WHVI layers (protocol 3.0)")
    ap.add_argument("--lambda-last", type=float, default=1e-5,
                    help="prior variance of the mean output head (protocol 1e-5)")
    ap.add_argument("--lambda-noise", type=float, default=1.0,
                    help="prior variance of the heteroscedastic noise branch")
    ap.add_argument("--noise-freeze-frac", type=float, default=0.5,
                    help="share of training with the noise branch frozen at its "
                    "sigma0 init (heteroscedastic only)")
    ap.add_argument("--sigma0", type=float, default=1.0)
    ap.add_argument("--hidden", type=int, nargs="*", default=[128, 128])
    ap.add_argument("--train-samples", type=int, default=1)
    ap.add_argument("--per-example-noise", action="store_true")
    ap.add_argument("--column-lrt", action="store_true",
                    help="per-example LRT on column-shaped heads (needs --per-example-noise)")
    ap.add_argument("--rect-mode", choices=["stack", "pad"], default="stack",
                    help="non-square layer construction (pad = one full-mixing block)")
    ap.add_argument("--bias", action="store_true",
                    help="deterministic bias on every WHVI layer")
    ap.add_argument("--ignore-kl", action="store_true", help="drop the KL term")
    ap.add_argument("--reference-exact", action="store_true",
                    help="the reference's exact protocol settings: s_init=0.01, no KL "
                    "warm-up, sigma0=1, stacked non-square layers, 1 train sample, "
                    "shared batch noise, no bias (X stays standardized per split, "
                    "as the JAX script leaves it)")
    ap.add_argument("--calibrate", action="store_true",
                    help="hold --calib-frac of each train split out, fit a predictive-"
                    "variance temperature on it, report tempered coverage")
    ap.add_argument("--calib-frac", type=float, default=0.1)
    ap.add_argument("--calib-mode", choices=["quantile", "nll"], default="quantile")
    ap.add_argument("--calib-pooled", action="store_true",
                    help="one temperature on all splits' pooled calibration z-scores")
    ap.add_argument("--grid", default=None,
                    help="JSON list of config-override dicts, run as one stacked fit "
                    "(keys: sigma0, lambda_hidden, lambda_last, lambda_noise, "
                    "kl_warmup_frac, noise_freeze_frac, seed)")
    ap.add_argument("--sequential-splits", action="store_true",
                    help="train the splits one after another instead of as one "
                    "replica-stacked fit")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _config(args) -> ProtocolConfig:
    if args.reference_exact:
        args.s_init = "0.01"
        args.kl_warmup_frac = 0.0
        args.sigma0 = 1.0
        args.rect_mode = "stack"
        args.train_samples = 1
        args.per_example_noise = False
        args.column_lrt = False
        args.bias = False
        args.normalize_y = False
        args.heteroscedastic = False
    return ProtocolConfig(
        n_splits=args.splits,
        epochs1=args.epochs1,
        epochs2=args.epochs2,
        batch_size=args.batch,
        seed=args.seed,
        s_init=args.s_init if args.s_init == "auto" else float(args.s_init),
        kl_warmup_frac=args.kl_warmup_frac,
        lambda_hidden=args.lambda_hidden,
        lambda_last=args.lambda_last,
        lambda_noise=args.lambda_noise,
        noise_freeze_frac=args.noise_freeze_frac,
        heteroscedastic=args.heteroscedastic,
        normalize_y=args.normalize_y,
        sigma0=args.sigma0,
        hidden=tuple(args.hidden),
        train_samples=args.train_samples,
        per_example_noise=args.per_example_noise,
        column_lrt=args.column_lrt,
        rect_mode=args.rect_mode,
        bias=args.bias,
        ignore_kl=args.ignore_kl,
        vmap_splits=False if args.sequential_splits else "auto",
        calibrate=args.calibrate,
        calib_frac=args.calib_frac,
        calib_mode=args.calib_mode,
        calib_pooled=args.calib_pooled,
    )


def main(argv=None) -> dict | None:
    """Run one dataset's protocol (or grid); returns its last line's dict."""
    args = parser().parse_args(argv)
    if args.list or not args.dataset:
        for name in sorted(UCI_DATASETS):
            emit(dataset_info(name))
        return None
    if args.cpu:
        device = torch.device("cpu")
        emit({"tool": "run_uci", "device": "cpu", "torch": torch.__version__})
    else:
        header("run_uci")
        device = torch.device("cuda", 0)
    X, y = load_uci(args.dataset)
    cfg = _config(args)
    log_fn = None if args.quiet else emit
    ckpt_dir = args.ckpt_dir or os.path.join("checkpoints", "torch", args.dataset)
    if args.grid is not None:
        out = evaluate_config_grid(
            X, y, cfg, json.loads(args.grid), ckpt_dir=ckpt_dir, log_fn=log_fn, device=device
        )
        for c in out["configs"]:
            c.pop("splits", None)
    else:
        out = evaluate_bayesian_regression(
            X, y, cfg, ckpt_dir=ckpt_dir, log_fn=log_fn, device=device
        )
        out.pop("splits")
    out["dataset"] = args.dataset
    out["device"] = device_name(device)
    return emit(out)


if __name__ == "__main__":
    main()
