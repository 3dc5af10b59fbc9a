"""The UCI protocol on one NVIDIA H100: replica-stacked against sequential.

    python -m whvi_tpu_torch.bench.protocol_bench [--epochs1 50]
        [--epochs2 450] [--splits 8] [--seed 0] [--profile-steps 30]
        [--stacked-only]

On Boston-shaped synthetic data (506 x 13: a fixed random ReLU net of the
features plus noise, made with numpy from ``--seed``), the protocol's
flagship (``ProtocolConfig``'s defaults: 13 -> 128 -> 128 -> 1, batch 64,
1 training sample, 64 eval samples) runs ``--splits`` splits for
``--epochs1`` + ``--epochs2`` epochs twice through
``evaluate_bayesian_regression``: stacked (one fit, the splits as
replicas) and, unless ``--stacked-only`` (the full protocol's 8
sequential fits take hours), sequential (one fit a split). The kernels
are built (or loaded) before either, so no fit's time holds the build.
Then ``--profile-steps`` warm
train steps of the stacked net and of one split run under
``torch.profiler``: the device's own events' time over the window's
host-clock time is its busy share (``utils.profiling.device_profile``).

Output: the first line names the card and its power limit; then one JSON
row a protocol run (wall seconds, warm ms a train step from the fit's
chunk logs, epochs/s amortized a split, RMSE and predictive MNLL) and one
a profiled window (ms a step, kernel ms a step, busy share, launches of
the port's kernels a step). :func:`run` takes its device; :func:`main`
refuses to run without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.evaluation import ProtocolConfig, evaluate_bayesian_regression
from whvi_tpu_torch.ops import fwht_cuda
from whvi_tpu_torch.utils.profiling import device_profile

__all__ = ["boston_like", "main", "profile_steps", "run"]


def boston_like(seed: int = 0, n: int = 506, d: int = 13):
    """``(X (n, d), y (n, 1))`` float32: standard normal features, ``y`` a
    fixed random ReLU net of them plus noise of 0.3 of its sd."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    f = np.maximum(X @ rng.randn(d, 32) / np.sqrt(d), 0.0) @ rng.randn(32, 1) / np.sqrt(32)
    y = f + 0.3 * f.std() * rng.randn(n, 1)
    return X.astype(np.float32), y.astype(np.float32)


def _warm_ms_a_step(chunks: list, steps_per_epoch: int) -> float | None:
    """ms a train step over the chunks after a fit's first (the build and
    first launches excluded), from their ``seconds`` and ``epoch``."""
    if len(chunks) < 2:
        return None
    epochs = chunks[-1]["epoch"] - chunks[0]["epoch"]
    return (chunks[-1]["seconds"] - chunks[0]["seconds"]) / (epochs * steps_per_epoch) * 1e3


def profile_steps(trainer, state, X, Y, steps: int) -> dict:
    """ms a train step (host clock, synchronized), kernel ms a step, busy
    share and host ms in ``Optimizer.step`` from
    :func:`~whvi_tpu_torch.utils.profiling.device_profile` over ``steps``
    warm steps on the batch ``X``, ``Y``, and the port's kernel launches a
    step."""
    w = torch.ones(X.shape[-2], device=X.device)
    for _ in range(5):
        trainer.train_step(state, X, Y, 455, True, weights=w)
    torch.cuda.synchronize()
    fwht_cuda.reset_launches()

    def window():
        for _ in range(steps):
            trainer.train_step(state, X, Y, 455, True, weights=w)

    p = device_profile(window)
    return {
        "ms_a_step_profiled": p["wall_s"] / steps * 1e3,
        "kernel_ms_a_step": p["device_us"] / steps / 1e3,
        "busy_share": p["busy_share"],
        "device_events_a_step": p["device_events"] / steps,
        "optimizer_host_ms_a_step": p["optimizer_host_us"] / steps / 1e3,
        "port_launches_a_step": {k: v / steps for k, v in fwht_cuda.LAUNCHES.items() if v},
    }


def run(
    *, device, epochs1: int = 50, epochs2: int = 450, splits: int = 8, seed: int = 0,
    profile: int = 30, stacked_only: bool = False, card: str = "cpu",
) -> list[dict]:
    """The stacked and the sequential protocol on ``device``, then (on a
    card) the profiled windows; returns the rows."""
    device = torch.device(device)
    if device.type == "cuda":
        fwht_cuda.load_library()  # builds the kernels if they are missing or stale
    X, y = boston_like(seed)
    cfg = ProtocolConfig(n_splits=splits, epochs1=epochs1, epochs2=epochs2,
                         epochs_per_call=max(1, (epochs1 + epochs2) // 10), seed=seed)
    n_tr = X.shape[0] - max(1, int(round(X.shape[0] * cfg.test_frac)))
    steps_per_epoch = -(-n_tr // cfg.batch_size)
    rows = []
    for stacked in (True,) if stacked_only else (True, False):
        chunks: list = []
        t0 = time.time()
        out = evaluate_bayesian_regression(
            X, y, dataclasses.replace(cfg, vmap_splits=stacked), device=device,
            log_fn=lambda e: chunks.append(e) if "phase" in e else None,
        )
        wall = time.time() - t0
        # the sequential fits log one run of chunks each: warm ms from the last
        per_fit = len(chunks) // (1 if stacked else splits)
        rows.append(emit({
            "bench": "protocol", "path": "stacked" if stacked else "sequential",
            "splits": splits, "epochs": epochs1 + epochs2, "steps_per_epoch": steps_per_epoch,
            "wall_s": wall,
            "fit_s": out["protocol_wall_s"] if stacked else sum(r["wall_s"] for r in out["splits"]),
            "warm_ms_a_step": _warm_ms_a_step(chunks[-per_fit:], steps_per_epoch),
            "epochs_per_s_amortized": (epochs1 + epochs2) * splits / (
                out["protocol_wall_s"] if stacked else sum(r["wall_s"] for r in out["splits"])),
            "rmse_mean": out["rmse_mean"], "pred_mnll_per_point_mean": out["pred_mnll_per_point_mean"],
            "coverage95_mean": out["coverage95_mean"], "card": card, "device": device_name(device),
        }))
    if profile and device.type == "cuda":
        from whvi_tpu_torch.evaluation import _build_net
        from whvi_tpu_torch.train import TrainConfig, Trainer

        rng = np.random.RandomState(seed + 1)
        Xb = torch.from_numpy(rng.randn(splits, 64, 13).astype(np.float32)).to(device)
        Yb = torch.from_numpy(rng.randn(splits, 64, 1).astype(np.float32)).to(device)
        for replicas in (splits, None):
            trainer = Trainer(_build_net(cfg, 13, 1), TrainConfig(), device=device,
                              replicas=replicas)
            state = trainer.init(list(range(splits)) if replicas else 0)
            x, yb = (Xb, Yb) if replicas else (Xb[0], Yb[0])
            rows.append(emit({
                "bench": "profiled train steps", "replicas": replicas, "steps": profile,
                **profile_steps(trainer, state, x, yb, profile), "card": card,
                "device": device_name(device),
            }))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs1", type=int, default=50)
    ap.add_argument("--epochs2", type=int, default=450)
    ap.add_argument("--splits", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=30)
    ap.add_argument("--stacked-only", action="store_true")
    args = ap.parse_args(argv)
    card = header("protocol_bench")["card"]
    return run(device=torch.device("cuda", 0), epochs1=args.epochs1, epochs2=args.epochs2,
               splits=args.splits, seed=args.seed, profile=args.profile_steps,
               stacked_only=args.stacked_only, card=card)


if __name__ == "__main__":
    main()
