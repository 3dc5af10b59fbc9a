"""Large-D scaling on one NVIDIA H100: ELBO steps/s (or predictive calls/s)
of a wide WHVI MLP against D.

Counterpart of ``experiments/run_scaling.py`` on one card::

    python -m whvi_tpu_torch.experiments.run_scaling [--sizes 1024 4096 8192]
        [--batch 256] [--samples 8] [--steps 50] [--repeats 1] [--predict]
        [--precision fp32|bf16] [--seed 0]

Model (``run_scaling.py:114-123``): ``WHVILinear(D, D, lambda_=3.0,
s_init="auto")``, relu, the same again, relu, ``WHVILinear(D, 1,
s_init="auto")``, with ``train_samples = --samples``; random weights from
``--seed``. Data: ``X (batch, D)`` and ``y (batch, 1)`` standard normal
from ``np.random.RandomState(--seed)``.

- Training: ``Trainer.train_step`` with ``n = batch``, the likelihood
  trained, the default ``TrainConfig`` and its decayed Adam.
- Predict (``--predict``): ``net.predict(X, samples)`` under ``no_grad``.

``--precision`` sets :func:`~whvi_tpu_torch.ops.set_whvi_mul_precision`
for the run. ``bf16`` computes what the JAX script computes with
``--backend pallas``: its samples are vmapped, so every square product
has ``(D,)`` diagonals and reaches the Pallas kernel in its default
``precision="bf16"``. ``fp32`` is the JAX ``--backend xla --precision
highest``. The column head's FWHT is fp32 in both, as in JAX.

Timing, as the JAX script's: a warm-up run of ``--steps`` steps, then per
repeat runs of N and of 2N steps (calls), each ending in a host fetch of
the last loss (of the summed predictions), which waits for the card;
``dt = (t(2N) - t(N)) / N`` cancels the fixed cost of a run. The loop is
eager Python on a host whose cores are shared, so t(N) and t(2N) are each
the least of ``TRIALS`` runs (one run of 2N steps can finish sooner than
one of N); a repeat whose 2N runs are still no slower than its N runs
raises rather than print a meaningless rate.

Output: the first line names the card and its power limit (``bench``'s
header); then one JSON row per repeat, with the JAX keys that apply
(``D, batch, mc_samples, precision``, then ``step_ms, elbo_steps_per_s,
posterior_samples_per_s`` or ``mode, call_ms, pred_samples_per_s``),
``tflops`` and ``mfu``, plus ``device`` and the last run's ``loss`` (or
``pred_mean``, its mean prediction). ``tflops`` is the JAX count (``elbo_step_flops`` of the two
square layers; ``S * 2 * whvi_mul_flops`` when predicting): the matmul
flops of the Kronecker formulation ``H_D = H_a (x) H_128``, which the
butterfly kernels do not perform. It is a flop-equivalent rate, so no
share of a peak is claimed: ``mfu`` is null.

Not ported: ``--mesh`` and ``--force-cpu-devices`` (one card; the sharded
step waits for the ``parallel/`` port), ``--dtype bf16`` (the kernels take
fp32 storage), ``--backend`` (replaced by ``--precision``) and ``--cpu``
(:func:`run` takes its device; :func:`main` refuses to run without a
card).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import emit, header
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu
from whvi_tpu_torch.ops import get_whvi_mul_precision, set_whvi_mul_precision
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.utils.profiling import elbo_step_flops, whvi_mul_flops

__all__ = ["TRIALS", "build_net", "data", "finite", "main", "run"]


def build_net(D: int, samples: int, device=None):
    """The scaling model, ``D -> D -> D -> 1``, on ``device``."""
    return WHVIRegression(
        [
            WHVILinear(D, D, lambda_=3.0, s_init="auto", device=device),
            relu,
            WHVILinear(D, D, lambda_=3.0, s_init="auto", device=device),
            relu,
            WHVILinear(D, 1, s_init="auto", device=device),
        ],
        train_samples=samples,
    )


def data(D: int, batch: int, seed: int, device):
    """``X (batch, D)``, ``y (batch, 1)`` standard normal, float32."""
    rng = np.random.RandomState(seed)
    X = rng.randn(batch, D).astype(np.float32)
    y = rng.randn(batch, 1).astype(np.float32)
    return torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)


TRIALS = 3


def _least_time(fn, k: int) -> tuple[float, float]:
    """The least seconds of ``TRIALS`` runs of ``fn(k)``, which ends in a
    host fetch, and the last run's value."""
    best = math.inf
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        value = fn(k)
        best = min(best, time.perf_counter() - t0)
    return best, value


def run(
    D: int,
    *,
    device,
    batch: int = 256,
    samples: int = 8,
    steps: int = 50,
    repeats: int = 1,
    predict: bool = False,
    precision: str = "fp32",
    seed: int = 0,
) -> list[dict]:
    """Train (or predict with) the scaling model at width ``D`` on
    ``device``; print and return one row per repeat."""
    device = torch.device(device)
    previous = get_whvi_mul_precision()
    set_whvi_mul_precision(precision)
    try:
        trainer = Trainer(build_net(D, samples), TrainConfig(), device=device)
        state = trainer.init(seed)
        net = trainer.net
        X, y = data(D, batch, seed, device)

        if predict:
            generator = torch.Generator(device=device).manual_seed(seed + 1)

            @torch.no_grad()
            def go(k):
                acc = torch.zeros((), device=device)
                for _ in range(k):
                    acc += net.predict(X, samples, generator).sum()
                return float(acc) / (k * samples * batch)

            flops = samples * 2 * whvi_mul_flops(D, batch)
        else:

            def go(k):
                for _ in range(k):
                    metrics = trainer.train_step(state, X, y, batch, True)
                return float(metrics["loss"])

            flops = elbo_step_flops([D, D], batch, samples)

        go(steps)  # warm-up: the kernels' build and first launches
        rows = []
        for _ in range(repeats):
            t1, _ = _least_time(go, steps)
            t2, value = _least_time(go, 2 * steps)
            if t2 <= t1:
                raise RuntimeError(
                    f"{2 * steps} steps took no longer than {steps} "
                    f"({t2:.4f} s, {t1:.4f} s): host timing noise; raise --steps"
                )
            dt = (t2 - t1) / steps
            row = {"D": D, "batch": batch, "mc_samples": samples, "precision": precision}
            if predict:
                row.update(
                    mode="predict",
                    call_ms=dt * 1e3,
                    pred_samples_per_s=samples * batch / dt,
                    pred_mean=value,
                )
            else:
                row.update(
                    step_ms=dt * 1e3,
                    elbo_steps_per_s=1.0 / dt,
                    posterior_samples_per_s=samples * batch / dt,
                    loss=value,
                )
            row.update(
                tflops=flops / dt / 1e12,
                mfu=None,
                device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            )
            rows.append(emit(row))
        return rows
    finally:
        set_whvi_mul_precision(previous)


def finite(row: dict) -> bool:
    """True when every number of a row is finite."""
    return all(
        math.isfinite(v) for v in row.values() if isinstance(v, (int, float))
    )


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[1024, 4096, 8192])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--samples", type=int, default=8, help="MC samples")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--predict", action="store_true",
                    help="time posterior-predictive calls instead of train steps")
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"),
                    help="operand precision of every whvi_mul (bf16: the JAX "
                    "--backend pallas kernels' default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    header("run_scaling")
    rows = []
    for D in args.sizes:
        rows += run(
            D, device=torch.device("cuda", 0), batch=args.batch,
            samples=args.samples, steps=args.steps, repeats=args.repeats,
            predict=args.predict, precision=args.precision, seed=args.seed,
        )
    return rows


if __name__ == "__main__":
    main()
