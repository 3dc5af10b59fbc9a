"""Large-D scaling on one NVIDIA H100: ELBO steps/s (or predictive calls/s)
of a wide WHVI MLP against D.

Counterpart of ``experiments/run_scaling.py`` on one card::

    python -m whvi_tpu_torch.experiments.run_scaling [--sizes 1024 4096 8192]
        [--batch 256] [--samples 8] [--steps 50] [--repeats 1] [--predict]
        [--precision fp32|bf16] [--dtype f32|bf16] [--profile N] [--seed 0]
        [--mesh DxS [--dist-backend nccl|gloo] | --force-cpu-devices N]
    torchrun --nproc-per-node N -m whvi_tpu_torch.experiments.run_scaling --mesh DxS

Model (``run_scaling.py:114-123``): ``WHVILinear(D, D, lambda_=3.0,
s_init="auto")``, relu, the same again, relu, ``WHVILinear(D, 1,
s_init="auto")``, with ``train_samples = --samples``; random weights from
``--seed``. Data: ``X (batch, D)`` and ``y (batch, 1)`` standard normal
from ``np.random.RandomState(--seed)``.

``--dtype`` (``run_scaling.py:69-78``) is the storage of the parameters,
the data, the activations and Adam's state. ``bf16`` is the JAX
``--dtype bf16`` with ``--backend xla``: every whvi_mul and the column
head's FWHT read and write bf16 (K1-K4's bf16-storage entries), each op
rounding to bf16 and each transform summing in fp32; Adam is optax's, op
for op in bf16 (``train.OptaxAdam``). The data are rounded from numpy's
float64 to bf16 as ``jnp.asarray(rng.randn(..), jnp.bfloat16)`` rounds
them (through float32). ``--dtype bf16 --precision bf16`` raises: the
JAX Pallas kernels cannot store bf16, so ``--backend pallas --dtype
bf16`` crashes there.

- Training: ``Trainer.train_step`` with ``n = batch``, the likelihood
  trained, the default ``TrainConfig`` and its decayed Adam.
- Predict (``--predict``): ``net.predict(X, samples)`` under ``no_grad``.

``--precision`` sets :func:`~whvi_tpu_torch.ops.set_whvi_mul_precision`
for the run. ``bf16`` computes what the JAX script computes with
``--backend pallas``: its samples are vmapped, so every square product
has ``(D,)`` diagonals and reaches the Pallas kernel in its default
``precision="bf16"``. ``fp32`` is the JAX ``--backend xla --precision
highest``. The column head's FWHT is fp32 in both, as in JAX.

Timing, as the JAX script's: a warm-up of ``--steps`` steps (on a card,
repeated for ``WARM_S`` seconds: an idle card sits at a low clock and
ramps up under load), then per repeat runs of N and of 2N steps (calls),
each ending in a host fetch of the last loss (of the summed predictions),
which waits for the card; ``dt = (t(2N) - t(N)) / N`` cancels the fixed
cost of a run. The loop is eager Python on a host whose cores are
shared, so t(N) and t(2N) are each the least of ``TRIALS`` runs, taken in
turns (N, 2N, N, 2N, ...) so that a slow spell of the host or the card
falls on both; a repeat whose 2N runs are still no slower than its N runs
raises rather than print a meaningless rate.

Output: the first line names the card and its power limit (``bench``'s
header); then one JSON row per repeat, with the JAX keys that apply
(``D, batch, mc_samples, precision, dtype``, then ``step_ms, elbo_steps_per_s,
posterior_samples_per_s`` or ``mode, call_ms, pred_samples_per_s``),
``tflops`` and ``mfu``, plus ``device``, the last run's ``loss`` (or
``pred_mean``, its mean prediction) and ``max_memory_gb``, the card's
peak allocation over the run above what was allocated when it began
(``torch.cuda.max_memory_allocated``; null on the CPU). ``tflops`` is the JAX count (``elbo_step_flops`` of the two
square layers; ``S * 2 * whvi_mul_flops`` when predicting): the matmul
flops of the Kronecker formulation ``H_D = H_a (x) H_128``, which the
butterfly kernels do not perform. It is a flop-equivalent rate, so no
share of a peak is claimed: ``mfu`` is null.

``--profile N`` (not in the JAX script) adds to each row what
``torch.profiler`` reads over N more steps (calls) on the card:
``kernel_ms``, the device time a step; ``busy_share``, that over the
profiled window's host-clock time; ``device_events``, the device events
a step; ``top_kernels``, the ``TOP_KERNELS`` kernels with the most
device time, ms a step each; and ``optimizer_host_ms``, the host time a step
inside ``Optimizer.step`` (train only).

``--mesh DxS`` (``run_scaling.py:46``) runs the sharded step
(``parallel.make_sharded_train_step``, MC samples over S ranks, batch rows
over D) and predict (``parallel.make_sharded_predict``, each rank's block
left unsharded-unassembled, as JAX leaves it sharded) over a world of
``D * S`` ranks: the group it runs in (under ``torchrun``), a world of one
in this process for ``1x1``, or ranks it spawns, on the cards with
``--dist-backend nccl`` (the default, one card a rank) or ``gloo``
(ranks may share a card). ``--force-cpu-devices N`` spawns ``N`` gloo
ranks on the CPU, the counterpart of JAX's ``N`` virtual CPU devices.
Without ``--mesh`` the step is one device's ``Trainer.train_step``, as
before. Mesh rows add JAX's ``"mesh": {"data", "sample"}`` and the port's
``"backend"`` and ``"ranks_per_card"`` (null on the CPU); their times and
``max_memory_gb`` are rank 0's, and rank 0 prints. Not ported:
``--backend`` (replaced by ``--precision``) and ``--cpu`` (:func:`run`
takes its device; :func:`main` refuses to run without a card unless
``--force-cpu-devices`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from whvi_tpu_torch.bench.common import device_name, emit, header
from whvi_tpu_torch.models import WHVILinear, WHVIRegression, relu
from whvi_tpu_torch.ops import check_storage, get_whvi_mul_precision, set_whvi_mul_precision
from whvi_tpu_torch.parallel.distributed import init_distributed, rank_device, spawn
from whvi_tpu_torch.parallel.mesh import make_mesh, make_sharded_predict, make_sharded_train_step
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.utils.profiling import (
    device_profile,
    elbo_step_flops,
    require_cuda,
    whvi_mul_flops,
)

__all__ = [
    "DTYPES", "TRIALS", "WARM_S", "build_net", "data", "finite", "main", "profile", "run",
]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}  # --dtype


def build_net(D: int, samples: int, device=None, dtype=torch.float32):
    """The scaling model, ``D -> D -> D -> 1``, its parameters of ``dtype``
    on ``device``."""
    kw = dict(s_init="auto", device=device, dtype=dtype)
    return WHVIRegression(
        [
            WHVILinear(D, D, lambda_=3.0, **kw),
            relu,
            WHVILinear(D, D, lambda_=3.0, **kw),
            relu,
            WHVILinear(D, 1, **kw),
        ],
        train_samples=samples,
        device=device,
        dtype=dtype,
    )


def data(D: int, batch: int, seed: int, device, dtype=torch.float32):
    """``X (batch, D)``, ``y (batch, 1)`` standard normal, of ``dtype``:
    numpy's float64 draws rounded as ``jnp.asarray(.., dtype)`` rounds
    them (to float32, then to bf16)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(batch, D).astype(np.float32)
    y = rng.randn(batch, 1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in (X, y))


TRIALS = 3
WARM_S = 0.5  # seconds of warm-up steps on a card before timing
TOP_KERNELS = 6  # --profile: the kernels named, by device time


def profile(go, k: int) -> dict:
    """:func:`~whvi_tpu_torch.utils.profiling.device_profile` over
    ``go(k)``, a step (call) at a time: device ms and events, the busy
    share, the kernels with the most device time and host ms inside
    ``Optimizer.step``."""
    p = device_profile(lambda: go(k), TOP_KERNELS)
    return {
        "kernel_ms": p["device_us"] / k / 1e3,
        "top_kernels": [[name[:80], us / k / 1e3] for name, us in p["top"]],
        "busy_share": p["busy_share"],
        "device_events": p["device_events"] / k,
        "optimizer_host_ms": p["optimizer_host_us"] / k / 1e3,
    }


def _least_times(fn, k: int) -> tuple[float, float, float]:
    """The least seconds of ``TRIALS`` runs of ``fn(k)`` and of
    ``fn(2 * k)``, taken in turns (each ends in a host fetch), and the
    last run's value."""
    best = [math.inf, math.inf]
    for _ in range(TRIALS):
        for i, n in enumerate((k, 2 * k)):
            t0 = time.perf_counter()
            value = fn(n)
            best[i] = min(best[i], time.perf_counter() - t0)
    return best[0], best[1], value


def _closing_barrier(fn, mesh):
    """``fn(k)`` ending on every rank of ``mesh`` at once (a barrier), so
    that the next run starts on every rank together."""

    def run_k(k):
        value = fn(k)
        mesh.barrier()
        return value

    return run_k


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
    dtype: str = "f32",
    seed: int = 0,
    profile_steps: int = 0,
    mesh=None,
) -> list[dict]:
    """Train (or predict with) the scaling model at width ``D`` on
    ``device`` in storage ``dtype`` (``"f32"`` or ``"bf16"``); print and
    return one row per repeat, each with :func:`profile`'s reading of
    ``profile_steps`` more steps on a card. With a ``(data, sample)``
    ``mesh`` every rank calls this, the step and predict are the sharded
    ones, and rank 0 prints."""
    device = torch.device(device)
    storage = DTYPES[dtype]
    check_storage(precision, storage)
    previous = get_whvi_mul_precision()
    set_whvi_mul_precision(precision)
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)  # not this run's
        net = build_net(D, samples, dtype=storage)
        if mesh is None:
            trainer = Trainer(net, TrainConfig(), device=device)
            train_step, forward = trainer.train_step, lambda x, g: net.predict(x, samples, g)
        else:
            train_step = make_sharded_train_step(net, mesh, TrainConfig(), device=device)
            trainer, forward = train_step.trainer, make_sharded_predict(net, mesh, samples)
        state = trainer.init(seed)
        net = trainer.net
        X, y = data(D, batch, seed, device, storage)

        def agree(flag: bool) -> bool:  # every rank of a mesh takes one decision
            return flag if mesh is None else mesh.agree(flag)

        if predict:
            generator = torch.Generator(device=device).manual_seed(seed + 1)

            @torch.no_grad()
            def go(k):
                acc = torch.zeros((), device=device)  # float32: the sum of bf16 sums
                for _ in range(k):
                    acc += forward(X, generator).sum()
                if mesh is not None:  # the blocks' sums
                    mesh.all_reduce(acc)
                return float(acc) / (k * samples * batch)

            flops = samples * 2 * whvi_mul_flops(D, batch)
        else:

            def go(k):
                for _ in range(k):
                    metrics = train_step(state, X, y, batch, True)
                return float(metrics["loss"])

            flops = elbo_step_flops([D, D], batch, samples)

        if mesh is not None:
            go = _closing_barrier(go, mesh)
        end = time.perf_counter() + WARM_S
        go(steps)  # warm-up: the kernels' build and first launches
        while agree(device.type == "cuda" and time.perf_counter() < end):
            go(steps)
        rows = []
        for _ in range(repeats):
            t1, t2, value = _least_times(go, steps)
            if mesh is not None:  # the slowest rank's, the same on every rank
                t1, t2 = mesh.max([t1, t2])
            if t2 <= t1:
                raise RuntimeError(
                    f"{2 * steps} steps took no longer than {steps} "
                    f"({t2:.4f} s, {t1:.4f} s): host timing noise; raise --steps"
                )
            dt = (t2 - t1) / steps
            row = {
                "D": D, "batch": batch, "mc_samples": samples, "precision": precision,
                "dtype": dtype,
            }
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
            if mesh is not None:
                cards = torch.cuda.device_count() if device.type == "cuda" else 0
                local = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.size))
                row.update(
                    mesh={"data": mesh.shape["data"], "sample": mesh.shape["sample"]},
                    backend=mesh.backend,
                    ranks_per_card=-(-local // cards) if cards else None,
                )
            if profile_steps and device.type == "cuda":
                row.update(profile(go, profile_steps))
            row.update(
                tflops=flops / dt / 1e12,
                mfu=None,
                device=device_name(device),
                max_memory_gb=(
                    (torch.cuda.max_memory_allocated(device) - held) / 1e9
                    if device.type == "cuda" else None
                ),
            )
            rows.append(emit(row) if mesh is None or mesh.rank == 0 else row)
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
    ap.add_argument("--dtype", default="f32", choices=tuple(DTYPES),
                    help="storage of parameters, data, activations and Adam's "
                    "state (bf16: the JAX --dtype bf16 on --backend xla)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="add torch.profiler's reading of N more steps to each row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DxS",
                    help="shard the batch over D ranks and the MC samples over S")
    ap.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"),
                    help="the mesh's torch.distributed backend on the cards (nccl: one "
                    "card a rank; gloo: ranks may share a card)")
    ap.add_argument("--force-cpu-devices", type=int, default=0, metavar="N",
                    help="run the mesh as N gloo ranks on the CPU")
    args = ap.parse_args(argv)
    check_storage(args.precision, DTYPES[args.dtype])
    if args.mesh is None:
        if args.force_cpu_devices:
            ap.error("--force-cpu-devices needs --mesh")
        header("run_scaling")
        return _rows(torch.device("cuda", 0), args)
    d, s = (int(v) for v in args.mesh.split("x"))
    if args.force_cpu_devices:
        if args.force_cpu_devices != d * s:
            ap.error(f"--mesh {args.mesh} needs {d * s} ranks, not {args.force_cpu_devices}")
        kind, backend = "cpu", "gloo"
    else:
        require_cuda()
        kind, backend = "cuda", args.dist_backend
    if dist.is_initialized() or "RANK" in os.environ or d * s == 1:
        joined = dist.is_initialized()  # a group of the caller's, or torchrun's, or one here
        init_distributed(backend)
        try:
            return _mesh_rows(rank_device(kind), args, d, s)
        finally:
            if not joined:
                dist.destroy_process_group()
    return spawn(_mesh_rows, d * s, backend, kind, args, d, s)[0]


def _rows(device, args, mesh=None) -> list[dict]:
    rows = []
    for D in args.sizes:
        rows += run(
            D, device=device, batch=args.batch, samples=args.samples, steps=args.steps,
            repeats=args.repeats, predict=args.predict, precision=args.precision,
            dtype=args.dtype, seed=args.seed, profile_steps=args.profile, mesh=mesh,
        )
    return rows


def _mesh_rows(device, args, d: int, s: int) -> list[dict]:
    """One rank's rows over the ``d x s`` mesh (rank 0 prints the header)."""
    mesh = make_mesh(d, s)
    if mesh.rank == 0:
        if device.type == "cuda":
            header("run_scaling")
        else:
            emit({"tool": "run_scaling", "device": "cpu", "ranks": mesh.size})
    return _rows(device, args, mesh)


if __name__ == "__main__":
    main()
