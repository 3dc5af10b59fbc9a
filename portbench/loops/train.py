"""The ``train`` loop: ``Trainer.train_step`` back to back on
device-resident batches, the loss read to the host once a chunk of steps,
as the port's ``run_epochs`` and ``fit`` read it.

A mix of this kind gives ``batches`` (the pool of distinct batches the
steps cycle through), ``check_steps`` (the first steps, made in set-up
through the window's own call and followed by the reference),
``chunk_steps``, ``warm_s`` (warm-up after the checked steps),
``trace_units`` (the steps under the profiler), and optionally ``mesh``
(``{"data", "sample"}``: the sharded step, one rank a card) and ``state``
(where the parameters start; the WHVI initialisation without it).

``train_samples_per_s`` is batch rows times MC samples times the steps of
the window over the window, which ends in a host read of the loss.
``correct``: each checked step's loss, mnll and kl against the
reference's (relative gaps, the worst step's), the first gradient as
Adam's state holds it and the parameters' change over the checked steps
(the worst leaf's gap of norms, :func:`portbench.harness.leaf_gap`);
leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import counts, data, harness, program, trace
from portbench.reference import adam_steps, layer_specs, reference_grads

# Adam's constants in the port's decayed_adam, which TrainConfig leaves as they are
ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


class _TrainLoop:
    """The train window's unit: one step on the next batch of the pool,
    with noise drawn from the harness's generator."""

    def __init__(self, cell, seed, device, mesh):
        cfg, traffic = cell.config, cell.traffic
        from whvi_tpu_torch.train import TrainConfig, Trainer

        self.device, self.mesh = device, mesh
        self.specs = layer_specs(cfg)
        dtype = program.dtype_of(cfg)
        self.gen = torch.Generator(device=device).manual_seed(seed % 2**64)
        self.params0 = cell.make_params(
            self.specs, self.gen, device, dtype, traffic.get("state")
        )
        # a mesh's samples are its chips' shares together
        self.S = cfg["train_samples"] * (1 if mesh is None else mesh.shape["sample"])
        self.net = program.build_net(cfg, cell.likelihood, device, train_samples=self.S)
        opt = cfg["optimizer"]
        self.trainer = Trainer(
            self.net, TrainConfig(lr0=opt["lr0"], gamma=opt["gamma"], p=opt["p"]),
            device=device, mesh=mesh,
        )
        self.state = self.trainer.init(seed % 2**63)
        program.load_params(self.net, self.params0)
        self.X, self.Y = data.make_rows(
            cfg["data"], (traffic["batches"], cfg["batch"]), self.gen, device, dtype
        )
        self.n, self.width = cfg["n"], harness.noise_width(self.specs)
        self.dtype, self.k = dtype, 0

    def step(self):
        flat = torch.randn(self.S, self.width, generator=self.gen, device=self.device, dtype=self.dtype)
        eps = harness.noise_views(self.specs, flat)
        b = self.k % self.X.shape[0]
        metrics = self.trainer.train_step(self.state, self.X[b], self.Y[b], self.n, True, eps=eps)
        self.k += 1
        return metrics, eps

    def chunk(self, steps: int) -> float:
        for _ in range(steps):
            metrics, _ = self.step()
        return float(metrics["loss"])  # the chunk's one host read

    def stop(self, flag: bool) -> bool:
        return flag if self.mesh is None else self.mesh.agree(flag)


def run(cell, seed, seconds, want_trace, device, mesh, t_start):
    """One run of a train mix; the harness turns what it returns into the
    result's line (None on a mesh's ranks other than 0)."""
    cfg, traffic = cell.config, cell.traffic
    phases = {"entered": time.perf_counter() - t_start}
    loop = _TrainLoop(cell, seed, device, mesh)
    harness.sync(device)
    phases["built"] = time.perf_counter() - t_start
    # the first steps: set-up, and what the reference follows
    fed, prog_losses, first_grad = [], [], None
    for k in range(traffic["check_steps"]):
        b = k % loop.X.shape[0]
        metrics, eps = loop.step()
        fed.append((loop.X[b].clone(), loop.Y[b].clone(), [None if e is None else e.clone() for e in eps]))
        prog_losses.append(tuple(float(metrics[key]) for key in ("loss", "mnll", "kl")))
        if k == 0:
            opt_state = loop.state.optimizer.state
            first_grad = {
                key: opt_state[p]["exp_avg"] / (1 - ADAM["b1"]) if p in opt_state
                else torch.zeros_like(p)
                for key, p in program.param_map(loop.net).items()
            }
    params_after = program.read_params(loop.net)
    phases["first_steps"] = time.perf_counter() - t_start
    chunk = traffic["chunk_steps"]
    end = time.perf_counter() + traffic["warm_s"]
    while not loop.stop(time.perf_counter() >= end):
        loop.chunk(chunk)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    # the measured window
    steps, failed, t0 = 0, 0, time.perf_counter()
    while True:
        loss = loop.chunk(chunk)
        steps += chunk
        failed += 0 if math.isfinite(loss) else chunk
        if loop.stop(time.perf_counter() - t0 >= seconds):
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    if mesh is not None:
        peak = int(mesh.max([float(peak)])[0])
    rows_samples = cfg["batch"] * loop.S
    out = {
        "attempted": steps, "failed": failed, "peak": peak, "phases": phases,
        "e2e": {"train_samples_per_s": counts.rate(steps, rows_samples, window_s),
                "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s},
        "unit_s": window_s / steps,
        "flops_per_unit": counts.train_step_flops(loop.specs, cfg["batch"], loop.S),
    }
    if want_trace:
        units, launched = traffic["trace_units"], program.launches()
        with trace.profiled(lambda: harness.sync(device)) as prof:
            loop.chunk(units)
        t = out["trace"] = trace.reduce_profile(prof["prof"])
        trace.check_complete(t, program.launches() - launched)
        t["units"] = units
        if mesh is not None:  # busy and window averaged over the chips
            both = torch.tensor([t["busy_s"], t["window_s"]], dtype=torch.float64, device=device)
            t["busy_s"], t["window_s"] = (mesh.all_reduce(both) / mesh.size).tolist()
    if mesh is not None and mesh.rank != 0:
        return None
    if want_trace:  # at a chip's share of the samples
        out["whvi_op"] = harness.whvi_op_time(
            cfg, loop.specs, cfg["batch"], cfg["train_samples"], True, device
        )
    specs, params0 = loop.specs, loop.params0
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["values"], out["worst_leaf"] = check(
        cell, specs, params0, fed, prog_losses, first_grad, params_after
    )
    return out


def check(cell, specs, params0, fed, prog_losses, first_grad, params_after):
    """The reference's first steps from ``params0`` on the fed batches and
    noise, against the program's: each step's loss, mnll and kl (relative
    gaps, the worst step), the first gradient's leaves and the change of
    the parameters over the steps (the worst leaf's gap of norms)."""
    cfg = cell.config
    block = harness.reference_block(specs, cfg["batch"])
    params0, first_grad, params_after = (
        harness.float32(p) for p in (params0, first_grad, params_after)
    )

    def grad_fn(p, k):
        x, y, eps = fed[k]
        eps = [None if e is None else e.float() for e in eps]
        return reference_grads(cell.reference_likelihood, cfg, specs, p, x.float(), y.float(),
                               eps, cfg["n"], block)

    with harness.no_tf32():
        ref_losses, ref_first, ref_after = adam_steps(
            params0, grad_fn, len(fed), {**cfg["optimizer"], **ADAM}
        )
    values = {}
    for j, name in enumerate(("loss", "mnll", "kl")):
        values[f"{name}_gap"] = max(
            abs(p[j] - r[j]) / abs(r[j]) for p, r in zip(prog_losses, ref_losses)
        )
    keys = sorted(params0)
    values["grad_gap"], worst_grad = harness.leaf_gap(first_grad, ref_first, keys)
    norms = {k: float(torch.linalg.vector_norm(ref_first[k])) for k in keys}
    median = statistics.median(norms.values())
    moved = [k for k in keys if norms[k] >= 1e-3 * median]  # leaves Adam moves by more than round-off
    prog_change = {k: params_after[k] - params0[k] for k in moved}
    ref_change = {k: ref_after[k] - params0[k] for k in moved}
    values["change_gap"], worst_change = harness.leaf_gap(prog_change, ref_change, moved)
    left_out = sorted(set(keys) - set(moved))
    return values, {"grad_gap": worst_grad, "change_gap": worst_change, "left_out": left_out}
