"""What the port's tracing costs, and how long the host takes to issue a
unit of work beside the device's time for it: a benchmark cell's unit (a
train step, a test-set score, a predictive call) timed in turns with
spans off, under ``utils.profiling.recording()``, under ``torch.profiler``
(as the benchmark's traced window takes it), and under ``recording()``
with the device waited for after every unit (``issue``).

Each cell of the checkout's ``BENCHMARK.json`` (one-card cells; the
harness in ``portbench/`` builds its net, parameters and data from
``--seed``) is warmed, then run for ``--seconds`` in each mode, ``--rounds``
times, the order of the modes reversed every round. One JSON row a cell,
mode and round:

- ``units_per_s``: units over the mode's host-clock time, which ends in a
  synchronize (train steps run in the loop's chunks, the loss read once a
  chunk, as the benchmark's window runs them);
- under ``recording``, ``profiler`` and ``issue``: ``spans_ms``, each
  span's ``[inclusive, self]`` host milliseconds a unit, and ``launches``,
  the port's kernel launches a unit (``span_summary``). Where the device
  sets the pace, the host waits inside its spans once the launch queue is
  full, so their times then read the device's pace; ``issue`` starts each
  unit on an idle device with an empty queue, so they read what the host
  itself takes to issue it;
- under ``profiler``: ``device_busy_ms``, the union of the device's events
  a unit, ``idle_share`` and ``idle_gaps`` (``portbench.trace``'s
  reduction: a gap is named by the host span or op running at its middle).

The first line names the card and its power limit. Run from the root of a
checkout, on a card:

    python -m tools.span_cost [--cells c5-largeD.train c4-mnist.eval] [--seconds 5] [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import data, harness, program, trace
from portbench.reference import layer_specs
from whvi_tpu_torch.utils import profiling

MODES = ("off", "recording", "profiler", "issue")


def unit_of(cell, seed: int, device):
    """``(run, units, one)``: a call issuing ``units`` of the cell's units
    as its loop issues them, and a call issuing one."""
    if cell.traffic["kind"] == "train":
        loop = cell.loop._TrainLoop(cell, seed, device, None)
        steps = cell.traffic["chunk_steps"]
        return (lambda: loop.chunk(steps)), steps, loop.step
    cfg, traffic, lik = cell.config, cell.traffic, cell.likelihood
    specs, dtype = layer_specs(cfg), program.dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    net = program.build_net(cfg, lik, device)
    program.load_params(net, cell.make_params(specs, gen, device, dtype, traffic.get("state")))
    rows, S = cfg["eval_rows"], cfg["eval_samples"]
    chunk = traffic.get("chunk_rows", rows)
    X, _ = data.make_rows(cfg["data"], (rows,), gen, device, dtype)
    flat = torch.randn(S, harness.noise_width(specs), generator=gen, device=device, dtype=dtype)
    eps = harness.noise_views(specs, flat)

    def score():
        for a in range(0, rows, chunk):
            with torch.no_grad():
                lik.answer(net.likelihood.predict(net.predict(X[a : a + chunk], S, eps=eps)))

    return score, 1, score


def timed(run, units: int, seconds: float, device) -> tuple[int, float]:
    """Units issued and host seconds, ``run`` repeated for ``seconds``,
    the device synchronized before and at the end."""
    harness.sync(device)
    done, t0 = 0, time.perf_counter()
    while True:
        run()
        done += units
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(device)
    return done, time.perf_counter() - t0


def per_unit(summary: dict, units: int) -> dict:
    return {
        "spans_ms": {
            name: [s["total_s"] / units * 1e3, s["self_s"] / units * 1e3]
            for name, s in sorted(summary["spans"].items())
        },
        "launches": sum(summary["launches"].values()) / units,
    }


def measure(run, units: int, one, mode: str, seconds: float, device) -> dict:
    """One mode's row (see the module docstring) of the cell whose units
    ``run`` issues ``units`` at a time, and ``one`` one at a time."""
    if mode == "issue":  # one unit at a time, each on an idle device
        run, units, mode = (lambda: (one(), harness.sync(device))), 1, "recording"
    if mode == "off":
        done, took = timed(run, units, seconds, device)
        return {"units": done, "seconds": took, "units_per_s": done / took}
    if mode == "recording":
        with profiling.recording():
            done, took = timed(run, units, seconds, device)
        return {"units": done, "seconds": took, "units_per_s": done / took,
                **per_unit(profiling.span_summary(), done)}
    with trace.profiled(lambda: harness.sync(device)) as prof:
        done, took = timed(run, units, seconds, device)
    reduced = trace.reduce_profile(prof["prof"])
    return {
        "units": done, "seconds": took, "units_per_s": done / took,
        **per_unit(profiling.span_summary(), done),
        "device_busy_ms": reduced["busy_s"] / done * 1e3,
        "idle_share": 1 - reduced["busy_s"] / reduced["window_s"],
        "idle_gaps": reduced["idle_gaps"],
    }


def run(root: str, cells, seconds: float, rounds: int, seed: int, device, warm_s: float = 2.0):
    """The rows of every cell, mode and round (see the module docstring)."""
    rows = []
    for name in cells:
        cell = harness.Cell(root, name)
        if cell.chips != 1:
            raise ValueError(f"{name} takes {cell.chips} cards; this tool runs one-card cells")
        issue, units, one = unit_of(cell, seed, device)
        timed(issue, units, warm_s, device)
        for r in range(rounds):
            for mode in MODES if r % 2 == 0 else MODES[::-1]:
                row = {"cell": name, "mode": mode, "round": r}
                row.update(measure(issue, units, one, mode, seconds, device))
                rows.append(row)
        del issue, one
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=["c5-largeD.train", "c4-mnist.eval"])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    args = ap.parse_args(argv)
    profiling.require_cuda()
    print(json.dumps({"card": profiling.card()}), flush=True)
    for row in run(os.getcwd(), args.cells, args.seconds, args.rounds, args.seed,
                   torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
