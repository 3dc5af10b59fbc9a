"""The readings that the limits of ``correct`` are set from, on the card::

    python3 -m portbench.calibrate --cells c5-largeD.train c4-mnist.eval \
        [--seeds 12] [--faulty-seeds 3] [--seconds 1] [--out FILE]

For each cell, in one process (the kernels built once): sound runs of the
program on ``--seeds`` seeds, then the lower-precision control and each
fault the cell can have (:mod:`portbench.faults`) on ``--faulty-seeds``
seeds, each a run of :func:`portbench.harness.run_cell` at the cell's own
sizes with a short window (``--seconds``). One JSON line a run, then one
a cell with each number's lower reading (the largest of the sound runs)
and the least reading of the control and of each fault. Seeds are drawn
apart from any a benchmark run uses by default. Needs the card(s) the
cell asks for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import harness

FAULTS = {
    "train": ("control_bf16", "unchanged_step", "half_batch"),
    "eval": ("control_bf16", "half_samples", "altered_answer"),
}
MESH_FAULTS = ("no_exchange",)


def _emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def _values(result) -> dict:
    values = {k: v["value"] for k, v in result["checks"].items()}
    return {**values, **{f"{k}_leaf": v for k, v in result.get("worst_leaf", {}).items()}}


def mesh_runs(device, root, name, plan, seconds):
    """A rank's share of ``plan``, ``[(fault, seed), ...]``, on one mesh that
    lives through all the runs: rank 0 returns each run's values and wall
    time."""
    from whvi_tpu_torch.parallel import make_mesh

    shape = harness.Cell(root, name).traffic["mesh"]
    mesh = make_mesh(shape["data"], shape["sample"])
    rows = []
    for fault, seed in plan:
        t0 = time.perf_counter()
        result = harness.run_cell(root, name, seed, seconds, False, device, t0, fault, mesh)
        if result is not None:
            rows.append((_values(result), time.perf_counter() - t0))
        mesh.barrier()
    return rows


def _readings(root, name, plan, seconds):
    """``(values, wall_s)`` of each run of ``plan`` on the cell's card(s)."""
    cell = harness.Cell(root, name)
    if cell.chips > 1:
        from whvi_tpu_torch.parallel.distributed import spawn

        os.environ.setdefault("NCCL_SHM_DISABLE", "1")
        return spawn(mesh_runs, cell.chips, "nccl", "cuda", root, name, plan, seconds)[0]
    rows = []
    for fault, seed in plan:
        t0 = time.perf_counter()
        result = harness.run_cell(root, name, seed, seconds, False, torch.device("cuda", 0), t0,
                                  fault)
        rows.append((_values(result), time.perf_counter() - t0))
    return rows


def calibrate(root, name, seeds, faulty_seeds, seconds, out) -> dict:
    cell = harness.Cell(root, name)
    faults = FAULTS.get(cell.traffic["kind"], ("control_bf16",)) + (MESH_FAULTS if cell.traffic.get("mesh") else ())
    if cell.traffic["kind"] == "eval":
        faults += cell.likelihood.FAULTS
    plan = [(None, s) for s in seeds] + [(f, s) for f in faults for s in faulty_seeds]
    readings = {}
    for (fault, seed), (values, wall) in zip(plan, _readings(root, name, plan, seconds)):
        readings.setdefault(fault or "sound", []).append(values)
        _emit({"cell": name, "fault": fault, "seed": seed, "wall_s": wall, "values": values}, out)
    summary = {"cell": name, "seeds": len(seeds), "numbers": {}}
    for number in [k for k, v in readings["sound"][0].items() if isinstance(v, float)]:
        summary["numbers"][number] = {
            kind: (max if kind == "sound" else min)(r[number] for r in rows)
            for kind, rows in readings.items()
        }
    _emit(summary, out)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faulty-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    faulty = [args.first_seed + 104729 * (i + 1) for i in range(args.faulty_seeds)]
    out = open(args.out, "a") if args.out else None
    try:
        for name in args.cells:
            calibrate(os.getcwd(), name, seeds, faulty, args.seconds, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
