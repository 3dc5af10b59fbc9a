"""Run one cell of the port's benchmark once, on the card(s) of this machine::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port, ``whvi_tpu_torch``. It prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with the reference beside its limit, which
also end standard error. It exits with another code than 0, and prints no
result, without enough CUDA devices, or if the JAX stack or the JAX package
was loaded in this process or, on a mesh, in any rank's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        entry = next((w for w in json.load(f)["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    found_s = time.perf_counter() - T_START
    if cards < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has {cards}",
              file=sys.stderr)
        return 3
    from portbench import harness

    want_trace = bool(args.trace)
    if entry["chips"] > 1:
        os.environ.setdefault("NCCL_SHM_DISABLE", "1")  # nothing in /dev/shm
        result, loaded = on_mesh(
            harness.mesh_rank, entry["chips"], "nccl", "cuda", root, args.workload,
            args.seed, args.seconds, want_trace, T_START, None,
        )
    else:
        result = harness.run_cell(
            root, args.workload, args.seed, args.seconds, want_trace, torch.device("cuda", 0),
            T_START,
        )
        loaded = harness.forbidden_modules()
    return report(result, found_s, loaded)


def on_mesh(rank_fn, chips: int, backend: str, device_kind: str, *args) -> tuple:
    """``rank_fn`` on a mesh of ``chips`` spawned ranks (each returns
    ``(result, loaded)``, as :func:`portbench.harness.mesh_rank`): rank 0's
    result, and what of the JAX stack any rank, or this process, loaded."""
    from whvi_tpu_torch.parallel.distributed import spawn

    from portbench import harness

    ranks = spawn(rank_fn, chips, backend, device_kind, *args)
    loaded = set(harness.forbidden_modules())
    for _, names in ranks:
        loaded.update(names)
    return ranks[0][0], sorted(loaded)


def report(result: dict, found_s: float, loaded: list) -> int:
    """Print the result's line, its checks last on standard error, and
    return 0; where the JAX stack was loaded, print no result and return
    4."""
    if loaded:
        print(f"refused: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    phases = {"torch_and_cards": found_s, **result["setup_phases"]}
    print("setup phases (s from the start): " + json.dumps(phases), file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
