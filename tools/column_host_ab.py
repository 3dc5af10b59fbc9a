"""The bf16 column head's host cost and the bf16 scaling path end to end,
this checkout against another (for example the parent commit unpacked by
``git archive``), in processes taken in turns on one card.

Each process (``--worker DIR``) imports ``whvi_tpu_torch`` from the
checkout ``DIR``, builds the bf16 scaling net at ``--D`` (``run_scaling``:
S = 8, batch 256) and prints one JSON row:

- ``host_us_predict``: host microseconds a call of the net's column head,
  ``ColumnMatrix.column_given_g`` at ``g (8, 1, D)``, under ``no_grad``;
- ``host_us_train``: the same call and its backward,
  ``torch.autograd.grad`` over ``g``, ``s1`` and ``s2``;

  each the least of ``ROUNDS`` rounds of ``CALLS`` calls, a round timed on
  the host clock from the first call's issue to the last's, before the
  card is waited for: a call's device work is a few microseconds, its
  host work tens, so the host sets the time (``device_ms`` gives the
  card's time of the last round, for that check);
- ``call_ms`` and ``step_ms``: ``run_scaling --dtype bf16 --sizes D
  [--predict]`` in that process (its least-of-trials difference timing).

The checkouts take turns, ``--pairs`` pairs, the order flipped every pair
(parent, change, change, parent, ...), so that drift of the host or the
card falls on both. The last row sums each metric up: each side's median,
the spread of the parent's runs (the distance between their quartiles),
the median of the pairs' ratios change / parent, how many pairs the change
was slower and faster in (ties count for neither), the two-sided sign
test's p over those, and a verdict: ``slower`` (``faster``) where the
change lost (won) at least nine tenths of all pairs and the medians differ
by more than the parent's spread, else ``unresolved``.

Run from the repository root (needs a card; the first line names it and
its power limit):

    python -m tools.column_host_ab --parent DIR [--pairs 10] [--D 4096]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROUNDS = 5
CALLS = 400
METRICS = ("host_us_predict", "host_us_train", "call_ms", "step_ms")
_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_us(fn, torch) -> tuple[float, float]:
    """The least host microseconds a call of ``fn`` over ``ROUNDS`` rounds,
    and the last round's device ms a call (CUDA events)."""
    for _ in range(CALLS):  # warm: the allocator's cache, the clocks
        fn()
    torch.cuda.synchronize()
    best, device_ms = math.inf, math.nan
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) / CALLS * 1e6)
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / CALLS
    return best, device_ms


def worker(root: str, D: int) -> dict:
    """One process's row, ``whvi_tpu_torch`` imported from ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import whvi_tpu_torch
    from whvi_tpu_torch.experiments import run_scaling
    from whvi_tpu_torch.ops import fwht_cuda

    if not whvi_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {whvi_tpu_torch.__file__}, not the checkout {root}")
    fwht_cuda.load_library()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    net = run_scaling.build_net(D, 8, device=dev, dtype=torch.bfloat16)
    m = net.layers[-1].matrix
    g = m.sample_g((8, 1)).detach().requires_grad_()
    with torch.no_grad():
        gy = torch.randn_like(m.column_given_g(g))

    def predict():
        with torch.no_grad():
            m.column_given_g(g)

    def train():
        torch.autograd.grad(m.column_given_g(g), (g, m.s1, m.s2), gy)

    row = {"root": root, "D": D}
    row["host_us_predict"], row["device_ms_predict"] = _host_us(predict, torch)
    row["host_us_train"], row["device_ms_train"] = _host_us(train, torch)
    base = ["--sizes", str(D), "--dtype", "bf16"]
    row["call_ms"] = run_scaling.main(base + ["--predict"])[0]["call_ms"]
    row["step_ms"] = run_scaling.main(base)[0]["step_ms"]
    return row


def _sign_p(k: int, n: int) -> float:
    """Two-sided sign test: the chance of a split at least as uneven as
    ``k`` of ``n`` when either side is as likely."""
    tail = sum(math.comb(n, i) for i in range(min(k, n - k) + 1)) / 2**n
    return min(1.0, 2 * tail)


def summary(rows: list[dict], metrics=METRICS) -> dict:
    """Each metric's medians, spread, ratio, slower and faster counts, p
    and verdict over the pairs (rows each with ``tree`` and ``pair``)."""
    out = {"summary": True}
    pairs = sorted({r["pair"] for r in rows})
    for metric in metrics:
        side = {t: [r[metric] for r in rows if r["tree"] == t] for t in ("parent", "change")}
        ratios = []
        for p in pairs:
            by = {r["tree"]: r[metric] for r in rows if r["pair"] == p}
            ratios.append(by["change"] / by["parent"])
        slower, faster = sum(q > 1 for q in ratios), sum(q < 1 for q in ratios)
        q1, _, q3 = statistics.quantiles(side["parent"], n=4)
        diff = statistics.median(side["change"]) - statistics.median(side["parent"])
        verdict = "unresolved"
        if slower >= 0.9 * len(ratios) and diff > q3 - q1:
            verdict = "slower"
        elif faster >= 0.9 * len(ratios) and -diff > q3 - q1:
            verdict = "faster"
        out[metric] = {
            "parent_median": statistics.median(side["parent"]),
            "change_median": statistics.median(side["change"]),
            "parent_iqr": q3 - q1,
            "ratio_median": statistics.median(ratios),
            "pairs_slower": slower,
            "pairs_faster": faster,
            "pairs": len(ratios),
            "sign_p": _sign_p(slower, slower + faster) if slower + faster else 1.0,
            "verdict": verdict,
        }
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--D", type=int, default=4096)
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.D)), flush=True)
        return {}
    if not args.parent:
        ap.error("--parent is required")
    from whvi_tpu_torch.bench.common import emit, header

    header("column_host_ab")
    rows = []
    for pair in range(args.pairs):
        order = ("parent", "change") if pair % 2 == 0 else ("change", "parent")
        for tree in order:
            root = os.path.abspath(args.parent) if tree == "parent" else _HERE
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root, "--D", str(args.D)],
                cwd=root, capture_output=True, text=True,
            )
            if proc.returncode:
                raise RuntimeError(f"worker in {root} exited {proc.returncode}: {proc.stderr[-3000:]}")
            rows.append(emit({"tree": tree, "pair": pair,
                              **json.loads(proc.stdout.strip().splitlines()[-1])}))
    return emit(summary(rows))


if __name__ == "__main__":
    main()
