"""Where a golden-sampler draw spends its time on one card.

    python -m whvi_tpu_torch.bench.sampler_bench [--seed 0] [--draws 3]

Two g posteriors, 4 walkers each: BASELINE config 4's (784 -> 1024 ->
1024 -> 10, random weights from ``--seed``, 256 rows of
``synthetic_classification``; the ``run_mnist --hmc`` target) and
``run_vi_vs_hmc``'s analytic target (D = 16). For each, one JSON row:

- ``grad_eval_ms`` / ``value_ms``: host ms of one gradient evaluation
  (``mcmc.chains.value_and_grad``) and of one value without a gradient,
  synchronized, warm, over 50 calls;
- ``draw_ms``: host ms of one NUTS draw of the 4 chains at depth 6
  (``nuts.nuts_draw``: 63 leapfrog steps, one gradient evaluation each),
  over ``--draws`` draws after a warm one; ``tree_ms``, the draw less 63
  gradient evaluations: the tree's bookkeeping;
- under ``torch.profiler`` over the same draws
  (``utils.profiling.device_profile``): ``kernel_ms_a_draw``,
  ``busy_share`` (the device's own events' time over the profiled
  window's wall clock),
  ``device_events_a_draw`` and the port's kernel launches a draw.

The first line names the card and its power limit; it raises without a
card.
"""

from __future__ import annotations

import argparse
import time

import torch

from whvi_tpu_torch.bench.common import emit, header
from whvi_tpu_torch.ops import fwht_cuda
from whvi_tpu_torch.utils.profiling import device_profile

__all__ = ["config4_net", "main", "run"]

DEPTH = 6  # the NUTS depth of run_mnist --hmc and of the analytic tier


def config4_net(seed: int):
    """BASELINE config 4 from ``run_mnist.build_net`` (784 -> 1024 -> 1024
    -> 10: stacked, square, stacked; softmax), on the CPU, its parameters
    drawn from ``seed`` and ``g_mu ~ N(0, 0.5^2)`` (a trained net's g's
    are off zero)."""
    from whvi_tpu_torch.experiments.run_mnist import build_net

    net = build_net(784, 10)
    gen = torch.Generator().manual_seed(seed)
    net.reset_parameters(gen)
    with torch.no_grad():
        for layer in net.layers[::2]:
            layer.matrix.g_mu.normal_(0.0, 0.5, generator=gen)
    return net


def _host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_draws(vg, state, draws, eps, m_inv, n: int) -> dict:
    """Kernel ms a draw, busy share, device events and the port's launches
    a draw over ``n`` NUTS draws, from
    :func:`~whvi_tpu_torch.utils.profiling.device_profile`."""
    from whvi_tpu_torch.mcmc.nuts import nuts_draw

    torch.cuda.synchronize()
    fwht_cuda.reset_launches()

    def window():
        s = state
        for t in range(n):
            s = nuts_draw(vg, s, draws(t), eps, m_inv, DEPTH, False)[0]

    p = device_profile(window)
    return {
        "profiled_draw_ms": p["wall_s"] / n * 1e3,
        "kernel_ms_a_draw": p["device_us"] / n / 1e3,
        "busy_share": p["busy_share"],
        "device_events_a_draw": p["device_events"] / n,
        "port_launches_a_draw": {k: v / n for k, v in fwht_cuda.LAUNCHES.items() if v},
    }


def run(seed: int = 0, n_draws: int = 3, card: str = "") -> list[dict]:
    """The two rows (see the module docstring) on ``cuda:0``."""
    from whvi_tpu_torch.data import synthetic_classification
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import analytic_problem
    from whvi_tpu_torch.mcmc import make_whvi_g_log_posterior
    from whvi_tpu_torch.mcmc.chains import jittered_inits, ravel, value_and_grad
    from whvi_tpu_torch.mcmc.nuts import nuts_draw, nuts_draws

    dev = torch.device("cuda", 0)
    fwht_cuda.load_library()  # builds the kernels if they are missing or stale
    (X, y), _ = synthetic_classification(seed=seed)
    lp4, init4 = make_whvi_g_log_posterior(config4_net(seed).to(dev), X[:256], y[:256])
    targets = {
        "config 4 g posterior (784-1024-1024-10, 256 rows)": (lp4, init4, 0.01),
        "analytic tier (D=16, n=48)": (
            analytic_problem(seed=seed, device=dev)["logp"], {"g": torch.zeros(16, device=dev)}, 0.05),
    }
    rows = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, (logp, init, step) in targets.items():
        qv, unflat = ravel(jittered_inits(init, gen, 4, 0.1))
        vg = value_and_grad(logp, unflat)
        grad_ms = _host_ms(lambda: vg(qv), 50)
        with torch.no_grad():
            value_ms = _host_ms(lambda: logp(unflat(qv)), 50)
        draws = nuts_draws(torch.Generator(device=dev).manual_seed(seed), 4, qv.shape[1], DEPTH, dev)
        eps = torch.full((4,), step, device=dev)
        m_inv = torch.ones_like(qv)
        state = (qv, *vg(qv))
        draw_ms = _host_ms(lambda: nuts_draw(vg, state, draws(0), eps, m_inv, DEPTH, False), n_draws)
        steps = 2**DEPTH - 1
        rows.append(emit({
            "bench": "nuts draw", "target": label, "walkers": 4, "g_coordinates": qv.shape[1],
            "depth": DEPTH, "grad_eval_ms": grad_ms, "value_ms": value_ms, "draw_ms": draw_ms,
            "tree_ms": draw_ms - steps * grad_ms, "draws_per_s_4_chains": 4e3 / draw_ms,
            "grad_evals_per_s": steps * 1e3 / draw_ms,
            **profile_draws(vg, state, draws, eps, m_inv, n_draws), "card": card,
        }))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args(argv)
    card = header("sampler_bench")["card"]
    return run(args.seed, args.draws, card)


if __name__ == "__main__":
    main()
