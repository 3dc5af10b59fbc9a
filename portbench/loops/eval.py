"""The ``eval`` loop: a closed loop of one client scoring the
configuration's ``eval_rows`` evaluation rows over and over. A score is
``WHVINetwork.predict`` then the likelihood's predictive answer over each
chunk of ``chunk_rows`` rows in turn (all the rows in one where the mix
names none), each chunk's answer copied to the host before the next
starts (the class argmax for a softmax, the mean and sd for a Gaussian),
as the port's ``run_mnist.accuracy`` scores a test set.

A mix of this kind gives ``noise_sets`` (a pool of noise draws the chunks
cycle through), ``checked_calls`` (the chunks' answers compared),
``warm_s``, ``trace_units`` (the scores under the profiler), optionally
``chunk_rows`` and ``rate`` (the name the rate is reported under, so that
cells whose spreads differ can carry bounds of their own), and ``state``: where the scored parameters lie
(:func:`portbench.harness.make_params`), a state with real spread, since a
scored net has been trained.

``eval_rows_per_s`` (or the mix's ``rate``) is every row scored in the
window over all of it;
``eval_call_ms_p95`` the 95th percentile of a score, from its start until
its last chunk's answer is on the host, over every score of the window.
``correct``: ``checked_calls`` chunk answers drawn from the seed among all
of the window's, each against the reference's answer to the same rows and
noise, judged by the likelihood's file.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import counts, data, harness, program, trace
from portbench.reference import layer_specs, sample_outputs


def run(cell, seed, seconds, want_trace, device, mesh, t_start):
    """One run of an eval mix, on one card; the harness turns what it
    returns into the result's line."""
    if mesh is not None:
        raise ValueError("an eval mix runs on one card")
    cfg, traffic, lik = cell.config, cell.traffic, cell.likelihood
    phases = {"entered": time.perf_counter() - t_start}
    specs, dtype = layer_specs(cfg), program.dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    params = cell.make_params(specs, gen, device, dtype, traffic.get("state"))
    net = program.build_net(cfg, lik, device)
    program.load_params(net, params)
    rows, S = cfg["eval_rows"], cfg["eval_samples"]
    chunk = traffic.get("chunk_rows", rows)
    chunks = [(a, min(a + chunk, rows)) for a in range(0, rows, chunk)]
    X, _ = data.make_rows(cfg["data"], (rows,), gen, device, dtype)
    pool = torch.randn(
        traffic["noise_sets"], S, harness.noise_width(specs), generator=gen, device=device,
        dtype=dtype,
    )
    noise = [harness.noise_views(specs, pool[j]) for j in range(pool.shape[0])]
    issued = [0]  # chunks answered so far: each takes the next noise of the pool

    def score():
        """One score: ``[(noise index, first row, end row, answer on the
        device, answer on the host), ...]``, a chunk each."""
        answers = []
        for a, b in chunks:
            j = issued[0] % len(noise)
            issued[0] += 1
            with torch.no_grad():
                y_hat = net.predict(X[a:b], S, eps=noise[j])
                dev, host = lik.answer(net.likelihood.predict(y_hat))
            answers.append((j, a, b, dev, host))
        return answers

    harness.sync(device)
    phases["built"] = time.perf_counter() - t_start
    score()
    phases["first_steps"] = time.perf_counter() - t_start
    end = time.perf_counter() + traffic["warm_s"]
    while time.perf_counter() < end:
        score()
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    chooser, kept, latencies, seen = random.Random(seed), [], [], 0
    K = traffic["checked_calls"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        c0 = time.perf_counter()
        answers = score()
        latencies.append(time.perf_counter() - c0)
        for answer in answers:  # a sample of the window's chunk answers, drawn from the seed
            if seen < K:
                kept.append(answer)
            else:
                slot = chooser.randrange(seen + 1)
                if slot < K:
                    kept[slot] = answer
            seen += 1
    window_s = time.perf_counter() - t0
    calls = len(latencies)
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    out = {
        "attempted": calls, "failed": 0, "peak": peak, "phases": phases,
        "e2e": {traffic.get("rate", "eval_rows_per_s"): counts.rate(calls, rows, window_s),
                "eval_call_ms_p95": counts.p95(latencies) * 1e3,
                "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s},
        "unit_s": window_s / calls,
        "flops_per_unit": counts.forward_flops(specs, rows, S),
    }
    if want_trace:
        units, launched = traffic["trace_units"], program.launches()
        with trace.profiled(lambda: harness.sync(device)) as prof:
            for _ in range(units):
                score()
        out["trace"] = trace.reduce_profile(prof["prof"])
        trace.check_complete(out["trace"], program.launches() - launched)
        out["trace"]["units"] = units
        widest = max(b - a for a, b in chunks)
        out["whvi_op"] = harness.whvi_op_time(cfg, specs, widest, S, False, device)
    kept = [(j, a, b, dev.cpu(), host) for j, a, b, dev, host in kept]
    del net
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["values"] = check(cell, specs, params, X, noise, kept)
    return out


def check(cell, specs, params, X, noise, kept) -> dict:
    """The reference's answer to each kept chunk, against the program's, by
    the likelihood's ``gaps``: the worst chunk's gap, or the sum over the
    chunks of a number the likelihood names in ``SUMMED``."""
    cfg, lik, ref_lik = cell.config, cell.likelihood, cell.reference_likelihood
    params = harness.float32(params)
    block = harness.reference_block(specs, max(b - a for _, a, b, _, _ in kept))
    values = {}
    with harness.no_tf32():
        for j, a, b, dev, host in kept:
            eps = [None if e is None else e.float() for e in noise[j]]
            y_hat = sample_outputs(specs, params, X[a:b].float(), eps, block)
            ref = ref_lik.predict(cfg["likelihood"], params, y_hat)
            ref = {k: v.cpu() for k, v in ref.items()}
            for k, v in lik.gaps(dev, host, ref, cell.limits).items():
                was = values.get(k, 0.0)
                values[k] = was + v if k in lik.SUMMED else max(was, v)
    return values
