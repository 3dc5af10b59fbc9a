"""The ``lm_train`` loop: a language model's ``Trainer.train_step`` back to
back on device-resident batches of token ids, the loss read to the host
once a chunk of steps. It runs the port's DeepSeek-V2 WHVI net
(``whvi_tpu_torch.models.deepseek_v2``) built from the configuration file.

A mix of this kind gives ``batch`` packed sequences of ``seq_len`` tokens,
``zipf`` (the exponent of the law the ids are drawn from over the
vocabulary, rank k with weight ``(k + 1)^-zipf``, so frequent ids repeat;
the targets are the ids shifted by one), ``batches`` (the pool of distinct
batches the steps cycle through), ``check_steps`` (the first steps, made in
set-up through the window's own call and followed by the reference),
``chunk_steps``, ``warm_s`` and ``trace_units`` (the steps under the
profiler).

Parameters come from the seed on the device: every WHVI map's WHVI
initialisation (``s1, s2 ~ scale N(0, 1)``, ``g_mu = 0``, ``g_rho ~ U(-3,
-2)``), the embedding ``N(0, 1)``, the norms' weights 1; noise one ``eps`` a
sample a map a step.

``train_samples_per_s`` is tokens times MC samples times the steps of the
window over the window, which ends in a host read of the loss.
``correct``: as the ``train`` loop, each checked step's loss, mnll and kl
against the reference's (``portbench/reference/deepseek_v2.py``; relative
gaps, the worst step's), the first gradient as Adam's state holds it and
the parameters' change over the checked steps (the worst leaf's gap of
norms; leaves whose reference gradient is under a thousandth of the median
leaf's left out of the change). The reference takes the program's chosen
experts; ``route_miss`` counts the rows, over the checked steps and the MoE
layers, whose own choice differs where its k-th and (k+1)-th router scores
lie ``route_margin`` (a limit of the cell, not a compared number) apart or
more.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from whvi_tpu_torch.models.deepseek_v2 import DeepseekV2WHVI, MoE  # the parent has none: its run stops here
from whvi_tpu_torch.ops import whvi_op
from whvi_tpu_torch.ops.whvi_op import whvi_mul_grouped
from whvi_tpu_torch.train import TrainConfig, Trainer

from portbench import counts, harness, program, trace
from portbench.loops import lm_counts
from portbench.reference import adam_steps
from portbench.reference import deepseek_v2 as reference

ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}  # the port's decayed_adam, as TrainConfig leaves it


@torch.no_grad()
def draw_params(net, gen) -> dict:
    """The net's parameters from ``gen``, under its names (see the module
    docstring)."""
    out = {}
    for name, p in net.named_parameters():
        if name == "embed_tokens":
            out[name] = torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype)
        elif name.endswith(".weight"):  # a norm's
            out[name] = torch.ones_like(p)
        elif name.endswith((".s1", ".s2")):
            s_init = net.config["s_init"]
            scale = p.shape[-1] ** -0.5 if s_init == "auto" else float(s_init)
            out[name] = torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype) * scale
        elif name.endswith(".g_mu"):
            out[name] = torch.zeros_like(p)
        else:  # g_rho
            out[name] = torch.rand(p.shape, generator=gen, device=p.device, dtype=p.dtype) - 3.0
    return out


class _LMLoop:
    """The window's unit: one step on the next batch of the pool, with noise
    drawn from the harness's generator."""

    def __init__(self, cell, seed, device):
        cfg, traffic = cell.config, cell.traffic
        whvi_op.set_whvi_mul_precision(cfg["precision"])  # the control replaces it
        dtype = program.dtype_of(cfg)
        self.device, self.gen = device, torch.Generator(device=device).manual_seed(seed % 2**64)
        self.S, self.B, self.T = cfg["train_samples"], traffic["batch"], traffic["seq_len"]
        self.net = DeepseekV2WHVI(cfg, train_samples=self.S, eval_samples=cfg["eval_samples"],
                                  device=device, dtype=dtype)
        opt = cfg["optimizer"]
        self.trainer = Trainer(self.net, TrainConfig(lr0=opt["lr0"], gamma=opt["gamma"], p=opt["p"]),
                               device=device)
        self.state = self.trainer.init(seed % 2**63)
        self.params0 = draw_params(self.net, self.gen)
        with torch.no_grad():
            for name, p in self.net.named_parameters():
                p.copy_(self.params0[name])
        V = cfg["vocab_size"]
        weights = torch.arange(1, V + 1, device=device, dtype=torch.float64) ** -traffic["zipf"]
        seqs = torch.multinomial(weights, traffic["batches"] * self.B * (self.T + 1),
                                 replacement=True, generator=self.gen)
        seqs = seqs.view(traffic["batches"], self.B, self.T + 1)
        self.X, self.Y = seqs[..., :-1].contiguous(), seqs[..., 1:].contiguous()
        self.maps = self.net.whvi_layers()
        self.moe = [m for m in self.net.modules() if isinstance(m, MoE)]
        self.shapes = [m.matrix.g_mu.shape for _, m in self.maps]
        self.width = sum(math.prod(s) for s in self.shapes)
        self.dtype, self.k = dtype, 0

    def noise(self) -> list:
        flat = torch.randn(self.S, self.width, generator=self.gen, device=self.device,
                           dtype=self.dtype)
        out, off = [], 0
        for shape in self.shapes:
            n = math.prod(shape)
            out.append(flat[:, off:off + n].view(self.S, 1, *shape))
            off += n
        return out

    def step(self):
        eps = self.noise()
        b = self.k % self.X.shape[0]
        metrics = self.trainer.train_step(self.state, self.X[b], self.Y[b], self.B * self.T, True,
                                          eps=eps)
        self.k += 1
        return metrics, eps, b

    def chunk(self, steps: int) -> float:
        for _ in range(steps):
            metrics = self.step()[0]
        return float(metrics["loss"])  # the chunk's one host read


def expert_op_time(moe: MoE, idx, S: int, device) -> dict | None:
    """``{"least_s", "measured_s", "rows", "segments"}`` of the grouped
    product, forward and backward through autograd, at a routed shape of the
    cell: the segments of the choices ``idx (S N, top_k)``, ``x`` gathered
    from ``S N`` rows of the hidden width, as the experts' gate and up take
    it. CUDA events around 10 calls, the median of 5 rounds after 3 of
    warm-up; None off a card."""
    if torch.device(device).type != "cuda":
        return None
    SN, k = idx.shape
    offsets, order = moe.segments(idx.view(S, SN // S, k))
    src = torch.div(order, k, rounding_mode="floor")
    D, E = moe.experts[0].gate_proj.matrix.s1.shape[-1], moe.held
    gen = torch.Generator(device=device).manual_seed(0)
    s1, s2 = (torch.randn(E, D, generator=gen, device=device) * D**-0.5 for _ in range(2))
    u = torch.randn(E * S, D, generator=gen, device=device)
    x = torch.randn(SN, D, generator=gen, device=device)
    g = torch.randn(SN * k, D, generator=gen, device=device)
    leaves = [t.requires_grad_(True) for t in (s1, u, s2, x)]

    def once():
        y = whvi_mul_grouped(*leaves, offsets, src)
        torch.autograd.grad(y, leaves, g)

    for _ in range(3):
        once()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            once()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10 / 1e3)
    rows = int(offsets[-1])
    least = lm_counts.grouped_op_bytes(rows, D, E * S) / counts.H100_HBM_BYTES_PER_S
    return {"least_s": least, "measured_s": statistics.median(times), "rows": rows,
            "segments": E * S}


def run(cell, seed, seconds, want_trace, device, mesh, t_start):
    """One run of an ``lm_train`` mix (one card); the harness turns what it
    returns into the result's line."""
    if mesh is not None:
        raise ValueError("the lm_train loop runs on one card")
    cfg, traffic = cell.config, cell.traffic
    phases = {"entered": time.perf_counter() - t_start}
    loop = _LMLoop(cell, seed, device)
    harness.sync(device)
    phases["built"] = time.perf_counter() - t_start
    fed, routes, prog_losses, first_grad = [], [], [], None
    for k in range(traffic["check_steps"]):
        metrics, eps, b = loop.step()
        fed.append((b, [e.clone() for e in eps]))
        routes.append([m.last_topk.clone() for m in loop.moe])
        prog_losses.append(tuple(float(metrics[key]) for key in ("loss", "mnll", "kl")))
        if k == 0:
            opt_state = loop.state.optimizer.state
            first_grad = {
                name: opt_state[p]["exp_avg"] / (1 - ADAM["b1"]) if p in opt_state
                else torch.zeros_like(p)
                for name, p in loop.net.named_parameters()
            }
    params_after = {name: p.detach().clone() for name, p in loop.net.named_parameters()}
    routed_rows = statistics.mean(  # the choices of experts held here, a step
        sum(int(((r >= m.first) & (r < m.first + m.held)).sum()) for r, m in zip(step, loop.moe))
        for step in routes
    )
    phases["first_steps"] = time.perf_counter() - t_start
    chunk = traffic["chunk_steps"]
    end = time.perf_counter() + traffic["warm_s"]
    while time.perf_counter() < end:
        loop.chunk(chunk)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    steps, failed, t0 = 0, 0, time.perf_counter()
    while True:
        loss = loop.chunk(chunk)
        steps += chunk
        failed += 0 if math.isfinite(loss) else chunk
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    B, T, S = loop.B, loop.T, loop.S
    out = {
        "attempted": steps, "failed": failed, "peak": peak, "phases": phases,
        "e2e": {"train_samples_per_s": counts.rate(steps, B * T * S, window_s),
                "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s},
        "unit_s": window_s / steps,
        "flops_per_unit": lm_counts.train_step_flops(cfg, B, T, S, routed_rows),
    }
    if want_trace:
        units, launched = traffic["trace_units"], program.launches()
        with trace.profiled(lambda: harness.sync(device)) as prof:
            loop.chunk(units)
        t = out["trace"] = trace.reduce_profile(prof["prof"])
        trace.check_complete(t, program.launches() - launched)
        t["units"] = units
        t["expert_op"] = expert_op_time(loop.moe[0], routes[0][0], S, device)
    names = [name for name, _ in loop.maps]
    X, Y, params0 = loop.X, loop.Y, loop.params0
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["values"], out["worst_leaf"] = check(
        cell, names, params0, X, Y, fed, routes, prog_losses, first_grad, params_after
    )
    return out


def check(cell, names, params0, X, Y, fed, routes, prog_losses, first_grad, params_after):
    """The reference's first steps from ``params0`` on the fed batches,
    noise and routing, against the program's (see the module docstring)."""
    cfg = cell.config
    params0, first_grad, params_after = (
        harness.float32(p) for p in (params0, first_grad, params_after)
    )
    B, T = X.shape[1:]
    misses = []

    def grad_fn(p, k):
        b, eps = fed[k]
        loss, mnll, kl, grads, miss = reference.reference_grads(
            cfg, p, X[b], Y[b], dict(zip(names, eps)), B * T, routes[k],
            cell.limits["route_margin"])
        misses.append(miss)
        return loss, mnll, kl, grads

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
    moved = [k for k in keys if norms[k] >= 1e-3 * median]
    prog_change = {k: params_after[k] - params0[k] for k in moved}
    ref_change = {k: ref_after[k] - params0[k] for k in moved}
    values["change_gap"], worst_change = harness.leaf_gap(prog_change, ref_change, moved)
    values["route_miss"] = float(sum(misses))
    left_out = sorted(set(keys) - set(moved))
    return values, {"grad_gap": worst_grad, "change_gap": worst_change, "left_out": left_out}
