"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result's line.

Everything that belongs to one configuration, one traffic mix, one kind of
loop, one likelihood or one per-layer metric sits in a file of its own,
found by name under the run's root:

- ``portbench/configs/<config>.json``: the file the configuration's entry
  in ``BENCHMARK.json`` names;
- ``portbench/traffic/<mix>.json``: a mix's parameters, data that the loop
  of its ``kind`` reads;
- ``portbench/loops/<kind>.py``: a general loop, ``run(cell, seed,
  seconds, trace, device, mesh, t_start)``; ``train`` and ``eval`` are
  there;
- ``portbench/likelihoods/<kind>.py`` and
  ``portbench/reference/likelihoods/<kind>.py``: a configuration's
  likelihood on the program's side and on the reference's;
- ``portbench/metrics/<metric>.py``: a per-layer reader, ``read(ctx)``;
- ``portbench/limits/<cell>.json``: the limits of the numbers that decide
  ``correct``.

A configuration's ``dtype`` is a name in ``torch``. The harness draws
parameters, data and noise from ``--seed`` on the device and hands the
same to the port and to the reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys

import torch

from portbench import counts, program

FORBIDDEN = ("jax", "jaxlib", "flax", "whvi_tpu")
GIB = 2.0**30
REFERENCE_ELEMENTS = 2**25  # a reference block holds about this many elements a tensor


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


_PLUGINS: dict = {}


def plugin(root: str, folder: str, name: str):
    """The module ``<root>/portbench/<folder>/<name>.py``, loaded once a
    path."""
    path = os.path.join(root, "portbench", *folder.split("/"), name + ".py")
    if path not in _PLUGINS:
        tag = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
        spec = importlib.util.spec_from_file_location(f"portbench_plugin_{tag}", path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(f"no {folder} file {name!r} at {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _PLUGINS[path] = module
    return _PLUGINS[path]


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


class Cell:
    """A workload of ``BENCHMARK.json`` under ``root`` with its
    configuration, traffic mix, limits and the metrics it reports, and the
    files it is run with: its loop, and its likelihood on each side."""

    def __init__(self, root: str, name: str):
        self.root = root
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, entry = name, found[0]
        self.chips = entry["chips"]
        cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = load_json(os.path.join(root, "portbench", "traffic", entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(root, "portbench", "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)
        ]

        self.loop = plugin(root, "loops", self.traffic["kind"])
        kind = self.config["likelihood"]["kind"]
        self.likelihood = plugin(root, "likelihoods", kind)
        self.reference_likelihood = plugin(root, "reference/likelihoods", kind)

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
        return plugin(self.root, "metrics", metric).read

    def make_params(self, specs: list, generator, device, dtype, state=None) -> dict:
        """The parameters of both sides: the WHVI layers' (:func:`make_params`)
        and the likelihood's own, each at ``state`` where it names them."""
        params = make_params(specs, generator, device, dtype, state)
        params.update(self.likelihood.params(self.config["likelihood"], device, dtype, state))
        return params


def forbidden_modules() -> list:
    """The modules of the JAX stack or the JAX package loaded in this
    process, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ----------------------------------------------------------------- inputs
def make_params(specs: list, generator, device, dtype, state=None) -> dict:
    """The WHVI layers' parameters, drawn on ``device`` in a few calls:
    ``s1, s2 ~ scale * N(0, 1)``, ``g_rho ~ U(lo, hi)`` and ``g_mu ~
    N(0, g_mu_std^2)``, with ``state = {"g_mu_std", "g_rho": [lo, hi]}``.
    Without ``state`` it is the WHVI initialisation, where training starts:
    ``g_mu = 0``, ``g_rho ~ U(-3, -2)``."""
    state = state or {}
    lo, hi = state.get("g_rho", (-3.0, -2.0))
    mu_std = state.get("g_mu_std", 0.0)
    whvi = [(i, s) for i, s in enumerate(specs) if s["kind"] != "relu"]
    sizes = [math.prod(s["shape"]) for _, s in whvi]
    z = torch.randn(2, sum(sizes), generator=generator, device=device, dtype=dtype)
    r = torch.rand(sum(sizes), generator=generator, device=device, dtype=dtype)
    mu = (torch.randn(sum(sizes), generator=generator, device=device, dtype=dtype) * mu_std
          if mu_std else torch.zeros(sum(sizes), device=device, dtype=dtype))
    params, off = {}, 0
    for (i, spec), n in zip(whvi, sizes):
        part, shape = slice(off, off + n), spec["shape"]
        params[f"{i}.s1"] = (z[0, part] * spec["scale"]).reshape(shape)
        params[f"{i}.s2"] = (z[1, part] * spec["scale"]).reshape(shape)
        params[f"{i}.g_mu"] = mu[part].reshape(shape)
        params[f"{i}.g_rho"] = (r[part] * (hi - lo) + lo).reshape(shape)
        off += n
    return params


def float32(tensors: dict) -> dict:
    """The reference's copy of ``tensors``, in float32."""
    return {k: v.float() for k, v in tensors.items()}


def noise_views(specs: list, flat: torch.Tensor) -> list:
    """Per-layer noise ``(S, 1, *shape)`` as views of ``flat (S, total)``."""
    out, off = [], 0
    for spec in specs:
        if spec["kind"] == "relu":
            out.append(None)
            continue
        n = math.prod(spec["shape"])
        out.append(flat[:, off : off + n].reshape(flat.shape[0], 1, *spec["shape"]))
        off += n
    return out


def noise_width(specs: list) -> int:
    return sum(math.prod(s["shape"]) for s in specs if s["kind"] != "relu")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference_block(specs: list, rows: int) -> int:
    widest = max(s["shape"][-1] * s["shape"][0] if s["kind"] == "stacked" else
                 s.get("shape", (1,))[-1] for s in specs)
    return max(1, REFERENCE_ELEMENTS // (rows * widest))


# ------------------------------------------------------------- the op's time
def whvi_op_time(config: dict, specs: list, rows: int, samples: int, train: bool, device):
    """``{"least_s", "measured_s"}`` of the public ``whvi_mul`` at the cell's
    widest square product: ``x (samples, rows, D)`` with ``(D,)`` diagonals
    and a shared-noise ``u (samples, 1, D)``, in the configuration's dtype;
    forward and backward through autograd for ``train``, the forward under
    ``no_grad`` otherwise. The time is CUDA events around 10 calls, the
    median of 5 rounds after 3 calls of warm-up. None off a card, or
    without a square layer."""
    from whvi_tpu_torch.ops import whvi_mul

    squares = [s["shape"][-1] for s in specs if s["kind"] == "square"]
    if torch.device(device).type != "cuda" or not squares:
        return None
    D, dtype = max(squares), program.dtype_of(config)
    g = torch.Generator(device=device).manual_seed(0)
    s1, s2 = (torch.randn(D, generator=g, device=device, dtype=dtype) for _ in range(2))
    u = torch.randn(samples, 1, D, generator=g, device=device, dtype=dtype)
    x = torch.randn(samples, rows, D, generator=g, device=device, dtype=dtype)
    if train:
        gy = torch.randn_like(x)
        leaves = [t.requires_grad_(True) for t in (s1, u, s2, x)]

        def once():
            y = whvi_mul(*leaves)
            torch.autograd.grad(y, leaves, gy)
    else:

        def once():
            with torch.no_grad():
                whvi_mul(s1, u, s2, x)

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
    least = counts.whvi_mul_bytes(samples * rows, D, samples, x.element_size(), train)
    return {"least_s": least / counts.H100_HBM_BYTES_PER_S, "measured_s": statistics.median(times)}


# ------------------------------------------------------------------- checks
def leaf_gap(prog: dict, ref: dict, keys) -> tuple:
    """``(gap, leaf)``: the worst leaf's gap of norms, ``| |prog| - |ref|
    |``, over the larger of that leaf's reference norm and the median
    leaf's."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    median = statistics.median(norms.values())
    gaps = {
        k: abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k]) / max(norms[k], median)
        for k in keys
    }
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _judge(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each compared number with its limit; correct
    when every number is finite and at most its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    return ok, checks


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the reference's float32 arithmetic."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --------------------------------------------------------------------- run
def _layer_context(cell, out, chips: int) -> dict:
    ctx = {
        "cell": cell.name, "kind": cell.traffic["kind"], "chips": chips,
        "mesh": cell.traffic.get("mesh"), "unit_s": out["unit_s"],
        "flops_per_unit": out["flops_per_unit"],
        "peak_flops": counts.H100_FP32_FLOPS * chips, "whvi_op": out.get("whvi_op"),
    }
    ctx.update(out.get("trace", {}))
    return ctx


def run_cell(root, name, seed, seconds, want_trace, device, t_start, fault=None, mesh=None):
    """One run of the cell ``name``: the result's line as a dict, with the
    compared numbers under ``checks``, last. ``fault`` plants a named fault
    of :mod:`portbench.faults` in the program for the run (its tests and its
    calibration); ``mesh`` is this rank's mesh when the mix has one."""
    cell = Cell(root, name)
    if fault is None:
        return _finish(cell, seed, seconds, want_trace, device, t_start, mesh)
    from portbench import faults

    with faults.planted(fault):
        return _finish(cell, seed, seconds, want_trace, device, t_start, mesh)


def _finish(cell, seed, seconds, want_trace, device, t_start, mesh):
    out = cell.loop.run(cell, seed, seconds, want_trace, device, mesh, t_start)
    if out is None:  # a rank of a mesh other than 0
        return None
    correct, checks = _judge(out["values"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    chips = cell.chips
    if want_trace:
        ctx = _layer_context(cell, out, chips)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        metrics = {
            m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end
        }
    cuda = torch.device(device).type == "cuda"
    result = {
        "correct": correct, "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": out["peak"],
        },
    }
    if want_trace:
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    if "worst_leaf" in out:  # where a gap of norms came from
        result["worst_leaf"] = out["worst_leaf"]
    result["setup_phases"] = out["phases"]  # seconds from the start at each step of set-up
    result["checks"] = checks
    return result


def mesh_rank(device, root, name, seed, seconds, want_trace, t_start, fault):
    """A rank of a mesh cell (``parallel.distributed.spawn`` runs it in
    each process): ``(result, loaded)``, the result on rank 0 and None on
    the others, and what of the JAX stack this rank's process loaded once
    its run had ended (:func:`forbidden_modules`)."""
    from whvi_tpu_torch.parallel import make_mesh

    shape = Cell(root, name).traffic["mesh"]
    mesh = make_mesh(shape["data"], shape["sample"])
    result = run_cell(root, name, seed, seconds, want_trace, device, t_start, fault, mesh)
    return result, forbidden_modules()
