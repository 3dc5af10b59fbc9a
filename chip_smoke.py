"""Smoke run of whvi_tpu_torch on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure:

1. Probe: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), nvcc, triton; TF32 off. Exits non-zero without a GPU.
2. Build: nvcc compiles whvi_tpu_torch/csrc/*.cu for sm_90a.
3. Kernels vs their plain PyTorch versions on the card, forward with and
   without residuals, backward through autograd, and the bare FWHT
   forward and backward, from D=2 to 16384 and at the flagship's
   broadcast shapes; max |kernel - plain| / max |plain| <= 1e-5. Times
   (CUDA events, warm, median of 7 rounds of 20 calls) of each kernel and
   its plain version at the flagship's shapes.
4. The slice: the flagship WHVI MLP 13 -> 128 -> 128 -> 1 (4 MC samples
   in training, 64 in evaluation, batch 64) on random weights from
   --seed trains two-phase for 2 + 20 epochs on synthetic regression data
   of Boston's split sizes and is evaluated; every kernel must have been
   launched by that run. The trained net's loss, predictions and
   gradients on the card (kernels) are held against a CPU copy (plain
   versions) on the same noise.

Before the last line it prints one JSON object of the kernels and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 1e-5  # fp32 butterflies: same adds as the plain version
SLICE_TOL = 1e-5  # loss and predictions, card (kernels) vs CPU (plain)
# Gradients sum S*B rows in another order on the card than on the CPU,
# with cancellation between rows.
SLICE_GRAD_TOL = 1e-4

KERNELS = {
    # counter: (source, the TPU kernel it replaces)
    "fused_y": ("whvi_tpu_torch/csrc/whvi_fused.cu", "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_res": ("whvi_tpu_torch/csrc/whvi_fused.cu", "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_bwd": ("whvi_tpu_torch/csrc/whvi_fused.cu", "whvi_tpu/ops/fwht_pallas.py:403"),
    "fwht": ("whvi_tpu_torch/csrc/fwht.cu", "whvi_tpu/ops/fwht_pallas.py:191"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, want) -> float:
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale


def cuda_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median per-call milliseconds of ``fn`` on the card, warm."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# ------------------------------------------------------------------ 1. probe


def probe() -> str:
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    log(f"nvcc: {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc (not on PATH)'}")
    try:
        import triton

        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: absent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}"
    )
    return smi


# ------------------------------------------------------------------ 2. build


def build(fc) -> float:
    t0 = time.perf_counter()
    report = fc.build_kernels()
    fc.load_library()
    seconds = time.perf_counter() - t0
    log(
        f"build: {seconds:.2f} s, nvcc {' '.join(fc.NVCC_FLAGS)} "
        f"{' '.join(fc.SOURCES)} (in {fc.CSRC}) -> {fc.LIB_PATH}"
    )
    for line in report.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return seconds


# -------------------------------------------------------- 3. kernel vs plain


def _operands(dev, gen, D, s_lead, u_lead, x_lead):
    def randn(*shape):
        return torch.randn(*shape, D, device=dev, generator=gen)

    return randn(*s_lead), randn(*u_lead), randn(*s_lead), randn(*x_lead)


def compare_fused(fc, dev, gen, label, D, s_lead, u_lead, x_lead) -> dict:
    """Normalized and absolute errors of K1, K2, K3 against the plain
    version on one shape."""
    s1, u, s2, x = _operands(dev, gen, D, s_lead, u_lead, x_lead)
    errs, abs_errs = {}, {}
    y, _, _ = fc.fused_raw(s1, u, s2, x, want_residuals=False)
    y_ref, i1_ref, i2_ref = fc.fused_plain(s1, u, s2, x, True)
    errs["fused_y"] = rel_err(y, y_ref)
    abs_errs["fused_y"] = (y - y_ref).abs().max().item()
    res = fc.fused_raw(s1, u, s2, x, want_residuals=True)
    errs["fused_res"] = max(rel_err(a, b) for a, b in zip(res, (y_ref, i1_ref, i2_ref)))
    abs_errs["fused_res"] = max(
        (a - b).abs().max().item() for a, b in zip(res, (y_ref, i1_ref, i2_ref))
    )
    inputs = [a.clone().requires_grad_() for a in (s1, u, s2, x)]
    ref_inputs = [a.clone().requires_grad_() for a in (s1, u, s2, x)]
    g = torch.randn(y.shape, device=dev, generator=gen)
    grads = torch.autograd.grad(fc.WhviMulFunction.apply(*inputs), inputs, g)
    ref = torch.autograd.grad(fc.fused_plain(*ref_inputs, False)[0], ref_inputs, g)
    errs["fused_bwd"] = max(rel_err(a, b) for a, b in zip(grads, ref))
    abs_errs["fused_bwd"] = max((a - b).abs().max().item() for a, b in zip(grads, ref))
    torch.cuda.synchronize()
    log(
        f"  {label:<26} D={D:<6} "
        + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
    )
    for name, err in errs.items():
        check(err <= KERNEL_TOL, f"{name} at {label} D={D}: error {err:.3e} > {KERNEL_TOL}")
    return abs_errs


def compare_fwht(fc, dev, gen, label, shape) -> float:
    x = torch.randn(*shape, device=dev, generator=gen)
    err_f = rel_err(fc.fwht_raw(x), fc.fwht_plain(x))
    abs_f = (fc.fwht_raw(x) - fc.fwht_plain(x)).abs().max().item()
    xg = x.clone().requires_grad_()
    g = torch.randn(shape, device=dev, generator=gen)
    (dx,) = torch.autograd.grad(fc.FwhtFunction.apply(xg), xg, g)
    err_b = rel_err(dx, fc.fwht_plain(g))
    torch.cuda.synchronize()
    log(f"  {label:<26} D={shape[-1]:<6} fwht={err_f:.2e} fwht_bwd={err_b:.2e}")
    check(max(err_f, err_b) <= KERNEL_TOL, f"fwht at {label}: {err_f:.3e}/{err_b:.3e}")
    return abs_f


# the flagship's shapes: (label, D, s1/s2 lead, u lead, x lead)
FLAGSHIP_SHAPES = [
    ("stack8x16 train u/sample", 16, (8,), (4, 1, 8), (4, 64, 1)),
    ("stack8x16 train u/row", 16, (8,), (4, 64, 8), (4, 64, 1)),
    ("square128 train u/sample", 128, (), (4, 1), (4, 64)),
    ("square128 train u/row", 128, (), (4, 64), (4, 64)),
    ("stack8x16 eval", 16, (8,), (64, 1, 8), (64, 51, 1)),
    ("square128 eval", 128, (), (64, 1), (64, 51)),
]


def kernels_vs_plain(fc, dev, seed) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"kernels vs plain (max |kernel - plain| / max |plain| <= {KERNEL_TOL}):")
    for D in (2, 4, 16, 128, 1024, 2048, 16384):
        compare_fused(fc, dev, gen, "(D,) diagonals, 64 rows", D, (), (), (64,))
        compare_fwht(fc, dev, gen, "fwht 64 rows", (64, D))
    max_abs = dict.fromkeys(KERNELS, 0.0)
    for label, D, s_lead, u_lead, x_lead in FLAGSHIP_SHAPES:
        for k, v in compare_fused(fc, dev, gen, label, D, s_lead, u_lead, x_lead).items():
            max_abs[k] = max(max_abs[k], v)
    for label, shape in (("column head train", (4, 1, 1, 128)), ("column head eval", (64, 1, 1, 128))):
        max_abs["fwht"] = max(max_abs["fwht"], compare_fwht(fc, dev, gen, label, shape))
    return max_abs


def kernel_times(fc, dev, seed) -> dict:
    """(kernel ms, plain ms) at the flagship's shapes; the first shape of
    each kernel is the one reported in the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    times = {}
    log("times at the flagship's shapes (ms per call, CUDA events, median of 7 x 20):")
    for name, label, shape in (
        ("fused_y", "square128 eval", FLAGSHIP_SHAPES[5]),
        ("fused_y", "stack8x16 eval", FLAGSHIP_SHAPES[4]),
        ("fused_res", "square128 train u/sample", FLAGSHIP_SHAPES[2]),
        ("fused_res", "stack8x16 train u/sample", FLAGSHIP_SHAPES[0]),
        ("fused_bwd", "square128 train u/sample", FLAGSHIP_SHAPES[2]),
        ("fused_bwd", "stack8x16 train u/sample", FLAGSHIP_SHAPES[0]),
    ):
        s1, u, s2, x = _operands(dev, gen, *shape[1:])
        if name == "fused_bwd":
            g = fc.fused_plain(s1, u, s2, x, False)[0].contiguous()
            kernel = lambda: fc.fused_bwd_raw(s1, u, s2, g)  # noqa: E731
            plain = lambda: fc.fused_plain(s2, u, s1, g, True)  # noqa: E731
        else:
            res = name == "fused_res"
            kernel = lambda: fc.fused_raw(s1, u, s2, x, res)  # noqa: E731
            plain = lambda: fc.fused_plain(s1, u, s2, x, res)  # noqa: E731
        # plain, kernel, kernel, plain: each version's mean of its two turns
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  {name:<9} {label:<26} kernel {k_ms:.4f}  plain {p_ms:.4f}")
        times.setdefault(name, (k_ms, p_ms))
    for label, shape in (("column head train", (4, 1, 1, 128)), ("column head eval", (64, 1, 1, 128))):
        x = torch.randn(*shape, device=dev, generator=gen)
        p1, k1, k2, p2 = (
            cuda_ms(lambda: fc.fwht_plain(x)), cuda_ms(lambda: fc.fwht_raw(x)),
            cuda_ms(lambda: fc.fwht_raw(x)), cuda_ms(lambda: fc.fwht_plain(x)),
        )
        log(f"  fwht      {label:<26} kernel {(k1 + k2) / 2:.4f}  plain {(p1 + p2) / 2:.4f}")
        times.setdefault("fwht", ((k1 + k2) / 2, (p1 + p2) / 2))
    return times


# ------------------------------------------------------------------ 4. slice


def synthetic_regression(seed: int, n_train=455, n_test=51, d=13):
    """Boston-sized regression data: a fixed random ReLU net of the
    features plus noise, standardized with the training split's moments."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n_train + n_test, d)
    W1 = rng.randn(d, 32) / math.sqrt(d)
    W2 = rng.randn(32, 1) / math.sqrt(32)
    f = np.maximum(X @ W1, 0.0) @ W2
    y = f + 0.3 * f.std() * rng.randn(*f.shape)
    Xtr, Xte, ytr, yte = X[:n_train], X[n_train:], y[:n_train], y[n_train:]
    mx, sx = Xtr.mean(0), Xtr.std(0) + 1e-8
    my, sy = ytr.mean(0), ytr.std(0) + 1e-8
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32((Xtr - mx) / sx), f32((ytr - my) / sy)), (
        f32((Xte - mx) / sx),
        f32((yte - my) / sy),
    )


def run_slice(fc, dev, seed) -> dict:
    from whvi_tpu_torch.models import WHVILinear, WHVIRegression, mlp_layers
    from whvi_tpu_torch.train import TrainConfig, Trainer

    (X, y), (Xt, yt) = synthetic_regression(seed)
    net = WHVIRegression(mlp_layers(13, 1, hidden=(128, 128)), train_samples=4, eval_samples=64)
    cfg = TrainConfig(epochs1=2, epochs2=20, epochs_per_call=2, batch_size=64)
    trainer = Trainer(net, cfg, device=dev)
    state = trainer.init(seed)
    log(f"slice: flagship 13->128->128->1, S=4 train / 64 eval, batch 64, "
        f"{len(X)} train / {len(Xt)} test rows, epochs {cfg.epochs1}+{cfg.epochs2}")

    fc.reset_launches()
    state, logs = trainer.fit(
        state, X, y,
        log_fn=lambda e: log(
            f"  epoch {e['epoch']:>3} phase {e['phase']} loss {e['loss']:.4f} "
            f"mnll {e['mnll']:.4f} kl {e['kl']:.4f} t {e['seconds']:.3f} s"
        ),
    )
    metrics = trainer.evaluate(Xt, yt, torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)

    warm_epochs = logs[-1]["epoch"] - logs[0]["epoch"]
    warm_s = logs[-1]["seconds"] - logs[0]["seconds"]
    log(f"  warm epochs/s (after the first chunk): {warm_epochs / warm_s:.2f} "
        f"({warm_epochs} epochs in {warm_s:.3f} s)")
    log("  eval: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the slice")
    check(all(math.isfinite(e["loss"]) for e in logs), "non-finite training loss")
    check(logs[-1]["loss"] < logs[0]["loss"], "the loss did not fall")
    for k in ("rmse", "pred_mnll_per_point", "coverage95"):
        check(math.isfinite(metrics[k]), f"non-finite {k}")

    # the trained net on the card (kernels) against a CPU copy (plain)
    cpu_net = copy.deepcopy(trainer.net).cpu()
    rng = np.random.RandomState(seed + 2)
    xb, yb = torch.from_numpy(X[:64]), torch.from_numpy(y[:64])
    eps = [
        torch.from_numpy(rng.randn(4, 1, *l.matrix.g_mu.shape).astype(np.float32))
        if isinstance(l, WHVILinear) else None
        for l in cpu_net.layers
    ]
    results = []
    for model, d in ((trainer.net, dev), (cpu_net, torch.device("cpu"))):
        model.zero_grad(set_to_none=True)
        e = [None if a is None else a.to(d) for a in eps]
        loss, _ = model.loss(xb.to(d), yb.to(d), len(X), weights=None, eps=e)
        loss.backward()
        with torch.no_grad():
            y_hat = model.predict(xb.to(d), 4, eps=e)
        grads = [p.grad.detach().cpu() for p in model.parameters()]
        results.append((loss.detach().cpu(), y_hat.cpu(), grads))
    (l_k, y_k, g_k), (l_p, y_p, g_p) = results
    loss_err, pred_err = rel_err(l_k, l_p), rel_err(y_k, y_p)
    grad_err = max(rel_err(a, b) for a, b in zip(g_k, g_p))
    log(f"  card vs CPU on the same noise: loss {loss_err:.2e}, predictions {pred_err:.2e} "
        f"(<= {SLICE_TOL}), gradients {grad_err:.2e} (<= {SLICE_GRAD_TOL})")
    check(max(loss_err, pred_err) <= SLICE_TOL, "slice loss/predictions disagree with the CPU")
    check(grad_err <= SLICE_GRAD_TOL, "slice gradients disagree with the CPU")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    smi = probe()
    from whvi_tpu_torch.ops import fwht_cuda as fc

    dev = torch.device("cuda", 0)
    build(fc)
    max_abs = kernels_vs_plain(fc, dev, args.seed)
    times = kernel_times(fc, dev, args.seed)
    launches = run_slice(fc, dev, args.seed)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_abs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name, (source, replaces) in KERNELS.items()
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
