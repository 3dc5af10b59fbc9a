"""Smoke run of whvi_tpu_torch on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure:

1. Probe: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), nvcc, triton; TF32 off. Exits non-zero without a GPU.
2. Build: nvcc compiles each of whvi_tpu_torch/csrc/*.cu for sm_90a, all
   at once, and links them into one library.
3. Kernels vs their plain PyTorch versions on the card, forward with and
   without residuals, backward through autograd, and the bare FWHT
   forward and backward, from D=2 to 16384, at the flagship's broadcast
   shapes and at the scaling path's (u (8,1,4096) over x (256,4096)
   expanded to (8,256,4096); the column head (8,1,1,4096)); max |kernel -
   plain| / max |plain| <= 1e-5, and every forward equal to the plain
   version bit for bit. Times
   (CUDA events, warm, median of 7 rounds of 20 calls, host cost
   included) of each kernel and its plain version at the flagship's
   shapes, logged.
4. The slice: the flagship WHVI MLP 13 -> 128 -> 128 -> 1 (4 MC samples
   in training, 64 in evaluation, batch 64) on random weights from
   --seed trains two-phase for 2 + 20 epochs on synthetic regression data
   of Boston's split sizes and is evaluated; every kernel must have been
   launched by that run, and no operand copied for alignment
   (fwht_cuda.REALIGNED). The trained net's loss, predictions and
   gradients on the card (kernels) are held against a CPU copy (plain
   versions) on the same noise.
5. The large-D kernel-diagnosis path (whvi_tpu_torch/ops/kron_cuda.py):
   each of its 13 kernels against its plain version at B=512, row tiles
   of 4 and 32 (and of 256, two tiles, for copy_2d, k_copy, emit_copy,
   k_swap, k_cur, k_onecast, k_mm1, k_mm2, k_full, k_flat and emit_full) and D = 128,
   1024, 8192, 16384 (shapes first, then values; tolerances
   kron_cuda.tol; the copies and the scale bit for bit), the full-product
   variants also against the fp32 product (BF16_TOL), and k_full, k_flat
   and emit_full (one kernel) against each other bit for bit; device times
   (CUDA graph replay) of kernel and plain at D=16384, B=512, TB=4, each
   with its share of HBM and bound, the persistent kernels (copy_2d,
   emit_copy, k_swap, k_cur, k_onecast, k_mm1, k_mm2, k_full, k_flat,
   emit_full) also at TB = 64, 128, 256, the ratio of k_scale, emit_copy
   and hbm_copy to their library call and the share of their bound of the
   row kernels and of the wgmma kernel at 1, 2 and 4 contractions (logged,
   not held). Then the path itself: the three entry
   points kernel_diag (and --floors), kernel_tune and kernel_check at
   their default sizes with few iterations; every one of the 13 kernels
   must have been launched by that run, and the entry points' own error
   columns are checked.
6. The large-D scaling path in K1-K3's bf16 mode (the Pallas kernels'
   default precision="bf16"): (a) each bf16 kernel against its bf16 plain
   version (y, residuals, and the backward through autograd against the
   plain backward, vjp_plain), at D = 4, 64, 1024, 2048, 4096, 16384 with
   (D,) diagonals and at the scaling path's shapes, u (8, 1, D) over x
   (256, D) expanded to (8, 256, D), D = 1024, 4096; tolerance
   fwht_cuda.bf16_tol, 2^-6/sqrt(f), f the last contraction after the last
   rounding; y also against the fp32 product (kron_cuda.BF16_TOL). (b)
   Device times (CUDA graph replay) of K1-K3 in both precisions and their
   plain versions at D = 4096, 2048 rows, each beside its bound (bytes
   read once and written once over 3.35 TB/s, or operations over the
   peak); K1 also at D=16384, B=512; K4 at the scaling path's column head
   beside torch.matmul(x, H_D). (c) The path itself:
   run_scaling.main at --sizes 4096 (its 50 steps a run: fewer are within
   the host clock's noise), train and --predict, fp32 and bf16; its rows
   must be finite, the three bf16 kernels and K4 must have been
   launched by that run, and no operand copied for alignment. Then the
   bf16 scaling net on the
   card against a CPU copy on the same weights and noise (loss, MNLL and
   predictions within kron_cuda.BF16_TOL; the gradients' error printed).
7. The rest of the model family, on K1-K4 in fp32: (a) BASELINE config 4
   through run_mnist.main --data synthetic at its default widths, 784 ->
   1024 -> 1024 -> 10 (stacked, square, stacked), batch 256, 1 + 2
   epochs; its loss must fall. (b) BASELINE config 3 with the protocol's
   split head (16 -> 512 padded -> 512 -> Parallel of two column heads,
   lambda 1e-5 and 1.0, per-example noise and the per-row column LRT,
   HeteroscedasticGaussianLikelihood(sigma0=0.3)), batch 256, 1 + 3
   epochs, its noise branch frozen for half the steps: the branch must
   equal its init (torch.equal) up to the boundary and differ after it.
   Both paths must launch K1-K3, the split head K4 too, with no operand
   copied for alignment, and each trained net on the card is held against
   a CPU copy on the same noise (loss and predictions within SLICE_TOL,
   gradients within SLICE_GRAD_TOL), counting the launches of one train
   step and one predictive call. (c) run_baseline_configs (config 3,
   --epochs2 20) and toy_bench (--epochs 200) through their entry points:
   their rows must be finite. Warm epochs/s and launches are logged.

Before the last line it prints one JSON object of the kernels (each with
its launches on the main path, max abs error, ms, plain_ms, bound_ms,
bound_by and library_ms; the error and the times both at the scaling
path's shapes for K1-K4, at D=16384, B=512, TB=4 for the large-D
kernels) and the nvidia-smi line; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from whvi_tpu_torch.utils.profiling import cuda_ms

KERNEL_TOL = 1e-5  # fp32 butterflies: same adds as the plain version
SLICE_TOL = 1e-5  # loss and predictions, card (kernels) vs CPU (plain)
# Gradients sum S*B rows in another order on the card than on the CPU,
# with cancellation between rows.
SLICE_GRAD_TOL = 1e-4

_FUSED = "whvi_tpu_torch/csrc/whvi_fused.cu"
KERNELS = {
    # counter (fwht_cuda.LAUNCHES): (source, the TPU kernel it replaces)
    "fused_y": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_res": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_bwd": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:403"),
    "fwht": ("whvi_tpu_torch/csrc/fwht.cu", "whvi_tpu/ops/fwht_pallas.py:191"),
    "fused_y_bf16": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_res_bf16": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_bwd_bf16": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:403"),
}
FLAGSHIP_KERNELS = ("fused_y", "fused_res", "fused_bwd", "fwht")  # phases 3-4
BF16_KERNELS = ("fused_y_bf16", "fused_res_bf16", "fused_bwd_bf16")  # phase 6


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, want) -> float:
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale


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


def compare_fused(fc, dev, gen, label, D, s_lead, u_lead, x_lead, samples=None) -> dict:
    """Normalized and absolute errors of K1, K2, K3 against the plain
    version on one shape; x (*x_lead, D), expanded to (samples, *x_lead, D)
    when samples is given. The forward (y, and y, i1, i2 with residuals)
    must equal the plain version bit for bit."""
    s1, u, s2, x0 = _operands(dev, gen, D, s_lead, u_lead, x_lead)
    x = x0 if samples is None else x0.expand(samples, *x0.shape)
    errs, abs_errs = {}, {}
    y, _, _ = fc.fused_raw(s1, u, s2, x, want_residuals=False)
    y_ref, i1_ref, i2_ref = fc.fused_plain(s1, u, s2, x, True)
    check(torch.equal(y, y_ref), f"fused_y at {label} D={D} is not the plain y bit for bit")
    errs["fused_y"] = rel_err(y, y_ref)
    abs_errs["fused_y"] = (y - y_ref).abs().max().item()
    res = fc.fused_raw(s1, u, s2, x, want_residuals=True)
    check(all(torch.equal(a, b) for a, b in zip(res, (y_ref, i1_ref, i2_ref))),
          f"fused_res at {label} D={D} is not the plain y, i1, i2 bit for bit")
    errs["fused_res"] = max(rel_err(a, b) for a, b in zip(res, (y_ref, i1_ref, i2_ref)))
    abs_errs["fused_res"] = max(
        (a - b).abs().max().item() for a, b in zip(res, (y_ref, i1_ref, i2_ref))
    )
    leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x0)]
    ref_leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x0)]
    inputs, ref_inputs = (
        [*l[:3], l[3] if samples is None else l[3].expand(samples, *x0.shape)]
        for l in (leaves, ref_leaves)
    )
    g = torch.randn(y.shape, device=dev, generator=gen)
    grads = torch.autograd.grad(fc.WhviMulFunction.apply(*inputs), leaves, g)
    ref = torch.autograd.grad(fc.fused_plain(*ref_inputs, False)[0], ref_leaves, g)
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
    """Errors of K4 forward and backward against the plain version; the
    forward must equal it bit for bit. Returns the forward's max abs error."""
    x = torch.randn(*shape, device=dev, generator=gen)
    y, y_ref = fc.fwht_raw(x), fc.fwht_plain(x)
    check(torch.equal(y, y_ref), f"fwht at {label} is not the plain version bit for bit")
    err_f = rel_err(y, y_ref)
    abs_f = (y - y_ref).abs().max().item()
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
    """K1-K4 in fp32 against their plain versions over D = 2..16384, at the
    flagship's shapes and at the scaling path's, where the kernels line
    times them (fused_times, fwht_times). Returns the max abs errors at the
    scaling path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"kernels vs plain (max |kernel - plain| / max |plain| <= {KERNEL_TOL}; "
        "forward bit for bit):")
    for D in (2, 4, 16, 128, 1024, 2048, 4096, 8192, 16384):
        compare_fused(fc, dev, gen, "(D,) diagonals, 64 rows", D, (), (), (64,))
        compare_fwht(fc, dev, gen, "fwht 64 rows", (64, D))
    for label, D, s_lead, u_lead, x_lead in FLAGSHIP_SHAPES:
        compare_fused(fc, dev, gen, label, D, s_lead, u_lead, x_lead)
    for label, shape in (("column head train", (4, 1, 1, 128)), ("column head eval", (64, 1, 1, 128))):
        compare_fwht(fc, dev, gen, label, shape)
    S, B, D = SCALING_S, SCALING_B, SCALING_D
    max_abs = compare_fused(fc, dev, gen, f"u ({S},1,D), x ({S},{B},D)", D, (), (S, 1), (B,), S)
    max_abs["fwht"] = compare_fwht(fc, dev, gen, "scaling column head", (S, 1, 1, D))
    return max_abs


def kernel_times(fc, dev, seed) -> None:
    """Logs kernel and plain ms a call at the flagship's shapes, eager, the
    wrappers' host cost included. The kernels line takes device times at
    the scaling path's shapes instead (fused_times, fwht_times)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
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
    for label, shape in (("column head train", (4, 1, 1, 128)), ("column head eval", (64, 1, 1, 128))):
        x = torch.randn(*shape, device=dev, generator=gen)
        p1, k1, k2, p2 = (
            cuda_ms(lambda: fc.fwht_plain(x)), cuda_ms(lambda: fc.fwht_raw(x)),
            cuda_ms(lambda: fc.fwht_raw(x)), cuda_ms(lambda: fc.fwht_plain(x)),
        )
        log(f"  fwht      {label:<26} kernel {(k1 + k2) / 2:.4f}  plain {(p1 + p2) / 2:.4f}")


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
    from whvi_tpu_torch.models import WHVIRegression, mlp_layers
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
    check(fc.REALIGNED == 0, f"the slice copied {fc.REALIGNED} misaligned operands")

    warm_epochs = logs[-1]["epoch"] - logs[0]["epoch"]
    warm_s = logs[-1]["seconds"] - logs[0]["seconds"]
    log(f"  warm epochs/s (after the first chunk): {warm_epochs / warm_s:.2f} "
        f"({warm_epochs} epochs in {warm_s:.3f} s)")
    log("  eval: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for name in FLAGSHIP_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the slice")
    check(all(math.isfinite(e["loss"]) for e in logs), "non-finite training loss")
    check(logs[-1]["loss"] < logs[0]["loss"], "the loss did not fall")
    for k in ("rmse", "pred_mnll_per_point", "coverage95"):
        check(math.isfinite(metrics[k]), f"non-finite {k}")

    # the trained net on the card (kernels) against a CPU copy (plain)
    net_vs_cpu(fc, "slice", trainer.net, X[:64], y[:64], len(X), np.random.RandomState(seed + 2))
    return launches


def given_noise(net, B: int, rng) -> list:
    """Noise for each layer of ``net`` on x (train_samples, B, n_in), drawn
    from ``rng`` in layer order: an array of the matrix's noise shape for a
    WHVI layer (per row with per-example noise), a tuple of the branches'
    for a Parallel, None otherwise."""
    from whvi_tpu_torch.models import Parallel, WHVILinear

    def noise(layer):
        if isinstance(layer, Parallel):
            return tuple(noise(b) for b in layer.branches)
        if not isinstance(layer, WHVILinear):
            return None
        x = torch.empty(net.train_samples, B, layer.n_in, device="meta")
        shape = layer.matrix.noise_shape(x, layer.lrt and layer.per_example_noise)
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    return [noise(layer) for layer in net.layers]


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(t, device) for t in tree)
    return tree.to(device)


def net_vs_cpu(fc, label, net, X, Y, n, rng) -> dict:
    """The net on the card (kernels) against a CPU copy (plain versions) on
    the rows X, Y and the same noise (given_noise): the loss and the
    predictions within SLICE_TOL, every parameter's gradient within
    SLICE_GRAD_TOL. Returns the launches of the card's loss and backward
    (one train step's kernels) and of its predictive call."""
    cpu_net = copy.deepcopy(net).cpu()
    S = net.train_samples
    xb, yb = torch.from_numpy(X), torch.from_numpy(Y)
    eps = given_noise(cpu_net, len(X), rng)
    results, launches = [], {}
    for model, d in ((net, next(net.parameters()).device), (cpu_net, torch.device("cpu"))):
        model.zero_grad(set_to_none=True)
        e = _to(eps, d)
        fc.reset_launches()
        loss, _ = model.loss(xb.to(d), yb.to(d), n, weights=None, eps=e)
        loss.backward()
        launches.setdefault("step", dict(fc.LAUNCHES))
        fc.reset_launches()
        with torch.no_grad():
            y_hat = model.predict(xb.to(d), S, eps=e)
        launches.setdefault("predict", dict(fc.LAUNCHES))
        grads = [p.grad.detach().cpu() for p in model.parameters()]
        results.append((loss.detach().cpu(), y_hat.cpu(), grads))
    (l_k, y_k, g_k), (l_p, y_p, g_p) = results
    loss_err, pred_err = rel_err(l_k, l_p), rel_err(y_k, y_p)
    grad_err = max(rel_err(a, b) for a, b in zip(g_k, g_p))
    log(f"  card vs CPU on the same noise: loss {loss_err:.2e}, predictions {pred_err:.2e} "
        f"(<= {SLICE_TOL}), gradients {grad_err:.2e} (<= {SLICE_GRAD_TOL})")
    check(max(loss_err, pred_err) <= SLICE_TOL, f"{label} loss/predictions disagree with the CPU")
    check(grad_err <= SLICE_GRAD_TOL, f"{label} gradients disagree with the CPU")
    return launches


# ------------------------------------------------------- 5. large-D kernels

_KRON = "whvi_tpu_torch/csrc/whvi_kron.cu"
_PIPE = "whvi_tpu_torch/csrc/whvi_pipe.cu"
_FULL = "whvi_tpu_torch/csrc/whvi_full.cu"
_COPY = "whvi_tpu_torch/csrc/copy_floor.cu"
KRON_KERNELS = {
    # counter: (source, the TPU kernel it replaces)
    "k_copy": (_KRON, "benchmarks/pallas_diag.py:73"),
    "k_scale": (_KRON, "benchmarks/pallas_diag.py:77"),
    "k_mm1": (_FULL, "benchmarks/pallas_diag.py:81"),
    "k_mm2": (_FULL, "benchmarks/pallas_diag.py:88"),
    "k_full": (_FULL, "benchmarks/pallas_diag.py:98"),
    "emit_full": (_FULL, "benchmarks/pallas_diag.py:120"),
    "hbm_copy": (_COPY, "benchmarks/pallas_diag.py:269"),
    "copy_2d": (_COPY, "benchmarks/pallas_diag.py:296"),
    "emit_copy": (_PIPE, "benchmarks/pallas_diag.py:322"),
    "k_cur": (_KRON, "benchmarks/pallas_tune.py:47"),
    "k_swap": (_KRON, "benchmarks/pallas_tune.py:57"),
    "k_flat": (_FULL, "benchmarks/pallas_tune.py:69"),
    "k_onecast": (_KRON, "benchmarks/pallas_tune.py:85"),
}
KRON_B = 512
KRON_TB = 4  # 128 row tiles of 4 rows: one block for most of the 132 SMs
# the kernels whose design holds at any tile: also checked at two tiles of
# 256 rows; the persistent ones also timed at kernel_diag --floors' tiles
FULL_KERNELS = ("k_full", "k_flat", "emit_full")  # one wgmma kernel: equal bit for bit
MM_KERNELS = ("k_mm1", "k_mm2")  # the same kernel after one or two contractions
WIDE_TILE_KERNELS = ("k_copy", "copy_2d", "emit_copy", "k_swap", "k_cur", "k_onecast",
                     *MM_KERNELS, *FULL_KERNELS)
COPY_2D_TBS = (64, 128, 256)
PERSISTENT = ("copy_2d", "emit_copy", "k_swap", "k_cur", "k_onecast", *MM_KERNELS,
              *FULL_KERNELS)
ROW_KERNELS = ("k_swap", "k_cur", "k_onecast")  # rows in registers: share of bound logged
# redesigned to beat one PyTorch call: their ratio to it is logged
REDESIGNED = ("k_scale", "emit_copy", "hbm_copy")


def _kron_operands(dev, gen, D):
    s1, u, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(3))
    return s1, u, s2, torch.randn(KRON_B, D, device=dev, generator=gen)


def kron_vs_plain(kc, fc, dev, seed) -> dict:
    """Each large-D kernel against its plain version; raises past its
    tolerance (kc.tol, normalized by max |plain|), for the full product
    past kc.BF16_TOL against the fp32 product, and unless the FULL_KERNELS
    agree bit for bit. Returns max |kernel - plain| at D=16384, TB=4,
    where kron_times times them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_abs = {}
    log(f"large-D kernels vs plain (B={KRON_B}; max |kernel - plain| / max |plain|, "
        f"and for the full product vs the fp32 product, <= {kc.BF16_TOL:.2e}):")
    for D in (128, 1024, 8192, 16384):
        s1, u, s2, x = _kron_operands(dev, gen, D)
        fp32 = fc.fused_plain(s1, u, s2, x, False)[0]
        for tb in (KRON_TB, 32, 256):
            errs, outs = {}, {}
            for name in KRON_KERNELS if tb != 256 else WIDE_TILE_KERNELS:
                y = outs[name] = kc.VARIANTS[name](s1, u, s2, x, tb)
                ref = kc.plain(name, s1, u, s2, x)
                torch.cuda.synchronize()
                err = rel_err(y, ref)
                check(err <= kc.tol(name, D), f"{name} at D={D} tb={tb}: {err:.3e} > {kc.tol(name, D)}")
                check(kc.tol(name, D) > 0 or torch.equal(y, ref), f"{name} at D={D} tb={tb}: not bit for bit")
                if D == 16384 and tb == KRON_TB:
                    max_abs[name] = (y - ref).abs().max().item()
                errs[name] = err
                if name in kc.FULL_PRODUCT:
                    e32 = rel_err(y, fp32)
                    check(e32 <= kc.BF16_TOL, f"{name} at D={D} tb={tb} vs fp32: {e32:.3e}")
                    errs[name + "/fp32"] = e32
            check(all(torch.equal(outs[FULL_KERNELS[0]], outs[n]) for n in FULL_KERNELS),
                  f"{', '.join(FULL_KERNELS)} at D={D} tb={tb}: not one kernel bit for bit")
            log(f"  D={D:<6} tb={tb:<3} " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))
    return max_abs


def kron_ops(name: str, B: int, D: int) -> tuple[float, float]:
    """(operations, peak rate) of a large-D kernel on (B, D): each factor
    contraction 2 B D f multiply-adds on the bf16 tensor cores (f = 128 for
    H_128, a = D / 128 for H_a), a diagonal product B D fp32 operations."""
    from whvi_tpu_torch.utils.profiling import H100_PEAK_BF16_FLOPS, H100_PEAK_FP32_FLOPS

    a = D // 128
    contractions = {"k_mm1": 128, "k_mm2": 128 + a}.get(name, 2 * (128 + a))
    if name in ("k_copy", "hbm_copy", "copy_2d", "emit_copy"):
        return 0.0, H100_PEAK_FP32_FLOPS
    if name == "k_scale":
        return float(B * D), H100_PEAK_FP32_FLOPS
    return 2.0 * B * D * contractions, H100_PEAK_BF16_FLOPS


def kron_times(kc, dev, seed) -> dict:
    """Kernel, plain and bound of each large-D kernel at D=16384, B=512,
    TB=4: device time of 20 calls in one CUDA graph (the benchmarks'
    time_us), so the wrappers' host cost does not hide the copies' device
    time. Each is logged with its share of HBM (2 * B * D * 4 bytes a call
    against 3.35 TB/s), the PERSISTENT kernels also at the tiles of
    COPY_2D_TBS, the kernels of REDESIGNED with their ratio to their
    library call, and the ROW_KERNELS, MM_KERNELS and FULL_KERNELS with
    their share of their bound. The copies' and the scale's plain version is one PyTorch call (x.clone(),
    x * s1), which is also their library call; the products have none (no
    one call rounds to bf16 between the factors)."""
    from whvi_tpu_torch.bench.common import bound_ms, rates, time_us

    D = 16384
    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, u, s2, x = _kron_operands(dev, gen, D)
    times = {}
    log(f"large-D times at D={D}, B={KRON_B}, TB={KRON_TB} (device ms per call, 20 calls "
        "in a CUDA graph, median of 5 replays, plain/kernel/kernel/plain; share of HBM):")
    runs = [(name, KRON_TB) for name in kc.VARIANTS]
    runs += [(name, tb) for tb in COPY_2D_TBS for name in PERSISTENT]
    for name, tb in runs:
        fn = kc.VARIANTS[name]
        kernel = lambda: fn(s1, u, s2, x, tb)  # noqa: E731
        plain = lambda: kc.plain(name, s1, u, s2, x)  # noqa: E731
        p1, k1, k2, p2 = (time_us(f, 20) / 1e3 for f in (plain, kernel, kernel, plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        if tb == KRON_TB:
            diagonals = {"k_scale": (s1,), "k_mm1": (s2,), "k_mm2": (s2,)}.get(
                name, () if name in ("k_copy", "hbm_copy", "copy_2d", "emit_copy") else (s1, u, s2))
            bound, by = bound_ms((x, *diagonals), (x,), *kron_ops(name, KRON_B, D))
            one_call = name in ("k_copy", "hbm_copy", "copy_2d", "emit_copy", "k_scale")
            times[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                           "library_ms": p_ms if one_call else None}
        k_frac, p_frac = (rates(KRON_B, D, ms * 1e3)["hbm_frac"] for ms in (k_ms, p_ms))
        log(f"  {name:<10} TB={tb:<4} kernel {k_ms:.4f} ({k_frac:.3f})  "
            f"plain {p_ms:.4f} ({p_frac:.3f})")
    for name in REDESIGNED:
        t = times[name]
        log(f"  {name} / its library call at TB={KRON_TB}: {t['ms'] / t['library_ms']:.3f} "
            f"({t['ms']:.4f} / {t['library_ms']:.4f} ms; share of bound {t['bound_ms'] / t['ms']:.3f})")
    for name in ROW_KERNELS + MM_KERNELS + FULL_KERNELS:
        t = times[name]
        log(f"  {name}'s share of its bound at TB={KRON_TB}: {t['bound_ms'] / t['ms']:.3f} "
            f"({t['bound_ms']:.4f} / {t['ms']:.4f} ms)")
    return times


def run_diag_path(kc, seed) -> dict:
    """The large-D diagnosis path through its entry points, at their
    default sizes with few iterations; returns the launch counts."""
    from whvi_tpu_torch.bench import kernel_check, kernel_diag, kernel_tune

    s = ["--seed", str(seed)]
    log("diagnosis path: kernel_diag, kernel_diag --floors, kernel_tune, kernel_check")
    kc.reset_launches()
    diag = kernel_diag.main(["--iters", "3", *s])
    floors = kernel_diag.main(["--floors", "--iters", "3", *s])
    tune = kernel_tune.main(["--iters", "3", *s])
    kcheck = kernel_check.main(["--iters", "5", *s])
    torch.cuda.synchronize()
    launches = dict(kc.LAUNCHES)
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for name in KRON_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the diagnosis path")
    for row in diag + floors + tune:
        check(math.isfinite(row["us"]) and row["us"] > 0, f"bad time in {row}")
        if "rel_err" in row:
            check(row["rel_err"] <= kc.BF16_TOL, f"product off the fp32 product: {row}")
    check(len(diag) == 2 + 3 * 6 and len(floors) == 1 + 2 * 3 + 1 and len(tune) == 2 * (1 + 3 * 4 + 1),
          "an entry point left out variants")
    for row in kcheck:
        check(row["rel_err_fp32"] <= KERNEL_TOL, f"K1 off the fp32 plain product: {row}")
        check(row["rel_err_bf16"] <= kc.BF16_TOL, f"K1 off the bf16 Kronecker path: {row}")
    return launches


# ---------------------------------------------- 6. the large-D scaling path

SCALING_D, SCALING_S, SCALING_B = 4096, 8, 256  # run_scaling.py's cell


def compare_bf16(fc, kc, dev, gen, label, D, u_lead, x_rows, samples=None) -> dict:
    """Errors of K1-K3 in bf16 mode against the bf16 plain version on one
    shape: (D,) s1 and s2, u (*u_lead, D), x (x_rows, D), expanded to
    (samples, x_rows, D) when samples is given. Tolerances fc.bf16_tol
    (the first transform's for i1 and the u gradient); y also within
    kc.BF16_TOL of the fp32 product. Returns the max abs errors."""
    def randn(*lead):
        return torch.randn(*lead, D, device=dev, generator=gen)

    s1, s2, u, x0 = randn(), randn(), randn(*u_lead), randn(x_rows)
    x = x0 if samples is None else x0.expand(samples, x_rows, D)
    tol1, tol2 = fc.bf16_tol(D, transform=1), fc.bf16_tol(D)
    errs, abs_errs = {}, {}

    def record(name, triples):
        for got, want, tol in triples:
            err = rel_err(got, want)
            check(err <= tol, f"{name} at {label} D={D}: error {err:.3e} > {tol:.3e}")
            errs[name] = max(errs.get(name, 0.0), err)
            abs_errs[name] = max(abs_errs.get(name, 0.0), (got - want).abs().max().item())

    y_ref, i1_ref, i2_ref = fc.fused_plain(s1, u, s2, x, True, "bf16")
    y = fc.fused_raw(s1, u, s2, x, False, "bf16")[0]
    record("fused_y_bf16", [(y, y_ref, tol2)])
    res = fc.fused_raw(s1, u, s2, x, True, "bf16")
    record("fused_res_bf16", zip(res, (y_ref, i1_ref, i2_ref), (tol2, tol1, tol2)))
    leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x0)]
    x_leaf = leaves[3] if samples is None else leaves[3].expand(samples, x_rows, D)
    out = fc.WhviMulFunction.apply(*leaves[:3], x_leaf, "bf16")
    g = torch.randn(out.shape, device=dev, generator=gen)
    grads = torch.autograd.grad(out, leaves, g)
    ref = [r.sum_to_size(a.shape) for r, a in zip(fc.vjp_plain(s1, u, s2, x, g, "bf16"), grads)]
    record("fused_bwd_bf16", zip(grads, ref, (tol2, tol1, tol2, tol2)))
    e32 = rel_err(y, fc.fused_plain(s1, u, s2, x, False)[0])
    check(e32 <= kc.BF16_TOL, f"bf16 y at {label} D={D} vs the fp32 product: {e32:.3e}")
    torch.cuda.synchronize()
    log(f"  {label:<30} D={D:<6} " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
        + f" y/fp32={e32:.2e}")
    return abs_errs


def bf16_vs_plain(fc, kc, dev, seed) -> dict:
    """Returns the max abs errors at the scaling path's shape (D=4096),
    where the kernels line times the bf16 kernels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    log("bf16 kernels vs plain (max |kernel - plain| / max |plain| <= 2^-6/sqrt(f)), "
        f"y vs the fp32 product <= {kc.BF16_TOL:.2e}:")
    shapes = [("(D,) diagonals, 64 rows", D, (), 64, None) for D in (4, 64, 1024, 2048, 4096, 16384)]
    shapes += [
        (f"u ({SCALING_S},1,D), x ({SCALING_S},{SCALING_B},D)", D, (SCALING_S, 1), SCALING_B, SCALING_S)
        for D in (1024, SCALING_D)
    ]
    for label, D, u_lead, x_rows, samples in shapes:
        abs_errs = compare_bf16(fc, kc, dev, gen, label, D, u_lead, x_rows, samples)
    return abs_errs  # the last shape: the scaling path's at D=4096


def fused_ops(D: int, rows: int) -> int:
    """Operations of one fused product over ``rows`` rows: two transforms of
    D log2 D adds and three diagonal products an element (fp32 CUDA cores;
    the bf16 mode's roundings are conversions, not operations)."""
    return rows * (2 * D * int(math.log2(D)) + 3 * D)


def _timed(kernel, plain, bound, library=None) -> dict:
    """Device ms a call (20 calls in a CUDA graph, median of 5 replays) of
    kernel and plain version in turns (plain, kernel, kernel, plain), and
    of the library call after them, with the bound beside them."""
    from whvi_tpu_torch.bench.common import time_us

    p1, k1, k2, p2 = (time_us(f, 20) / 1e3 for f in (plain, kernel, kernel, plain))
    return {
        "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None if library is None else time_us(library, 20) / 1e3,
    }


def _log_time(label: str, t: dict) -> None:
    lib = "" if t["library_ms"] is None else f"  library {t['library_ms']:.4f}"
    log(f"  {label:<18} kernel {t['ms']:.4f}  plain {t['plain_ms']:.4f}  bound {t['bound_ms']:.4f} "
        f"({t['bound_by']}; share {t['bound_ms'] / t['ms']:.3f}){lib}")


def fused_times(fc, dev, seed) -> dict:
    """K1-K3 in both precisions at the scaling path's shape (D=4096,
    u (8,1,D), x (256,D) expanded to (8,256,D): 2048 rows), each with its
    bound (bytes: x, u, s1, s2 read once, the outputs written once), and
    K1 at D=16384, B=512 (PERF.md's large-D shape). Returns the kernels
    line's entries of the six kernels at the scaling shape."""
    from whvi_tpu_torch.bench.common import bound_ms
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    gen = torch.Generator(device=dev).manual_seed(seed)
    D, S, B = SCALING_D, SCALING_S, SCALING_B
    s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
    u = torch.randn(S, 1, D, device=dev, generator=gen)
    x = torch.randn(B, D, device=dev, generator=gen).expand(S, B, D)
    g = torch.randn(S, B, D, device=dev, generator=gen)
    ops = fused_ops(D, S * B)
    times = {}
    log(f"times at D={D}, u ({S},1,D), x ({S},{B},D) (device ms per call, 20 calls in a "
        "CUDA graph, median of 5 replays, plain/kernel/kernel/plain; bound and its share):")
    for precision in ("fp32", "bf16"):
        for name, kernel, plain, ins, n_out in (
            ("fused_y", lambda: fc.fused_raw(s1, u, s2, x, False, precision),
             lambda: fc.fused_plain(s1, u, s2, x, False, precision), (x, u, s1, s2), 1),
            ("fused_res", lambda: fc.fused_raw(s1, u, s2, x, True, precision),
             lambda: fc.fused_plain(s1, u, s2, x, True, precision), (x, u, s1, s2), 3),
            ("fused_bwd", lambda: fc.fused_bwd_raw(s1, u, s2, g, precision),
             lambda: fc.fused_plain(s2, u, s1, g, True, precision), (g, u, s1, s2), 3),
        ):
            t = _timed(kernel, plain, bound_ms(ins, [g] * n_out, ops, PEAK))
            key = name if precision == "fp32" else name + "_bf16"
            _log_time(f"{precision} {name}", t)
            times[key] = t
    D, B = 16384, KRON_B
    s1, u, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(3))
    x = torch.randn(B, D, device=dev, generator=gen)
    log(f"K1 at D={D}, B={B}:")
    for precision in ("fp32", "bf16"):
        t = _timed(lambda: fc.fused_raw(s1, u, s2, x, False, precision),
                   lambda: fc.fused_plain(s1, u, s2, x, False, precision),
                   bound_ms((x, u, s1, s2), (x,), fused_ops(D, B), PEAK))
        _log_time(f"{precision} fused_y", t)
    return times


def fwht_times(fc, dev, seed) -> dict:
    """K4 at the scaling path's column head, (8, 1, 1, 4096), beside
    torch.matmul(x, H_D) with H_D built once (TF32 off): the one PyTorch
    call that computes the same transform, timed as a yardstick only."""
    from whvi_tpu_torch.bench.common import bound_ms
    from whvi_tpu_torch.ops.hadamard import factor_H
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    D = SCALING_D
    x = torch.randn(SCALING_S, 1, 1, D, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    H = factor_H(D, torch.float32, dev)
    t = _timed(lambda: fc.fwht_raw(x), lambda: fc.fwht_plain(x),
               bound_ms((x,), (x,), x.numel() * int(math.log2(D)), PEAK),
               library=lambda: torch.matmul(x, H))
    log(f"K4 at the scaling path's column head, x {tuple(x.shape)} (library: x @ H_D):")
    _log_time("fwht", t)
    for rows, D in ((2048, SCALING_D), (KRON_B, 16384)):  # where its bytes dominate
        xb = torch.randn(rows, D, device=dev)
        tb = _timed(lambda: fc.fwht_raw(xb), lambda: fc.fwht_plain(xb),
                    bound_ms((xb,), (xb,), xb.numel() * int(math.log2(D)), PEAK))
        _log_time(f"fwht ({rows}, {D})", tb)
    return {"fwht": t}


def scaling_net_vs_cpu(dev, seed) -> None:
    """The bf16 scaling net on the card (kernels) against a CPU copy (plain
    versions) on the same weights, data and noise: loss, MNLL and
    predictions within kron_cuda.BF16_TOL. The kernels sum in butterfly
    order and the plain version in matmul order, and the elementwise ops
    differ in the last fp32 bit, so a rounding may flip. A flip perturbs
    its row downstream, the next layer's roundings of that row flip by the
    thousand, and within two layers the two nets differ as independent
    roundings would, about as far as the bf16 product from the fp32 one (a
    one-ulp change of the noise alone moves the predictions by 2.3e-3 to
    2.6e-3 on the CPU). The gradients, sums over 2048 rows that mostly
    cancel, move by up to 8.6e-3 under that one-ulp change: their error is
    printed, not held."""
    from whvi_tpu_torch.experiments import run_scaling
    from whvi_tpu_torch.models import WHVILinear
    from whvi_tpu_torch.ops import kron_cuda as kc
    from whvi_tpu_torch.ops import set_whvi_mul_precision

    D, S, B = SCALING_D, SCALING_S, SCALING_B
    net = run_scaling.build_net(D, S, dev)
    net.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    cpu_net = copy.deepcopy(net).cpu()
    X, y = run_scaling.data(D, B, seed, "cpu")
    rng = np.random.RandomState(seed + 3)
    eps = [
        torch.from_numpy(rng.randn(S, 1, *l.matrix.g_mu.shape).astype(np.float32))
        if isinstance(l, WHVILinear) else None
        for l in cpu_net.layers
    ]
    results = []
    set_whvi_mul_precision("bf16")
    try:
        for model, d in ((net, dev), (cpu_net, torch.device("cpu"))):
            e = [None if a is None else a.to(d) for a in eps]
            loss, aux = model.loss(X.to(d), y.to(d), B, eps=e)
            loss.backward()
            with torch.no_grad():
                pred = model.predict(X.to(d), S, eps=e)
            grads = [p.grad.detach().cpu() for p in model.parameters()]
            results.append((loss.detach().cpu(), aux["mnll"].detach().cpu(), pred.cpu(), grads))
    finally:
        set_whvi_mul_precision("fp32")
    (l_k, m_k, y_k, g_k), (l_p, m_p, y_p, g_p) = results
    errs = {"loss": rel_err(l_k, l_p), "mnll": rel_err(m_k, m_p), "predictions": rel_err(y_k, y_p)}
    grad_err = max(rel_err(a, b) for a, b in zip(g_k, g_p))
    log(f"  bf16 net D={D} card vs CPU on the same noise: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (<= {kc.BF16_TOL:.2e}); gradients {grad_err:.2e} (not held)")
    check(max(errs.values()) <= kc.BF16_TOL, "the bf16 scaling net disagrees with its CPU copy")


def run_scaling_path(fc, dev, seed) -> dict:
    """run_scaling at D=4096, train and predict, fp32 and bf16, through its
    entry point; returns the launch counts of that run."""
    from whvi_tpu_torch.experiments import run_scaling

    log(f"scaling path: run_scaling --sizes {SCALING_D}, train and predict, fp32 and bf16")
    fc.reset_launches()
    rows = []
    for precision in ("fp32", "bf16"):
        for predict in ([], ["--predict"]):
            rows += run_scaling.main([
                "--sizes", str(SCALING_D), "--seed", str(seed),
                "--precision", precision, *predict,
            ])
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; operands realigned {fc.REALIGNED}")
    check(fc.REALIGNED == 0, "the scaling path copied misaligned operands")
    check(len(rows) == 4, f"run_scaling gave {len(rows)} rows, not 4")
    for row in rows:
        check(run_scaling.finite(row), f"non-finite row {row}")
    for name in (*BF16_KERNELS, "fwht", "fused_y", "fused_res", "fused_bwd"):
        check(launches[name] > 0, f"kernel {name} was not launched by the scaling path")
    scaling_net_vs_cpu(dev, seed)
    return launches


# ------------------------------------------- 7. the rest of the model family

MNIST_EPOCHS = ("1", "2")  # run_mnist's --epochs1, --epochs2 in the smoke
HETERO_EPOCHS = (1, 3)  # the split-head net's epochs1, epochs2 (8 steps an epoch)
FAMILY_KERNELS = ("fused_y", "fused_res", "fused_bwd")  # K1-K3; K4 too on the split head


def _path_report(label, logs, launches, realigned, per_call) -> None:
    """Logs a path's warm epochs/s (after the first chunk), its launches
    and operands realigned (read just after the path), and its launches a
    train step and a predictive call."""
    warm_epochs = logs[-1]["epoch"] - logs[0]["epoch"]
    warm_s = logs[-1]["seconds"] - logs[0]["seconds"]
    log(f"  {label} warm epochs/s (after the first chunk): {warm_epochs / warm_s:.2f} "
        f"({warm_epochs} epochs in {warm_s:.3f} s)")
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; operands realigned {realigned}")
    for what, counts in per_call.items():
        log(f"  launches a {'train step' if what == 'step' else 'predictive call'}: "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    check(realigned == 0, f"{label} copied {realigned} misaligned operands")
    check(all(math.isfinite(e["loss"]) for e in logs), f"non-finite {label} training loss")


def run_mnist_path(fc, dev, seed) -> None:
    """(a) BASELINE config 4 through run_mnist.main: 784 -> 1024 -> 1024 ->
    10 at batch 256 on synthetic_classification for 1 + 2 epochs."""
    from whvi_tpu_torch.experiments import run_mnist

    log(f"config 4: run_mnist --data synthetic, 784->1024->1024->10, batch 256, "
        f"epochs {'+'.join(MNIST_EPOCHS)}")
    fc.reset_launches()
    row, trainer, logs = run_mnist.main([
        "--data", "synthetic", "--epochs1", MNIST_EPOCHS[0], "--epochs2", MNIST_EPOCHS[1],
        "--seed", str(seed),
    ])
    torch.cuda.synchronize()
    launches, realigned = dict(fc.LAUNCHES), fc.REALIGNED
    X, y = run_mnist.synthetic_classification(seed=seed)[0]
    per_call = net_vs_cpu(fc, "config 4", trainer.net, X[:256], y[:256, None].astype(np.float32),
                          len(X), np.random.RandomState(seed + 4))
    _path_report("config 4", logs, launches, realigned, per_call)
    for name in FAMILY_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by config 4")
    check(logs[-1]["loss"] < logs[0]["loss"], "the config 4 loss did not fall")
    check(0.0 <= row["test_accuracy"] <= 1.0, f"bad accuracy in {row}")


def hetero_split_net():
    """BASELINE config 3's 16 -> 512 -> 512 net with the protocol's split
    head, as whvi_tpu/evaluation.py:169-240 builds it with
    heteroscedastic=True: the mean branch at lambda_last 1e-5, the noise
    branch at lambda_noise 1.0, every WHVI layer with s_init "auto",
    per-example noise and the per-row column LRT."""
    from whvi_tpu_torch.models import (
        HeteroscedasticGaussianLikelihood, Parallel, WHVILinear, WHVINetwork, relu,
    )

    kw = dict(s_init="auto", per_example_noise=True, column_lrt=True, rect_mode="pad")
    layers = [
        WHVILinear(16, 512, 3.0, **kw), relu, WHVILinear(512, 512, 3.0, **kw), relu,
        Parallel([WHVILinear(512, 1, 1e-5, **kw), WHVILinear(512, 1, 1.0, **kw)]),
    ]
    return WHVINetwork(layers, HeteroscedasticGaussianLikelihood(sigma0=0.3),
                       train_samples=1, eval_samples=64)


def run_hetero_path(fc, dev, seed) -> None:
    """(b) the split-head config 3 net trained across a noise_freeze_steps
    boundary at half its steps; the noise branch must equal its init up to
    the boundary and differ after it."""
    from whvi_tpu_torch.experiments.run_baseline_configs import synthetic_hetero_data
    from whvi_tpu_torch.train import TrainConfig, Trainer

    X, y, _ = synthetic_hetero_data(seed=seed)
    n_tr = int(0.9 * len(X))
    steps = sum(HETERO_EPOCHS) * -(-n_tr // 256)
    cfg = TrainConfig(epochs1=HETERO_EPOCHS[0], epochs2=HETERO_EPOCHS[1], epochs_per_call=1,
                      batch_size=256, kl_warmup_steps=int(0.2 * steps),
                      noise_freeze_steps=steps // 2)
    trainer = Trainer(hetero_split_net(), cfg, device=dev)
    state = trainer.init(seed)
    net = trainer.net
    noise0 = [p.detach().clone() for p in net.layers[-1].branches[1].parameters()]
    mean0 = [p.detach().clone() for p in net.layers[-1].branches[0].parameters()]
    log(f"config 3 split head: 16->512(pad)->512->[1|1] column LRT, batch 256, "
        f"{n_tr} train rows, epochs {'+'.join(map(str, HETERO_EPOCHS))} "
        f"({steps} steps), noise frozen for {cfg.noise_freeze_steps} steps")

    def frozen_as_it_should(entry):
        same = all(torch.equal(p, q) for p, q in zip(net.layers[-1].branches[1].parameters(), noise0))
        log(f"  epoch {entry['epoch']} step {state.step} loss {entry['loss']:.4f}: "
            f"noise branch {'unchanged' if same else 'moved'}")
        check(same == (state.step <= cfg.noise_freeze_steps),
              f"noise branch at step {state.step}: unchanged={same}")

    fc.reset_launches()
    state, logs = trainer.fit(state, X[:n_tr], y[:n_tr], log_fn=frozen_as_it_should)
    metrics = trainer.evaluate(X[n_tr:], y[n_tr:], torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    launches, realigned = dict(fc.LAUNCHES), fc.REALIGNED
    check(state.step == steps, f"{state.step} steps, not {steps}")
    check(not all(torch.equal(p, q) for p, q in zip(net.layers[-1].branches[0].parameters(), mean0)),
          "the mean branch did not train")
    log("  eval: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    for k, v in metrics.items():
        check(math.isfinite(v), f"non-finite {k}")
    per_call = net_vs_cpu(fc, "config 3 split head", net, X[:256], y[:256], n_tr,
                          np.random.RandomState(seed + 5))
    _path_report("config 3 split head", logs, launches, realigned, per_call)
    for name in (*FAMILY_KERNELS, "fwht"):
        check(launches[name] > 0, f"kernel {name} was not launched by the split-head net")


def run_family_entry_points(fc, seed) -> None:
    """(d) run_baseline_configs (config 3, short --epochs2) and toy_bench
    (--epochs 200) through their entry points; their rows must be finite."""
    from whvi_tpu_torch.bench import toy_bench
    from whvi_tpu_torch.experiments import run_baseline_configs, run_scaling

    log("entry points: run_baseline_configs --skip 5 --epochs2 20, toy_bench --epochs 200")
    fc.reset_launches()
    rows = run_baseline_configs.main(["--skip", "5", "--epochs2", "20", "--seed", str(seed)])
    rows.append(toy_bench.main(["--epochs", "200"]))
    torch.cuda.synchronize()
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in fc.LAUNCHES.items() if v))
    check(len(rows) == 2, f"{len(rows)} rows, not 2")
    for row in rows:
        check(run_scaling.finite(row), f"non-finite row {row}")
    check(all(math.isfinite(r) and r > 0 for r in rows[-1]["runs"]), f"bad runs in {rows[-1]}")
    check(fc.REALIGNED == 0, "the entry points copied misaligned operands")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    smi = probe()
    from whvi_tpu_torch.ops import fwht_cuda as fc
    from whvi_tpu_torch.ops import kron_cuda as kc

    dev = torch.device("cuda", 0)
    build(fc)
    max_abs = kernels_vs_plain(fc, dev, args.seed)
    kernel_times(fc, dev, args.seed)
    launches = run_slice(fc, dev, args.seed)
    max_abs.update(kron_vs_plain(kc, fc, dev, args.seed))
    times = kron_times(kc, dev, args.seed)
    launches.update(run_diag_path(kc, args.seed))
    max_abs.update(bf16_vs_plain(fc, kc, dev, args.seed))
    times.update(fused_times(fc, dev, args.seed))
    times.update(fwht_times(fc, dev, args.seed))
    scaling = run_scaling_path(fc, dev, args.seed)
    launches.update({name: scaling[name] for name in BF16_KERNELS})
    run_mnist_path(fc, dev, args.seed)
    run_hetero_path(fc, dev, args.seed)
    run_family_entry_points(fc, args.seed)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_abs[name],
            **times[name],
        }
        for name, (source, replaces) in {**KERNELS, **KRON_KERNELS}.items()
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
