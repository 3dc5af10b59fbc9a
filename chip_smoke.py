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
   version bit for bit. Where fwht_cuda.sums_group takes a shape the
   backward runs K3's reduce mode (fused_bwd_sums), also held against its
   plain version, its dx K3's bit for bit; K3 itself is held bit for bit
   at every shape. A path's K3 launches count under either counter. Times
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
   Device times (CUDA graph replay) of K1-K3 and K3's reduce mode in both
   precisions and their plain versions at D = 4096, 2048 rows, each beside its bound (bytes
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
8. The UCI protocol (whvi_tpu_torch/evaluation.py), its splits stacked as
   the replicas of one net, on K1-K4 in fp32: (a) K1-K3 against their
   plain versions at the replica shapes, s1 (8,1,1,D), u (8,S,1,D), x
   (8,S,B,D) and the stacked layer's (8,1,1,8,16) diagonals, which read
   through 4 strided dims. (b) One stacked flagship step (R=8, 13 -> 128 ->
   128 -> 1 as ProtocolConfig builds it, batch 64) against a CPU copy on
   the same noise (SLICE_TOL, SLICE_GRAD_TOL), and a replica against its
   own unreplicated net on the card (STEP_TOL); the launches of a train
   step and of a predictive call must equal a single split's; ms a step of
   each, host clock. (c) evaluate_bayesian_regression stacked, R=8, on
   506 x 13 synthetic data, 2 + 6 epochs, calibrate, checkpoints every 2
   epochs: every K1-K4 launched, no operand realigned, protocol_wall_s and
   epochs_per_s_amortized logged; the same call again resumes and must give
   equal metrics; a stacked fit interrupted and resumed must equal the
   uninterrupted one (torch.equal); the sequential protocol on the same
   data for comparison. (d) evaluate_config_grid, lambda_hidden 1.0 and
   3.0 x 8 splits. (e) run_protocol_feasibility at n=8192, 8 features,
   1 + 2 epochs; (f) run_uci yacht --splits 8 --epochs1 1 --epochs2 4 on a
   synthetic 308 x 7 yacht file; their rows must be finite.

9. The golden samplers (whvi_tpu_torch/mcmc/), on K1-K4 in fp32: (a) the
   g log posterior and its gradient at 4 walkers on the card against a
   CPU copy (SLICE_TOL, MCMC_GRAD_TOL) at config 4's full width (784 ->
   1024 -> 1024 -> 10, 256 rows of synthetic_classification, 3072 g's)
   and on run_vi_vs_hmc's 6 -> 8 -> 1 net, with the launches of one
   gradient evaluation and of one value, and no operand realigned; (b) 5
   HMC and 5 NUTS draws of 2 chains on config 4's posterior from the same
   random numbers on the card and on a CPU copy (MCMC_DRAW_TOL); (c) the
   path: NUTS at config 4 (4 chains, depth 4, 10 + 10 draws) and
   parallel tempering on the 6 -> 8 -> 1 posterior (2 ladders of 4 rungs,
   10 + 10 rounds), each under torch.cuda.set_sync_debug_mode("error"),
   then the predictive of the tempering draws on held-out rows: every
   K1-K4 launched, no operand realigned, draws/s and gradient
   evaluations/s logged; (d) run_vi_vs_hmc's analytic tier cut to 4
   chains x (100 + 100) draws at depth 5: no divergence, the NUTS mean
   within ANALYTIC_MEAN_TOL_SD exact posterior sds of the exact mean and
   its sd within ANALYTIC_SD_RATIO_TOL of the exact sd.

10. bf16 storage (the JAX package's dtype=bfloat16) through K1-K4 and
   the column kernel: (a) each bf16-storage kernel (fused_y_bf16s,
   fused_res_bf16s, fused_bwd_bf16s, fwht_bf16s) against its plain
   version at the scaling path's shapes, u (8,1,D) over x (256,D)
   expanded to 2048 rows at D = 4096 and 8192, K1-K3 at D=16384, B=512
   (precision_check's shape), and K4 at (8,1,1,4096): every forward and
   the backward (against vjp_plain) bit for bit; the column kernel's
   three modes (column_y_bf16s, column_res_bf16s, column_bwd_bf16s)
   against column_plain / column_bwd_plain bit for bit at the column
   head (8,1,D), D = 4096 and 8192, the column LRT's rows (8,256,4096),
   8 replicas, and D = 2 and 16384. (b) run_scaling.main
   --dtype bf16 at --sizes 4096 8192, train and --predict: its rows
   finite, K1-K3 and the column kernel launched, no fp32-storage
   product, no bare fwht_bf16s and no operand realigned; the same with
   --profile 10 in a fresh process (this one's profiler has lost kernel
   records after the phases before); then the fp32 rows at the same D,
   step ms, device events and peak memory logged beside them. (c) The
   bf16 scaling net at D=4096 on the card against a CPU copy on the same
   weights and noise: loss and every gradient within 2^-7 of its max; a
   train step launches column_res_bf16s and column_bwd_bf16s once each,
   a predictive call column_y_bf16s once, neither fwht_bf16s. (d)
   Device times (CUDA graph replay) of the four kernels and their plain
   versions at D=4096, 2048 rows (K4 at the column head, beside
   torch.matmul(x, H_D) in bf16), and of K1-K3 at D=8192, each with its
   bound at 2 bytes an element; the column kernel's modes at the column
   head (8,1,D), D = 4096 and 8192, and at (8,256,4096), in turns with
   their plain versions, the chain they replaced and the launch floor (a
   kernel that does nothing on the same grid), beside g @ H_D; then
   bench/fwht_sweep.py at D = 256, 4096, 16384 (the launches of
   fwht_bf16s in the kernels line are this run's).

11. The mesh (whvi_tpu_torch/parallel/, no new kernel): the scaling model
   (batch 256, S=8) for 20 steps and a predictive call, (a) on the 1x1
   mesh of a world of one on NCCL against the unsharded trainer (loss,
   parameters and predictions within 1e-6; one all-reduce a step; the
   launches of one device), and run_scaling.main --mesh 1x1, train and
   --predict; (b) in a world of four ranks (NCCL, one a card, where there
   are four cards; else gloo, the four ranks sharing the one card) at
   meshes 2x2, 1x4 and 4x1 in fp32 and bf16 storage, 2x2 in the bf16
   precision and 1x4 at D=8192. Held: each step's loss and gradient
   against one device's at the same parameters and noise, and the last
   loss against one device's run (1e-5 fp32, 2^-7 bf16); the sharded
   predictions against one device's on the same parameters (1e-6); every
   rank's parameters equal to rank 0's (broadcast, torch.equal); each
   rank's launches a step and a call equal to one device's, one
   all-reduce a step, no operand realigned. Logged, not held: the
   parameters after 20 steps against one device's run, beside the same
   reading for one device against itself with the batch rows permuted
   (the same function, its sums in another order); then run_scaling.run
   on each storage mesh, train and predict, its step ms, call ms and
   peak memory a rank; (c) the flagship's Trainer on the 2x2 mesh for
   2 + 6 epochs against one device (loss, metrics and parameters, 1e-5)
   and evaluate_bayesian_regression on the split mesh, R=8 over the four
   ranks, against phase 8's stack (1e-6); (d) NUTS at config 4, its 4
   chains over the four ranks, each rank's chain against that chain run
   alone on one card from the same numbers (1e-5; the distance to phase
   9's batch of 4 chains is logged). A rank that fails fails the smoke;
   the phase's parts are timed.

12. The checks and figures (no new kernel), each through its entry point
   on the card, each part's launches counted alone: (a) bench/grad_check
   --backend all at --dim 64 and at the scaling path's D=4096 (batch 4):
   gradcheck and gradgradcheck of both transforms in float64, the
   autograd Functions' VJPs against the plain versions' (fp32 within
   grad_check.GRAD_TOL = 1e-5, the bf16 precision within bf16_tol) with
   K2-K4 and K2-K3 bf16 launched, and the float64 self-adjointness; (b)
   bench/precision_check at its sizes (D = 1024, 4096, 16384; the auto
   rows at 2048, 4096, 8192), batch 512, --iters cut from 100 to 20:
   rel_err_vs_f64 <= PRECISION_BOUND of each mode (fp32 1e-6; the bf16
   precision and bf16 storage 2^-7), auto_equals_fp32 at every D, K1 in
   each mode launched (us_per_call and hbm_frac logged beside PERF.md's K1
   rows); (c) bench/column_lrt_check at its sizes (D = 128, 1024, 8192,
   300 epochs, 64 draws): every variance finite, K4 launched; the
   gradient variance's direction at D=8192 logged (JAX's own rows put the
   column LRT on either side of the explicit sample: PERF.md); (d)
   bench/diag_matmul at its sizes: match_left and match_right; (e)
   utils.profiling.trace around one whvi_mul at D=4096 in a fresh
   process: the trace names whvi_fused_kernel, K1's symbol, and the call
   launched K1 once (in the smoke's own process, after phase 11's ranks
   used the card, torch.profiler loses kernel records, and trace raises);
   (f) bench/make_figures --quick --only toy_fan (500 + 2000 of 500 +
   20000 epochs): its JSON written, the
   with-KL net's predictive sd in the gap x in [0.6, 1.4] larger than the
   no-KL net's, K1-K4 launched. No part may copy an operand for
   alignment. The parts are timed.

13. The grouped WHVI product (whvi_tpu_torch/ops/grouped.py, the expert
   layer's) at the routed shape of the DeepSeek-V2 cell
   (dsv2lite-whvi.train-t1024): D=2048, 8 experts held x 4 samples (32
   segments, one empty), 13764 routed rows of 98304 top-6 choices over
   16384 (token, sample) rows, x gathered (gate and up) and not (down), in
   both precisions: K1 and K2 against grouped_plain (fp32 y, i1, i2 bit for
   bit over the routed rows, y 0 past them), K3 with its sums against
   grouped_bwd_plain (1e-5 of the largest element; fp32 dx bit for bit where
   x is not gathered), the bf16 mode within fwht_cuda.bf16_tol. Each
   kernel timed at the gathered shape beside the plain loop, with its bound
   (each routed row read and written once, y's 98304 rows written, s1 and
   s2 an expert, u a segment). Then a small DeepSeek-V2 WHVI net (hidden 64,
   a dense and two MoE layers, g_mu drawn N(0, 0.5^2)) takes
   Trainer.train_step on the card under set_sync_debug_mode("error")
   against a CPU copy (loss, mnll, kl within 1e-5, every gradient within
   1e-4), then in the bf16 precision (loss and mnll within 2^-7 of the
   CPU's), and Trainer.predict in each; every grouped kernel must have
   been launched there, and, every map having D <= 8192, no K3 with PyTorch's
   sums (fused_bwd, fused_bwd_bf16): each backward took a reduce mode.
14. The stacked form of K3's reduce mode (fused_bwd_sums_stacked) at the
   DeepSeek-V2 cell's stacked maps (q_proj, kv_a_proj_with_mqa, kv_b_proj,
   the shared down map, the dense gate/up, lm_head; u one of 4 samples, x
   broadcast over the stack axis) at N = 256 rows a sample: dx equal to
   K3's bit for bit, ds1, du and ds2 within 1e-5 of the plain version's,
   two launches and the launch without dx bit for bit, the bf16 precision
   refused (no product with (stack, D) diagonals runs in it). Then checked
   the same way and timed at the cell's N = 4096 for lm_head, q_proj and
   kv_b_proj beside its bound (g, i1, i2 and x read
   once, dx written once, over 3.35 TB/s), the plain version and K3 with
   PyTorch's reductions (the backward the stacked maps ran before), and
   ptxas's registers and spills of its instances at those widths.

Before the last line it prints one JSON object of the kernels (each with
its launches on the main path, or for fwht_bf16s, which the bf16 scaling
path launches no more, on phase 10's fwht_sweep run, the counts set to 0
just before it; max abs error, ms, plain_ms, bound_ms,
bound_by and library_ms; the error and the times both at the scaling
path's shapes for K1-K4 in both storages and the column kernel's modes
(times at the column head (8,1,4096)), at D=16384, B=512, TB=4 for the
large-D kernels, at phase 13's routed shape for the grouped kernels, their
launches phase 13's net's, and at phase 14's lm_head for the stacked reduce
mode, its launches phase 13's net's) and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from whvi_tpu_torch.bench.common import fused_ops
from whvi_tpu_torch.utils.profiling import cuda_ms

KERNEL_TOL = 1e-5  # fp32 butterflies: same adds as the plain version
SLICE_TOL = 1e-5  # loss and predictions, card (kernels) vs CPU (plain)
# Gradients sum S*B rows in another order on the card than on the CPU,
# with cancellation between rows.
SLICE_GRAD_TOL = 1e-4

_FUSED = "whvi_tpu_torch/csrc/whvi_fused.cu"
_SUMS = "whvi_tpu_torch/csrc/whvi_bwd_sums.cu"  # K3's reduce mode, square and stacked
_BF16S = "whvi_tpu_torch/csrc/whvi_bf16s.cu"  # K1-K3 on bf16 storage
_COLUMN = "whvi_tpu_torch/csrc/whvi_column.cu"  # the column head on bf16 storage
_GROUPED = "whvi_tpu_torch/csrc/whvi_grouped.cu"  # the grouped product (the expert layer's)
KERNELS = {
    # counter (fwht_cuda.LAUNCHES): (source, the TPU kernel it replaces)
    "fused_y": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_res": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_bwd": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:403"),
    "fused_bwd_sums": (_SUMS, "whvi_tpu/ops/fwht_pallas.py:403"),  # _bwd: K3 and its sums
    "fwht": ("whvi_tpu_torch/csrc/fwht.cu", "whvi_tpu/ops/fwht_pallas.py:191"),
    "fused_y_bf16": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_res_bf16": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_bwd_bf16": (_FUSED, "whvi_tpu/ops/fwht_pallas.py:403"),
    "fused_bwd_sums_bf16": (_SUMS, "whvi_tpu/ops/fwht_pallas.py:403"),
    "fused_y_bf16s": (_BF16S, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_res_bf16s": (_BF16S, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_bwd_bf16s": (_BF16S, "whvi_tpu/ops/fwht_pallas.py:403"),
    "fwht_bf16s": ("whvi_tpu_torch/csrc/fwht.cu", "whvi_tpu/ops/fwht_pallas.py:191"),
    "column_y_bf16s": (_COLUMN, "whvi_tpu/ops/fwht_pallas.py:191"),
    "column_res_bf16s": (_COLUMN, "whvi_tpu/ops/fwht_pallas.py:191"),
    "column_bwd_bf16s": (_COLUMN, "whvi_tpu/ops/fwht_pallas.py:191"),
    # the grouped product (a WHVI matrix a segment of rows; the JAX package has no such
    # product): the fused bodies it runs a segment at a time
    "fused_grouped_y": (_GROUPED, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_grouped_res": (_GROUPED, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_grouped_bwd_sums": (_GROUPED, "whvi_tpu/ops/fwht_pallas.py:403"),
    "fused_grouped_y_bf16": (_GROUPED, "whvi_tpu/ops/fwht_pallas.py:124"),
    "fused_grouped_res_bf16": (_GROUPED, "whvi_tpu/ops/fwht_pallas.py:113"),
    "fused_grouped_bwd_sums_bf16": (_GROUPED, "whvi_tpu/ops/fwht_pallas.py:403"),
    # K3's reduce mode for stacked (stack, D) diagonals, a block at a time
    "fused_bwd_sums_stacked": (_SUMS, "whvi_tpu/ops/fwht_pallas.py:403"),
}
FLAGSHIP_KERNELS = ("fused_y", "fused_res", "fused_bwd", "fwht")  # phases 3-4
BF16_KERNELS = ("fused_y_bf16", "fused_res_bf16", "fused_bwd_bf16")  # phase 6
COLUMN_KERNELS = ("column_y_bf16s", "column_res_bf16s", "column_bwd_bf16s")  # by mode
# phase 10's path; the bare fwht_bf16s runs there no more (its launches are fwht_sweep's)
BF16S_KERNELS = ("fused_y_bf16s", "fused_res_bf16s", "fused_bwd_bf16s", *COLUMN_KERNELS)
# A backward counts K3 under one of these counters, by the product's shape
# (fwht_cuda.bwd_counter): K3 with PyTorch's batch reductions after it, or
# its reduce mode, square or (fp32 only) stacked, which sums them itself.
K3_COUNTERS = {"fused_bwd": ("fused_bwd", "fused_bwd_sums", "fused_bwd_sums_stacked"),
               "fused_bwd_bf16": ("fused_bwd_bf16", "fused_bwd_sums_bf16")}


def launched(launches: dict, name: str) -> int:
    """Launches of kernel ``name`` in ``launches``, K3's under either counter."""
    return sum(launches.get(n, 0) for n in K3_COUNTERS.get(name, (name,)))


def fold_k3(launches: dict) -> dict:
    """``launches`` with K3's two counters added into one, so that runs whose
    products differ in shape (a replicated stack keeps K3, one replica's
    net takes the reduce mode) compare kernel for kernel."""
    out = {}
    for name, n in launches.items():
        base = next((b for b, names in K3_COUNTERS.items() if name in names), name)
        out[base] = out.get(base, 0) + n
    return out


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


def build(fc) -> str:
    """Build the kernels' library and log nvcc's report; returns the report."""
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
    return report


# -------------------------------------------------------- 3. kernel vs plain


def _operands(dev, gen, D, s_lead, u_lead, x_lead):
    def randn(*shape):
        return torch.randn(*shape, D, device=dev, generator=gen)

    return randn(*s_lead), randn(*u_lead), randn(*s_lead), randn(*x_lead)


def compare_fused(fc, dev, gen, label, D, s_lead, u_lead, x_lead, samples=None) -> dict:
    """Normalized and absolute errors of K1, K2, K3 against the plain
    version on one shape; x (*x_lead, D), expanded to (samples, *x_lead, D)
    when samples is given. The forward (y, and y, i1, i2 with residuals)
    and K3's outputs must equal the plain version bit for bit. The
    gradients through WhviMulFunction count under the counter its backward
    takes: K3's reduce mode (fused_bwd_sums, or fused_bwd_sums_stacked) where
    fc.sums_group (fc.sums_stacked) takes the shape, which is then checked
    against its plain version too."""
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
    k3, k3_ref = fc.fused_bwd_raw(s1, u, s2, g), fc.fused_plain(s2, u, s1, g, True)
    check(all(torch.equal(a, b) for a, b in zip(k3, k3_ref)),
          f"fused_bwd at {label} D={D} is not the plain dx, w1, t2 bit for bit")
    grads = torch.autograd.grad(fc.WhviMulFunction.apply(*inputs), leaves, g)
    ref = torch.autograd.grad(fc.fused_plain(*ref_inputs, False)[0], ref_leaves, g)
    errs["fused_bwd"] = max(rel_err(a, b) for a, b in zip(k3, k3_ref))
    abs_errs["fused_bwd"] = max((a - b).abs().max().item() for a, b in zip(k3, k3_ref))
    bwd = fc.bwd_counter(s1, u, s2, x)
    errs[bwd] = max(errs.get(bwd, 0.0), *(rel_err(a, b) for a, b in zip(grads, ref)))
    abs_errs[bwd] = max(abs_errs.get(bwd, 0.0), *((a - b).abs().max().item()
                                                 for a, b in zip(grads, ref)))
    if bwd != "fused_bwd":  # the reduce mode itself: K3's dx, the plain sums
        got = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1_ref, i2_ref, True)
        want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1_ref, i2_ref, True)
        check(torch.equal(got[0], k3[0]), f"{bwd} at {label} D={D}: dx is not K3's")
        errs[bwd] = max(errs[bwd], *(rel_err(a, b) for a, b in zip(got[1:], want[1:])))
        abs_errs[bwd] = max(abs_errs[bwd], *((a - b).abs().max().item()
                                            for a, b in zip(got[1:], want[1:])))
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
        check(launched(launches, name) > 0, f"kernel {name} was not launched by the slice")
    check(all(math.isfinite(e["loss"]) for e in logs), "non-finite training loss")
    check(logs[-1]["loss"] < logs[0]["loss"], "the loss did not fall")
    for k in ("rmse", "pred_mnll_per_point", "coverage95"):
        check(math.isfinite(metrics[k]), f"non-finite {k}")

    # the trained net on the card (kernels) against a CPU copy (plain)
    net_vs_cpu(fc, "slice", trainer.net, X[:64], y[:64], len(X), np.random.RandomState(seed + 2))
    return launches


def given_noise(net, B: int, rng) -> list:
    """Noise for each layer of ``net`` on x (train_samples, B, n_in) (with a
    leading replica axis on a replicated net), drawn from ``rng`` in layer
    order: an array of the matrix's noise shape for a WHVI layer (per row
    with per-example noise), a tuple of the branches' for a Parallel, None
    otherwise."""
    from whvi_tpu_torch.models import Parallel, WHVILinear

    lead = () if net.replicas is None else (net.replicas,)

    def noise(layer):
        if isinstance(layer, Parallel):
            return tuple(noise(b) for b in layer.branches)
        if not isinstance(layer, WHVILinear):
            return None
        x = torch.empty(*lead, net.train_samples, B, layer.n_in, device="meta")
        shape = layer.matrix.noise_shape(x, layer.lrt and layer.per_example_noise)
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    return [noise(layer) for layer in net.layers]


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
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
    eps = given_noise(cpu_net, X.shape[-2], rng)
    results, launches = [], {}
    for model, d in ((net, next(net.parameters()).device), (cpu_net, torch.device("cpu"))):
        model.zero_grad(set_to_none=True)
        e = _to(eps, d)
        fc.reset_launches()
        loss, _ = model.loss(xb.to(d), yb.to(d), n, weights=None, eps=e)
        loss.sum().backward()  # a replicated net's loss is one a replica
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
    record("fused_bwd_bf16", zip(fc.fused_bwd_raw(s1, u, s2, g, "bf16"),
                                 fc.fused_plain(s2, u, s1, g, True, "bf16"), (tol2, tol1, tol2)))
    grads = torch.autograd.grad(out, leaves, g)
    ref = [r.sum_to_size(a.shape) for r, a in zip(fc.vjp_plain(s1, u, s2, x, g, "bf16"), grads)]
    # the gradients under the counter the backward takes (K3's reduce mode where it can)
    record(fc.bwd_counter(s1, u, s2, x, "bf16"), zip(grads, ref, (tol2, tol1, tol2, tol2)))
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
    """K1-K3 and K3's reduce mode in both precisions at the scaling path's
    shape (D=4096, u (8,1,D), x (256,D) expanded to (8,256,D): 2048 rows),
    each with its bound (bytes: each input read once, the outputs written
    once), and K1 at D=16384, B=512 (PERF.md's large-D shape). Returns the
    kernels line's entries of the eight kernels at the scaling shape."""
    from whvi_tpu_torch.bench.common import bound_ms
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    gen = torch.Generator(device=dev).manual_seed(seed)
    D, S, B = SCALING_D, SCALING_S, SCALING_B
    s1, s2 = (torch.randn(D, device=dev, generator=gen) for _ in range(2))
    u = torch.randn(S, 1, D, device=dev, generator=gen)
    x = torch.randn(B, D, device=dev, generator=gen).expand(S, B, D)
    g = torch.randn(S, B, D, device=dev, generator=gen)
    res = {p: fc.fused_raw(s1, u, s2, x, True, p)[1:] for p in ("fp32", "bf16")}
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
            # the reduce mode (the scaling net's second layer: dx stored),
            # on the forward's residuals i1, i2
            ("fused_bwd_sums",
             lambda: fc.fused_bwd_sums_raw(s1, u, s2, x, g, *res[precision], True, precision),
             lambda: fc.fused_bwd_sums_plain(s1, u, s2, x, g, *res[precision], True, precision),
             (g, *res[precision], x, u, s1, s2), 1),
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
        check(launched(launches, name) > 0, f"kernel {name} was not launched by the scaling path")
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
        check(launched(launches, name) > 0, f"kernel {name} was not launched by config 4")
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
        check(launched(launches, name) > 0, f"kernel {name} was not launched by the split-head net")


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


# ----------------------------------------------------- 8. the UCI protocol

PROTOCOL_R = 8  # the protocol's n_splits, the replicas of one stacked fit
PROTOCOL_EPOCHS = (2, 6)  # epochs1, epochs2 instead of 500 + 50000
PROTOCOL_KERNELS = ("fused_y", "fused_res", "fused_bwd", "fwht")  # K1-K4, fp32
# K1-K3 at the replica shapes: (label, D, s1/s2 lead, u lead, x lead); the
# stacked layer's eval shape reads through 4 strided dims, the kernel's most
REPLICA_SHAPES = [
    ("replicas square128 train", 128, (8, 1, 1), (8, 1, 1), (8, 1, 64)),
    ("replicas square128 eval", 128, (8, 1, 1), (8, 64, 1), (8, 64, 51)),
    ("replicas stack8x16 train", 16, (8, 1, 1, 8), (8, 1, 1, 8), (8, 1, 64, 1)),
    ("replicas stack8x16 eval", 16, (8, 1, 1, 8), (8, 64, 1, 8), (8, 64, 51, 1)),
    ("replicas stack8x16 u/row", 16, (8, 1, 1, 8), (8, 8, 64, 8), (8, 8, 64, 1)),
]
STEP_TOL = 1e-6  # a replica against its own unreplicated net, both on the card


def replica_shapes_vs_plain(fc, dev, seed) -> None:
    """(a) K1-K3 at the replica shapes against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"K1-K3 at the replica shapes (<= {KERNEL_TOL}; forward bit for bit):")
    for label, D, s_lead, u_lead, x_lead in REPLICA_SHAPES:
        compare_fused(fc, dev, gen, label, D, s_lead, u_lead, x_lead)


def _flagship_trainer(dev, replicas, seeds, epochs=(0, 1)):
    from whvi_tpu_torch.evaluation import ProtocolConfig, _build_net
    from whvi_tpu_torch.train import TrainConfig, Trainer

    trainer = Trainer(
        _build_net(ProtocolConfig(), 13, 1),
        TrainConfig(epochs1=epochs[0], epochs2=epochs[1], checkpoint_every=2, epochs_per_call=2),
        device=dev, replicas=replicas,
    )
    return trainer, trainer.init(seeds if replicas else seeds[0])


def protocol_step(fc, dev, seed) -> dict:
    """(b) One stacked flagship step (R=8, 13 -> 128 -> 128 -> 1 as
    ProtocolConfig builds it, batch 64) on the card against a CPU copy on
    the same noise; replica r against its own unreplicated net on the card
    (STEP_TOL), with the launches of a train step and a predictive call of
    each, which must agree; then ms a train step of each, host clock, the
    stacked one serving 8 splits. Returns the stacked net's launches."""
    R, B = PROTOCOL_R, 64
    seeds = [seed * 1000 + s for s in range(R)]
    rng = np.random.RandomState(seed + 6)
    X = rng.randn(R, B, 13).astype(np.float32)
    Y = rng.randn(R, B, 1).astype(np.float32)
    trainer, state = _flagship_trainer(dev, R, seeds)
    log(f"protocol step: flagship 13->128->128->1 stacked R={R}, batch {B}, "
        "train_samples 1, against a CPU copy:")
    stacked = net_vs_cpu(fc, "stacked flagship", trainer.net, X, Y, 455, rng)
    eps = given_noise(trainer.net, B, np.random.RandomState(seed + 7))
    r = R - 1
    single, _ = _flagship_trainer(dev, None, [seeds[r]])
    outs, per_call = [], []
    for model, x, y, e in (
        (trainer.net, X, Y, eps),
        (single.net, X[r], Y[r], [None if a is None else a[r] for a in eps]),
    ):
        model.zero_grad(set_to_none=True)
        e = _to(e, dev)
        fc.reset_launches()
        loss, _ = model.loss(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), 455, eps=e)
        loss.sum().backward()
        counts = {"step": dict(fc.LAUNCHES)}
        with torch.no_grad():
            pred = model.predict(torch.from_numpy(x).to(dev), 1, eps=e)
            fc.reset_launches()
            model.predict(torch.from_numpy(x).to(dev), 64)
        counts["predict"] = dict(fc.LAUNCHES)
        per_call.append(counts)
        outs.append((loss.detach(), pred, [p.grad.detach() for p in model.parameters()]))
    (l_s, y_s, g_s), (l_1, y_1, g_1) = outs
    errs = (rel_err(l_s[r], l_1), rel_err(y_s[r], y_1), max(rel_err(a[r], b) for a, b in zip(g_s, g_1)))
    log(f"  replica {r} against its own net on the card: loss {errs[0]:.2e}, predictions "
        f"{errs[1]:.2e}, gradients {errs[2]:.2e} (<= {STEP_TOL})")
    check(max(errs) <= STEP_TOL, "a replica disagrees with its own net")
    for what in ("step", "predict"):
        log(f"  launches a {'train step' if what == 'step' else 'predictive call'}, stacked "
            f"R={R} / one split: "
            + ", ".join(f"{k} {per_call[0][what][k]}/{per_call[1][what][k]}"
                        for k in per_call[0][what] if per_call[0][what][k] or per_call[1][what][k]))
        check(fold_k3(per_call[0][what]) == fold_k3(per_call[1][what]),
              f"a stacked {what} launches other kernels than a single split's")
    # host-clock ms a train step, warm, stacked and single in turns
    Xd, Yd = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
    w = torch.ones(B, device=dev)

    def ms_a_step(tr, st, x, y, n=50):
        for _ in range(5):
            tr.train_step(st, x, y, 455, True, weights=w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tr.train_step(st, x, y, 455, True, weights=w)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    single, s_state = _flagship_trainer(dev, None, [seeds[0]])
    trainer, state = _flagship_trainer(dev, R, seeds)
    times = [ms_a_step(single, s_state, Xd[0], Yd[0]), ms_a_step(trainer, state, Xd, Yd)]
    times += [ms_a_step(trainer, state, Xd, Yd), ms_a_step(single, s_state, Xd[0], Yd[0])]
    one, stack = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    log(f"  ms a train step (host clock, 50 warm steps, single/stacked/stacked/single): "
        f"one split {one:.3f}, stacked R={R} {stack:.3f} ({stack / R:.3f} a split; "
        + ", ".join(f"{t:.3f}" for t in times) + ")")
    return stacked


def _protocol_data(seed):
    (X, y), (Xt, yt) = synthetic_regression(seed)
    return np.concatenate([X, Xt]), np.concatenate([y, yt])


def run_protocol_path(fc, dev, seed, tmp) -> dict:
    """(c) evaluate_bayesian_regression, stacked R=8, on the 506 x 13
    synthetic data, 2 + 6 epochs, calibrate, checkpoint_every=2 into
    ``tmp``: the main path of this phase, every K1-K4 launched and no
    operand realigned; then the same call again, which resumes from the
    last checkpoint and must give equal metrics; a fit interrupted after
    epoch 4 and resumed, torch.equal to an uninterrupted one; and the
    sequential protocol on the same data for comparison. Returns the
    stacked protocol's result (phase 11 holds the split mesh to it)."""
    from whvi_tpu_torch.evaluation import ProtocolConfig, evaluate_bayesian_regression

    X, y = _protocol_data(seed)
    cfg = ProtocolConfig(n_splits=PROTOCOL_R, epochs1=PROTOCOL_EPOCHS[0],
                         epochs2=PROTOCOL_EPOCHS[1], checkpoint_every=2, calibrate=True,
                         seed=seed)
    log(f"protocol: evaluate_bayesian_regression stacked R={PROTOCOL_R} on {X.shape[0]}x"
        f"{X.shape[1]}, epochs {'+'.join(map(str, PROTOCOL_EPOCHS))}, calibrate, "
        "checkpoint_every 2")
    chunks = []
    fc.reset_launches()
    out = evaluate_bayesian_regression(
        X, y, cfg, ckpt_dir=tmp, device=dev,
        log_fn=lambda e: chunks.append(e) if "phase" in e else None,
    )
    torch.cuda.synchronize()
    launches, realigned = dict(fc.LAUNCHES), fc.REALIGNED
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; REALIGNED {realigned}")
    check(realigned == 0, f"the protocol copied {realigned} misaligned operands")
    for name in PROTOCOL_KERNELS:
        check(launched(launches, name) > 0, f"kernel {name} was not launched by the protocol")
    steps = -(-(X.shape[0] - 51 - 46) // 64)  # train rows after test and calibration rows
    warm = chunks[-1]["epoch"] - chunks[0]["epoch"], chunks[-1]["seconds"] - chunks[0]["seconds"]
    log(f"  protocol_wall_s {out['protocol_wall_s']:.3f}, epochs_per_s_amortized "
        f"{out['splits'][0]['epochs_per_s_amortized']:.2f}; warm {warm[0] / warm[1]:.2f} epochs/s "
        f"of the stack ({warm[1] / (warm[0] * steps) * 1e3:.3f} ms a step of {steps} an epoch)")
    keys = ("rmse_mean", "mnll_per_point_mean", "pred_mnll_per_point_mean", "coverage95_mean",
            "temperature_mean", "coverage95_cal_mean")
    log("  " + ", ".join(f"{k} {out[k]:.4f}" for k in keys))
    for k in keys:
        check(math.isfinite(out[k]), f"non-finite {k}")
    again = evaluate_bayesian_regression(X, y, cfg, ckpt_dir=tmp, device=dev)
    same = all(again[k] == out[k] for k in keys)
    log(f"  the same call again (resumes at epoch {sum(PROTOCOL_EPOCHS)}): metrics equal {same}, "
        f"protocol_wall_s {again['protocol_wall_s']:.3f}")
    check(same, "the resumed protocol's metrics differ")

    seq = evaluate_bayesian_regression(X, y, dataclasses.replace(cfg, vmap_splits=False),
                                       device=dev)
    log(f"  sequential protocol, same data: wall {sum(r['wall_s'] for r in seq['splits']):.3f} s "
        f"over {PROTOCOL_R} fits; rmse_mean {seq['rmse_mean']:.4f} (stacked {out['rmse_mean']:.4f}),"
        f" pred_mnll_per_point_mean {seq['pred_mnll_per_point_mean']:.4f} "
        f"(stacked {out['pred_mnll_per_point_mean']:.4f})")

    # interrupted after epoch 4 and resumed against uninterrupted, stacked R=8
    rows = np.random.RandomState(seed + 8).randn(PROTOCOL_R, 130, 14).astype(np.float32)
    Xs, ys = rows[..., :13], rows[..., 13:]
    seeds = [seed * 1000 + s for s in range(PROTOCOL_R)]
    ref, ref_state = _flagship_trainer(dev, PROTOCOL_R, seeds, epochs=(1, 5))
    ref.fit(ref_state, Xs, ys, ckpt_dir=os.path.join(tmp, "ref"))

    def stop_at_5(entry):
        if entry["epoch"] == 5:
            raise KeyboardInterrupt

    cut, cut_state = _flagship_trainer(dev, PROTOCOL_R, seeds, epochs=(1, 5))
    try:
        cut.fit(cut_state, Xs, ys, ckpt_dir=os.path.join(tmp, "cut"), log_fn=stop_at_5)
    except KeyboardInterrupt:
        pass
    check(sorted(os.listdir(os.path.join(tmp, "cut")))[::2] == ["ckpt-3.npz"],
          "the interrupted fit left other checkpoints than ckpt-3")
    res, res_state = _flagship_trainer(dev, PROTOCOL_R, seeds, epochs=(1, 5))
    res.fit(res_state, Xs, ys, ckpt_dir=os.path.join(tmp, "cut"))
    equal = res_state.step == ref_state.step and all(
        torch.equal(p, q) and all(
            torch.equal(res_state.optimizer.state[p][k], ref_state.optimizer.state[q][k])
            for k in ("exp_avg", "exp_avg_sq"))
        for p, q in zip(res.net.parameters(), ref.net.parameters())
    )
    log(f"  a stacked fit interrupted after epoch 5 and resumed from ckpt-3: torch.equal to the "
        f"uninterrupted fit (parameters and Adam moments): {equal}")
    check(equal, "the resumed fit differs from the uninterrupted one")
    return out


def run_grid_path(fc, dev, seed) -> None:
    """(d) evaluate_config_grid: lambda_hidden 1.0 and 3.0 x 8 splits."""
    from whvi_tpu_torch.evaluation import ProtocolConfig, evaluate_config_grid

    X, y = _protocol_data(seed)
    base = ProtocolConfig(n_splits=PROTOCOL_R, epochs1=PROTOCOL_EPOCHS[0],
                          epochs2=PROTOCOL_EPOCHS[1], seed=seed)
    fc.reset_launches()
    out = evaluate_config_grid(X, y, base, [{"lambda_hidden": 1.0}, {"lambda_hidden": 3.0}],
                               device=dev)
    torch.cuda.synchronize()
    log(f"grid: 2 configs x {PROTOCOL_R} splits (R={out['stack_size']}): protocol_wall_s "
        f"{out['protocol_wall_s']:.3f}; "
        + "; ".join(f"lambda_hidden {c['config_overrides']['lambda_hidden']}: rmse_mean "
                    f"{c['rmse_mean']:.4f}, pred_mnll_per_point_mean "
                    f"{c['pred_mnll_per_point_mean']:.4f}" for c in out["configs"])
        + "; launches " + ", ".join(f"{k} {v}" for k, v in fc.LAUNCHES.items() if v))
    check(fc.REALIGNED == 0, "the grid copied misaligned operands")
    for c in out["configs"]:
        check(all(math.isfinite(c[k]) for k in ("rmse_mean", "mnll_mean")), f"non-finite {c}")


def run_protocol_entry_points(fc, seed, tmp) -> None:
    """(e) run_protocol_feasibility at n=8192, 8 features, 1 + 2 epochs;
    (f) run_uci yacht --splits 8 --epochs1 1 --epochs2 4 on a synthetic
    yacht_hydrodynamics.data of yacht's shape (308 x 7) in a temporary
    WHVI_DATA_DIR. Their rows must be finite."""
    from whvi_tpu_torch.experiments import run_protocol_feasibility, run_uci

    log("entry points: run_protocol_feasibility --epochs1 1 --epochs2 2 (n=8192, 8 features); "
        "run_uci yacht --splits 8 --epochs1 1 --epochs2 4 (synthetic 308x7)")
    fc.reset_launches()
    feas = run_protocol_feasibility.main(["--epochs1", "1", "--epochs2", "2", "--seed", str(seed)])
    rng = np.random.RandomState(seed + 9)
    table = rng.rand(308, 7)
    table[:, -1] = np.exp(3 * table[:, 0]) + 0.1 * rng.randn(308)
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    np.savetxt(os.path.join(data_dir, "yacht_hydrodynamics.data"), table)
    os.environ["WHVI_DATA_DIR"] = data_dir
    try:
        uci = run_uci.main(["yacht", "--splits", "8", "--epochs1", "1", "--epochs2", "4",
                            "--ckpt-dir", os.path.join(tmp, "uci"), "--quiet",
                            "--seed", str(seed)])
    finally:
        del os.environ["WHVI_DATA_DIR"]
    torch.cuda.synchronize()
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in fc.LAUNCHES.items() if v)
        + f"; REALIGNED {fc.REALIGNED}")
    check(fc.REALIGNED == 0, "the protocol entry points copied misaligned operands")
    for row in (feas, uci):
        check(all(math.isfinite(v) for v in row.values() if isinstance(v, float)),
              f"non-finite row {row}")
    for name in PROTOCOL_KERNELS:
        check(launched(fc.LAUNCHES, name) > 0, f"kernel {name} was not launched by the entry points")


# ------------------------------------------------- 9. the golden samplers

SAMPLER_KERNELS = ("fused_y", "fused_res", "fused_bwd", "fwht")  # K1-K4, fp32
MCMC_GRAD_TOL = 1e-4  # log-posterior gradients sum 256 rows in another order
MCMC_DRAW_TOL = 1e-4  # draws after a few transitions, card vs CPU
# the analytic tier's NUTS at the cut size against its exact posterior: the
# mean's RMSE over the 16 coordinates, in units of the exact marginal sd
# (averaged over coordinates; 0.0154 at seed 0). At the cut size's ESS of
# 100-300 the Monte Carlo error of a mean is 0.06-0.1 sd, so 0.25 sd leaves
# room for it and still catches a bias of a quarter sd. The NUTS sd over the
# exact sd (averaged over coordinates) is held to the JAX script's gate.
ANALYTIC_MEAN_TOL_SD = 0.25
ANALYTIC_SD_RATIO_TOL = 0.1


def nonlinear_net(seed: int):
    """run_vi_vs_hmc's nonlinear-tier net, 6 -> 8 (stacked) -> 1 (column
    head), bias and per-example noise, random weights, on the CPU."""
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import _lin
    from whvi_tpu_torch.models import WHVIRegression, relu

    torch.manual_seed(seed)
    net = WHVIRegression([_lin(6, 8, 1.0), relu, _lin(8, 1, 1.0)], sigma0=0.3, train_samples=4)
    with torch.no_grad():
        for layer in net.layers[::2]:
            layer.matrix.g_mu.normal_(0.0, 0.5)
            layer.bias.normal_(0.0, 0.1)
    return net


def sampler_posteriors(seed: int) -> dict:
    """The two g posteriors of the phase, each ``(cpu_net, X, y)``: config
    4 (random weights, sampler_bench.config4_net) on 256 rows of
    synthetic_classification, and the nonlinear tier's net on its 64-row
    synthetic subset (yacht's fallback)."""
    from whvi_tpu_torch.bench.sampler_bench import config4_net
    from whvi_tpu_torch.data import synthetic_classification
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import _load_subset

    (X4, y4), _ = synthetic_classification(seed=seed)
    X6, y6, _, _, _ = _load_subset(seed, 64, 0)
    return {"config 4": (config4_net(seed), X4[:256], y4[:256]),
            "6-8-1": (nonlinear_net(seed), X6, y6)}


def log_posterior_vs_cpu(fc, dev, seed, posteriors) -> dict:
    """(a) The g log posterior and its gradient at 4 walkers on the card
    (kernels) against a CPU copy (plain versions), with the launches of
    one gradient evaluation and of one value without a gradient."""
    from whvi_tpu_torch.mcmc import make_whvi_g_log_posterior
    from whvi_tpu_torch.mcmc.chains import jittered_inits, ravel, value_and_grad

    per_eval = {}
    for label, (net, X, y) in posteriors.items():
        lp_cpu, init = make_whvi_g_log_posterior(net, X, y)
        lp_card, _ = make_whvi_g_log_posterior(copy.deepcopy(net).to(dev), X, y)
        qv, unflat = ravel(jittered_inits(init, torch.Generator().manual_seed(seed + 9), 4, 0.1))
        v_cpu, g_cpu = value_and_grad(lp_cpu, unflat)(qv)
        vg_card = value_and_grad(lp_card, unflat)
        vg_card(qv.to(dev))  # warm
        torch.cuda.synchronize()
        fc.reset_launches()
        v_card, g_card = vg_card(qv.to(dev))
        torch.cuda.synchronize()
        grad_launches, realigned = dict(fc.LAUNCHES), fc.REALIGNED
        fc.reset_launches()
        with torch.no_grad():
            v_nograd = lp_card(unflat(qv.to(dev)))
        torch.cuda.synchronize()
        value_launches = dict(fc.LAUNCHES)
        v_err, g_err = rel_err(v_card.cpu(), v_cpu), rel_err(g_card.cpu(), g_cpu)
        log(f"  {label}: {qv.shape[1]} g coordinates, 4 walkers, {X.shape[0]} rows: value "
            f"{v_err:.2e} (<= {SLICE_TOL}), gradient {g_err:.2e} (<= {MCMC_GRAD_TOL}); a gradient "
            "evaluation launches " + ", ".join(f"{k} {v}" for k, v in grad_launches.items() if v)
            + "; a value without one " + ", ".join(f"{k} {v}" for k, v in value_launches.items() if v)
            + f"; operands realigned {realigned}")
        check(v_err <= SLICE_TOL, f"{label} log posterior disagrees with the CPU")
        check(g_err <= MCMC_GRAD_TOL, f"{label} log-posterior gradient disagrees with the CPU")
        check(torch.equal(v_nograd, v_card), f"{label}: the value without a gradient differs")
        check(realigned == 0, f"{label} copied misaligned operands")
        check(grad_launches["fused_res"] > 0 and launched(grad_launches, "fused_bwd") > 0,
              f"{label}: a gradient evaluation launched no K2/K3")
        check(value_launches["fused_y"] > 0, f"{label}: a value launched no K1")
        per_eval[label] = {"gradient": grad_launches, "value": value_launches}
    check(per_eval["6-8-1"]["gradient"]["fwht"] > 0, "the column head launched no K4")
    return per_eval


def draws_vs_cpu(dev, seed, posteriors) -> None:
    """(b) 5 HMC and 5 NUTS draws of 2 chains on config 4's posterior,
    from the same random numbers on the card and on a CPU copy."""
    from whvi_tpu_torch.mcmc import HMCConfig, NUTSConfig, make_whvi_g_log_posterior
    from whvi_tpu_torch.mcmc import hmc, nuts
    from whvi_tpu_torch.mcmc.chains import jittered_inits

    net, X, y = posteriors["config 4"]
    lp_cpu, init = make_whvi_g_log_posterior(net, X, y)
    lp_card, _ = make_whvi_g_log_posterior(copy.deepcopy(net).to(dev), X, y)
    inits = jittered_inits(init, torch.Generator().manual_seed(seed + 10), 2, 0.1)
    dim = sum(g[0].numel() for g in inits.values())
    gen = torch.Generator().manual_seed(seed + 11)
    runs = {
        "HMC": (hmc._hmc_chains, HMCConfig(n_samples=5, n_warmup=0, n_leapfrog=3,
                                           init_step_size=2e-3, adapt=False),
                hmc.hmc_draws(gen, 2, dim, "cpu")),
        "NUTS": (nuts._nuts_chains, NUTSConfig(n_samples=5, n_warmup=0, max_tree_depth=3,
                                               init_step_size=2e-3, adapt=False),
                 nuts.nuts_draws(gen, 2, dim, 3, "cpu")),
    }
    for label, (sample_fn, cfg, make) in runs.items():
        draws = [make(t) for t in range(cfg.n_samples)]
        got = {}
        for where, d, lp in (("card", dev, lp_card), ("cpu", torch.device("cpu"), lp_cpu)):
            feed = lambda t, d=d: _to(draws[t], d)
            got[where] = sample_fn(lp, _to(inits, d), None, cfg, feed)
        err = max(rel_err(got["card"][0][i].cpu(), got["cpu"][0][i]) for i in init)
        acc_key = "accept_rate" if label == "HMC" else "accept_stat"
        log(f"  {label}, 2 chains x 5 draws from the same numbers: draws card vs CPU {err:.2e} "
            f"(<= {MCMC_DRAW_TOL}); accept {got['card'][1][acc_key].cpu().numpy().round(4)}")
        check(err <= MCMC_DRAW_TOL, f"{label} draws disagree with the CPU")


def _no_sync(fn):
    """``fn()`` with every host sync an error (torch.cuda.set_sync_debug_mode),
    timed by the host clock between two synchronizes outside it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nuts_config():
    """The path's NUTS at config 4: depth 4, 10 + 10 draws."""
    from whvi_tpu_torch.mcmc import NUTSConfig

    return NUTSConfig(n_samples=10, n_warmup=10, max_tree_depth=4)


def run_sampler_path(fc, dev, seed, posteriors) -> dict:
    """(c) The path: NUTS at config 4 (4 chains, depth 4, 10 + 10 draws)
    and parallel tempering on the 6-8-1 posterior (2 ladders of 4 rungs,
    10 + 10 rounds), each under sync debug mode "error", then the
    posterior predictive of the tempering draws on held-out rows. Every
    K1-K4 must launch, no operand be realigned. Returns the NUTS draws
    (phase 11 holds the sharded chains to them)."""
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import _load_subset, _predictive_from_g_draws
    from whvi_tpu_torch.mcmc import (
        PTConfig, ess, make_whvi_g_log_posterior, nuts_sample_chains,
        pt_sample_chains, split_rhat,
    )
    from whvi_tpu_torch.mcmc.nuts import gradient_evaluations

    # the mode must catch a sync at all: a read of a device value
    caught = False
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device=dev).item()
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(caught, 'set_sync_debug_mode("error") let .item() through')
    net4 = copy.deepcopy(posteriors["config 4"][0]).to(dev)
    net6 = copy.deepcopy(posteriors["6-8-1"][0]).to(dev)
    _, X6, y6 = posteriors["6-8-1"]
    _, _, X_te, y_te, _ = _load_subset(seed, 64, 100)
    ncfg = nuts_config()
    pcfg = PTConfig(n_samples=10, n_warmup=10, n_rungs=4, n_leapfrog=8)
    fc.reset_launches()
    lp4, init4 = make_whvi_g_log_posterior(net4, *posteriors["config 4"][1:])
    lp6, init6 = make_whvi_g_log_posterior(net6, X6, y6)
    (s4, st4), wall4 = _no_sync(lambda: nuts_sample_chains(
        lp4, init4, torch.Generator(device=dev).manual_seed(seed + 12), ncfg, n_chains=4))
    (s6, st6), wall6 = _no_sync(lambda: pt_sample_chains(
        lp6, init6, torch.Generator(device=dev).manual_seed(seed + 13), pcfg, n_chains=2))
    pred = _predictive_from_g_draws(net6, X_te, y_te, s6)
    torch.cuda.synchronize()
    launches, realigned = dict(fc.LAUNCHES), fc.REALIGNED
    evals4 = gradient_evaluations(ncfg)
    evals6 = 1 + 20 * pcfg.n_leapfrog
    rates = {
        "nuts_config4_draws_per_s": 4 * 20 / wall4,
        "nuts_config4_grad_evals_per_s": evals4 / wall4,
        "pt_681_rounds_per_s": 2 * 20 / wall6,
        "pt_681_grad_evals_per_s": evals6 / wall6,
    }
    log(f"  NUTS config 4, 4 chains x (10 + 10) draws, depth 4, no host sync: {wall4:.3f} s, "
        f"{rates['nuts_config4_draws_per_s']:.2f} draws/s, "
        f"{rates['nuts_config4_grad_evals_per_s']:.1f} gradient evaluations/s ({evals4} of 4 "
        f"walkers); divergences {st4['divergences'].tolist()}, accept "
        f"{st4['accept_stat'].cpu().numpy().round(3)}, R-hat max "
        f"{max(float(split_rhat(s4[i]).max()) for i in s4):.3f}, ESS min "
        f"{min(float(ess(s4[i]).min()) for i in s4):.1f}")
    log(f"  PT 6-8-1, 2 ladders x 4 rungs x (10 + 10) rounds, 8 leapfrog steps, no host sync: "
        f"{wall6:.3f} s, {rates['pt_681_rounds_per_s']:.2f} rounds/s, "
        f"{rates['pt_681_grad_evals_per_s']:.1f} gradient evaluations/s ({evals6} of 8 walkers); "
        f"swap rates {st6['swap_rate'].cpu().numpy().round(2).tolist()}")
    log(f"  predictive of the PT draws on 100 held-out rows: "
        + ", ".join(f"{k} {v:.4f}" for k, v in pred.items()))
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; operands realigned {realigned}")
    check(realigned == 0, "the sampler path copied misaligned operands")
    for name in SAMPLER_KERNELS:
        check(launched(launches, name) > 0, f"kernel {name} was not launched by the sampler path")
    for s in (s4, s6):
        check(all(bool(torch.isfinite(v).all()) for v in s.values()), "non-finite draws")
    check(s4[0].shape == (4, 10, 1, 1024) and s6[0].shape == (2, 10, 1, 8),
          f"draw shapes {tuple(s4[0].shape)}, {tuple(s6[0].shape)}")
    check(all(math.isfinite(v) for v in pred.values()), f"non-finite predictive {pred}")
    return s4


def run_analytic_path(dev, seed) -> dict:
    """(d) run_vi_vs_hmc's analytic tier at a cut size (16-dim exact
    posterior, 4 chains x (100 + 100) NUTS draws at depth 5, 300 VI
    steps): no divergence, the NUTS mean within ANALYTIC_MEAN_TOL_SD exact
    posterior sds of the exact mean, and the NUTS sd within
    ANALYTIC_SD_RATIO_TOL of the exact sd."""
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import (
        analytic_gates,
        analytic_problem,
        analytic_tier,
    )

    a = analytic_tier(seed=seed, n_vi_steps=300, n_nuts=100, n_warmup=100, tree_depth=5,
                      device=dev)
    nuts_row = a["nuts"]
    exact_sd = float(torch.diagonal(analytic_problem(seed=seed, device=dev)["Sigma"]).sqrt().mean())
    rmse_sd = nuts_row["mean_rmse_vs_exact"] / exact_sd
    sd_ratio = nuts_row["sd_ratio_vs_exact_mean"]
    log(f"  analytic tier, 4 chains x (100 + 100) draws, depth 5: NUTS mean RMSE vs exact "
        f"{nuts_row['mean_rmse_vs_exact']:.5f} = {rmse_sd:.4f} exact sd (exact sd {exact_sd:.5f}; "
        f"<= {ANALYTIC_MEAN_TOL_SD} sd), sd ratio {sd_ratio:.4f} (within "
        f"{ANALYTIC_SD_RATIO_TOL} of 1), R-hat {nuts_row['rhat_max']:.4f}, ESS "
        f"{nuts_row['ess_min']:.1f}, divergences {nuts_row['divergences']}; "
        f"{nuts_row['draws_per_s']:.1f} draws/s, {nuts_row['grad_evals_per_s']:.1f} gradient "
        f"evaluations/s; VI mean corr {a['vi']['mean_corr_vs_exact']:.4f}; gates at this cut "
        f"size (not held): {analytic_gates(a)}")
    check(nuts_row["divergences"] == 0, "the analytic tier's NUTS diverged")
    check(rmse_sd <= ANALYTIC_MEAN_TOL_SD, "the analytic tier's NUTS mean misses the exact mean")
    check(abs(sd_ratio - 1) < ANALYTIC_SD_RATIO_TOL,
          "the analytic tier's NUTS sd misses the exact sd")
    return a


# ------------------------------------------------ 10. bf16 storage (K1-K4)

BF16S_WIDTHS = (4096, 8192)  # run_scaling --dtype bf16's sizes in the smoke
BF16S_NET_TOL = 2.0**-7  # the bf16 scaling net, card vs CPU: loss and gradients


def bf16s_vs_plain(fc, dev, seed) -> dict:
    """K1-K4 on bf16 storage against their plain versions at the scaling
    path's shapes: u (8,1,D) over x (256,D) expanded to 2048 rows, D = 4096
    and 8192; K1-K3 at D=16384 over 512 rows of x (precision_check's
    shape); and the column head (8,1,1,4096). Every forward (y; y, i1,
    i2; the bare transform) and the backward (against vjp_plain: the same
    kernel on the swapped operands, then the same reductions) bit for bit.
    Returns the largest abs error of each kernel over the shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    log("bf16-storage kernels vs plain (forwards and the backward bit for bit):")
    max_abs = dict.fromkeys(("fused_y_bf16s", "fused_res_bf16s", "fused_bwd_bf16s"), 0.0)
    S, B = SCALING_S, SCALING_B
    for D, u_lead, x_lead in (*((D, (S, 1), (B,)) for D in BF16S_WIDTHS), (16384, (), (KRON_B,))):
        s1, s2 = (torch.randn(D, device=dev, generator=gen).to(bf16) for _ in range(2))
        u = torch.randn(*u_lead, D, device=dev, generator=gen).to(bf16)
        x0 = torch.randn(*x_lead, D, device=dev, generator=gen).to(bf16)
        lead = torch.broadcast_shapes(u.shape[:-1], x0.shape[:-1])
        x = x0.expand(*lead, D)
        ref = fc.fused_plain(s1, u, s2, x, True)
        y = fc.fused_raw(s1, u, s2, x, False)[0]
        res = fc.fused_raw(s1, u, s2, x, True)
        check(y.dtype == bf16 and torch.equal(y, ref[0]), f"fused_y_bf16s at D={D}")
        check(all(torch.equal(a, b) for a, b in zip(res, ref)), f"fused_res_bf16s at D={D}")
        leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x0)]
        out = fc.WhviMulFunction.apply(*leaves[:3], leaves[3].expand(*lead, D))
        g = torch.randn(out.shape, device=dev, generator=gen).to(bf16)
        grads = torch.autograd.grad(out, leaves, g)
        want = [r.sum_to_size(a.shape) for r, a in zip(fc.vjp_plain(s1, u, s2, x, g), grads)]
        check(all(torch.equal(a, b) for a, b in zip(grads, want)), f"fused_bwd_bf16s at D={D}")
        for name, pairs in (("fused_y_bf16s", [(y, ref[0])]), ("fused_res_bf16s", zip(res, ref)),
                            ("fused_bwd_bf16s", zip(grads, want))):
            max_abs[name] = max(max_abs[name], *((a.float() - b.float()).abs().max().item()
                                                 for a, b in pairs))
        log(f"  u {tuple(u.shape[:-1])}, x {tuple(x.shape[:-1])} D={D}: y, y/i1/i2 and the "
            "gradients equal")
    xh = torch.randn(S, 1, 1, SCALING_D, device=dev, generator=gen).to(bf16)
    yh = fc.fwht_raw(xh)
    check(torch.equal(yh, fc.fwht_plain(xh)), "fwht_bf16s at the column head")
    gh = torch.randn(xh.shape, device=dev, generator=gen).to(bf16)
    xg = xh.clone().requires_grad_()
    (dx,) = torch.autograd.grad(fc.FwhtFunction.apply(xg), xg, gh)
    check(torch.equal(dx, fc.fwht_plain(gh)), "fwht_bf16s backward at the column head")
    max_abs["fwht_bf16s"] = (yh.float() - fc.fwht_plain(xh).float()).abs().max().item()
    log(f"  column head {tuple(xh.shape)}: forward and backward equal")
    torch.cuda.synchronize()
    return max_abs


# the column kernel's shapes: (s lead, g lead, D): the column head (8, 1, D)
# at D = 4096 and 8192, the column LRT's rows (8, 256, 4096), 8 replicas,
# and the edges of the kernel's range, D = 2 and 16384
COLUMN_SHAPES = [
    ((), (SCALING_S, 1), 4096),
    ((), (SCALING_S, 1), 8192),
    ((), (SCALING_S, SCALING_B), 4096),
    ((8, 1, 1), (8, SCALING_S, 1), 4096),
    ((), (SCALING_S, 1), 2),
    ((), (SCALING_S, 1), 16384),
]


def _column_operands(dev, gen, s_lead, g_lead, D):
    bf16 = torch.bfloat16
    s1, s2 = (torch.randn(*s_lead, D, device=dev, generator=gen).to(bf16) for _ in range(2))
    g = torch.randn(*g_lead, D, device=dev, generator=gen).to(bf16)
    gy = torch.randn(torch.broadcast_shapes(g.shape, s1.shape), device=dev, generator=gen).to(bf16)
    return s1, g, s2, gy


def column_vs_plain(fc, dev, seed) -> dict:
    """The column kernel's three modes (y; y and t; the backward's dg, p1,
    p2) against column_plain / column_bwd_plain at COLUMN_SHAPES, bit for
    bit. Returns the largest abs error of each mode over the shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    log("column kernel vs plain (every mode bit for bit):")
    max_abs = dict.fromkeys(COLUMN_KERNELS, 0.0)
    for s_lead, g_lead, D in COLUMN_SHAPES:
        s1, g, s2, gy = _column_operands(dev, gen, s_lead, g_lead, D)
        ref_y, ref_t = fc.column_plain(s1, g, s2, True)
        y = fc.column_raw(s1, g, s2, False)[0]
        res = fc.column_raw(s1, g, s2, True)
        bwd = fc.column_bwd_raw(s1, s2, gy, ref_t.contiguous())
        ref_bwd = fc.column_bwd_plain(s1, s2, gy, ref_t)
        for name, pairs in (("column_y_bf16s", [(y, ref_y)]), ("column_res_bf16s", zip(res, (ref_y, ref_t))),
                            ("column_bwd_bf16s", zip(bwd, ref_bwd))):
            pairs = list(pairs)
            check(all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in pairs),
                  f"{name} at s {s_lead}, g {g_lead}, D={D} is not the plain version bit for bit")
            max_abs[name] = max(max_abs[name], *((a.float() - b.float()).abs().max().item()
                                                 for a, b in pairs))
        log(f"  s {tuple(s1.shape[:-1])}, g {tuple(g.shape[:-1])} D={D}: y, y/t and dg/p1/p2 equal")
    torch.cuda.synchronize()
    return max_abs


def _column_chain(fc, s1, g, s2, gy, t):
    """The chain the column kernel replaced (the parent's column_given_g on
    bf16 storage, n == D): its forward, H_rows * g, K4, s1_0 *, * s2; and
    its backward up to the reductions, the slice's zero fill and copy, the
    four products, K4 and * H_rows (autograd's ops, on the same
    operands)."""
    D = g.shape[-1]
    H_rows = torch.ones(1, D, dtype=g.dtype, device=g.device)
    s1_rows, a = s1[..., :1, None], (s1[..., :1] * t).unsqueeze(-2)
    t_rows = t.unsqueeze(-2)

    def forward():
        rows = s1_rows * fc.fwht_raw(H_rows * g[..., None, :]) * s2
        return rows.reshape(rows.shape[:-2] + (D,))[..., :D]

    def backward():
        full = gy.new_zeros(gy.shape)
        full[..., :D] = gy
        rows = full.unsqueeze(-2)
        da = rows * s2
        p2 = rows * a
        dt = da * s1_rows
        p1 = da * t_rows
        return fc.fwht_raw(dt) * H_rows, p1, p2

    return forward, backward


def column_times(fc, dev, seed) -> dict:
    """Device ms a call (20 calls in a CUDA graph, median of 5 replays) of
    each mode of the column kernel, in turns with its plain version, the
    chain it replaced on the same operands and the launch floor (a kernel
    that does nothing, on the same grid, fwht_cuda.column_floor), in the
    order plain, kernel, chain, floor, floor, chain, kernel, plain; then
    torch.matmul(g, H_D) in bf16 as the one-call yardstick. Bound: bytes
    (g or gy, t, s2, s1_0 read once, each output written once) over 3.35
    TB/s. At the column head (8,1,D) for D = 4096 (the kernels line) and
    8192, and at the column LRT's rows (8,256,4096)."""
    from whvi_tpu_torch.bench.common import bound_ms, time_us
    from whvi_tpu_torch.ops.hadamard import factor_H
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    times = {}
    log("column kernel times (device ms a call, CUDA graph; plain/kernel/chain/floor in turns; "
        "bound at 2 bytes an element; library: g @ H_D):")
    for s_lead, g_lead, D in (((), (SCALING_S, 1), SCALING_D), ((), (SCALING_S, 1), 8192),
                              ((), (SCALING_S, SCALING_B), SCALING_D)):
        s1, g, s2, gy = _column_operands(dev, gen, s_lead, g_lead, D)
        y, t = fc.column_raw(s1, g, s2, True)
        H = factor_H(D, torch.bfloat16, dev)
        chain_fwd, chain_bwd = _column_chain(fc, s1, g, s2, gy, t)
        rows, s1_0, log2d = g.numel() // D, s1[..., :1], int(math.log2(D))
        for name, kernel, plain, chain, ins, outs, ops in (
            ("column_y_bf16s", lambda: fc.column_raw(s1, g, s2, False),
             lambda: fc.column_plain(s1, g, s2, False), chain_fwd, (g, s2, s1_0), (y,), log2d + 2),
            ("column_res_bf16s", lambda: fc.column_raw(s1, g, s2, True),
             lambda: fc.column_plain(s1, g, s2, True), chain_fwd, (g, s2, s1_0), (y, t), log2d + 2),
            ("column_bwd_bf16s", lambda: fc.column_bwd_raw(s1, s2, gy, t),
             lambda: fc.column_bwd_plain(s1, s2, gy, t), chain_bwd, (gy, t, s2, s1_0), (y, y, y),
             log2d + 5),
        ):
            fns = {"plain": plain, "kernel": kernel, "chain": chain,
                   "floor": lambda: fc.column_floor(rows, D, dev)}
            order = ["plain", "kernel", "chain", "floor"]
            got = {k: [] for k in fns}
            for k in order + order[::-1]:
                got[k].append(time_us(fns[k], 20) / 1e3)
            ms = {k: sum(v) / len(v) for k, v in got.items()}
            bound = bound_ms(ins, outs, g.numel() * ops, PEAK)
            t_row = {"ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": time_us(lambda: torch.matmul(g, H), 20) / 1e3}
            log(f"  {name:<17} g {tuple(g.shape)}: kernel {t_row['ms']:.5f}  chain {ms['chain']:.5f}  "
                f"floor {ms['floor']:.5f}  plain {t_row['plain_ms']:.5f}  library "
                f"{t_row['library_ms']:.5f}  bound {bound[0]:.6f} ({bound[1]}; share "
                f"{bound[0] / t_row['ms']:.3f})")
            if g.shape == (SCALING_S, 1, SCALING_D):
                times[name] = t_row
    return times


def bf16s_times(fc, dev, seed) -> dict:
    """Device ms a call (CUDA graph) of the four bf16-storage kernels and
    their plain versions at the scaling shape (D=4096, 2048 rows; K4 at
    the column head (8,1,1,4096), beside torch.matmul(x, H_D) in bf16),
    each with its bound at 2 bytes an element; K1-K3 logged at D=8192
    too. Returns the kernels line's entries (D=4096)."""
    from whvi_tpu_torch.bench.common import bound_ms
    from whvi_tpu_torch.ops.hadamard import factor_H
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    S, B = SCALING_S, SCALING_B
    times = {}
    for D in BF16S_WIDTHS:
        s1, s2 = (torch.randn(D, device=dev, generator=gen).to(bf16) for _ in range(2))
        u = torch.randn(S, 1, D, device=dev, generator=gen).to(bf16)
        x = torch.randn(B, D, device=dev, generator=gen).to(bf16).expand(S, B, D)
        g = torch.randn(S, B, D, device=dev, generator=gen).to(bf16)
        ops = fused_ops(D, S * B)
        log(f"bf16-storage times at D={D}, u ({S},1,D), x ({S},{B},D) (device ms per call, "
            "20 calls in a CUDA graph, median of 5 replays; bound at 2 bytes an element):")
        for name, kernel, plain, ins, n_out in (
            ("fused_y_bf16s", lambda: fc.fused_raw(s1, u, s2, x, False),
             lambda: fc.fused_plain(s1, u, s2, x, False), (x, u, s1, s2), 1),
            ("fused_res_bf16s", lambda: fc.fused_raw(s1, u, s2, x, True),
             lambda: fc.fused_plain(s1, u, s2, x, True), (x, u, s1, s2), 3),
            ("fused_bwd_bf16s", lambda: fc.fused_bwd_raw(s1, u, s2, g),
             lambda: fc.fused_plain(s2, u, s1, g, True), (g, u, s1, s2), 3),
        ):
            t = _timed(kernel, plain, bound_ms(ins, [g] * n_out, ops, PEAK))
            _log_time(name if D == SCALING_D else f"{name} D={D}", t)
            if D == SCALING_D:
                times[name] = t
    D = SCALING_D
    xh = torch.randn(S, 1, 1, D, device=dev, generator=gen).to(bf16)
    H = factor_H(D, bf16, dev)
    times["fwht_bf16s"] = _timed(
        lambda: fc.fwht_raw(xh), lambda: fc.fwht_plain(xh),
        bound_ms((xh,), (xh,), xh.numel() * int(math.log2(D)), PEAK),
        library=lambda: torch.matmul(xh, H))
    _log_time("fwht_bf16s", times["fwht_bf16s"])
    xb = torch.randn(S * B, D, device=dev, generator=gen).to(bf16)
    tb = _timed(lambda: fc.fwht_raw(xb), lambda: fc.fwht_plain(xb),
                bound_ms((xb,), (xb,), xb.numel() * int(math.log2(D)), PEAK))
    _log_time(f"fwht_bf16s ({S * B}, {D})", tb)
    return times


def bf16s_net_vs_cpu(fc, dev, seed) -> None:
    """The bf16 scaling net (D=4096) on the card (kernels) against a CPU
    copy (plain versions) on the same weights, data and noise: loss and
    every gradient within BF16S_NET_TOL of its max. The products equal
    their plain versions bit for bit; the elementwise ops and the fp32
    sums of the reductions may differ in the last fp32 bit between the two
    devices, and a bf16 rounding then lands on its other side. Logs the
    launches of the card's loss and backward (a train step's: Adam
    launches no kernel of the port) and of one predictive call."""
    from whvi_tpu_torch.experiments import run_scaling
    from whvi_tpu_torch.models import WHVILinear

    D, S, B = SCALING_D, SCALING_S, SCALING_B
    net = run_scaling.build_net(D, S, dev, torch.bfloat16)
    net.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    cpu_net = copy.deepcopy(net).cpu()
    X, y = run_scaling.data(D, B, seed, "cpu", torch.bfloat16)
    rng = np.random.RandomState(seed + 3)
    eps = [
        torch.from_numpy(rng.randn(S, 1, *l.matrix.g_mu.shape).astype(np.float32)).to(torch.bfloat16)
        if isinstance(l, WHVILinear) else None
        for l in cpu_net.layers
    ]
    results = []
    fc.reset_launches()
    for model, d in ((net, dev), (cpu_net, torch.device("cpu"))):
        e = [None if a is None else a.to(d) for a in eps]
        loss, _ = model.loss(X.to(d), y.to(d), B, eps=e)
        loss.backward()
        results.append((loss.detach().cpu(), [p.grad.detach().cpu() for p in model.parameters()]))
    step = {k: v for k, v in fc.LAUNCHES.items() if v}
    fc.reset_launches()
    with torch.no_grad():
        net.predict(X.to(dev), S)
    call = {k: v for k, v in fc.LAUNCHES.items() if v}
    log(f"  launches of a bf16-storage train step: {step}; of a predictive call: {call}")
    for name, launches, want in (("column_res_bf16s", step, 1), ("column_bwd_bf16s", step, 1),
                                 ("column_y_bf16s", step, 0), ("fwht_bf16s", step, 0),
                                 ("column_y_bf16s", call, 1), ("column_res_bf16s", call, 0),
                                 ("fwht_bf16s", call, 0)):
        check(launches.get(name, 0) == want, f"the bf16-storage net launched {name} "
              f"{launches.get(name, 0)} times, not {want}")
    (l_k, g_k), (l_p, g_p) = results
    err = rel_err(l_k.float(), l_p.float())
    grad_err = max(rel_err(a.float(), b.float()) for a, b in zip(g_k, g_p))
    log(f"  bf16-storage net D={D} card vs CPU on the same noise: loss {err:.2e}, "
        f"gradients {grad_err:.2e} (<= {BF16S_NET_TOL:.2e})")
    check(max(err, grad_err) <= BF16S_NET_TOL, "the bf16-storage net disagrees with its CPU copy")


def run_bf16s_path(fc, dev, seed) -> dict:
    """run_scaling --dtype bf16 at D = 4096 and 8192, train and predict,
    through its entry point: its rows finite, each bf16-storage kernel
    launched and no fp32-storage product, no operand realigned. Then the
    same with --profile 10 in a fresh process (device events and kernel
    ms a step), and the fp32 rows at the same D, for step ms and peak
    memory beside them. Returns the launch counts of the bf16 run."""
    from whvi_tpu_torch.experiments import run_scaling

    sizes = [str(D) for D in BF16S_WIDTHS]
    log(f"bf16-storage path: run_scaling --dtype bf16 --sizes {' '.join(sizes)}, train and predict")
    fc.reset_launches()
    rows = []
    for predict in ([], ["--predict"]):
        rows += run_scaling.main(["--sizes", *sizes, "--seed", str(seed), "--dtype", "bf16",
                                  *predict])
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; operands realigned {fc.REALIGNED}")
    check(fc.REALIGNED == 0, "the bf16-storage path copied misaligned operands")
    for name in BF16S_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the bf16-storage path")
    for name in ("fused_y", "fused_res", "fused_bwd", "fwht", *BF16_KERNELS):
        check(launched(launches, name) == 0, f"the bf16-storage path launched the fp32-storage {name}")
    check(launches["fwht_bf16s"] == 0, "the bf16-storage path launched the bare fwht_bf16s")
    # profiled in a fresh process: this one's profiler, after the phases
    # before, has lost kernel records (utils.profiling raises then)
    for predict in ([], ["--predict"]):
        out = subprocess.run(
            [sys.executable, "-m", "whvi_tpu_torch.experiments.run_scaling", "--sizes", *sizes,
             "--seed", str(seed), "--dtype", "bf16", "--profile", "10", *predict],
            capture_output=True, text=True, timeout=300, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        rows += [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{") and '"D"' in line]
    log("  the fp32 rows beside them:")
    for predict in ([], ["--predict"]):
        rows += run_scaling.main(["--sizes", *sizes, "--seed", str(seed), *predict])
    check(len(rows) == 12, f"run_scaling gave {len(rows)} rows, not 12")
    for row in rows:
        check(run_scaling.finite(row), f"non-finite row {row}")
    for row in rows:
        what = f"call {row['call_ms']:.3f} ms" if "call_ms" in row else f"step {row['step_ms']:.3f} ms"
        log(f"  D={row['D']} {row['dtype']:>4} {row.get('mode', 'train'):>7}: {what}, "
            f"peak {row['max_memory_gb']} GB")
        if "kernel_ms" in row:  # the profiled bf16 rows
            log(f"    kernels {row['kernel_ms']} ms in {row['device_events']} device events, "
                f"busy {row['busy_share']}, "
                f"Optimizer.step host {row['optimizer_host_ms']} ms; top kernels "
                f"(ms a step): {row['top_kernels']}")
    return launches


def run_fwht_sweep(fc) -> dict:
    """The FWHT sweep's entry point at three widths, few iterations: every
    row's kernel equal to its plain version (the sweep checks), times
    finite, K4 launched in both storages. Returns the launches of that
    run (the bare fwht_bf16s's path since the column head has a kernel of
    its own)."""
    from whvi_tpu_torch.bench import fwht_sweep

    fc.reset_launches()
    rows, crossover = fwht_sweep.main(["--sizes", "256", "4096", "16384", "--iters", "10"])
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    check(len(rows) == 3 and all(math.isfinite(v) for r in rows for v in r.values()),
          "fwht_sweep rows")
    check(launches["fwht_bf16s"] > 0 and launches["fwht"] > 0, "fwht_sweep launched no K4")
    log(f"  fwht_sweep crossover: {crossover}; launches fwht {launches['fwht']}, fwht_bf16s "
        f"{launches['fwht_bf16s']}")
    return launches


# ------------------------------------------------------------ 11. the mesh

MESH_WORLD = 4  # ranks of (b)-(d): one a card, or sharing the one card
MESH_STEPS = 20  # the checked runs' steps
MESH_TIMED_STEPS = 30  # run_scaling.run's steps a run on a mesh: 30 and 60 steps of ~15 ms
# differ by ~0.45 s, far above the host clock's noise
# (layout, storage, precision, D): the checked runs of (b); all but the bf16
# precision are also timed through run_scaling.run
MESH_RUNS = (
    *[(layout, "f32", "fp32", SCALING_D) for layout in ((2, 2), (1, 4), (4, 1))],
    *[(layout, "bf16", "fp32", SCALING_D) for layout in ((2, 2), (1, 4), (4, 1))],
    ((2, 2), "f32", "bf16", SCALING_D),
    ((1, 4), "f32", "fp32", 8192),  # config 5's "D=8192, high-MC ELBO sharded"
)
MESH_ONE_TOL = 1e-6  # (a) the 1x1 mesh against the unsharded trainer
# (b) each step of four ranks against one device at the same parameters
# and noise, and the last loss: fp32 sums in another order; bf16 storage
# and the bf16 precision round where one device rounds, but a sum in
# another order may flip a rounding (the bf16 nets' 2^-7)
MESH_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
MESH_FIT_TOL = 1e-5  # (c) the flagship on 2x2 against one device
MESH_STACK_TOL = 1e-6  # (c) the split stack against phase 8's
MESH_NUTS_TOL = 1e-5  # (d) a rank's chain against that chain run alone
MESH_FLAGSHIP_EPOCHS = (2, 6)


def _mesh_tol(storage: str, precision: str) -> float:
    return MESH_TOL["bf16" if "bf16" in (storage, precision) else "fp32"]


def scaling_checked(fc, dev, key, seed, mesh=None, rows=None) -> dict:
    """MESH_STEPS train steps of the scaling model (batch 256, S=8) and then
    a predictive call: sharded on ``mesh``, else the unsharded trainer (on
    the batch's ``rows``, a permutation, where given: the same loss, its
    sums in another order);
    loss, parameters and predictions (on the CPU), the launches a step and
    a call, the all-reduces a step, operands realigned. On a mesh also:
    before every step, one device's loss and gradient at the same
    parameters and noise (on this rank, outside the counts), and the
    steps' largest errors against them (the gradients' over the largest
    gradient of all parameters, and over each parameter's own largest,
    which a sum that cancels makes large in bf16); whether every rank
    holds rank 0's parameters bit for bit; and the sharded predictions
    against one device's on the same parameters."""
    import torch.distributed as dist

    from whvi_tpu_torch.experiments import run_scaling
    from whvi_tpu_torch.ops import set_whvi_mul_precision
    from whvi_tpu_torch.parallel.mesh import (
        COLLECTIVES, make_sharded_predict, make_sharded_train_step, reset_collectives,
    )
    from whvi_tpu_torch.train import TrainConfig, Trainer

    _, storage, precision, D = key
    dtype = run_scaling.DTYPES[storage]
    net = run_scaling.build_net(D, SCALING_S, dtype=dtype)
    set_whvi_mul_precision(precision)
    try:
        if mesh is None:
            trainer = Trainer(net, TrainConfig(), device=dev)
            step = trainer.train_step
        else:
            step = make_sharded_train_step(net, mesh, TrainConfig(), device=dev)
            trainer = step.trainer
        state = trainer.init(seed)
        X, y = run_scaling.data(D, SCALING_B, seed, dev, dtype)
        if rows is not None:
            X, y = X[rows], y[rows]
        params = list(trainer.net.parameters())
        counts, all_reduce, realigned = {}, 0, 0
        grad_err = grad_err_own = loss_err = 0.0
        for _ in range(MESH_STEPS):
            if mesh is not None:
                one = torch.Generator(device=dev)
                one.set_state(state.generator.get_state())
                trainer.net.zero_grad(set_to_none=False)
                loss_one, _ = trainer.net.loss(X, y, SCALING_B, one)
                loss_one.backward()
                grads_one = [p.grad.float().clone() for p in params]  # the step zeroes .grad
            torch.cuda.synchronize(dev)
            fc.reset_launches()
            reset_collectives()
            metrics = step(state, X, y, SCALING_B, True)
            torch.cuda.synchronize(dev)
            for k, v in fc.LAUNCHES.items():
                counts[k] = counts.get(k, 0) + v
            all_reduce += COLLECTIVES["all_reduce"]
            realigned += fc.REALIGNED
            if mesh is not None:
                loss_err = max(loss_err, abs(float(metrics["loss"]) / loss_one.item() - 1.0))
                scale = max(g.abs().max().item() for g in grads_one)
                diffs = [(p.grad.float() - g).abs().max().item() for p, g in zip(params, grads_one)]
                grad_err = max(grad_err, max(diffs) / scale)
                grad_err_own = max(grad_err_own, *(
                    d / max(g.abs().max().item(), 1e-30) for d, g in zip(diffs, grads_one)))
        train = {k: v / MESH_STEPS for k, v in counts.items() if v}
        all_reduce /= MESH_STEPS
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        fc.reset_launches()
        with torch.no_grad():
            if mesh is None:
                y_hat = trainer.net.predict(X, SCALING_S, gen)
            else:
                pred = make_sharded_predict(trainer.net, mesh, SCALING_S)
                block = pred(X, gen)
        torch.cuda.synchronize(dev)
        predict = {k: v for k, v in fc.LAUNCHES.items() if v}
        realigned += fc.REALIGNED
        if mesh is not None:  # and the same parameters' one-device predictions
            y_hat = pred.gather(block)
            with torch.no_grad():
                y_one = trainer.net.predict(
                    X, SCALING_S, torch.Generator(device=dev).manual_seed(seed + 1))
    finally:
        set_whvi_mul_precision("fp32")
    flat = torch.cat([p.detach().float().reshape(-1) for p in trainer.net.parameters()])
    out = dict(loss=float(metrics["loss"]), params=flat.cpu(), y_hat=y_hat.float().cpu(),
               train=train, predict=predict, all_reduce=all_reduce, realigned=realigned)
    if mesh is not None:
        ref = flat.clone()
        dist.broadcast(ref, 0)
        out["equal_to_rank0"] = not mesh.agree(not torch.equal(ref, flat))
        out["predict_vs_one"] = rel_err(y_hat.float(), y_one.float())
        out["step_grad_err"], out["step_loss_err"] = grad_err, loss_err
        out["step_grad_err_own"] = grad_err_own
    return out


def _flagship(dev, seed, mesh=None):
    """The flagship (13 -> 128 -> 128 -> 1, S=4 train / 64 eval, batch 64)
    on phase 4's data, MESH_FLAGSHIP_EPOCHS epochs, then its evaluation:
    (loss, parameters, metrics)."""
    from whvi_tpu_torch.models import WHVIRegression, mlp_layers
    from whvi_tpu_torch.train import TrainConfig, Trainer

    (X, y), (Xt, yt) = synthetic_regression(seed)
    net = WHVIRegression(mlp_layers(13, 1, hidden=(128, 128)), train_samples=4, eval_samples=64)
    e1, e2 = MESH_FLAGSHIP_EPOCHS
    cfg = TrainConfig(epochs1=e1, epochs2=e2, epochs_per_call=2, batch_size=64)
    trainer = Trainer(net, cfg, device=dev, mesh=mesh)
    state = trainer.init(seed)
    state, logs = trainer.fit(state, X, y)
    metrics = trainer.evaluate(Xt, yt, torch.Generator(device=dev).manual_seed(seed + 1))
    flat = torch.cat([p.detach().reshape(-1) for p in trainer.net.parameters()]).cpu()
    return logs[-1]["loss"], flat, metrics


def _protocol_config(seed):
    from whvi_tpu_torch.evaluation import ProtocolConfig

    return ProtocolConfig(n_splits=PROTOCOL_R, epochs1=PROTOCOL_EPOCHS[0],
                          epochs2=PROTOCOL_EPOCHS[1], checkpoint_every=2, calibrate=True,
                          seed=seed)


def mesh_rank(dev, seed: int, tmp: str) -> dict:
    """What every rank of phase 11's four-rank world runs: (b) the checked
    runs and run_scaling.run on each mesh, (c) the flagship on 2x2 and the
    protocol on the split mesh, (d) NUTS with its chains split over the
    ranks. Each part's kernel launches are counted from 0."""
    from whvi_tpu_torch.evaluation import evaluate_bayesian_regression
    from whvi_tpu_torch.experiments import run_scaling
    from whvi_tpu_torch.mcmc import nuts_sample_chains
    from whvi_tpu_torch.ops import fwht_cuda as fc
    from whvi_tpu_torch.parallel import make_mesh
    from whvi_tpu_torch.parallel.mesh import make_split_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"checked": {}, "rows": [], "times": {}}
    for key in MESH_RUNS:
        mesh = make_mesh(*key[0])
        out["checked"][key] = scaling_checked(fc, dev, key, seed, mesh)
        if key[2] == "fp32":
            for predict in (False, True):
                out["rows"] += run_scaling.run(
                    key[3], device=dev, steps=MESH_TIMED_STEPS, predict=predict,
                    dtype=key[1], seed=seed, mesh=mesh,
                )
    t0 = time.perf_counter()
    fc.reset_launches()
    out["flagship"] = _flagship(dev, seed, make_mesh(2, 2))
    X, y = _protocol_data(seed)
    out["protocol"] = evaluate_bayesian_regression(
        X, y, _protocol_config(seed), ckpt_dir=os.path.join(tmp, "protocol"), device=dev,
        split_mesh=make_split_mesh(),
    )
    torch.cuda.synchronize(dev)
    out["times"]["c"] = time.perf_counter() - t0
    out["c_launches"], out["c_realigned"] = dict(fc.LAUNCHES), fc.REALIGNED
    t0 = time.perf_counter()
    lp4, init4 = config4_posterior(dev, seed)
    mesh = make_mesh(1, MESH_WORLD)
    fc.reset_launches()
    s4, _ = nuts_sample_chains(
        lp4, init4, torch.Generator(device=dev).manual_seed(seed + 12), nuts_config(),
        n_chains=4, mesh=mesh,
    )
    torch.cuda.synchronize(dev)
    out["times"]["d"] = time.perf_counter() - t0
    out["d_launches"], out["d_realigned"] = dict(fc.LAUNCHES), fc.REALIGNED
    out["nuts"] = {k: v.cpu() for k, v in s4.items()}
    out["nuts_chains"] = mesh.part(4, mesh.axis_names)
    out["nuts_alone"] = nuts_alone(lp4, init4, dev, seed, out["nuts_chains"])
    return out


def config4_posterior(dev, seed):
    """Phase 9's config-4 g posterior (256 rows), on ``dev``."""
    from whvi_tpu_torch.bench.sampler_bench import config4_net
    from whvi_tpu_torch.data import synthetic_classification
    from whvi_tpu_torch.mcmc import make_whvi_g_log_posterior

    (X4, y4), _ = synthetic_classification(seed=seed)
    return make_whvi_g_log_posterior(config4_net(seed).to(dev), X4[:256], y4[:256])


def nuts_alone(lp, init, dev, seed, chains: slice) -> dict:
    """Phase 9's 4-chain NUTS run cut to ``chains``: the same jittered
    starts and draws (every chain's, from the same generator), sampled
    in a batch of only those chains."""
    from whvi_tpu_torch.mcmc import nuts
    from whvi_tpu_torch.mcmc.chains import jittered_inits, ravel, tree_map

    cfg = nuts_config()
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    inits = jittered_inits(init, gen, 4, 0.1)
    make = nuts.nuts_draws(gen, 4, ravel(inits)[0].shape[1], cfg.max_tree_depth, dev)
    draws = [make(t) for t in range(cfg.n_warmup + cfg.n_samples)]
    samples, _ = nuts._nuts_chains(
        lp, tree_map(lambda a: a[chains], inits), None, cfg,
        lambda t: tree_map(lambda a: a[chains], draws[t]),
    )
    return {k: v.cpu() for k, v in samples.items()}


def _scaling_errs(got: dict, want: dict) -> dict:
    return {
        "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "params": rel_err(got["params"], want["params"]),
        "predictions": rel_err(got["y_hat"], want["y_hat"]),
    }


def _launch_line(counts: dict) -> str:
    return ", ".join(f"{k} {v:g}" for k, v in counts.items() if v) or "none"


def run_mesh_path(fc, dev, seed, protocol_out, nuts_s4) -> None:
    """Phase 11, the mesh (whvi_tpu_torch/parallel/): (a) a world of one
    on NCCL, (b)-(d) four ranks, one a card over NCCL where there are four
    cards, else sharing the one card over gloo. Every comparison is logged
    before any is held; the phase fails with the list of those that miss."""
    import torch.distributed as dist

    from whvi_tpu_torch.experiments import run_scaling
    from whvi_tpu_torch.parallel import init_distributed, make_mesh
    from whvi_tpu_torch.parallel.distributed import spawn

    fails = []

    def hold(ok: bool, what: str) -> None:
        if not ok:
            fails.append(what)

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_WORLD else "gloo"
    refs, witness = {}, {}
    perm = torch.randperm(SCALING_B, generator=torch.Generator().manual_seed(seed)).to(dev)
    for key in MESH_RUNS:
        one = (None,) + key[1:]
        if one not in refs:
            refs[one] = scaling_checked(fc, dev, one, seed)
            permuted = scaling_checked(fc, dev, one, seed, rows=perm)
            witness[one] = rel_err(permuted["params"], refs[one]["params"])

    t_a = time.perf_counter()
    log("  (a) a world of one on NCCL: the 1x1 mesh against the unsharded trainer, "
        f"{MESH_STEPS} steps and a predictive call")
    init_distributed("nccl")
    try:
        mesh = make_mesh(1, 1)
        for key, want in refs.items():
            got = scaling_checked(fc, dev, key, seed, mesh)
            errs = _scaling_errs(got, want)
            log(f"    D={key[3]} {key[1]}/{key[2]}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (<= {MESH_ONE_TOL}); all_reduce a step {got['all_reduce']:g}; a step launches "
                + _launch_line(got["train"]) + "; a call " + _launch_line(got["predict"]))
            hold(max(errs.values()) <= MESH_ONE_TOL, f"the 1x1 mesh differs from one device at {key}")
            hold(got["all_reduce"] == 1, f"{got['all_reduce']} all-reduces a step at 1x1, not 1")
            hold(fold_k3(got["train"]) == fold_k3(want["train"])
                 and fold_k3(got["predict"]) == fold_k3(want["predict"]),
                 f"the 1x1 mesh launches other kernels than one device at {key}")
            hold(got["realigned"] == 0, "the 1x1 mesh copied misaligned operands")
        rows = []
        for predict in ([], ["--predict"]):
            rows += run_scaling.main(["--mesh", "1x1", "--sizes", str(SCALING_D),
                                      "--seed", str(seed), *predict])
    finally:
        dist.destroy_process_group()
    for row in rows:
        hold(run_scaling.finite(row) and row["backend"] == "nccl", f"1x1 row {row}")
    t_b = time.perf_counter()

    used = max(1, min(cards, MESH_WORLD))
    log(f"  (b)-(d) {MESH_WORLD} ranks over {backend} on {used} card(s) ({MESH_WORLD // used} a card)")
    want_fit = _flagship(dev, seed)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(mesh_rank, MESH_WORLD, backend, "cuda", seed, tmp)
    t_e = time.perf_counter()
    got = ranks[0]
    log(f"  (b) {MESH_STEPS} steps a mesh, each step's loss and gradient against one device's at "
        "the same parameters and noise, the last loss and the parameters against one device's "
        "run (the parameters are not held; beside them one device's run with the batch rows "
        "permuted against its run in order)")
    for key in MESH_RUNS:
        want = refs[(None,) + key[1:]]
        tol = _mesh_tol(key[1], key[2])
        mine = got["checked"][key]
        per_rank = [r["checked"][key] for r in ranks]
        step_err = max(max(c["step_grad_err"], c["step_loss_err"]) for c in per_rank)
        last_loss = abs(mine["loss"] - want["loss"]) / abs(want["loss"])
        log(f"    {key[0][0]}x{key[0][1]} D={key[3]} {key[1]}/{key[2]}: a step's gradient "
            f"{max(c['step_grad_err'] for c in per_rank):.2e} (of each parameter's own largest "
            f"{max(c['step_grad_err_own'] for c in per_rank):.2e}, not held) and loss "
            f"{max(c['step_loss_err'] for c in per_rank):.2e}, the last loss {last_loss:.2e} "
            f"(<= {tol:.2e}); parameters {rel_err(mine['params'], want['params']):.2e} (one "
            f"device, rows permuted: {witness[(None,) + key[1:]]:.2e}), "
            f"predictions {rel_err(mine['y_hat'], want['y_hat']):.2e} against one device's run; "
            f"sharded predictions vs one device on the same parameters {mine['predict_vs_one']:.2e} "
            f"(<= {MESH_ONE_TOL}); every rank equal to rank 0 "
            f"{all(c['equal_to_rank0'] for c in per_rank)}; all_reduce a step {mine['all_reduce']:g}; "
            "a step launches a rank " + _launch_line(mine["train"]) + "; a call "
            + _launch_line(mine["predict"]) + f"; realigned {sum(c['realigned'] for c in per_rank)}")
        hold(max(step_err, last_loss) <= tol, f"the mesh's steps differ from one device's at {key}")
        hold(mine["predict_vs_one"] <= MESH_ONE_TOL, f"the sharded predict differs at {key}")
        for c in per_rank:
            hold(c["equal_to_rank0"], f"a rank's parameters differ from rank 0's at {key}")
            hold(fold_k3(c["train"]) == fold_k3(want["train"])
                 and fold_k3(c["predict"]) == fold_k3(want["predict"]),
                 f"a rank launches other kernels than one device at {key}")
            hold(c["all_reduce"] == 1 and c["realigned"] == 0, f"collectives or realigned at {key}")
    for row in got["rows"]:
        hold(run_scaling.finite(row), f"non-finite row {row}")
        what = f"call {row['call_ms']:.3f} ms" if "call_ms" in row else f"step {row['step_ms']:.3f} ms"
        log(f"    run_scaling {row['mesh']['data']}x{row['mesh']['sample']} D={row['D']} "
            f"{row['dtype']:>4} {row.get('mode', 'train'):>7}: {what}, peak {row['max_memory_gb']}"
            f" GB a rank, {row['backend']}, {row['ranks_per_card']} ranks a card")
    hold(len(got["rows"]) == 14, f"{len(got['rows'])} mesh rows, not 14")

    loss, params, metrics = got["flagship"]
    w_loss, w_params, w_metrics = want_fit
    errs = {"loss": abs(loss - w_loss) / abs(w_loss), "parameters": rel_err(params, w_params)}
    errs.update({k: abs(metrics[k] - v) / max(abs(v), 1e-30) for k, v in w_metrics.items()})
    log(f"  (c) the flagship on 2x2, {'+'.join(map(str, MESH_FLAGSHIP_EPOCHS))} epochs, against "
        "one device: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (<= {MESH_FIT_TOL})")
    hold(max(errs.values()) <= MESH_FIT_TOL, "the flagship on the mesh differs from one device")
    keys = ("rmse_mean", "mnll_per_point_mean", "pred_mnll_per_point_mean", "coverage95_mean",
            "temperature_mean", "coverage95_cal_mean")
    p_errs = {k: abs(got["protocol"][k] - protocol_out[k]) / max(abs(protocol_out[k]), 1e-30)
              for k in keys}
    log(f"    the protocol on the split mesh, R={PROTOCOL_R} over {MESH_WORLD} ranks, against "
        "phase 8's stack: " + ", ".join(f"{k} {v:.2e}" for k, v in p_errs.items())
        + f" (<= {MESH_STACK_TOL}); launches a rank " + _launch_line(got["c_launches"])
        + f"; realigned {got['c_realigned']}; {got['times']['c']:.1f} s")
    hold(max(p_errs.values()) <= MESH_STACK_TOL, "the split-mesh protocol differs from phase 8's")
    nuts_err = max(
        rel_err(got["nuts"][i][r["nuts_chains"]], r["nuts_alone"][i]) for r in ranks for i in nuts_s4
    )
    lp4, init4 = config4_posterior(dev, seed)
    alone0 = nuts_alone(lp4, init4, dev, seed, slice(0, 1))
    batch_err = max(rel_err(alone0[i], nuts_s4[i][:1].cpu()) for i in nuts_s4)
    log(f"  (d) NUTS at config 4 (phase 9's run), its 4 chains over {MESH_WORLD} ranks: draws "
        f"against each rank's chain run alone from the same numbers {nuts_err:.2e} (<= "
        f"{MESH_NUTS_TOL}); against phase 9's batch of 4 chains "
        f"{max(rel_err(got['nuts'][i], nuts_s4[i].cpu()) for i in nuts_s4):.2e}, and on one card "
        f"without a mesh chain 0 alone against that batch {batch_err:.2e} (neither held: a batch "
        "of 4 walkers sums the rows in another order than one walker, and NUTS with dual "
        "averaging turns a last-bit difference into another trajectory); launches a rank "
        + _launch_line(got["d_launches"]) + f"; realigned {got['d_realigned']}; "
        f"{got['times']['d']:.1f} s")
    hold(nuts_err <= MESH_NUTS_TOL, "the sharded chains differ from their chains run alone")
    for r in ranks:
        for part, kernels in (("c", FLAGSHIP_KERNELS), ("d", ("fused_res", "fused_bwd"))):
            launches = r[f"{part}_launches"]
            hold(r[f"{part}_realigned"] == 0, f"({part}) copied misaligned operands")
            for name in kernels:
                hold(launched(launches, name) > 0, f"({part}): a rank launched no {name}")
    log(f"  phase 11 parts: references {t_a - t0:.1f} s, (a) {t_b - t_a:.1f} s, (b)-(d) "
        f"{t_e - t_b:.1f} s (the world's (c) {got['times']['c']:.1f}, (d) {got['times']['d']:.1f})")
    check(not fails, "phase 11: " + "; ".join(fails))


# ------------------------------------------------ 12. checks and figures

GRAD_CHECK_DIMS = (64, SCALING_D)
PRECISION_ITERS = "20"  # precision_check's --iters (100 by default)
PRECISION_BOUND = {"fp32": 1e-6, "bf16": 2.0**-7, "bf16s": 2.0**-7}
PRECISION_KERNELS = ("fused_y", "fused_y_bf16", "fused_y_bf16s")  # K1 in each mode
# grad_check's (D,) diagonals take K3's reduce mode in both precisions
GRAD_KERNELS = ("fused_res", "fused_bwd_sums", "fused_res_bf16", "fused_bwd_sums_bf16", "fwht")
TOY_FAN_KERNELS = ("fused_y", "fused_res", "fused_bwd", "fwht")
# (e): one whvi_mul at D = argv[1] traced into argv[2], in a fresh process
TRACE_ONE = """
import json, sys, torch
from whvi_tpu_torch.ops import fwht_cuda as fc, whvi_mul
from whvi_tpu_torch.utils.profiling import trace
dev = torch.device("cuda", 0)
s1, u, s2, x = (torch.randn(*lead, int(sys.argv[1]), device=dev) for lead in ((), (), (), (256,)))
whvi_mul(s1, u, s2, x)  # loads the kernel library outside the trace
fc.reset_launches()
with trace(sys.argv[2]) as path:
    whvi_mul(s1, u, s2, x)
print(json.dumps({"path": path, "launches": {k: v for k, v in fc.LAUNCHES.items() if v},
                  "realigned": fc.REALIGNED}))
"""


def run_checks_path(fc, dev, seed, tmp) -> None:
    """Phase 12: the check CLIs, the profiler trace and the toy fan's data,
    each part's launches counted alone (see the module docstring)."""
    from whvi_tpu_torch.bench import column_lrt_check, diag_matmul, grad_check, make_figures
    from whvi_tpu_torch.bench import precision_check

    fails, times = [], {}

    def hold(ok: bool, what: str) -> None:
        if not ok:
            fails.append(what)

    def part(name, kernels, fn):
        torch.cuda.synchronize()
        fc.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches = {k: v for k, v in fc.LAUNCHES.items() if v}
        log(f"  ({name}) launches " + (", ".join(f"{k} {v}" for k, v in launches.items()) or "none")
            + f"; realigned {fc.REALIGNED}; {times[name]:.1f} s")
        hold(fc.REALIGNED == 0, f"({name}) copied misaligned operands")
        for k in kernels:
            hold(launched(launches, k) > 0, f"({name}) launched no {k}")
        return out

    def grad_checks():
        return [row for D in GRAD_CHECK_DIMS
                for row in grad_check.main(["--dim", str(D), "--batch", "4"])]

    rows = part("a", GRAD_KERNELS, grad_checks)
    hold(len(rows) == 4 * len(GRAD_CHECK_DIMS) and all(r["ok"] for r in rows), "(a) grad_check")
    for r in rows:
        if r["backend"] == "kernel":
            log(f"  (a) D={r['dim']} kernel VJPs against plain: max error fp32 "
                f"{max(v for k, v in r['errors'].items() if 'fp32' in k):.2e} (<= "
                f"{r['tol']['fp32']}), bf16 {max(v for k, v in r['errors'].items() if 'bf16' in k):.2e}")

    rows = part("b", PRECISION_KERNELS, lambda: precision_check.main(["--iters", PRECISION_ITERS]))
    for r in rows:
        hold(r["auto_equals_fp32"], f"(b) the default precision differs from fp32 at D={r['D']}")
        if "mode" in r:
            bound = PRECISION_BOUND[r["mode"]]
            hold(r["rel_err_vs_f64"] <= bound,
                 f"(b) {r['mode']} at D={r['D']}: rel_err_vs_f64 {r['rel_err_vs_f64']:.3e} > {bound}")
            log(f"  (b) D={r['D']:<6} {r['mode']:<6} rel_err_vs_f64 {r['rel_err_vs_f64']:.3e} "
                f"(<= {bound:.2e}); {r['us_per_call']:.2f} us a call, {r['GBps']:.0f} GB/s, "
                f"hbm_frac {r['hbm_frac']:.3f}, bound {r['bound_ms'] * 1e3:.2f} us "
                f"(share {r['bound_ms'] * 1e3 / r['us_per_call']:.3f})")

    rows = part("c", ("fwht",), lambda: column_lrt_check.main([]))
    for r in rows:
        hold(all(math.isfinite(r[f"{e}_{v}_var"]) for e in ("explicit", "column_lrt")
                 for v in ("loss", "grad")), f"(c) a variance is not finite at D={r['D']}")
        log(f"  (c) D={r['D']:<5} grad_var explicit {r['explicit_grad_var']:.4e} column LRT "
            f"{r['column_lrt_grad_var']:.4e} (reduction {r['grad_var_reduction']:.3f}); loss_var "
            f"{r['explicit_loss_var']:.4e} / {r['column_lrt_loss_var']:.4e} "
            f"(reduction {r['loss_var_reduction']:.3f})")
    last = rows[-1]
    log(f"  (c) at D={last['D']} the column LRT's gradient variance is "
        + ("at most" if last["column_lrt_grad_var"] <= last["explicit_grad_var"] else "above")
        + " the explicit sample's (logged, not held: PERF.md)")

    rows = part("d", (), lambda: diag_matmul.main([]))
    hold(all(r["match_left"] and r["match_right"] for r in rows), "(d) diag_matmul mismatch")

    def kernel_events(path):
        with open(path) as f:
            return [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]

    def fresh_trace():
        # in a fresh process: after phase 11's ranks used the card, this
        # process's profiler loses kernel records (utils.profiling)
        out = subprocess.run(
            [sys.executable, "-c", TRACE_ONE, str(SCALING_D), os.path.join(tmp, "trace")],
            capture_output=True, text=True, timeout=300, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        return json.loads(out.stdout.strip().splitlines()[-1])

    fresh = part("e", (), fresh_trace)  # its launch counts in the fresh process
    names = kernel_events(fresh["path"])
    hold(any("whvi_fused_kernel" in n for n in names),
         "(e) the trace does not name whvi_fused_kernel")
    hold(fresh["launches"].get("fused_y") == 1 and fresh["realigned"] == 0,
         f"(e) the traced call launched {fresh['launches']}, realigned {fresh['realigned']}")
    log(f"  (e) trace of one whvi_mul at D={SCALING_D} in a fresh process: kernel events "
        f"{names}; launches {fresh['launches']}")

    (fan,) = part("f", TOY_FAN_KERNELS, lambda: make_figures.main(
        ["--quick", "--only", "toy_fan", "--out-dir", os.path.join(tmp, "figures")]))
    with open(fan["data"]) as f:
        gap = json.load(f)["gap_sd"]
    log(f"  (f) toy fan, predictive sd in the gap: with KL {gap['with_kl']:.4f}, no KL "
        f"{gap['no_kl']:.4f}")
    hold(gap["with_kl"] > gap["no_kl"], "(f) the with-KL net is not wider in the gap")
    log("  phase 12 parts: " + ", ".join(f"({k}) {v:.1f} s" for k, v in times.items()))
    check(not fails, "phase 12: " + "; ".join(fails))


# ------------------------------------------------------------------ 13. the grouped product


GROUPED_KERNELS = ("fused_grouped_y", "fused_grouped_res", "fused_grouped_bwd_sums")
# the DeepSeek-V2 cell's routed shape: D=2048, 8 experts held x 4 samples,
# 98304 top-6 choices of 16384 (token, sample) rows, 13764 routed here
# unevenly, one segment empty
GROUPED_D, GROUPED_E, GROUPED_P = 2048, 8, 4
GROUPED_COUNTS = (480, 0, 310, 402, 390, 377, 351, 402, *(380 + 7 * i for i in range(24)))
GROUPED_ROWS, GROUPED_CHOICES = 16384, 98304
DSV2_SMOKE = {  # hidden 64, a dense layer and two MoE layers of 4 of 8 experts, top 2
    "hidden_size": 64, "num_hidden_layers": 3, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "intermediate_size": 96, "moe_intermediate_size": 48, "n_routed_experts": 4,
    "first_expert": 0, "published": {"n_routed_experts": 8}, "num_experts_per_tok": 2,
    "n_shared_experts": 1, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "norm_topk_prob": False, "num_attention_heads": 4, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32, "q_lora_rank": None,
    "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "vocab_size": 256, "lambda": 1.0, "s_init": "auto",
}


def _grouped_operands(dev, gen, gather: bool):
    """``(s1, u, s2, x, offsets, index, g)`` at the routed shape; ``x`` the
    hidden rows with ``index`` the choices' rows where ``gather``, else one
    row a choice."""
    D, E, P, M = GROUPED_D, GROUPED_E, GROUPED_P, GROUPED_CHOICES
    offsets = torch.tensor((0, *np.cumsum(GROUPED_COUNTS)), dtype=torch.int64, device=dev)
    s1, s2 = (torch.randn(E, D, device=dev, generator=gen) * D**-0.5 for _ in range(2))
    u = torch.randn(E * P, D, device=dev, generator=gen)
    if gather:
        x = torch.randn(GROUPED_ROWS, D, device=dev, generator=gen)
        index = torch.randint(0, GROUPED_ROWS, (M,), device=dev, generator=gen)
    else:
        x, index = torch.randn(M, D, device=dev, generator=gen), None
    return s1, u, s2, x, offsets, index, torch.randn(M, D, device=dev, generator=gen)


def grouped_vs_plain(fc, dev, seed) -> dict:
    """Phase 13 (a): the grouped K1, K2 and K3 with its sums against their
    plain versions at the routed shape, x gathered and not, in both
    precisions. Returns the max abs errors by counter."""
    from whvi_tpu_torch.ops import grouped as gr

    gen = torch.Generator(device=dev).manual_seed(seed)
    count, abs_errs = sum(GROUPED_COUNTS), {}
    log(f"grouped product vs plain at D={GROUPED_D}, {len(GROUPED_COUNTS)} segments, {count} "
        f"routed rows of {GROUPED_CHOICES} (fp32 forward bit for bit, sums <= {KERNEL_TOL}):")
    for precision in ("fp32", "bf16"):
        suffix = "" if precision == "fp32" else "_bf16"
        for gather in (True, False):
            s1, u, s2, x, offsets, index, g = _grouped_operands(dev, gen, gather)
            host = offsets.cpu()  # the plain loop's bounds
            label = f"{precision} {'gathered' if gather else 'rows'}"
            y1 = gr.grouped_raw(s1, u, s2, x, offsets, index, False, precision)[0]
            res = gr.grouped_raw(s1, u, s2, x, offsets, index, True, precision)
            want = gr.grouped_plain(s1, u, s2, x, host, index, True, precision)
            check(torch.equal(y1, res[0]), f"fused_grouped_y{suffix} ({label}) is not K2's y")
            check(bool(torch.all(res[0][count:] == 0)), f"fused_grouped_res{suffix} ({label}): "
                  "y is not 0 past the routed rows")
            bwd = gr.grouped_bwd_raw(s1, u, s2, x, offsets, index, g, res[1], res[2], precision)
            bwd_ref = gr.grouped_bwd_plain(s1, u, s2, x, host, index, g, res[1], res[2], precision)
            if precision == "fp32" and not gather:
                check(torch.equal(bwd[0], bwd_ref[0]), f"fused_grouped_bwd_sums ({label}): dx is "
                      "not the plain dx bit for bit")
            errs = {}
            # (name, outputs, plain outputs, each output's transforms after its last rounding)
            for name, got, ref, ks in (
                ("fused_grouped_y", (y1,), want[:1], (2,)),
                ("fused_grouped_res", res, want, (2, 1, 2)),
                ("fused_grouped_bwd_sums", bwd, bwd_ref, (2, 2, 1, 2)),
            ):
                pairs = list(zip(got, ref))
                if name != "fused_grouped_bwd_sums":  # the routed rows; the sums another order
                    pairs = [(a[:count], b[:count]) for a, b in pairs]
                    if precision == "fp32":
                        check(all(torch.equal(a, b) for a, b in pairs),
                              f"{name} ({label}) is not the plain version bit for bit")
                errs[name] = 0.0
                for (a, b), k in zip(pairs, ks):
                    err, tol = rel_err(a, b), (KERNEL_TOL if precision == "fp32"
                                               else fc.bf16_tol(GROUPED_D, k))
                    check(err <= tol, f"{name}{suffix} ({label}): {err:.3e} > {tol}")
                    errs[name] = max(errs[name], err)
                abs_errs[name + suffix] = max(abs_errs.get(name + suffix, 0.0),
                                              *((a - b).abs().max().item() for a, b in pairs))
            torch.cuda.synchronize()
            log(f"  {label:<14} " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    return abs_errs


def grouped_times(fc, dev, seed) -> dict:
    """Phase 13 (b): the grouped kernels at the gathered routed shape (gate
    and up's), each beside the plain loop of fused_plain over the segments,
    with its bound: the routed rows' x (and g, i1, i2) read once, y's rows
    all written (0 past the routed rows), i1, i2 and dx at the routed rows
    (dx at x's rows, zeroed), s1 and s2 an expert and u a segment."""
    from whvi_tpu_torch.ops import grouped as gr
    from whvi_tpu_torch.utils.profiling import H100_HBM_GBPS
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    gen = torch.Generator(device=dev).manual_seed(seed)
    s1, u, s2, x, offsets, index, g = _grouped_operands(dev, gen, True)
    host = offsets.cpu()
    D, M, count = GROUPED_D, GROUPED_CHOICES, sum(GROUPED_COUNTS)
    row = 4 * D
    diag = row * (2 * GROUPED_E + len(GROUPED_COUNTS)) + 8 * count  # s1, s2, u; the index

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / (H100_HBM_GBPS * 1e9) * 1e3, ops / PEAK * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    times = {}
    log(f"grouped times at D={D}, {count} routed rows of {M}, x gathered from "
        f"{GROUPED_ROWS} (device ms per call, 20 calls in a CUDA graph, median of 5 replays):")
    for precision in ("fp32", "bf16"):
        _, i1, i2 = gr.grouped_raw(s1, u, s2, x, offsets, index, True, precision)
        for name, kernel, plain, nbytes, ops in (
            ("fused_grouped_y",
             lambda: gr.grouped_raw(s1, u, s2, x, offsets, index, False, precision),
             lambda: gr.grouped_plain(s1, u, s2, x, host, index, False, precision),
             diag + row * (count + M), fused_ops(D, count)),
            ("fused_grouped_res",
             lambda: gr.grouped_raw(s1, u, s2, x, offsets, index, True, precision),
             lambda: gr.grouped_plain(s1, u, s2, x, host, index, True, precision),
             diag + row * (3 * count + M), fused_ops(D, count)),
            ("fused_grouped_bwd_sums",
             lambda: gr.grouped_bwd_raw(s1, u, s2, x, offsets, index, g, i1, i2, precision),
             lambda: gr.grouped_bwd_plain(s1, u, s2, x, host, index, g, i1, i2, precision),
             diag + row * (4 * count + GROUPED_ROWS + 3 * len(GROUPED_COUNTS)),
             fused_ops(D, count) + 6 * D * count),
        ):
            t = _timed(kernel, plain, bound(nbytes, ops))
            key = name if precision == "fp32" else name + "_bf16"
            _log_time(f"{precision} {name.removeprefix('fused_')}", t)
            times[key] = t
    return times


def run_grouped_net_path(fc, dev, seed) -> dict:
    """Phase 13 (c): a small DeepSeek-V2 WHVI net's Trainer.train_step on the
    card against the same step on a CPU copy (the plain versions), in fp32
    and in the bf16 precision, and Trainer.predict in each. Returns the grouped
    kernels' launches there."""
    from whvi_tpu_torch.models.deepseek_v2 import DeepseekV2WHVI
    from whvi_tpu_torch.ops import set_whvi_mul_precision
    from whvi_tpu_torch.ops.kron_cuda import BF16_TOL
    from whvi_tpu_torch.train import TrainConfig, Trainer

    S, B, T, V = 2, 2, 16, DSV2_SMOKE["vocab_size"]
    seq = torch.randint(0, V, (B, T + 1), generator=torch.Generator().manual_seed(seed))
    torch.manual_seed(seed + 1)
    first = DeepseekV2WHVI(DSV2_SMOKE, train_samples=S, eval_samples=S)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # g_mu ~ N(0, 0.5^2): the products carry signal, not only noise
        for name, p in first.named_parameters():
            if name.endswith("g_mu"):
                p.normal_(generator=gen).mul_(0.5)
    start = first.state_dict()
    fc.reset_launches()
    for precision in ("fp32", "bf16"):
        set_whvi_mul_precision(precision)
        try:
            out = {}
            for device in ("cpu", dev):
                net = DeepseekV2WHVI(DSV2_SMOKE, train_samples=S, eval_samples=S)
                trainer = Trainer(net, TrainConfig(lr0=1e-2), device=device)
                state = trainer.init(seed + 2)
                net.load_state_dict(start)
                eps = [e.to(device) for e in
                       net.draw_noise((S, B * T), torch.Generator().manual_seed(seed + 3))]
                x, y = seq[:, :-1].to(device), seq[:, 1:].to(device)
                if device == dev:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    metrics = trainer.train_step(state, x, y, B * T, True, eps=eps)
                finally:
                    if device == dev:
                        torch.cuda.set_sync_debug_mode("default")
                out[str(device)] = ({k: float(metrics[k]) for k in ("loss", "mnll", "kl")},
                                    {k: p.grad.cpu() for k, p in net.named_parameters()})
                if device == dev:  # K1's grouped instance: the expert layer's predictive path
                    logits = trainer.predict(x.float(), torch.Generator(device=dev).manual_seed(seed))
                    check(tuple(logits.shape) == (S, B * T, V)
                          and bool(torch.isfinite(logits).all()),
                          f"dsv2 predict: logits {tuple(logits.shape)} not finite")
            (card, card_grads), (plain, plain_grads) = out[str(dev)], out["cpu"]
            errs = {k: abs(card[k] - plain[k]) / abs(plain[k]) for k in card}
            if precision == "fp32":
                errs["grads"] = max(rel_err(card_grads[k], g) for k, g in plain_grads.items()
                                    if g.abs().max() > 0)
                check(max(errs[k] for k in card) <= SLICE_TOL, f"dsv2 step fp32: {errs}")
                check(errs["grads"] <= SLICE_GRAD_TOL, f"dsv2 step fp32 gradients: {errs}")
            else:
                check(max(errs["loss"], errs["mnll"]) <= BF16_TOL, f"dsv2 step bf16: {errs}")
            log(f"  dsv2 net step {precision} card vs cpu: loss {card['loss']:.6f} "
                f"mnll {card['mnll']:.6f}, "
                + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
        finally:
            set_whvi_mul_precision("fp32")
    launches = {n: fc.LAUNCHES[n] for n in KERNELS if n.startswith("fused_grouped")}
    log(f"  dsv2 net launches: {launches}; K3: "
        + ", ".join(f"{n} {fc.LAUNCHES[n]}" for names in K3_COUNTERS.values() for n in names)
        + f"; realigned: {fc.REALIGNED}")
    for name, n in launches.items():
        check(n > 0, f"the dsv2 net launched no {name}")
    # every map has D <= 8192: each backward takes a reduce mode, the stacked
    # maps its stacked form (they compute fp32 in the bf16 precision too)
    check(fc.LAUNCHES["fused_bwd"] == fc.LAUNCHES["fused_bwd_bf16"] == 0,
          "the dsv2 net launched K3 with PyTorch's sums")
    check(fc.LAUNCHES["fused_bwd_sums_stacked"] > 0, "the dsv2 net launched no stacked reduce mode")
    return {**launches, STACKED_KERNEL: fc.LAUNCHES[STACKED_KERNEL]}


def run_grouped_path(fc, dev, seed) -> tuple[dict, dict, dict]:
    """Phase 13: ``(max_abs, times, launches)`` of the grouped kernels."""
    max_abs = grouped_vs_plain(fc, dev, seed)
    times = grouped_times(fc, dev, seed)
    return max_abs, times, run_grouped_net_path(fc, dev, seed)


# ------------------------------------------------------------------ 14. the stacked reduce mode


STACKED_KERNEL = "fused_bwd_sums_stacked"  # fp32 only: no bf16 product has (stack, D) diagonals
# the DeepSeek-V2 cell's stacked maps, (D, stack): u one of STACKED_S samples
# (S, 1, stack, D), x (S, N, 1, D) broadcast over the stack axis
STACKED_MAPS = {
    "q_proj": (2048, 2), "kv_a_proj_with_mqa": (2048, 1), "kv_b_proj": (512, 8),
    "shared_down": (4096, 1), "dense_gate_up": (2048, 6), "lm_head": (2048, 7),
}
STACKED_S, STACKED_N, STACKED_CELL_N = 4, 256, 4096
STACKED_TIMED = ("lm_head", "q_proj", "kv_b_proj")  # at the cell's N; lm_head's in the JSON


def _stacked_operands(fc, dev, gen, D, stack, N):
    """``(s1, u, s2, x, g, i1, i2)`` of a stacked map's backward at N rows a sample."""
    s1, s2 = (torch.randn(stack, D, device=dev, generator=gen) * D**-0.5 for _ in range(2))
    u = torch.randn(STACKED_S, 1, stack, D, device=dev, generator=gen)
    x = torch.randn(STACKED_S, N, 1, D, device=dev, generator=gen)
    _, i1, i2 = fc.fused_raw(s1, u, s2, x, True)
    return s1, u, s2, x, torch.randn(i1.shape, device=dev, generator=gen), i1, i2


def check_stacked(fc, name, ops) -> float:
    """The stacked form at one map's operands against its plain version:
    taken by the stacked rule (and refused in the bf16 precision), one
    launch a call, dx equal to K3's bit for bit, ds1, du and ds2 within
    KERNEL_TOL, two launches and the launch without dx bit for bit. Logs the
    errors and returns the largest absolute one."""
    s1, u, s2, x, g, i1, i2 = ops
    D, stack, N = x.shape[-1], s1.shape[0], x.shape[1]
    where = f"{STACKED_KERNEL} at {name} N={N}"
    check(fc.sums_group(s1, u, s2, x) is None and fc.sums_stacked(s1, u, s2, x) == (N, stack)
          and fc._reduce_mode(s1, u, s2, x, "bf16") is None,
          f"{name}: the stacked rule does not take ({stack}, {D}) at N={N} in fp32 alone")
    fc.reset_launches()
    got = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
    again = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, True)
    no_dx = fc.fused_bwd_sums_raw(s1, u, s2, x, g, i1, i2, False)
    check(fc.LAUNCHES[STACKED_KERNEL] == 3 and sum(fc.LAUNCHES.values()) == 3,
          f"{where}: launches {fc.LAUNCHES}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{where}: two launches differ")
    check(no_dx[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], no_dx[1:])),
          f"{where}: the sums without dx differ")
    del again, no_dx
    check(torch.equal(got[0], fc.fused_bwd_raw(s1, u, s2, g)[0]), f"{where}: dx is not K3's")
    want = fc.fused_bwd_sums_plain(s1, u, s2, x, g, i1, i2, True)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    for what, err in zip(("dx", "ds1", "du", "ds2"), errs):
        check(err <= KERNEL_TOL, f"{where}: {what} {err:.3e} > {KERNEL_TOL}")
    log(f"  {name:<20} ({stack},{D}) N={N:<5} dx={errs[0]:.2e} ds1={errs[1]:.2e} "
        f"du={errs[2]:.2e} ds2={errs[3]:.2e}")
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def stacked_vs_plain(fc, dev, seed) -> dict:
    """Phase 14 (a): the stacked form against its plain version
    (:func:`check_stacked`) at each stacked map's shape, N = 256. Returns
    the max abs error by counter."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"stacked reduce mode vs plain at u ({STACKED_S},1,stack,D), x ({STACKED_S},N,1,D) "
        f"(sums <= {KERNEL_TOL}; dx K3's bit for bit):")
    return {STACKED_KERNEL: max(
        check_stacked(fc, name, _stacked_operands(fc, dev, gen, D, stack, STACKED_N))
        for name, (D, stack) in STACKED_MAPS.items()
    )}


def stacked_times(fc, dev, seed, report: str | None) -> tuple[dict, dict]:
    """Phase 14 (b): the stacked form at the cell's N = 4096 for lm_head,
    q_proj and kv_b_proj, each checked against its plain version there
    (:func:`check_stacked`), then timed, dx stored, beside its bound, the
    plain version and K3 with PyTorch's reductions; (c) ptxas's registers
    and spills of its instances at those widths (``report``: nvcc's, None
    to skip). Returns the max abs error and the kernels line's times
    (lm_head's), by counter."""
    from whvi_tpu_torch.bench.common import bound_ms, time_us
    from whvi_tpu_torch.bench.kernel_sass import _instance, ptxas
    from whvi_tpu_torch.utils.profiling import H100_PEAK_FP32_FLOPS as PEAK

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    abs_err, times = 0.0, {}
    log(f"stacked reduce mode at u ({STACKED_S},1,stack,D), x ({STACKED_S},{STACKED_CELL_N},1,D): "
        "checked as above, then timed, dx stored (device ms per call, 20 calls in a CUDA graph, "
        "median of 5 replays; K3 + PyTorch: K3 then _input_grads and dx's stack sum):")
    for name in STACKED_TIMED:
        D, stack = STACKED_MAPS[name]
        ops = _stacked_operands(fc, dev, gen, D, stack, STACKED_CELL_N)
        abs_err = max(abs_err, check_stacked(fc, name, ops))
        torch.cuda.empty_cache()
        s1, u, s2, x, g, i1, i2 = ops
        rows = g.numel() // D

        def old(a=ops):
            dx, w1, t2 = fc.fused_bwd_raw(*a[:3], a[4])
            return fc._input_grads((True,) * 4, *a, dx, w1, t2)

        t = _timed(lambda: fc.fused_bwd_sums_raw(*ops, True),
                   lambda: fc.fused_bwd_sums_plain(*ops, True),
                   bound_ms((g, i1, i2, x, u, s1, s2), (g,),
                            fused_ops(D, rows) + 6 * D * rows, PEAK))
        t["k3_torch_ms"] = time_us(old, 20) / 1e3
        _log_time(name, t)
        log(f"  {'':<18} K3 + PyTorch {t['k3_torch_ms']:.4f} "
            f"({t['k3_torch_ms'] / t['ms']:.2f}x the stacked form)")
        if name == "lm_head":
            times[STACKED_KERNEL] = t
        del ops, s1, u, s2, x, g, i1, i2, old
        torch.cuda.empty_cache()
    if report is not None:
        widths = {int(math.log2(D)) for D, _ in (STACKED_MAPS[n] for n in STACKED_TIMED)}
        for symbol, row in sorted(ptxas(report).items()):
            inst = _instance(symbol)
            if inst and inst["kernel"] == "whvi_bwd_sums" and inst["L"] in widths:
                log(f"  ptxas {'stacked' if inst.get('stacked') else 'square '} L={inst['L']} "
                    f"bf16={int(inst['bf16'])}: {row.get('registers')} registers, "
                    f"{row.get('spill_stores')} B spill stores, {row.get('spill_loads')} B loads")
    return {STACKED_KERNEL: abs_err}, times


def run_stacked_path(fc, dev, seed, report: str | None) -> tuple[dict, dict]:
    """Phase 14: ``(max_abs, times)`` of the stacked reduce mode."""
    max_abs = stacked_vs_plain(fc, dev, seed)
    at_cell, times = stacked_times(fc, dev, seed, report)
    return {STACKED_KERNEL: max(max_abs[STACKED_KERNEL], at_cell[STACKED_KERNEL])}, times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    smi = probe()
    from whvi_tpu_torch.ops import fwht_cuda as fc
    from whvi_tpu_torch.ops import kron_cuda as kc

    dev = torch.device("cuda", 0)
    report = build(fc)
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
    launches.update({name: scaling[name] for name in (*BF16_KERNELS, "fused_bwd_sums_bf16")})
    run_mnist_path(fc, dev, args.seed)
    run_hetero_path(fc, dev, args.seed)
    run_family_entry_points(fc, args.seed)
    replica_shapes_vs_plain(fc, dev, args.seed)
    protocol_step(fc, dev, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        protocol_out = run_protocol_path(fc, dev, args.seed, tmp)
        run_grid_path(fc, dev, args.seed)
        run_protocol_entry_points(fc, args.seed, tmp)
    t9 = time.perf_counter()
    log("phase 9: the golden samplers")
    posteriors = sampler_posteriors(args.seed)
    log_posterior_vs_cpu(fc, dev, args.seed, posteriors)
    draws_vs_cpu(dev, args.seed, posteriors)
    nuts_s4 = run_sampler_path(fc, dev, args.seed, posteriors)
    run_analytic_path(dev, args.seed)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s; the smoke so far: "
        f"{time.perf_counter() - t_start:.1f} s")
    t10 = time.perf_counter()
    log("phase 10: bf16 storage through K1-K4")
    max_abs.update(bf16s_vs_plain(fc, dev, args.seed))
    max_abs.update(column_vs_plain(fc, dev, args.seed))
    t_a = time.perf_counter()
    bf16s = run_bf16s_path(fc, dev, args.seed)
    launches.update({name: bf16s[name] for name in BF16S_KERNELS})
    t_b = time.perf_counter()
    bf16s_net_vs_cpu(fc, dev, args.seed)
    t_c = time.perf_counter()
    times.update(bf16s_times(fc, dev, args.seed))
    times.update(column_times(fc, dev, args.seed))
    t_d = time.perf_counter()
    launches["fwht_bf16s"] = run_fwht_sweep(fc)["fwht_bf16s"]
    t_e = time.perf_counter()
    log(f"phase 10: {t_e - t10:.1f} s ((a) {t_a - t10:.1f}, (b) {t_b - t_a:.1f}, (c) "
        f"{t_c - t_b:.1f}, (d) {t_d - t_c:.1f}, fwht_sweep {t_e - t_d:.1f}); the smoke: "
        f"{t_e - t_start:.1f} s")
    log("phase 11: the mesh (whvi_tpu_torch/parallel/)")
    run_mesh_path(fc, dev, args.seed, protocol_out, nuts_s4)
    t_f = time.perf_counter()
    log(f"phase 11: {t_f - t_e:.1f} s; the smoke: {t_f - t_start:.1f} s")
    log("phase 12: the checks and figures")
    with tempfile.TemporaryDirectory() as tmp:
        run_checks_path(fc, dev, args.seed, tmp)
    t_g = time.perf_counter()
    log(f"phase 12: {t_g - t_f:.1f} s; the smoke: {t_g - t_start:.1f} s")
    log("phase 13: the grouped product (the expert layer's)")
    grouped = run_grouped_path(fc, dev, args.seed)
    for part, found in zip((max_abs, times, launches), grouped):
        part.update(found)
    t_h = time.perf_counter()
    log(f"phase 13: {t_h - t_g:.1f} s; the smoke: {t_h - t_start:.1f} s")
    log("phase 14: the stacked reduce mode (the language model's stacked maps)")
    for part, found in zip((max_abs, times), run_stacked_path(fc, dev, args.seed, report)):
        part.update(found)
    t_i = time.perf_counter()
    log(f"phase 14: {t_i - t_h:.1f} s; the smoke: {t_i - t_start:.1f} s")

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
