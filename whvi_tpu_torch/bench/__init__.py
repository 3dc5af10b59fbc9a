"""Kernel benchmarks of the port on one NVIDIA H100, each a module run as
``python -m whvi_tpu_torch.bench.<name>``:

- :mod:`~whvi_tpu_torch.bench.kernel_diag`: where the fused product's
  time goes at large D, a stage at a time (``benchmarks/pallas_diag.py``);
- :mod:`~whvi_tpu_torch.bench.kernel_tune`: the product's layouts and row
  tiles (``benchmarks/pallas_tune.py``);
- :mod:`~whvi_tpu_torch.bench.kernel_check`: the fused fp32 kernel (K1)
  against the plain paths, its bytes/s and flop rate
  (``benchmarks/tpu_kernel_check.py``);
- :mod:`~whvi_tpu_torch.bench.fwht_sweep`: the bare FWHT (K4) against
  the dense ``x @ H_D`` across D, fp32 and bf16 storage, and their
  crossover (``benchmarks/fwht_sweep.py``);
- :mod:`~whvi_tpu_torch.bench.toy_bench`: the toy protocol's training
  epochs/s, eager (``bench.py``);
- :mod:`~whvi_tpu_torch.bench.protocol_bench`: the UCI protocol's wall
  clock, replica-stacked against sequential, and the device's busy share
  in a profiled train step of each;
- :mod:`~whvi_tpu_torch.bench.precision_check`: K1's error against
  float64 and its time in each precision and storage, and whether the
  default precision is fp32 (``benchmarks/precision_check.py``,
  ``auto_dispatch_check.py``);
- :mod:`~whvi_tpu_torch.bench.diag_matmul`: a diagonal product, dense
  against broadcast (``benchmarks/diag_matmul.py``);
- :mod:`~whvi_tpu_torch.bench.grad_check`,
  :mod:`~whvi_tpu_torch.bench.column_lrt_check`: the transforms' and the
  kernels' gradients, and the column LRT's estimator variance
  (``benchmarks/grad_check.py``, ``column_lrt_check.py``; ``--cpu`` asks
  for the CPU);
- :mod:`~whvi_tpu_torch.bench.make_figures`: the report's figures, their
  data as JSON (``benchmarks/make_figures.py``; ``--cpu`` too).

Each prints one JSON object a line, the first naming the card and its
power limit, and raises without a CUDA device unless it takes ``--cpu``
and is given it: a time never falls back to the CPU.
"""
