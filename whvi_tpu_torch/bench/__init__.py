"""Kernel benchmarks of the port on one NVIDIA H100, each a module run as
``python -m whvi_tpu_torch.bench.<name>``:

- :mod:`~whvi_tpu_torch.bench.kernel_diag`: where the fused product's
  time goes at large D, a stage at a time (``benchmarks/pallas_diag.py``);
- :mod:`~whvi_tpu_torch.bench.kernel_tune`: the product's layouts and row
  tiles (``benchmarks/pallas_tune.py``);
- :mod:`~whvi_tpu_torch.bench.kernel_check`: the fused fp32 kernel (K1)
  against the plain paths, its bytes/s and flop rate
  (``benchmarks/tpu_kernel_check.py``);
- :mod:`~whvi_tpu_torch.bench.toy_bench`: the toy protocol's training
  epochs/s, eager (``bench.py``).

Each prints one JSON object a line, the first naming the card and its
power limit, and raises without a CUDA device: there is no CPU fallback.
"""
