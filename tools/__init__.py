"""Design tools for the CUDA kernels of whvi_tpu_torch, run from the repository root."""
