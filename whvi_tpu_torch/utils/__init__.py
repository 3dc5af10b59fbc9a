from whvi_tpu_torch.utils.profiling import (
    H100_HBM_GBPS,
    H100_PEAK_BF16_FLOPS,
    H100_PEAK_TF32_FLOPS,
    card,
    cuda_ms,
    fwht_flops,
    require_cuda,
    whvi_mul_flops,
)

__all__ = [
    "H100_HBM_GBPS",
    "H100_PEAK_BF16_FLOPS",
    "H100_PEAK_TF32_FLOPS",
    "card",
    "cuda_ms",
    "fwht_flops",
    "require_cuda",
    "whvi_mul_flops",
]
