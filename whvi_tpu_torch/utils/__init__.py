from whvi_tpu_torch.utils.metrics import JsonlLogger, Throughput
from whvi_tpu_torch.utils.profiling import (
    H100_HBM_GBPS,
    H100_PEAK_BF16_FLOPS,
    H100_PEAK_TF32_FLOPS,
    card,
    cuda_ms,
    device_profile,
    elbo_step_flops,
    fwht_flops,
    net_train_step_flops,
    require_cuda,
    whvi_layer_fwd_flops,
    whvi_layer_train_flops,
    whvi_mul_flops,
)

__all__ = [
    "H100_HBM_GBPS",
    "H100_PEAK_BF16_FLOPS",
    "H100_PEAK_TF32_FLOPS",
    "JsonlLogger",
    "Throughput",
    "card",
    "cuda_ms",
    "device_profile",
    "elbo_step_flops",
    "fwht_flops",
    "net_train_step_flops",
    "require_cuda",
    "whvi_layer_fwd_flops",
    "whvi_layer_train_flops",
    "whvi_mul_flops",
]
