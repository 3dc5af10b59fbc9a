from whvi_tpu_torch.ops.fwht_cuda import (
    LAUNCHES,
    FwhtFunction,
    WhviMulFunction,
    reset_launches,
)
from whvi_tpu_torch.ops.hadamard import (
    build_H,
    build_H_rows,
    fwht,
    is_pow_of_2,
    kl_diag_normal,
    next_pow_of_2,
)
from whvi_tpu_torch.ops.whvi_op import (
    whvi_dense,
    whvi_mul,
    whvi_mul_dense_oracle,
)

__all__ = [
    "FwhtFunction",
    "LAUNCHES",
    "WhviMulFunction",
    "build_H",
    "build_H_rows",
    "fwht",
    "is_pow_of_2",
    "kl_diag_normal",
    "next_pow_of_2",
    "reset_launches",
    "whvi_dense",
    "whvi_mul",
    "whvi_mul_dense_oracle",
]
