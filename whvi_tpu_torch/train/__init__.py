from whvi_tpu_torch.train.optim import (
    decay_schedule,
    decayed_adam,
    mask_likelihood_grads,
    mask_noise_branch_grads,
    validate_split_head,
)
from whvi_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainState,
    batch_layout,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "Trainer",
    "batch_layout",
    "decay_schedule",
    "decayed_adam",
    "mask_likelihood_grads",
    "mask_noise_branch_grads",
    "validate_split_head",
]
