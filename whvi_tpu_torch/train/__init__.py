from whvi_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from whvi_tpu_torch.train.optim import (
    OptaxAdam,
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
    hyper_schedule,
)

__all__ = [
    "OptaxAdam",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "batch_layout",
    "decay_schedule",
    "decayed_adam",
    "hyper_schedule",
    "latest_checkpoint",
    "mask_likelihood_grads",
    "mask_noise_branch_grads",
    "restore_checkpoint",
    "save_checkpoint",
    "validate_split_head",
]
