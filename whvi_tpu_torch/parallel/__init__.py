"""Meshes over ``torch.distributed``: the ``(data, sample)`` MC-ELBO,
sharded predict and train step, and the replica-split mesh (counterpart
of :mod:`whvi_tpu.parallel`; ``is_multi_host`` is ``is_distributed``
here, a rank being a process, not a host)."""

from whvi_tpu_torch.parallel.distributed import init_distributed, is_distributed
from whvi_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_predict,
    make_sharded_train_step,
    sharded_loss_fn,
)

__all__ = [
    "init_distributed",
    "is_distributed",
    "make_mesh",
    "make_sharded_predict",
    "make_sharded_train_step",
    "sharded_loss_fn",
]
