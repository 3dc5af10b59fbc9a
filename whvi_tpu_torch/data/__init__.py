from whvi_tpu_torch.data.mnist import (
    load_mnist,
    mnist_available,
    synthetic_classification,
)
from whvi_tpu_torch.data.toy import cubic_data, polynomial_data

__all__ = [
    "cubic_data",
    "load_mnist",
    "mnist_available",
    "polynomial_data",
    "synthetic_classification",
]
