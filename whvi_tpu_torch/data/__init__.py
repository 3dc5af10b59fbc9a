from whvi_tpu_torch.data.mnist import (
    load_digits_classification,
    load_mnist,
    load_sklearn_classification,
    mnist_available,
    synthetic_classification,
)
from whvi_tpu_torch.data.toy import cubic_data, polynomial_data
from whvi_tpu_torch.data.uci import UCI_DATASETS, dataset_info, load_uci

__all__ = [
    "UCI_DATASETS",
    "cubic_data",
    "dataset_info",
    "load_digits_classification",
    "load_mnist",
    "load_sklearn_classification",
    "load_uci",
    "mnist_available",
    "polynomial_data",
    "synthetic_classification",
]
