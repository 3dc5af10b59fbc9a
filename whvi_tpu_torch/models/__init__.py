from whvi_tpu_torch.models.layers import Activation, WHVILinear, relu
from whvi_tpu_torch.models.likelihoods import GaussianLikelihood
from whvi_tpu_torch.models.networks import WHVINetwork, WHVIRegression, mlp_layers
from whvi_tpu_torch.models.weights import (
    ColumnMatrix,
    SquarePow2Matrix,
    StackedMatrix,
    setup_dimensions,
)

__all__ = [
    "Activation",
    "ColumnMatrix",
    "GaussianLikelihood",
    "SquarePow2Matrix",
    "StackedMatrix",
    "WHVILinear",
    "WHVINetwork",
    "WHVIRegression",
    "mlp_layers",
    "relu",
    "setup_dimensions",
]
