from whvi_tpu_torch.models.layers import (
    Activation,
    Dense,
    Parallel,
    WHVILinear,
    cosine,
    relu,
    sigmoid,
    tanh,
)
from whvi_tpu_torch.models.likelihoods import (
    CategoricalLikelihood,
    GaussianLikelihood,
    HeteroscedasticGaussianLikelihood,
)
from whvi_tpu_torch.models.networks import (
    WHVIClassification,
    WHVINetwork,
    WHVIRegression,
    mlp_layers,
)
from whvi_tpu_torch.models.weights import (
    ColumnMatrix,
    PaddedSquareMatrix,
    SquarePow2Matrix,
    StackedMatrix,
    setup_dimensions,
)

__all__ = [
    "Activation",
    "CategoricalLikelihood",
    "ColumnMatrix",
    "Dense",
    "GaussianLikelihood",
    "HeteroscedasticGaussianLikelihood",
    "PaddedSquareMatrix",
    "Parallel",
    "SquarePow2Matrix",
    "StackedMatrix",
    "WHVIClassification",
    "WHVILinear",
    "WHVINetwork",
    "WHVIRegression",
    "cosine",
    "mlp_layers",
    "relu",
    "setup_dimensions",
    "sigmoid",
    "tanh",
]
