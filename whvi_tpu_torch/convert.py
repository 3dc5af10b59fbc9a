"""Parameters of the JAX package in and out of the port's modules.

The JAX network's parameters are the pytree ``{"layers": (p0, p1, ...),
"likelihood": {"rho": ...}}`` (``whvi_tpu/models/networks.py:51-58``):
one dict per layer, ``{}`` for an activation, ``{"s1", "s2", "g_mu",
"g_rho"[, "bias"]}`` for a WHVI layer, with the stacked matrix's
``stack`` axis leading. Leaves are numpy arrays (``np.asarray`` of a JAX
array). The port's modules keep the same names and shapes, so the
conversion is a copy per leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from whvi_tpu_torch.models.layers import WHVILinear

__all__ = ["load_jax_params", "export_params"]

_MATRIX_KEYS = ("s1", "s2", "g_mu", "g_rho")


def _layer_params(layer) -> dict:
    if not isinstance(layer, WHVILinear):
        return {}
    params = {k: getattr(layer.matrix, k) for k in _MATRIX_KEYS}
    if layer.bias is not None:
        params["bias"] = layer.bias
    return params


@torch.no_grad()
def load_jax_params(net, params) -> None:
    """Copy the JAX parameter pytree ``params`` into ``net`` in place."""
    if len(params["layers"]) != len(net.layers):
        raise ValueError(
            f"{len(params['layers'])} JAX layers for a net of {len(net.layers)}"
        )
    for layer, src in zip(net.layers, params["layers"]):
        dst = _layer_params(layer)
        if set(src) != set(dst):
            raise ValueError(
                f"{type(layer).__name__}: JAX keys {sorted(src)}, "
                f"port keys {sorted(dst)}"
            )
        for name, tensor in dst.items():
            _copy(tensor, src[name], name)
    _copy(net.likelihood.rho, params["likelihood"]["rho"], "rho")


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"{name}: JAX shape {src.shape}, port shape {tuple(dst.shape)}"
        )
    dst.copy_(torch.tensor(src, dtype=dst.dtype))


def export_params(net) -> dict:
    """The inverse of :func:`load_jax_params`: the JAX pytree of numpy
    arrays for ``net``'s current parameters."""

    def host(t):
        return t.detach().cpu().numpy().copy()

    return {
        "layers": tuple(
            {k: host(v) for k, v in _layer_params(layer).items()}
            for layer in net.layers
        ),
        "likelihood": {"rho": host(net.likelihood.rho)},
    }
