"""Parameters of the JAX package in and out of the port's modules.

The JAX network's parameters are the pytree ``{"layers": (p0, p1, ...),
"likelihood": {...}}`` (``whvi_tpu/models/networks.py:51-58``), one
entry per layer:

- ``{}`` for an activation;
- ``{"s1", "s2", "g_mu", "g_rho"[, "bias"]}`` for a WHVI layer, whatever
  its matrix (the stacked matrix's ``stack`` axis leading);
- ``{"w"[, "b"]}`` for ``Dense``;
- ``{"branches": (...)}`` for ``Parallel``, one such entry per branch;

and ``{"rho"}`` or ``{}`` for the likelihood. Leaves are numpy arrays
(``np.asarray`` of a JAX array). The port's modules keep the same names
and shapes, so the conversion is a copy per leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from whvi_tpu_torch.models.layers import Dense, Parallel, WHVILinear

__all__ = ["export_params", "load_jax_params", "param_tree"]

_MATRIX_KEYS = ("s1", "s2", "g_mu", "g_rho")


def _layer_params(layer):
    if isinstance(layer, WHVILinear):
        params = {k: getattr(layer.matrix, k) for k in _MATRIX_KEYS}
        if layer.bias is not None:
            params["bias"] = layer.bias
        return params
    if isinstance(layer, Dense):
        return {"w": layer.w} if layer.b is None else {"w": layer.w, "b": layer.b}
    if isinstance(layer, Parallel):
        return {"branches": tuple(_layer_params(b) for b in layer.branches)}
    return {}


def param_tree(net) -> dict:
    """``net``'s parameter tensors in the JAX pytree's layout."""
    return {
        "layers": tuple(_layer_params(layer) for layer in net.layers),
        "likelihood": dict(net.likelihood.named_parameters()),
    }


def _copy_tree(dst, src, path: str) -> None:
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            keys = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path}: JAX keys {keys}, port keys {sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}.{k}")
    elif isinstance(dst, tuple):
        if not isinstance(src, (tuple, list)) or len(src) != len(dst):
            raise ValueError(f"{path}: JAX {type(src).__name__} for {len(dst)} entries")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_tree(d, s, f"{path}[{i}]")
    else:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: JAX shape {src.shape}, port shape {tuple(dst.shape)}")
        dst.copy_(torch.tensor(src, dtype=dst.dtype))


@torch.no_grad()
def load_jax_params(net, params) -> None:
    """Copy the JAX parameter pytree ``params`` into ``net`` in place;
    raises on any key, length or shape that differs."""
    _copy_tree(param_tree(net), params, "params")


def export_params(net) -> dict:
    """The inverse of :func:`load_jax_params`: the JAX pytree of numpy
    arrays for ``net``'s current parameters."""

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(host(v) for v in tree)
        return tree.detach().cpu().numpy().copy()

    return host(param_tree(net))
