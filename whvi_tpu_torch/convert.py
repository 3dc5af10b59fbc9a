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
and shapes, so the conversion is a copy per leaf. A replicated net
(:func:`whvi_tpu_torch.models.networks.stack_replicas`) takes the JAX
package's stacked parameters, each leaf with the leading replica axis of
its ``vmap_splits`` trainer.

:func:`load_jax_checkpoint` reads a JAX ``ckpt-*.npz``
(``whvi_tpu/train/checkpoint.py``): its ``leaf_{i}`` arrays are the
leaves of the JAX ``TrainState(params, opt_state, key, step)`` in JAX's
flatten order, which is rebuilt here without JAX (dict keys sorted,
tuples in order): the parameters, then optax's ``scale_by_adam`` count,
first and second moments and the schedule's count, then the PRNG key and
the step.

bf16 leaves (the JAX package's ``dtype=bfloat16``). ``np.asarray`` of a
JAX bf16 array has ``ml_dtypes``' bfloat16 dtype (kind ``V``, 2 bytes),
and a JAX checkpoint stores it as raw 2-byte ``|V2``; ``torch.from_numpy``
takes neither, so such a leaf comes in through its bits, viewed as int16
and then as ``torch.bfloat16`` (exact). Going out, numpy has no bf16 of
its own: :func:`export_params` gives a bf16 parameter as a float32 array
of the same values (exact), which ``jnp.asarray(a, jnp.bfloat16)`` takes
back without a rounding. :func:`load_jax_adam` and :func:`export_adam`
carry optax's ``decayed_adam`` state (moments in the parameters' dtype)
the same ways.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from whvi_tpu_torch.models.layers import Dense, Parallel, WHVILinear
from whvi_tpu_torch.train.checkpoint import flatten, to_tensor, unflatten

__all__ = [
    "export_adam",
    "export_params",
    "host_array",
    "load_jax_adam",
    "load_jax_checkpoint",
    "load_jax_params",
    "param_tree",
]

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


def host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; bf16 (which numpy lacks) as float32, exact."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


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
        src = to_tensor(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: JAX shape {tuple(src.shape)}, port shape {tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))


@torch.no_grad()
def load_jax_params(net, params) -> None:
    """Copy the JAX parameter pytree ``params`` into ``net`` in place;
    raises on any key, length or shape that differs."""
    _copy_tree(param_tree(net), params, "params")


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host_tree(v) for v in tree)
    return host_array(tree)


def export_params(net) -> dict:
    """The inverse of :func:`load_jax_params`: the JAX pytree of numpy
    arrays for ``net``'s current parameters (bf16 ones as float32)."""
    return _host_tree(param_tree(net))


def _moment_tree(net, optimizer, key: str):
    """Adam's ``key`` moment of each parameter in the JAX pytree's layout
    (zeros before the first step)."""
    state = optimizer.state

    def moment(p):
        return state[p][key] if key in state.get(p, {}) else torch.zeros_like(p)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(walk(v) for v in tree)
        return moment(tree)

    return walk(param_tree(net))


def export_adam(net, optimizer, scheduler) -> tuple:
    """optax's ``decayed_adam`` state for ``net`` under the port's
    ``(optimizer, scheduler)`` (:func:`whvi_tpu_torch.train.decayed_adam`)
    as numpy: ``((count, mu, nu), (count,))``, the leaves of
    ``(ScaleByAdamState, ScaleByScheduleState)``, ``mu`` and ``nu`` in the
    parameter pytree's layout (bf16 moments as float32)."""
    params = list(net.parameters())
    steps = {int(optimizer.state[p]["step"]) for p in params if p in optimizer.state}
    count = np.int32(steps.pop() if steps else 0)
    return (
        (count, _host_tree(_moment_tree(net, optimizer, "exp_avg")),
         _host_tree(_moment_tree(net, optimizer, "exp_avg_sq"))),
        (np.int32(scheduler.last_epoch),),
    )


@torch.no_grad()
def load_jax_adam(net, optimizer, scheduler, opt_state) -> None:
    """Set the port's Adam and schedule from optax's ``decayed_adam`` state
    ``opt_state`` (``((count, mu, nu), (count,))``, or the NamedTuples
    themselves): the moments in each parameter's dtype, the step count of
    every parameter, and the LambdaLR at the schedule's count with the
    learning rate it sets there."""
    (count, mu, nu), (sched_count,) = opt_state
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        dst = _moment_tree(net, optimizer, key)
        _copy_tree(dst, tree, f"opt_state.{key}")
        for p, m in zip(flatten(param_tree(net)), flatten(dst)):
            optimizer.state[p][key] = m
    for p in net.parameters():
        optimizer.state[p]["step"] = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    epoch = int(np.asarray(sched_count))
    for group, base, lam in zip(optimizer.param_groups, scheduler.base_lrs, scheduler.lr_lambdas):
        group["lr"] = base * lam(epoch)  # what LambdaLR.step sets there
    scheduler.last_epoch = epoch
    scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]


def load_jax_checkpoint(net, path: str) -> dict:
    """Load the parameters of the JAX checkpoint ``path`` (a
    ``save_checkpoint`` of a ``TrainState``, stacked or not) into ``net``
    through :func:`load_jax_params`; returns the checkpoint's metadata
    with ``step`` added (the JAX step counter, per replica when stacked).
    Raises unless the file holds exactly the leaves of a ``TrainState`` of
    ``net``'s parameters under the JAX package's ``decayed_adam`` (``3 P +
    4`` for ``P`` parameter leaves) and each parameter leaf has the port's
    shape."""
    template = param_tree(net)
    n_params = len(flatten(template))
    with np.load(path) as data:
        n_saved = len(data.files)
        if n_saved != 3 * n_params + 4:
            raise ValueError(
                f"checkpoint {path} holds {n_saved} leaves, not the {3 * n_params + 4} "
                f"of a TrainState of this net's {n_params} parameter leaves"
            )
        leaves = [data[f"leaf_{i}"] for i in range(n_saved)]
    load_jax_params(net, unflatten(template, leaves[:n_params]))
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    step = leaves[-1]
    meta["step"] = step.tolist()
    return meta
