"""Checkpoint and resume of a training state (PyTorch).

Counterpart of :mod:`whvi_tpu.train.checkpoint`, with its file layout: a
state is a tree (dicts, tuples and lists) of tensors, numpy arrays and
scalars, flattened in the JAX package's order (dict keys sorted, tuples
and lists in order) into ``leaf_{i}`` arrays of one
``numpy.savez_compressed`` file ``ckpt-{epoch}.npz``, with a ``.meta.json``
sidecar holding the metadata and the leaf count. The ``.npz`` is written
to a ``.tmp`` file and renamed, so an interrupted save never leaves a
half-written latest checkpoint. No pickle: restore reads arrays only, and
rebuilds the tree from a template of the same structure, refusing a
checkpoint whose leaf count or any leaf's shape differs from it.

A bf16 tensor is saved as the JAX package saves a bf16 array: its raw 2
bytes an element (numpy ``|V2``), read back through its bits
(:func:`to_tensor`), so a bf16 state resumes bit for bit.

What a trainer puts in the tree is the trainer's business
(:meth:`whvi_tpu_torch.train.Trainer.state_tree`).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

__all__ = [
    "flatten", "latest_checkpoint", "restore_checkpoint", "save_checkpoint", "to_tensor",
    "unflatten",
]


def flatten(tree: Any) -> list:
    """The leaves of ``tree`` in the JAX package's flatten order: dict keys
    sorted, tuples and lists in order; None is no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    if tree is None:
        return []
    return [tree]


def unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with its leaves replaced, in :func:`flatten`
    order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def to_tensor(a) -> torch.Tensor:
    """A CPU tensor of the numpy array (or array-like) ``a``: a 2-byte
    void array (``ml_dtypes``' bfloat16, or a checkpoint's ``|V2``) through
    its bits as ``torch.bfloat16``, anything else as ``torch.tensor``."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.tensor(a)


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bf16: its bits, as JAX saves it
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, metadata: dict | None = None) -> str:
    """Write the tree ``state`` to ``path`` (``.npz``) atomically and its
    JSON-able ``metadata`` plus the leaf count to ``path + '.meta.json'``."""
    leaves = flatten(state)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
    meta = dict(metadata or {})
    meta["n_leaves"] = len(leaves)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def _like(got: np.ndarray, want):
    """``got`` as ``want``'s kind: a tensor of its dtype on its device, or
    a numpy array of its dtype."""
    if torch.is_tensor(want):
        return to_tensor(got).to(dtype=want.dtype, device=want.device)
    return np.asarray(got, dtype=np.asarray(want).dtype)


def restore_checkpoint(path: str, template: Any) -> tuple[Any, dict]:
    """``(state, metadata)`` from a checkpoint of :func:`save_checkpoint`,
    with ``template``'s structure and each leaf of its template leaf's
    dtype (and device, for tensors). Raises if the checkpoint's leaf count
    or a leaf's shape differs from the template's."""
    want = flatten(template)
    with np.load(path) as data:
        n_saved = len(data.files)
        if n_saved != len(want):
            raise ValueError(
                f"checkpoint {path} holds {n_saved} leaves but the "
                f"current model/optimizer state has {len(want)} — "
                "the architecture or config changed since it was saved; "
                "use a fresh checkpoint dir (or resume=False)"
            )
        got = [data[f"leaf_{i}"] for i in range(len(want))]
    for i, (g, w) in enumerate(zip(got, want)):
        want_shape = tuple(w.shape) if torch.is_tensor(w) else tuple(np.shape(w))
        if tuple(g.shape) != want_shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {g.shape} != template "
                f"{want_shape} — architecture changed since save; use a "
                "fresh checkpoint dir (or resume=False)"
            )
    state = unflatten(template, [_like(g, w) for g, w in zip(got, want)])
    metadata = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            metadata = json.load(f)
    return state, metadata


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> str | None:
    """Path of the ``{prefix}-{step}.npz`` in ``ckpt_dir`` with the largest
    integer ``step``, if any."""
    if not os.path.isdir(ckpt_dir):
        return None
    best_step, best = -1, None
    for name in os.listdir(ckpt_dir):
        if not (name.startswith(prefix + "-") and name.endswith(".npz")):
            continue
        try:
            step = int(name[len(prefix) + 1 : -4])
        except ValueError:
            continue
        if step > best_step:
            best_step, best = step, os.path.join(ckpt_dir, name)
    return best
