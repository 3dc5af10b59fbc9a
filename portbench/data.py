"""Inputs made on the device from the seed, in a few large calls.

Two kinds, named by a configuration's ``data.kind``:

- ``normal``: ``X`` and ``y`` standard normal, as the scaling experiment
  makes its batch (``D -> D -> D -> 1`` regression on noise);
- ``prototypes``: a class prototype a class, standard normal, plus
  Gaussian noise of ``noise`` standard deviation a row, labels uniform over
  the classes: the synthetic stand-in for MNIST of the port's
  ``data.mnist.synthetic_classification``, at MNIST's shapes, drawn here
  on the device (that one draws with numpy on the host).
"""

from __future__ import annotations

import torch


def make_rows(data: dict, lead: tuple, generator: torch.Generator, device, dtype):
    """``(X (*lead, n_in), y)`` of ``data``'s kind: ``y (*lead, n_out)``
    for ``normal``, class indices ``(*lead,)`` as floats for
    ``prototypes``."""
    kw = dict(generator=generator, device=device)
    if data["kind"] == "normal":
        X = torch.randn(*lead, data["n_in"], dtype=dtype, **kw)
        y = torch.randn(*lead, data["n_out"], dtype=dtype, **kw)
        return X, y
    if data["kind"] == "prototypes":
        protos = torch.randn(data["classes"], data["n_in"], dtype=dtype, **kw)
        labels = torch.randint(0, data["classes"], lead, **kw)
        X = protos[labels] + data["noise"] * torch.randn(*lead, data["n_in"], dtype=dtype, **kw)
        return X, labels.to(dtype)
    raise ValueError(f"unknown data kind {data['kind']!r}")
