"""What the benchmark takes from the program: the system under test.

The program is ``whvi_tpu_torch``, the PyTorch and CUDA port. From a
configuration file this module builds the port's own network through its
public constructors (``WHVILinear``, and the net class that the
likelihood's file of :mod:`portbench.likelihoods` names), sets the operand
precision the configuration states, and moves the harness's parameters
into the net and back out, so that the port and the reference start from
the same numbers. Nothing here computes what is judged: the window calls
the port's ``Trainer.train_step`` and ``WHVINetwork.predict`` themselves.
"""

from __future__ import annotations

import torch

from whvi_tpu_torch.models import WHVILinear, relu
from whvi_tpu_torch.ops import fwht_cuda, whvi_op


def dtype_of(config: dict) -> torch.dtype:
    """The storage type the configuration states, by its name in ``torch``
    (``"float32"``, ``"bfloat16"``, ...)."""
    dtype = getattr(torch, config["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {config['dtype']!r}")
    return dtype


def build_net(config: dict, lik, device, train_samples: int | None = None):
    """The configuration's network on ``device`` around the likelihood
    module ``lik``, the precision of every ``whvi_mul`` set to the
    configuration's; ``train_samples`` (a mesh's, all its chips' shares) in
    place of the configuration's."""
    whvi_op.set_whvi_mul_precision(config["precision"])
    dtype = dtype_of(config)
    layers = []
    for layer in config["layers"]:
        if layer == "relu":
            layers.append(relu)
            continue
        layers.append(WHVILinear(
            layer["n_in"], layer["n_out"], lambda_=layer["lambda"],
            s_init=layer.get("s_init", 0.01), device=device, dtype=dtype,
        ))
    samples = dict(
        train_samples=train_samples or config["train_samples"], eval_samples=config["eval_samples"]
    )
    return lik.build(layers, config["likelihood"], samples, device, dtype)


def param_map(net) -> dict:
    """The net's parameters under the reference's names (``"<i>.s1"`` ..
    ``"<i>.g_rho"`` for WHVI layer ``i``), and the likelihood's own under
    theirs (``"rho"``)."""
    out = {}
    for i, layer in enumerate(net.layers):
        matrix = getattr(layer, "matrix", None)
        if matrix is None:
            continue
        for name in ("s1", "s2", "g_mu", "g_rho"):
            out[f"{i}.{name}"] = getattr(matrix, name)
    out.update(net.likelihood.named_parameters())
    return out


@torch.no_grad()
def load_params(net, params: dict) -> None:
    """Copy the harness's ``params`` into the net; the names and shapes must
    match the net's exactly."""
    targets = param_map(net)
    if set(targets) != set(params):
        raise ValueError(f"parameters {sorted(params)} do not match the net's {sorted(targets)}")
    for key, p in targets.items():
        if p.shape != params[key].shape:
            raise ValueError(f"{key}: shape {tuple(params[key].shape)}, the net's {tuple(p.shape)}")
        p.copy_(params[key])


@torch.no_grad()
def read_params(net) -> dict:
    """A copy of the net's parameters under the reference's names."""
    return {k: p.detach().clone() for k, p in param_map(net).items()}


def launches() -> int:
    """The port's kernel launches so far (its ``fwht_cuda.LAUNCHES``)."""
    return sum(fwht_cuda.LAUNCHES.values())
