"""The nets of a configuration file, as plain functions of a parameter dict.

A configuration's ``layers`` list holds ``"relu"`` and WHVI layers
``{"n_in", "n_out", "lambda", "s_init"}``. A WHVI layer's weight sample is
``W = diag(s1) H diag(u) H diag(s2)`` with ``u = g_mu + softplus(g_rho) *
eps`` (the local reparameterisation: one ``u`` a sample, shared by the
rows), so ``x W^T = s1 * H(u * H(s2 * x))``. Its shape decides its form,
as the WHVI paper's reference code builds it:

- ``square``: ``n_in == n_out``, a power of two; parameters ``(D,)``;
- ``column``: ``n_out == 1``; parameters ``(D,)`` with ``D`` the next
  power of two of ``n_in``; the weight row is the first ``n_in`` entries of
  row 0 of a square sample, ``s1[0] * H(u) * s2``, since row 0 of ``H`` is
  all ones;
- ``stacked``: otherwise; ``stack = ceil(n_out / D)`` square blocks of
  ``D``, the next power of two of ``n_in``, over the zero-padded input,
  their outputs concatenated and cut to ``n_out``; parameters ``(stack,
  D)``.

The parameter dict has ``"<i>.s1"``, ``"<i>.s2"``, ``"<i>.g_mu"``,
``"<i>.g_rho"`` for the WHVI layer at index ``i`` of ``layers``, and
whatever the likelihood's own parameters are (``"rho"``, the noise scale
``softplus(rho)``, for a Gaussian). A likelihood is a module of
:mod:`portbench.reference.likelihoods`, ``log_prob(likelihood, params, y,
y_hat)`` and ``predict(likelihood, params, y_hat)``, that the harness finds
by the configuration's ``likelihood.kind``. Noise ``eps`` is a list with
one ``(S, 1, *shape)`` tensor a WHVI layer and None a ReLU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.fwht import fwht


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length()


def layer_specs(config: dict) -> list:
    """One dict a layer: ``{"kind": "relu"}``, or ``{"kind", "n_in",
    "n_out", "shape", "lambda", "scale"}`` for a WHVI layer, ``shape``
    its parameters' and ``scale`` the standard deviation of ``s1`` and
    ``s2`` at initialisation (0.01, or ``D**-0.5`` for ``"auto"``)."""
    specs = []
    for layer in config["layers"]:
        if layer == "relu":
            specs.append({"kind": "relu"})
            continue
        n_in, n_out = layer["n_in"], layer["n_out"]
        D = _pow2_at_least(n_in)
        if n_out == 1:
            kind, shape = "column", (D,)
        elif n_in == n_out and D == n_in:
            kind, shape = "square", (D,)
        else:
            kind, shape = "stacked", (-(-n_out // D), D)
        s_init = layer.get("s_init", 0.01)
        specs.append({
            "kind": kind, "n_in": n_in, "n_out": n_out, "shape": shape,
            "lambda": float(layer["lambda"]),
            "scale": D**-0.5 if s_init == "auto" else float(s_init),
        })
    return specs


def _u(params, i, e):
    return params[f"{i}.g_mu"] + F.softplus(params[f"{i}.g_rho"]) * e


def _layer(spec, params, i, h, e):
    """One layer on ``h (S, B, n_in)`` (or ``(B, n_in)``, broadcast over
    the samples of ``e``)."""
    kind = spec["kind"]
    if kind == "relu":
        return torch.relu(h)
    s1, s2, u = params[f"{i}.s1"], params[f"{i}.s2"], _u(params, i, e)
    if kind == "square":
        return s1 * fwht(u * fwht(s2 * h))
    if kind == "column":
        row = (s1[0] * fwht(u) * s2)[..., : spec["n_in"]]  # (S, 1, n_in)
        return torch.sum(h * row, dim=-1, keepdim=True)
    D = spec["shape"][-1]
    hp = F.pad(h, (0, D - spec["n_in"]))[..., None, :]  # (.., B, 1, D)
    out = s1 * fwht(u * fwht(s2 * hp))  # (S, B, stack, D)
    return out.reshape(*out.shape[:-2], -1)[..., : spec["n_out"]]


def forward(specs, params, x, eps):
    """``(S, B, n_out)`` outputs of the samples of ``eps`` on ``x (B,
    n_in)``."""
    h = x
    for i, (spec, e) in enumerate(zip(specs, eps)):
        h = _layer(spec, params, i, h, e)
    if h.dim() == 2:  # a net without a WHVI layer: no sample axis
        h = h.expand(eps[0].shape[0], *h.shape)
    return h


def kl_total(specs, params):
    """Sum over WHVI layers of KL(N(g_mu, softplus(g_rho)^2) || N(0,
    lambda))."""
    total = 0.0
    for i, spec in enumerate(specs):
        if spec["kind"] == "relu":
            continue
        mu, sigma = params[f"{i}.g_mu"], F.softplus(params[f"{i}.g_rho"])
        var_p = spec["lambda"]
        total = total + torch.sum(
            0.5 * math.log(var_p) - torch.log(sigma)
            + (sigma * sigma + mu * mu) / (2.0 * var_p) - 0.5
        )
    return total


def _blocks(S: int, block: int):
    return [slice(a, min(a + block, S)) for a in range(0, S, block)]


def reference_grads(lik, config, specs, params, x, y, eps, n: float, block: int):
    """The negative ELBO ``mnll + kl`` at ``params`` on the batch ``(x,
    y)`` with noise ``eps`` under the likelihood module ``lik``, and its
    gradient: ``(loss, mnll, kl, grads)``,
    floats and a dict like ``params``. ``mnll = -(n / (S B)) sum_{s, b}
    log p(y_b | f_s(x_b))``. The samples run ``block`` at a time, each
    block's backward adding its part, so the memory held is a block's."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    S, B = eps[0].shape[0], x.shape[0]
    mnll = 0.0
    for part in _blocks(S, block):
        y_hat = forward(specs, leaves, x, [None if e is None else e[part] for e in eps])
        share = -(n / (S * B)) * torch.sum(lik.log_prob(config["likelihood"], leaves, y, y_hat))
        share.backward()
        mnll += float(share.detach())
    kl = kl_total(specs, leaves)
    kl.backward()
    grads = {
        k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in leaves.items()
    }
    kl = float(kl.detach())
    return mnll + kl, mnll, kl, grads


@torch.no_grad()
def sample_outputs(specs, params, x, eps, block: int):
    """``(S, B, n_out)`` outputs, ``block`` samples at a time."""
    S = eps[0].shape[0]
    return torch.cat([
        forward(specs, params, x, [None if e is None else e[part] for e in eps])
        for part in _blocks(S, block)
    ])
