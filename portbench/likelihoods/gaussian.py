"""``{"kind": "gaussian", "sigma0"}``: the port's ``WHVIRegression``, a
noise scale ``softplus(rho)`` learned from ``sigma0``. A predictive call
answers the mixture's mean and standard deviation, both copied to the
host.

Compared, each over the reference's root mean square, the worst call's:
``mean_gap``, the mean's largest gap; ``spread_gap``, the largest gap of
the epistemic variance, the answer's ``sd^2`` less the reference's
``sigma^2``, against the reference's variance of the sample means. The
``sd`` itself is all but ``sigma`` where the spread is small, so its own
gap would hide a spread computed wrong. A mix's ``state`` may set
``sigma``, the noise scale of the scored net.
"""

from __future__ import annotations

import math

import torch

from whvi_tpu_torch.models import WHVIRegression

SUMMED = ()
FAULTS = ("no_spread",)  # faults of portbench.faults that only this likelihood can have


def build(layers, likelihood: dict, samples: dict, device, dtype):
    return WHVIRegression(layers, sigma0=likelihood["sigma0"], device=device, dtype=dtype,
                          **samples)


def params(likelihood: dict, device, dtype, state=None) -> dict:
    """``rho`` with ``softplus(rho)`` the state's ``sigma``, else
    ``sigma0``."""
    sigma = (state or {}).get("sigma", likelihood["sigma0"])
    rho = math.log(math.expm1(sigma))
    return {"rho": torch.tensor(rho, device=device, dtype=dtype)}


def answer(prediction):
    """``(on the device, on the host)``: the mean and sd stacked, ``(2, B,
    n_out)``."""
    moments = torch.stack(prediction)
    return moments, moments.cpu()


def _rms(t) -> float:
    return float(t.square().mean().sqrt())


def gaps(dev, host, ref: dict, limits: dict) -> dict:
    mean, sd = host.float()
    spread = sd.square() - ref["noise_var"]
    return {
        "mean_gap": float((mean - ref["mean"]).abs().max()) / _rms(ref["mean"]),
        "spread_gap": float((spread - ref["spread"]).abs().max()) / _rms(ref["spread"]),
    }
