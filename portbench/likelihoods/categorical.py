"""``{"kind": "categorical"}``: the port's ``WHVIClassification``, a
softmax over class logits. A predictive call answers the mean class
probabilities on the device and copies each row's most probable class to
the host, as a test-set score does.

Compared: ``prob_gap``, the worst call's largest gap of a class
probability over the reference's largest departure from uniform;
``class_miss``, summed over the calls, the rows whose class on the host
is not the reference's where the reference's two best classes lie
``class_margin`` of that departure apart or more.
"""

from __future__ import annotations

import torch

from whvi_tpu_torch.models import WHVIClassification

SUMMED = ("class_miss",)
FAULTS = ()


def build(layers, likelihood: dict, samples: dict, device, dtype):
    return WHVIClassification(layers, **samples).to(device)


def params(likelihood: dict, device, dtype, state=None) -> dict:
    return {}


def answer(prediction):
    """``(probabilities on the device, classes on the host)``."""
    return prediction, prediction.argmax(-1).cpu()


def gaps(dev, host, ref: dict, limits: dict) -> dict:
    probs = ref["probs"]
    scale = float((probs - 1.0 / probs.shape[-1]).abs().max())
    top2 = torch.topk(probs, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) >= limits["class_margin"] * scale
    return {
        "prob_gap": float((dev.float() - probs).abs().max()) / scale,
        "class_miss": float(torch.sum(clear & (host != probs.argmax(-1)))),
    }
