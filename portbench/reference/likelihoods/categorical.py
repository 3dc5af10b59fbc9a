"""The reference's softmax likelihood, ``{"kind": "categorical"}``: class
logits ``y_hat (S, B, C)``, labels ``(B,)`` of class indices."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def log_prob(likelihood: dict, params, y, y_hat):
    """``(S, B)`` log probability of each row's label under each sample."""
    logp = F.log_softmax(y_hat, dim=-1)
    index = y.reshape(1, -1, 1).long().expand(y_hat.shape[0], -1, 1)
    return torch.gather(logp, -1, index)[..., 0]


@torch.no_grad()
def predict(likelihood: dict, params, y_hat) -> dict:
    """What a predictive call answers: ``probs``, the mean over the samples
    of the class probabilities, ``(B, C)``."""
    return {"probs": torch.mean(torch.softmax(y_hat, dim=-1), dim=0)}
