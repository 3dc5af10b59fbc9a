"""Faults planted in the program for a run, by name: the lower-precision
control and the faults that the check of ``correct`` has to catch. The
calibration (:mod:`portbench.calibrate`) reads each one's numbers on the
card; the tests see each one turn ``correct`` false. The benchmark's own
runs plant none.

- ``control_bf16``: every ``whvi_mul`` in the port's own ``"bf16"``
  precision (operands rounded to bfloat16 before each transform), the step
  below the float32 the configurations state;
- ``unchanged_step``: the optimizer's step returns, leaving the state as it
  was;
- ``half_batch``: the likelihood's estimate over the first half of the
  rows alone, the second half left out (the mean taken over the rest);
- ``half_samples``: the predictive answer from the first half of the MC
  samples;
- ``altered_answer``: the first row's answer replaced by the second's
  where the likelihood produces it;
- ``no_spread``: a Gaussian's predictive sd without the epistemic part,
  the noise scale alone;
- ``no_exchange``: the mesh's gradient all-reduce left out, so each rank
  steps on its own samples' gradient.
"""

from __future__ import annotations

import contextlib

import torch

from whvi_tpu_torch.models.likelihoods import CategoricalLikelihood, GaussianLikelihood
from whvi_tpu_torch.ops import whvi_op
from whvi_tpu_torch.parallel.mesh import Mesh

LIKELIHOODS = (GaussianLikelihood, CategoricalLikelihood)
NAMES = (
    "control_bf16", "unchanged_step", "half_batch", "half_samples", "altered_answer",
    "no_spread", "no_exchange",
)


def _first_half_rows(t, rows: int):
    """``t`` with its rows axis (the one of length ``rows``, last but one for
    outputs, last for per-row values) cut to the first half."""
    h = rows // 2
    if t.dim() >= 2 and t.shape[-2] == rows:
        return t[..., :h, :]
    return t[..., :h]


def _patches(name: str) -> list:
    """``(owner, attribute, replacement)`` triples for the fault ``name``."""
    if name == "control_bf16":
        original = whvi_op.set_whvi_mul_precision
        return [(whvi_op, "set_whvi_mul_precision", lambda _name: original("bf16"))]
    if name == "unchanged_step":
        return [(torch.optim.Adam, "step", lambda self, closure=None: None)]
    if name == "half_batch":
        out = []
        for cls in LIKELIHOODS:
            mnll, log_prob = cls.mnll, cls.log_prob

            def half_mnll(self, y, y_hat, n, weights=None, _mnll=mnll):
                rows = y_hat.shape[-2]
                y = y.reshape(rows, -1) if y.dim() == 1 else y
                return _mnll(
                    self, _first_half_rows(y, rows), _first_half_rows(y_hat, rows), n,
                    None if weights is None else _first_half_rows(weights, rows),
                )

            def half_log_prob(self, y, y_hat, _log_prob=log_prob):  # the mesh's loss reads it
                lp = _log_prob(self, y, y_hat)
                h = lp.shape[-1] // 2
                return torch.cat([lp[..., :h], lp[..., :h]], dim=-1)

            out += [(cls, "mnll", half_mnll), (cls, "log_prob", half_log_prob)]
        return out
    if name in ("half_samples", "altered_answer"):
        out = []
        for cls in LIKELIHOODS:
            predict = cls.predict

            def planted(self, y_hat, _predict=predict):
                if name == "half_samples":
                    return _predict(self, y_hat[: y_hat.shape[0] // 2])
                answer = _predict(self, y_hat)
                parts = answer if isinstance(answer, tuple) else (answer,)
                altered = []
                for t in parts:
                    t = t.clone()
                    t[0] = t[1]
                    altered.append(t)
                return tuple(altered) if isinstance(answer, tuple) else altered[0]

            out.append((cls, "predict", planted))
        return out
    if name == "no_spread":
        predict = GaussianLikelihood.predict

        def noise_alone(self, y_hat, _predict=predict):
            mean, _ = _predict(self, y_hat)
            return mean, self.sigma(mean.dim()).expand_as(mean)

        return [(GaussianLikelihood, "predict", noise_alone)]
    if name == "no_exchange":
        all_reduce = Mesh.all_reduce

        def skip_gradients(self, t, *args, _all_reduce=all_reduce, **kw):
            if t.dtype == torch.float32 and t.numel() > 1:  # the step's gradients
                return t
            return _all_reduce(self, t, *args, **kw)

        return [(Mesh, "all_reduce", skip_gradients)]
    raise ValueError(f"unknown fault {name!r}; have {NAMES}")


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` planted, for the block."""
    patches = _patches(name)
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, new in patches:
            setattr(owner, attr, new)
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)
        whvi_op.set_whvi_mul_precision("fp32")
