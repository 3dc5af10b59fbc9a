"""Synthetic toy datasets of the reference experiments (numpy).

The port's own copy of :mod:`whvi_tpu.data.toy`; both draw from numpy's
``RandomState``, so the arrays are bit-equal to the JAX package's.

- :func:`cubic_data`: the README quickstart, ``y = x0 + x1^2 - 0.3 x2^3``
  on 200 standard-normal points, a 150/50 train/test split.
- :func:`polynomial_data`: the paper's toy example, a degree-8 polynomial
  with noise ``N(0, exp(-3))`` on 128 points with a gap on
  ``x in [0.6, 1.4]``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cubic_data", "polynomial_f", "polynomial_data", "POLY_COEFFS"]


def cubic_data(seed: int = 0, n: int = 200, n_train: int = 150):
    """``((x_train, y_train), (x_test, y_test))``, float32, ``y (n, 1)``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3).astype(np.float32)
    y = (x[:, 0] + x[:, 1] ** 2 - 0.3 * x[:, 2] ** 3).reshape(-1, 1)
    perm = rng.permutation(n)
    tr, te = perm[:n_train], perm[n_train:]
    return (x[tr], y[tr].astype(np.float32)), (x[te], y[te].astype(np.float32))


# The degree-8 polynomial through these anchor points (a Vandermonde
# solve, as the reference notebook's cell 3):
# f(x) = 0.50 - 3.45x + 1.14x^2 + 4.36x^3 - 0.93x^4 - 1.77x^5 + 0.39x^6
#        + 0.22x^7 - 0.06x^8
_ANCHORS_X = np.array([-2.0, -1.5, -0.8, 0.0, 0.5, 1.4, 2.0, 2.7, 3.0])
_ANCHORS_Y = np.array([1.2, 1.5, 2.0, 0.5, -0.5, 1.2, 0.0, 1.0, 1.3])
POLY_COEFFS = np.linalg.solve(np.vander(_ANCHORS_X, len(_ANCHORS_X)), _ANCHORS_Y)


def polynomial_f(x: np.ndarray) -> np.ndarray:
    return np.polyval(POLY_COEFFS, x)


def polynomial_data(
    seed: int = 0,
    n: int = 128,
    noise_var: float = float(np.exp(-3.0)),
    gap: tuple[float, float] = (0.6, 1.4),
    x_range: tuple[float, float] = (-1.0, 2.0),
):
    """``(x (n, 1), y (n, 1))``: ``n`` points from ``U(x_range)`` outside
    ``gap`` (drawn until exactly ``n`` survive), with Gaussian noise of
    variance ``noise_var``."""
    rng = np.random.RandomState(seed)
    xs = []
    while len(xs) < n:
        cand = rng.uniform(x_range[0], x_range[1], size=4 * n)
        cand = cand[(cand < gap[0]) | (cand > gap[1])]
        xs.extend(cand.tolist())
    x = np.asarray(xs[:n], dtype=np.float32).reshape(-1, 1)
    y = polynomial_f(x[:, 0]).reshape(-1, 1)
    y = y + rng.randn(n, 1) * np.sqrt(noise_var)
    return x, y.astype(np.float32)
