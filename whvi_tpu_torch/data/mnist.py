"""MNIST from IDX files, scikit-learn's bundled classification sets, and
a synthetic classification stand-in (numpy).

The port's own copy of :mod:`whvi_tpu.data.mnist`. :func:`load_mnist`
reads the standard IDX files (optionally gzipped) from
``$WHVI_DATA_DIR``, ``data/mnist/`` or ``data/`` of the repository;
nothing is downloaded. :func:`synthetic_classification` makes class
prototypes plus noise at MNIST's shapes from a seed, so the classifier
runs anywhere. :func:`load_digits_classification` and
:func:`load_sklearn_classification` read the real sets that scikit-learn
ships (offline), importing it only when called.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = [
    "load_digits_classification",
    "load_mnist",
    "load_sklearn_classification",
    "mnist_available",
    "synthetic_classification",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SEARCH_DIRS = [
    os.environ.get("WHVI_DATA_DIR", ""),
    os.path.join(_ROOT, "data", "mnist"),
    os.path.join(_ROOT, "data"),
]

_FILES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def _find(names) -> str | None:
    for d in _SEARCH_DIRS:
        if not d:
            continue
        for name in names:
            for suffix in ("", ".gz"):
                p = os.path.join(d, name + suffix)
                if os.path.exists(p):
                    return p
    return None


def _read_idx(path: str) -> np.ndarray:
    """The array of an IDX file of unsigned bytes: a 4-byte magic (two
    zero bytes, the type code, the rank), big-endian 32-bit dims, data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = data[3]
    dims = struct.unpack_from(f">{ndim}I", data, 4)
    arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def mnist_available() -> bool:
    return all(_find(v) is not None for v in _FILES.values())


def load_mnist(flatten: bool = True):
    """``((X_train, y_train), (X_test, y_test))``; X float32 in [0, 1],
    y int32."""
    paths = {k: _find(v) for k, v in _FILES.items()}
    missing = [k for k, p in paths.items() if p is None]
    if missing:
        raise FileNotFoundError(
            f"MNIST files missing: {missing}; place IDX files under "
            f"{[d for d in _SEARCH_DIRS if d]}"
        )
    Xtr = _read_idx(paths["train_images"]).astype(np.float32) / 255.0
    ytr = _read_idx(paths["train_labels"]).astype(np.int32)
    Xte = _read_idx(paths["test_images"]).astype(np.float32) / 255.0
    yte = _read_idx(paths["test_labels"]).astype(np.int32)
    if flatten:
        Xtr = Xtr.reshape(len(Xtr), -1)
        Xte = Xte.reshape(len(Xte), -1)
    return (Xtr, ytr), (Xte, yte)


def synthetic_classification(
    n_train: int = 4096,
    n_test: int = 1024,
    n_in: int = 784,
    n_classes: int = 10,
    noise: float = 2.0,
    seed: int = 0,
):
    """Class prototypes plus Gaussian noise at MNIST's default shapes:
    ``((X_train, y_train), (X_test, y_test))``, X float32, y int32."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, n_in).astype(np.float32)

    def make(n):
        y = rng.randint(0, n_classes, size=n).astype(np.int32)
        X = protos[y] + noise * rng.randn(n, n_in).astype(np.float32)
        return X.astype(np.float32), y

    return make(n_train), make(n_test)


def load_digits_classification(test_frac: float = 0.2, seed: int = 0):
    """Scikit-learn's bundled 8x8 handwritten digits (1797 samples, 10
    classes, UCI Optical Recognition of Handwritten Digits), split by a
    seeded permutation: ``((X_tr, y_tr), (X_te, y_te))``, X float32 in
    [0, 1], flattened to 64, y int32."""
    from sklearn.datasets import load_digits

    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    perm = np.random.RandomState(seed).permutation(len(X))
    n_te = int(round(test_frac * len(X)))
    te, tr = perm[:n_te], perm[n_te:]
    return (X[tr], y[tr]), (X[te], y[te])


def load_sklearn_classification(name: str, test_frac: float = 0.2, seed: int = 0):
    """Scikit-learn's bundled ``wine`` (178 x 13, 3 classes) or
    ``breast_cancer`` (569 x 30, 2 classes), split by a seeded permutation,
    features standardized on the train split: ``((X_tr, y_tr), (X_te,
    y_te))``."""
    from sklearn import datasets as skd

    loaders = {"wine": skd.load_wine, "breast_cancer": skd.load_breast_cancer}
    if name not in loaders:
        raise ValueError(f"unknown sklearn set {name!r}; have {sorted(loaders)}")
    d = loaders[name]()
    X = d.data.astype(np.float32)
    y = d.target.astype(np.int32)
    perm = np.random.RandomState(seed).permutation(len(X))
    n_te = int(round(test_frac * len(X)))
    te, tr = perm[:n_te], perm[n_te:]
    mu = X[tr].mean(axis=0)
    sd = X[tr].std(axis=0) + 1e-8
    X = (X - mu) / sd
    return (X[tr], y[tr]), (X[te], y[te])
