"""UCI regression dataset loaders (the reference experiment suite).

The port's own copy of :mod:`whvi_tpu.data.uci`: the counterparts of the
reference's per-dataset runner loaders (run_{boston,concrete,energy,
yacht,kin8nm,naval}.py) plus protein and two sets that ship with
scikit-learn. Each loader returns ``(X, y)`` float32 arrays with ``y``
2-D.

Each dataset file is looked up, at call time, in ``$WHVI_DATA_DIR`` and
then in ``<repo>/data/``. Files the reference downloads at first use
(kin8nm from OpenML, naval from UCI) are not fetched: their loaders raise
a ``FileNotFoundError`` naming the expected file. ``boston`` expects the
classic ``housing.data`` whitespace format.

The scikit-learn sets (diabetes, linnerud) import scikit-learn when they
are loaded; without it they raise an ``ImportError`` that says so.
"""

from __future__ import annotations

import os

import numpy as np

from whvi_tpu_torch.data.sheets import read_xls_numeric, read_xlsx_numeric

__all__ = ["load_uci", "UCI_DATASETS", "dataset_info"]

_REPO_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data"
)


def _search_dirs() -> list[str]:
    return [d for d in (os.environ.get("WHVI_DATA_DIR", ""), _REPO_DATA) if d]


def _find(*names: str) -> str:
    dirs = _search_dirs()
    for d in dirs:
        for name in names:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(
        f"none of {names} found in {dirs}; "
        "set WHVI_DATA_DIR or place the file in <repo>/data/"
    )


def _split_xy(table: np.ndarray, n_targets: int = 1):
    X = table[:, :-n_targets].astype(np.float32)
    y = table[:, -n_targets:].astype(np.float32)
    return X, y


def load_boston():
    """Boston housing: 506 x 13 -> 1. Classic ``housing.data`` layout
    (whitespace, MEDV last), or a CSV with a header row."""
    path = _find("housing.data", "boston.data", "boston.csv")
    if path.endswith(".csv"):
        table = np.genfromtxt(path, delimiter=",", skip_header=1)
    else:
        table = np.loadtxt(path)
    return _split_xy(table)


def load_concrete():
    """Concrete compressive strength: 1030 x 8 -> 1 (Concrete_Data.xls)."""
    table = read_xls_numeric(_find("Concrete_Data.xls"))
    return _split_xy(table)


def load_energy():
    """Energy efficiency (ENB2012): 768 x 8 -> 2 targets (heating and
    cooling load)."""
    table = read_xlsx_numeric(_find("ENB2012_data.xlsx"))
    return _split_xy(table, n_targets=2)


def load_yacht():
    """Yacht hydrodynamics: 308 x 6 -> 1."""
    table = np.loadtxt(_find("yacht_hydrodynamics.data"))
    return _split_xy(table)


def load_kin8nm():
    """kin8nm: 8192 x 8 -> 1 (openml.org dataset 189,
    'dataset_2175_kin8nm.csv')."""
    path = _find("dataset_2175_kin8nm.csv", "kin8nm.csv")
    table = np.genfromtxt(path, delimiter=",", skip_header=1)
    return _split_xy(table)


def load_naval():
    """Naval propulsion (UCI CBM): 11934 x 16 -> 2 compressor/turbine
    decay coefficients."""
    path = _find("naval_data.txt", os.path.join("UCI CBM Dataset", "data.txt"))
    table = np.loadtxt(path)
    return _split_xy(table, n_targets=2)


def load_protein():
    """Protein tertiary structure (CASP): 45730 x 9 -> 1 (RMSD is the
    first column of the UCI CSV)."""
    path = _find("CASP.csv", "protein.csv")
    table = np.genfromtxt(path, delimiter=",", skip_header=1)
    X = table[:, 1:].astype(np.float32)
    y = table[:, :1].astype(np.float32)
    return X, y


def _sklearn_datasets():
    try:
        from sklearn import datasets
    except ImportError as e:
        raise ImportError(
            "this dataset ships with scikit-learn, which is not installed"
        ) from e
    return datasets


def load_diabetes_sk():
    """Diabetes progression (Efron et al.): 442 x 10 -> 1, raw target
    units, from scikit-learn."""
    d = _sklearn_datasets().load_diabetes(scaled=False)
    return d.data.astype(np.float32), d.target.astype(np.float32)[:, None]


def load_linnerud_sk():
    """Linnerud exercise physiology: 20 x 3 -> 3 (weight, waist, pulse),
    from scikit-learn."""
    d = _sklearn_datasets().load_linnerud()
    return d.data.astype(np.float32), d.target.astype(np.float32)


UCI_DATASETS = {
    "boston": load_boston,
    "concrete": load_concrete,
    "energy": load_energy,
    "yacht": load_yacht,
    "kin8nm": load_kin8nm,
    "naval": load_naval,
    "protein": load_protein,
    # offline extras (not in the reference's six)
    "diabetes": load_diabetes_sk,
    "linnerud": load_linnerud_sk,
}


def dataset_info(name: str) -> dict:
    """Shapes and availability, without raising on a missing file or a
    missing scikit-learn (the JAX package's raises on the latter)."""
    try:
        X, y = load_uci(name)
        return {
            "name": name,
            "available": True,
            "n": X.shape[0],
            "n_in": X.shape[1],
            "n_out": y.shape[1],
        }
    except (FileNotFoundError, ImportError) as e:
        return {"name": name, "available": False, "reason": str(e)}


def load_uci(name: str):
    if name not in UCI_DATASETS:
        raise KeyError(
            f"unknown dataset {name!r}; have {sorted(UCI_DATASETS)}"
        )
    return UCI_DATASETS[name]()
