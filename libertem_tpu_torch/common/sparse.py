"""Sparse/dense conversion helpers (counterpart of
``libertem_tpu/common/sparse.py``): scipy.sparse based; the pydata
``sparse`` package is imported only when a caller names one of its
formats."""
from __future__ import annotations

import numpy as np


def is_sparse(arr) -> bool:
    return hasattr(arr, "todense") or hasattr(arr, "toarray")


def to_dense(arr) -> np.ndarray:
    if hasattr(arr, "todense"):
        return np.asarray(arr.todense())
    if hasattr(arr, "toarray"):
        return np.asarray(arr.toarray())
    return np.asarray(arr)


def to_sparse(arr):
    import scipy.sparse as sp
    if is_sparse(arr):
        return arr
    arr = np.asarray(arr)
    return sp.csr_matrix(arr.reshape(arr.shape[0], -1) if
                         arr.ndim > 2 else arr)


def sparse_to_coo(arr):
    """``arr`` as a scipy.sparse COO matrix; None and numpy arrays pass
    through."""
    import scipy.sparse as sp
    if arr is None or isinstance(arr, np.ndarray):
        return arr
    return sp.coo_matrix(arr)


def to_backend(arr: np.ndarray, backend):
    """Convert a dense ``(depth, *sig)`` array (or one frame) to the
    named array backend: pydata-sparse formats keep the shape, scipy
    formats are 2D with the sig axes flattened to one."""
    if backend is None or backend == "numpy":
        return np.asarray(arr)
    if str(backend).startswith("sparse."):
        import sparse as sparse_pkg
        cls = getattr(sparse_pkg, str(backend).split(".", 1)[1])
        return cls.from_numpy(np.asarray(arr))
    if str(backend).startswith("scipy.sparse."):
        import scipy.sparse as sp
        ctor = getattr(sp, str(backend).rsplit(".", 1)[1])
        flat = np.asarray(arr)
        return ctor(flat.reshape(flat.shape[0], -1))
    raise ValueError(f"unknown array backend: {backend!r}")
