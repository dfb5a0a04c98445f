"""Exact integer math helpers (counterpart of
``libertem_tpu/common/math.py``)."""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

_prod_accepted = (
    int, bool,
    np.bool_, np.signedinteger, np.unsignedinteger,
)


def prod(iterable: Iterable[int]) -> int:
    """Exact product as a Python int (no numpy overflow); raises
    ValueError on non-integer entries, so shape math never silently
    truncates floats."""
    result = 1
    for item in iterable:
        if not isinstance(item, _prod_accepted):
            raise ValueError(
                f"prod() accepts integer types only, got {type(item)}"
            )
        result *= int(item)
    return result


def count_nonzero(mask) -> int:
    """Truthy entries of a dense or sparse mask (a sparse array that
    ``np.count_nonzero`` refuses is counted as ``astype(bool).sum()``,
    without densifying)."""
    if mask is None:
        return 0
    try:
        return int(np.count_nonzero(mask))
    except (TypeError, ValueError):
        return int(mask.astype(bool).sum())


def make_2D_square(shape: Sequence[int]) -> tuple[int, ...]:
    """A 1-D shape whose size is a perfect square as the 2-D square;
    any other shape unchanged.  Raises ValueError on a size below 1."""
    if len(shape) != 1:
        return tuple(int(s) for s in shape)
    size = prod(shape)
    if size < 1:
        raise ValueError("Zero or negative shape.size")
    side = math.isqrt(size)
    if side * side == size:
        return (side, side)
    return tuple(int(s) for s in shape)


def flat_nonzero(mask) -> np.ndarray:
    """Flat indices of the truthy entries of a dense array."""
    return np.flatnonzero(np.asarray(mask))


def ndenumerate(array):
    """``np.ndenumerate``, also over sparse arrays (densified when
    numpy refuses to iterate them)."""
    try:
        yield from np.ndenumerate(array)
    except (RuntimeError, TypeError):
        arr = np.asarray(
            array.todense() if hasattr(array, "todense") else array
        )
        yield from np.ndenumerate(arr)
