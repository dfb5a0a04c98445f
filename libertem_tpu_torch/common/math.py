"""Exact integer math helpers (counterpart of
``libertem_tpu/common/math.py``)."""
from __future__ import annotations

from typing import Iterable

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
