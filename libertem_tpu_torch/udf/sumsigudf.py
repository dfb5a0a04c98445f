"""SumSigUDF: per-frame sum over the signal axes (counterpart of
``libertem_tpu/udf/sumsigudf.py``)."""
from __future__ import annotations

import numpy as np

from .base import UDF


class SumSigUDF(UDF):
    """Sum over the signal axes -> one value per navigation position."""

    def get_result_buffers(self):
        return {
            "intensity": self.buffer(
                kind="nav", dtype=self.meta.input_dtype
            ),
        }

    def process_tile(self, tile):
        self.results.intensity += tile.sum(dim=tuple(range(1, tile.ndim)))

    def fused_moments_spec(self):
        """A frame's sig sum is its projection on a ones mask row."""
        if np.dtype(self.meta.input_dtype) != np.float32:
            return None
        return {"mode": "sumsig", "name": "intensity"}
