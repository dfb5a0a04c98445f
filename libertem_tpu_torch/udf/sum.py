"""SumUDF: sum all frames (counterpart of ``libertem_tpu/udf/sum.py``)."""
from __future__ import annotations

import numpy as np

from .base import UDF


class SumUDF(UDF):
    """Sum over the navigation axis -> one (*sig) image."""

    def __init__(self, dtype="float32"):
        super().__init__(dtype=dtype)

    def _dtype(self) -> np.dtype:
        dtype = np.result_type(self.params.dtype, self.meta.input_dtype)
        # the device accumulates in float32 either way
        if dtype == np.float64:
            dtype = np.dtype(np.float32)
        return dtype

    def get_result_buffers(self):
        return {"intensity": self.buffer(kind="sig", dtype=self._dtype())}

    def process_tile(self, tile):
        self.results.intensity += tile.sum(dim=0)

    def merge(self, dest, src):
        dest.intensity = dest.intensity + src.intensity

    def fused_moments_spec(self):
        """Consumes the fused pass's per-pixel column sum."""
        if self._dtype() != np.float32:
            return None
        return {"mode": "colsum", "name": "intensity"}
