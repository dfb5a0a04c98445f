"""FEMUDF: fluctuation electron microscopy, the per-frame standard
deviation over a ring of detector pixels (counterpart of
``libertem_tpu/udf/FEM.py``).

Device path: a gather of the ring pixels and a per-frame population
standard deviation, over the whole block at once.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import UDF


class FEMUDF(UDF):
    def __init__(self, center=None, rad_in=None, rad_out=None, **kwargs):
        super().__init__(
            center=center, rad_in=rad_in, rad_out=rad_out, **kwargs
        )
        self._ring_idx = None
        self._ring_key = None

    @classmethod
    def with_params(cls, cy=None, cx=None, ri=None, ro=None):
        return cls(center=(cy, cx), rad_in=ri, rad_out=ro)

    def get_tiling_preferences(self):
        # the ring gather indexes the flattened WHOLE frame
        return {"whole_frames": True,
                "depth": self.TILE_DEPTH_DEFAULT,
                "total_size": self.TILE_SIZE_MAX}

    def get_result_buffers(self):
        return {
            "intensity": self.buffer(kind="nav", dtype="float32"),
        }

    def _ring_index(self) -> torch.Tensor:
        """Flat indices of the pixels with rad_in < d <= rad_out, on the
        run's device, kept for the sig shape and device they were made
        for."""
        key = (self.meta.sig_shape, str(self.meta.device))
        if self._ring_key == key:
            return self._ring_idx
        h, w = self.meta.sig_shape
        cy, cx = self.params.center
        y, x = np.ogrid[0:h, 0:w]
        d = np.sqrt((y - cy) ** 2 + (x - cx) ** 2)
        sel = (d > self.params.rad_in) & (d <= self.params.rad_out)
        idx = np.flatnonzero(sel.reshape(-1))
        if len(idx) == 0:
            raise ValueError("FEM ring selects no pixels")
        self._ring_idx = torch.from_numpy(idx).to(self.meta.device)
        self._ring_key = key
        return self._ring_idx

    def process_tile(self, tile):
        flat = tile.reshape(tile.shape[0], -1)
        vals = flat[:, self._ring_index()].to(torch.float32)
        self.results.intensity += torch.std(vals, dim=1, correction=0)


def run_fem(ctx, dataset, center, rad_in, rad_out, roi=None):
    """:class:`FEMUDF` over ``dataset``: its result buffers by name."""
    return ctx.run_udf(
        dataset, FEMUDF(center=center, rad_in=rad_in, rad_out=rad_out),
        roi=roi)
