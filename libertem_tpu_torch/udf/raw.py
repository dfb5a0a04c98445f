"""PickUDF: extract raw frames under a (small) roi (counterpart of
``libertem_tpu/udf/raw.py``).

Storage: a single-kind buffer of shape (n_selected, *sig) in the
dataset's own dtype; each block copies its valid frames to their rows
(at the block's roi-compressed global offset).  Partition states are
disjoint, so the merge is an add that is exact bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import UDF

# unsigned types whose add PyTorch does not implement everywhere: add
# them as their signed twins, which give the same bits
_SIGNED_TWIN = {
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}


def _add_disjoint(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` where at each position at least one of them is 0."""
    twin = _SIGNED_TWIN.get(a.dtype)
    if twin is None:
        return a + b
    return (a.view(twin) + b.view(twin)).view(a.dtype)


class PickUDF(UDF):
    def get_preferred_input_dtype(self):
        return self.USE_NATIVE_DTYPE  # keep the raw dtype

    def _n_selected(self) -> int:
        if self.meta.roi is not None:
            return int(np.count_nonzero(self.meta.roi))
        return self.meta.dataset_shape.nav.size

    def get_result_buffers(self):
        return {
            "intensity": self.buffer(
                kind="single",
                extra_shape=(self._n_selected(),)
                + tuple(self.meta.dataset_shape.sig),
                dtype=self.meta.input_dtype,
            ),
        }

    def process_tile(self, tile):
        out = self.results.intensity
        start = self.meta.global_offset
        valid = self.meta.valid_frames
        index = (slice(start, start + valid),)
        if len(self.meta.tiling_scheme) > 1:
            index += self.meta.sig_slice.get()
        out[index] = tile[:valid].to(out.dtype)
        self.results.intensity = out

    def merge(self, dest, src):
        dest.intensity = _add_disjoint(dest.intensity, src.intensity)
