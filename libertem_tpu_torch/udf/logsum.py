"""LogsumUDF: sum of log-scaled frames (counterpart of
``libertem_tpu/udf/logsum.py``).

Each frame is shifted by its minimum before log1p, then summed over
nav; the zero-padded tail rows are masked out.
"""
from __future__ import annotations

import torch

from .base import UDF


class LogsumUDF(UDF):
    def get_result_buffers(self):
        return {
            "logsum": self.buffer(kind="sig", dtype="float32"),
        }

    def get_tiling_preferences(self):
        # needs whole frames for the per-frame minimum
        return {
            "whole_frames": True,
            "depth": self.TILE_DEPTH_DEFAULT,
            "total_size": self.TILE_SIZE_MAX,
        }

    def process_tile(self, tile):
        sig_axes = tuple(range(1, tile.ndim))
        mn = tile.amin(dim=sig_axes, keepdim=True)
        contrib = torch.log1p(tile - mn)
        vmask = self.meta.tile_valid.reshape(
            (-1,) + (1,) * (tile.ndim - 1)
        )
        self.results.logsum += (contrib * vmask).sum(dim=0)

    def merge(self, dest, src):
        dest.logsum = dest.logsum + src.logsum
