"""LogsumUDF: sum of log-scaled frames (counterpart of
``libertem_tpu/udf/logsum.py``).

Each frame is shifted by its minimum before log1p, then summed over
nav; the zero-padded tail rows are masked out.  The minimum of complex
values is the JAX package's (``jnp.min``, that is ``lax.min``): the
least in lexicographic order of (real, imaginary).
"""
from __future__ import annotations

import torch

from .base import UDF


def _frame_min(tile, sig_axes):
    """Per-frame minimum over ``sig_axes`` (kept as size-1 axes)."""
    if not tile.is_complex():
        return tile.amin(dim=sig_axes, keepdim=True)
    re, im = tile.real, tile.imag
    mre = re.amin(dim=sig_axes, keepdim=True)
    # ties in the real part go to the least imaginary part
    mim = torch.where(re == mre, im, torch.full_like(im, float("inf")))
    return torch.complex(mre, mim.amin(dim=sig_axes, keepdim=True))


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
        mn = _frame_min(tile, sig_axes)
        contrib = torch.log1p(tile - mn)
        vmask = self.meta.tile_valid.reshape(
            (-1,) + (1,) * (tile.ndim - 1)
        )
        contrib = (contrib * vmask).sum(dim=0)
        # the real buffer takes the real part, as the JAX package's
        # cast to its state dtype does
        if contrib.is_complex():
            contrib = contrib.real
        self.results.logsum += contrib

    def merge(self, dest, src):
        dest.logsum = dest.logsum + src.logsum


def run_logsum(ctx, dataset, roi=None, progress=False):
    """:class:`LogsumUDF` over ``dataset``: its result buffers by
    name."""
    return ctx.run_udf(dataset, LogsumUDF(), roi=roi, progress=progress)
