"""CrystallinityUDF: per-frame FFT ring integration (counterpart of
``libertem_tpu/udf/crystallinity.py``).

Device path: a batched 2-D FFT of the tile (``torch.fft.fft2``, cuFFT
on the card), its magnitude times a static fftshifted ring mask,
summed over sig: one value per frame.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import UDF


class CrystallinityUDF(UDF):
    def __init__(self, rad_in=None, rad_out=None, real_center=None,
                 real_rad=None, **kwargs):
        super().__init__(
            rad_in=rad_in, rad_out=rad_out, real_center=real_center,
            real_rad=real_rad, **kwargs
        )
        self._masks = None
        self._mask_key = None

    def get_result_buffers(self):
        return {
            "intensity": self.buffer(kind="nav", dtype="float32"),
        }

    def get_tiling_preferences(self):
        # the FFT needs whole frames
        return {
            "whole_frames": True,
            "depth": self.TILE_DEPTH_DEFAULT,
            "total_size": self.TILE_SIZE_MAX,
        }

    def _get_masks(self):
        """The Fourier ring disk(rad_out) - disk(rad_in) centred at
        (h/2, w/2), fftshifted and restricted to the rfft2 half-plane
        (columns 0..w//2), and the optional real-space mask that blanks
        a disk before the FFT; as tensors on the run's device."""
        key = (self.meta.sig_shape, str(self.meta.device))
        if self._mask_key == key:
            return self._masks
        from ..masks import circular

        h, w = self.meta.sig_shape
        out = circular(w * 0.5, h * 0.5, w, h,
                       self.params.rad_out).astype(np.float32)
        inn = circular(w * 0.5, h * 0.5, w, h,
                       self.params.rad_in).astype(np.float32)
        fmask = np.fft.fftshift(out - inn)
        # the full-plane fft2 equals rfft2 on columns 0..w//2; zero the
        # conjugate columns so the half-plane sum matches
        fmask[:, w // 2 + 1:] = 0.0
        real_mask = None
        rc, rr = self.params.real_center, self.params.real_rad
        if rc is not None and rr is not None:
            real_mask = torch.from_numpy(1.0 - circular(
                rc[1], rc[0], w, h, rr
            ).astype(np.float32)).to(self.meta.device)
        self._masks = (
            torch.from_numpy(np.ascontiguousarray(fmask)).to(
                self.meta.device
            ),
            real_mask,
        )
        self._mask_key = key
        return self._masks

    def process_tile(self, tile):
        fmask, real_mask = self._get_masks()
        frames = tile.to(torch.float32)
        if real_mask is not None:
            frames = frames * real_mask
        spec = torch.fft.fft2(frames).abs()
        self.results.intensity += (spec * fmask).sum(dim=(1, 2))


def run_analysis_crystall(ctx, dataset, rad_in, rad_out, real_center=None,
                          real_rad=None, roi=None, progress=False):
    """:class:`CrystallinityUDF` over ``dataset``: its result buffers by
    name."""
    return ctx.run_udf(
        dataset,
        CrystallinityUDF(rad_in=rad_in, rad_out=rad_out,
                         real_center=real_center, real_rad=real_rad),
        roi=roi, progress=progress)
