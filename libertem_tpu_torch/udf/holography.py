"""Off-axis electron holography reconstruction (counterpart of
``libertem_tpu/udf/holography.py``):

    wave = IFFT(aperture * crop(FFT(hologram) shifted to the sideband))

On the device, per block: one batched ``torch.fft.fft2``, the crop of
the rows and columns around the sideband (one index per axis, which is
the JAX package's roll followed by its crop), the aperture product and
one ``ifft2``.  The aperture is a numpy array made once and kept as a
device tensor until the parameters change (``on_params_updated``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import UDF


def estimate_sideband_position(
    holo: np.ndarray, central_band_mask_radius: Optional[float] = None,
) -> tuple:
    """(y, x) of the strongest sideband in FFT coordinates: the carrier
    peak of the upper half-plane outside the masked central band."""
    holo = np.asarray(holo, dtype=np.float64)
    h, w = holo.shape
    spec = np.abs(np.fft.fft2(holo))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fy ** 2 + fx ** 2)
    if central_band_mask_radius is None:
        central_band_mask_radius = 0.05
    spec = np.where(r > central_band_mask_radius, spec, 0.0)
    # the sidebands are a conjugate pair
    spec[h // 2:, :] = 0.0
    iy, ix = np.unravel_index(np.argmax(spec), spec.shape)
    return int(iy), int(ix)


def estimate_sideband_size(sb_position, holo_shape,
                           fraction: float = 0.5) -> float:
    """Aperture radius: ``fraction`` of the sideband's distance from the
    origin, in FFT pixels."""
    h, w = holo_shape
    dy = min(sb_position[0], h - sb_position[0])
    dx = min(sb_position[1], w - sb_position[1])
    return float(np.hypot(dy, dx) * fraction)


def _aperture(shape, radius, smoothness: float = 0.05) -> np.ndarray:
    """A smoothed circular aperture centred at index (0, 0) of the FFT
    layout, float32."""
    h, w = shape
    fy = np.fft.fftfreq(h) * h
    fx = np.fft.fftfreq(w) * w
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    edge = max(1.0, smoothness * radius)
    ap = np.clip((radius - r) / edge + 0.5, 0.0, 1.0)
    return ap.astype(np.float32)


def _crop_index(n: int, out: int, shift: int) -> np.ndarray:
    """The indices of an FFT axis of length ``n`` that the crop to
    ``out`` keeps after a roll by ``-shift``: the first ceil(out / 2)
    and the last floor(out / 2) positions of the rolled axis."""
    keep = np.concatenate([
        np.arange(out // 2 + out % 2), np.arange(n - out // 2, n),
    ])
    return (keep + shift) % n


class HoloReconstructUDF(UDF):
    """Complex object waves from off-axis holograms.

    Parameters
    ----------
    out_shape : (int, int)
        The wave's shape, at most the frame's: the sideband is cropped
        in Fourier space (the wave downsampled).  None: the frame's.
    sb_position : (int, int)
        The sideband's position in the FFT of the full frame
        (:func:`estimate_sideband_position`).
    sb_size : float
        Aperture radius in FFT pixels (:func:`estimate_sideband_size`).
    sb_smoothness : float
        The aperture's edge width as a fraction of sb_size.
    """

    def __init__(self, out_shape=None, sb_position=None,
                 sb_size=None, sb_smoothness=0.05):
        if sb_position is None or sb_size is None:
            raise ValueError(
                "sb_position and sb_size are required (see "
                "estimate_sideband_position/size)"
            )
        super().__init__(
            out_shape=tuple(out_shape) if out_shape else None,
            sb_position=tuple(int(v) for v in sb_position),
            sb_size=float(sb_size),
            sb_smoothness=float(sb_smoothness),
        )
        self._plan = None

    def on_params_updated(self):
        self._plan = None

    def get_backends(self):
        return (self.BACKEND_TORCH,)

    def _get_out_shape(self):
        if self.params.out_shape is not None:
            oh, ow = self.params.out_shape
            sh, sw = self.meta.sig_shape
            if oh > sh or ow > sw:
                # a larger crop would repeat frequency rows or columns
                raise ValueError(
                    f"out_shape {(oh, ow)} exceeds the frame shape "
                    f"{(sh, sw)}; the sideband crop can only "
                    "downsample"
                )
            return self.params.out_shape
        return self.meta.sig_shape

    def get_result_buffers(self):
        return {
            "wave": self.buffer(
                kind="nav", extra_shape=self._get_out_shape(),
                dtype="complex64",
            ),
        }

    def get_tiling_preferences(self):
        return {"whole_frames": True,
                "depth": self.TILE_DEPTH_DEFAULT,
                "total_size": self.TILE_SIZE_MAX}

    def _get_plan(self, device) -> dict:
        if self._plan is None or self._plan["aperture"].device != device:
            oh, ow = self._get_out_shape()
            sy, sx = self.params.sb_position
            h, w = self.meta.sig_shape
            self._plan = {
                "aperture": torch.from_numpy(_aperture(
                    (oh, ow), self.params.sb_size,
                    self.params.sb_smoothness)).to(device),
                "rows": torch.from_numpy(_crop_index(h, oh, sy)).to(device),
                "cols": torch.from_numpy(_crop_index(w, ow, sx)).to(device),
            }
        return self._plan

    def process_tile(self, tile):
        plan = self._get_plan(tile.device)
        spec = torch.fft.fft2(tile.to(torch.float32))
        spec = spec.index_select(-2, plan["rows"]).index_select(
            -1, plan["cols"])
        self.results.wave = torch.fft.ifft2(spec * plan["aperture"]).to(
            torch.complex64)
