"""FFT analyses: a Fourier-space ring per frame (APPLY_FFT_MASK), the
spectrum of a picked frame (PICK_FFT_FRAME) and of the sum of frames
(FFTSUM_FRAMES); counterpart of ``libertem_tpu/analysis/fft.py``.

The per-frame spectra are one batched ``torch.fft.fft2`` of the tile
on the device; the other two post-process one frame with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..udf.base import UDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis
from .raw import PickFrameAnalysis
from .sum import SumAnalysis


def _fft_ring_mask(sig_shape, rad_in, rad_out) -> np.ndarray:
    """The ring rad_in < d <= rad_out around the centre of the shifted
    spectrum, in unshifted (fft) layout."""
    h, w = sig_shape
    y, x = np.ogrid[0:h, 0:w]
    d = np.sqrt((y - h // 2) ** 2 + (x - w // 2) ** 2)
    sel = (d > rad_in) & (d <= rad_out)
    return np.fft.ifftshift(sel).astype(np.float32)


def _real_aperture(sig_shape, real_rad, real_cy, real_cx):
    """A real-space mask that blocks the zero-order disk: 1 - disk; None
    without all three parameters."""
    if real_rad is None or real_cy is None or real_cx is None:
        return None
    h, w = sig_shape
    y, x = np.ogrid[0:h, 0:w]
    return 1.0 - (
        ((y - real_cy) ** 2 + (x - real_cx) ** 2) <= real_rad ** 2
    ).astype(np.float32)


class ApplyFFTMaskUDF(UDF):
    """sum(|FFT(aperture * frame)| * fourier_ring) per frame."""

    def __init__(self, rad_in, rad_out, real_rad=None, real_centery=None,
                 real_centerx=None):
        super().__init__(rad_in=rad_in, rad_out=rad_out, real_rad=real_rad,
                         real_centery=real_centery,
                         real_centerx=real_centerx)
        self._masks = None

    def get_result_buffers(self):
        return {"intensity": self.buffer(kind="nav", dtype="float32")}

    def get_tiling_preferences(self):
        # a spectrum needs the whole frame
        return {"whole_frames": True, "depth": self.TILE_DEPTH_DEFAULT,
                "total_size": self.TILE_SIZE_MAX}

    def on_params_updated(self):
        self._masks = None

    def _get_masks(self, device):
        if self._masks is None or self._masks[0].device != device:
            sig = self.meta.sig_shape
            ring = torch.from_numpy(_fft_ring_mask(
                sig, self.params.rad_in, self.params.rad_out)).to(device)
            ap = _real_aperture(sig, self.params.real_rad,
                                self.params.real_centery,
                                self.params.real_centerx)
            self._masks = (ring, None if ap is None
                           else torch.from_numpy(ap).to(device))
        return self._masks

    def process_tile(self, tile):
        ring, aperture = self._get_masks(tile.device)
        x = tile.to(torch.float32)
        if aperture is not None:
            x = x * aperture
        spec = torch.fft.fft2(x).abs()
        self.results.intensity += (spec * ring).sum(dim=(1, 2))


class ApplyFFTMask(BaseAnalysis, id_="APPLY_FFT_MASK"):
    def get_udf(self):
        p = self.parameters
        return ApplyFFTMaskUDF(
            rad_in=p["rad_in"], rad_out=p["rad_out"],
            real_rad=p.get("real_rad"),
            real_centery=p.get("real_centery"),
            real_centerx=p.get("real_centerx"),
        )

    def get_udf_results(self, udf_results, roi, damage):
        data = udf_results["intensity"].data
        dmg = self.nav_damage(damage)
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(data, damage=dmg),
                key="intensity", title="intensity",
                desc="Fourier-space ring intensity per scan position",
            ),
        ], raw_results=udf_results)


def _spectrum(frame: np.ndarray, p: dict) -> np.ndarray:
    """The shifted magnitude spectrum of a float64 frame, behind the
    parameters' real-space aperture when they give one."""
    ap = _real_aperture(frame.shape, p.get("real_rad"),
                        p.get("real_centery"), p.get("real_centerx"))
    if ap is not None:
        frame = frame * ap
    return np.fft.fftshift(np.abs(np.fft.fft2(frame)))


class PickFFTFrameAnalysis(PickFrameAnalysis, id_="PICK_FFT_FRAME"):
    def get_udf_results(self, udf_results, roi, damage):
        fft = _spectrum(np.asarray(udf_results["intensity"].data,
                                   dtype=np.float64)[0], self.parameters)
        coords_str = ", ".join(str(c) for c in self.get_coords())
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=fft,
                visualized=lambda: visualize_simple(fft, logarithmic=True),
                key="intensity", title=f"FFT of frame ({coords_str})",
                desc="magnitude spectrum of the selected frame",
            ),
        ], raw_results=udf_results)


class SumfftAnalysis(SumAnalysis, id_="FFTSUM_FRAMES"):
    def get_udf_results(self, udf_results, roi, damage):
        fft = _spectrum(np.asarray(udf_results["intensity"].data,
                                   dtype=np.float64), self.parameters)
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=fft,
                visualized=lambda: visualize_simple(fft, logarithmic=True),
                key="intensity", title="FFT of the sum of frames",
                desc="magnitude spectrum of the summed frames",
            ),
        ], raw_results=udf_results)
