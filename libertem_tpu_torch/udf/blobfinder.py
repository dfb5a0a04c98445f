"""Correlation peak finding, the basis of strain mapping (counterpart
of ``libertem_tpu/udf/blobfinder.py``).

Each frame is cross-correlated with a match pattern on the device on
the real half-spectrum: one batched ``torch.fft.rfft2`` of the block,
a product in place with the conjugate half-spectrum of the centred
template (the inverse's 1/(h w) folded in), one unscaled ``irfft2``,
then

* :class:`FullFrameCorrelationUDF`: the argmax over the whole map per
  frame, refined by the centre of mass of its 3x3 neighbourhood
  (clipped at the border);
* :class:`SparseCorrelationUDF`: per expected peak, the argmax and the
  centre of mass of a (2 steps + 1)^2 window around it; the windows
  wrap around the border, as the correlation does.

The template spectrum and the windows are numpy arrays made once, as
in the JAX package, and kept as device tensors until the parameters
change (``on_params_updated``); both UDFs take the device spectrum
from ``_half_spectrum``.  Both UDFs need whole frames, and run
on the generic device path.  Each block's correlation is the span
``libertem.correlate`` and what follows it ``libertem.refine``
(``common/tracing.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import masks as mask_lib
from ..common.exceptions import UDFException
from ..common.tracing import udf_span
from .base import UDF


class MatchPattern:
    """A correlation template, rendered into its conjugate spectrum."""

    def __init__(self, search: float = 10.0):
        self.search = search

    def get_mask(self, sig_shape) -> np.ndarray:
        raise NotImplementedError()

    def get_template_spectrum(self, sig_shape) -> np.ndarray:
        """conj(FFT(template centred at (0, 0))), complex64: the
        correlation peaks land on the pattern's positions."""
        mask = self.get_mask(sig_shape)
        return np.conj(
            np.fft.fft2(np.fft.ifftshift(mask))
        ).astype(np.complex64)


class Disk(MatchPattern):
    def __init__(self, radius: float, search: Optional[float] = None):
        super().__init__(search or 2 * radius)
        self.radius = radius

    def get_mask(self, sig_shape):
        h, w = sig_shape
        return mask_lib.circular(
            w // 2, h // 2, w, h, self.radius, antialiased=True
        )


class RadialGradient(MatchPattern):
    def __init__(self, radius: float, search: Optional[float] = None):
        super().__init__(search or 2 * radius)
        self.radius = radius

    def get_mask(self, sig_shape):
        h, w = sig_shape
        return mask_lib.radial_gradient(
            w // 2, h // 2, w, h, self.radius, antialiased=True
        )


class BackgroundSubtraction(MatchPattern):
    def __init__(self, radius: float, radius_outer: float,
                 search: Optional[float] = None):
        super().__init__(search or radius_outer)
        self.radius = radius
        self.radius_outer = radius_outer

    def get_mask(self, sig_shape):
        h, w = sig_shape
        return mask_lib.background_subtraction(
            w // 2, h // 2, w, h, self.radius_outer, self.radius,
            antialiased=True,
        )


def _subpixel_refine(corr, iy, ix):
    """Per frame of ``corr`` (d, h, w), the centre of mass of the 3x3
    window (clipped at the border) around (iy, ix), less the window's
    minimum: float32 (y, x), each (d,)."""
    h, w = corr.shape[-2:]
    o = torch.arange(-1, 2, device=corr.device)
    yy = (iy[:, None] + o).clamp(0, h - 1)  # (d, 3)
    xx = (ix[:, None] + o).clamp(0, w - 1)
    frames = torch.arange(corr.shape[0], device=corr.device)
    window = corr[frames[:, None, None], yy[:, :, None], xx[:, None, :]]
    window = window - window.amin(dim=(1, 2), keepdim=True)
    total = window.sum(dim=(1, 2)).clamp_min(1e-12)
    of = o.to(corr.dtype)
    dy = (window * of[:, None]).sum(dim=(1, 2)) / total
    dx = (window * of[None, :]).sum(dim=(1, 2)) / total
    return iy.to(torch.float32) + dy, ix.to(torch.float32) + dx


def _half_spectrum(match_pattern, sig_shape, device) -> torch.Tensor:
    """``conj(rfft2(template)) / (h * w)``, complex64 (h, w // 2 + 1) on
    ``device``: the first half of the template's conjugate spectrum
    (its other half is the mirror, the template being real), with the
    inverse transform's 1/(h w) folded in."""
    h, w = sig_shape
    spectrum = match_pattern.get_template_spectrum(sig_shape)
    return torch.from_numpy(np.ascontiguousarray(
        spectrum[..., : w // 2 + 1] / (h * w), dtype=np.complex64)
    ).to(device)


def _correlate(tile, spectrum):
    """The real circular cross-correlation of each frame of ``tile``
    with the template of ``spectrum`` (``_half_spectrum``'s): (d, h, w)
    float32."""
    h, w = tile.shape[-2:]
    f = torch.fft.rfft2(tile.to(torch.float32))
    f.mul_(spectrum)
    # the 1/(h w) is in the spectrum: the inverse runs unscaled
    return torch.fft.irfft2(f, s=(h, w), norm="forward")


class FullFrameCorrelationUDF(UDF):
    """The strongest correlation peak of each frame: its position, its
    subpixel refinement and its value."""

    def __init__(self, match_pattern: MatchPattern, **kwargs):
        super().__init__(match_pattern=match_pattern, **kwargs)
        self._spectrum = None

    def on_params_updated(self):
        self._spectrum = None

    def get_backends(self):
        return (self.BACKEND_TORCH,)

    def get_result_buffers(self):
        return {
            "centers": self.buffer(kind="nav", extra_shape=(2,),
                                   dtype="float32"),
            "refineds": self.buffer(kind="nav", extra_shape=(2,),
                                    dtype="float32"),
            "peak_values": self.buffer(kind="nav", dtype="float32"),
        }

    def _require_whole_sig(self):
        """A sig-split scheme (forced by a co-running UDF's small tiles)
        would correlate parts of frames: refuse it."""
        if tuple(self.meta.sig_slice.shape) != tuple(self.meta.sig_shape):
            raise UDFException(
                f"{type(self).__name__} needs whole frames but the "
                "tiling scheme splits sig (a co-running UDF requested "
                "small tiles?); run it in its own pass"
            )

    def get_tiling_preferences(self):
        return {"whole_frames": True,
                "depth": self.TILE_DEPTH_DEFAULT,
                "total_size": self.TILE_SIZE_MAX}

    def _get_spectrum(self, device) -> torch.Tensor:
        if self._spectrum is None or self._spectrum.device != device:
            self._spectrum = _half_spectrum(
                self.params.match_pattern, self.meta.sig_shape, device)
        return self._spectrum

    def process_tile(self, tile):
        self._require_whole_sig()
        with udf_span("libertem.correlate"):
            corr = _correlate(tile, self._get_spectrum(tile.device))
        with udf_span("libertem.refine"):
            w = corr.shape[-1]
            flat = corr.reshape(corr.shape[0], -1)
            flat_idx = torch.argmax(flat, dim=-1)  # the first maximum
            iy = flat_idx // w
            ix = flat_idx % w
            ref_y, ref_x = _subpixel_refine(corr, iy, ix)
            self.results.centers = torch.stack([iy, ix], dim=-1).to(
                torch.float32)
            self.results.refineds = torch.stack([ref_y, ref_x], dim=-1)
            self.results.peak_values = flat.amax(dim=-1)


class SparseCorrelationUDF(UDF):
    """Per frame and per expected peak (``peaks``, (n, 2) y, x), the
    correlation maximum within +-``steps`` pixels, its window's centre
    of mass and its value."""

    def __init__(self, match_pattern: MatchPattern,
                 peaks: np.ndarray, steps: int = 5, **kwargs):
        peaks = np.asarray(peaks, dtype=np.int32)
        super().__init__(
            match_pattern=match_pattern, peaks=peaks, steps=steps,
            **kwargs,
        )
        self._plan = None

    def on_params_updated(self):
        self._plan = None

    def get_backends(self):
        return (self.BACKEND_TORCH,)

    def get_result_buffers(self):
        n = len(self._kwargs["peaks"])
        return {
            "centers": self.buffer(kind="nav", extra_shape=(n, 2),
                                   dtype="float32"),
            "refineds": self.buffer(kind="nav", extra_shape=(n, 2),
                                    dtype="float32"),
            "peak_values": self.buffer(kind="nav", extra_shape=(n,),
                                       dtype="float32"),
        }

    _require_whole_sig = FullFrameCorrelationUDF._require_whole_sig

    def get_tiling_preferences(self):
        return {"whole_frames": True,
                "depth": self.TILE_DEPTH_DEFAULT,
                "total_size": self.TILE_SIZE_MAX}

    def _get_plan(self, device) -> dict:
        """The template spectrum, the windows' flat pixel indices
        (n_peaks, size^2) and the peaks, as tensors on ``device``."""
        if self._plan is None or self._plan["spectrum"].device != device:
            steps = int(self.params.steps)
            h, w = self.meta.sig_shape
            peaks = np.asarray(self.params.peaks)
            offs = np.arange(-steps, steps + 1)
            # the correlation is circular, so the windows wrap: clipping
            # would repeat border cells and break the map from the
            # argmax's position to its offset
            win_y = (peaks[:, 0:1, None] + offs[None, :, None]) % h
            win_x = (peaks[:, 1:2, None] + offs[None, None, :]) % w
            flat = (win_y * w + win_x).reshape(len(peaks), -1)
            self._plan = {
                "spectrum": _half_spectrum(
                    self.params.match_pattern, self.meta.sig_shape,
                    device),
                "windows": torch.from_numpy(
                    flat.astype(np.int64)).to(device),
                "peaks": torch.from_numpy(
                    peaks.astype(np.float32)).to(device),
            }
        return self._plan

    def process_tile(self, tile):
        self._require_whole_sig()
        plan = self._get_plan(tile.device)
        steps = int(self.params.steps)
        size = 2 * steps + 1
        with udf_span("libertem.correlate"):
            corr = _correlate(tile, plan["spectrum"])
        with udf_span("libertem.refine"):
            # (depth, n_peaks, size^2) windows around the expected peaks
            wins = corr.reshape(corr.shape[0], -1)[:, plan["windows"]]
            idx = torch.argmax(wins, dim=-1)
            dy = (idx // size).to(torch.float32) - steps
            dx = (idx % size).to(torch.float32) - steps
            peaks = plan["peaks"][None]
            self.results.centers = peaks + torch.stack([dy, dx], dim=-1)
            # subpixel: the window's centre of mass, less its minimum
            w0 = wins - wins.amin(dim=-1, keepdim=True)
            total = w0.sum(dim=-1).clamp_min(1e-12)
            g = torch.arange(size, dtype=torch.float32,
                             device=corr.device) - steps
            ry = (w0 * g.repeat_interleave(size)).sum(dim=-1) / total
            rx = (w0 * g.repeat(size)).sum(dim=-1) / total
            self.results.refineds = peaks + torch.stack([ry, rx], dim=-1)
            self.results.peak_values = wins.amax(dim=-1)


def run_blobfinder(ctx, dataset, match_pattern: MatchPattern,
                   peaks: Optional[np.ndarray] = None, steps: int = 5,
                   roi=None):
    """The full-frame correlation without expected ``peaks``, else the
    sparse one around them."""
    if peaks is None:
        udf = FullFrameCorrelationUDF(match_pattern=match_pattern)
    else:
        udf = SparseCorrelationUDF(
            match_pattern=match_pattern, peaks=peaks, steps=steps,
        )
    return ctx.run_udf(dataset, udf, roi=roi)


def fit_lattice(refineds, peaks, zero, a, b):
    """Per frame, the least-squares affine lattice (zero', a', b') with
    pos_k = zero' + h_k a' + k_k b', where (h_k, k_k) are the integer
    indices of ``peaks`` in the nominal lattice (zero, a, b).  Returns
    per-frame ``zero``, ``a``, ``b`` (each (..., 2)), the relative
    length changes ``da_rel`` and ``db_rel``, and ``rotation`` (of a,
    radians)."""
    refineds = np.asarray(refineds, dtype=np.float64)
    peaks = np.asarray(peaks, dtype=np.float64)
    zero = np.asarray(zero, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    nav_shape = refineds.shape[:-2]
    n_peaks = refineds.shape[-2]
    flat = refineds.reshape(-1, n_peaks, 2)

    M = np.stack([a, b], axis=-1)  # (2, 2), columns a and b
    hk = np.round(np.linalg.solve(M, (peaks - zero).T).T)  # (n_peaks, 2)

    # pos = A @ [zero_y zero_x a_y a_x b_y b_x]
    A = np.zeros((n_peaks * 2, 6))
    for k in range(n_peaks):
        h, kk = hk[k]
        A[2 * k] = [1, 0, h, 0, kk, 0]
        A[2 * k + 1] = [0, 1, 0, h, 0, kk]
    rhs = flat.reshape(-1, n_peaks * 2).T  # (n_peaks * 2, n_frames)
    sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    sol = sol.T  # (n_frames, 6)
    la = np.linalg.norm(a)
    lb = np.linalg.norm(b)
    return {
        "zero": sol[:, 0:2].reshape(nav_shape + (2,)),
        "a": sol[:, 2:4].reshape(nav_shape + (2,)),
        "b": sol[:, 4:6].reshape(nav_shape + (2,)),
        "da_rel": (np.linalg.norm(sol[:, 2:4], axis=-1) / max(la, 1e-12)
                   - 1.0).reshape(nav_shape),
        "db_rel": (np.linalg.norm(sol[:, 4:6], axis=-1) / max(lb, 1e-12)
                   - 1.0).reshape(nav_shape),
        "rotation": (np.arctan2(sol[:, 2], sol[:, 3])
                     - np.arctan2(a[0], a[1])).reshape(nav_shape),
    }
