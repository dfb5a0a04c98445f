"""CoMUDF: centre of mass (counterpart of ``libertem_tpu/udf/com.py``).

Device side: three projections per frame (total, y-weighted,
x-weighted), on the fused path as rows of the fused mask stack, on the
generic path as a float32 matmul of the tile with the stack.  Every
derived field (shifts, rotation/flip correction, regression,
magnitude, divergence, curl) is computed on the host in
``get_results``, in float64 numpy, as are the module's helpers
(``guess_corrections``, ``apply_correction``, ``divergence`` ...).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..masks import circular, gradient_x, gradient_y
from .base import UDF
from .masks import TileOperand


class RegressionOptions:
    NO_REGRESSION = -1
    SUBTRACT_MEAN = 0
    SUBTRACT_LINEAR = 1


@dataclass
class CoMParams:
    cy: Optional[float] = None
    cx: Optional[float] = None
    r: Optional[float] = None      # outer mask radius (None = whole frame)
    ri: Optional[float] = None     # inner radius (annular CoM)
    scan_rotation: float = 0.0
    flip_y: bool = False
    regression: int = RegressionOptions.NO_REGRESSION


def apply_com_correction(sy, sx, scan_rotation, flip_y):
    """Flip-then-rotate shift correction: flip_y negates y, then the
    (y, x) vector is rotated with R = [[cos, sin], [-sin, cos]]."""
    theta = np.deg2rad(scan_rotation)
    if flip_y:
        sy = -sy
    y_corr = sy * np.cos(theta) + sx * np.sin(theta)
    x_corr = -sy * np.sin(theta) + sx * np.cos(theta)
    return y_corr, x_corr


def com_masks(sig_shape, cy, cx, r=None, ri=None) -> np.ndarray:
    """(3, *sig) stack: [total, y-weighted, x-weighted]."""
    h, w = sig_shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    d2 = (y - cy) ** 2 + (x - cx) ** 2
    if r is not None:
        base = (d2 <= r ** 2).astype(np.float32)
    else:
        base = np.ones((h, w), dtype=np.float32)
    if ri is not None and ri > 0:
        # annulus: keep d > ri
        base *= (d2 > ri ** 2).astype(np.float32)
    return np.stack([base, y * base, x * base], axis=0)


class CoMUDF(UDF):
    def __init__(self, com_params: Optional[CoMParams] = None):
        super().__init__(com_params=com_params or CoMParams())
        self._operand = TileOperand()

    @classmethod
    def with_params(cls, cy=None, cx=None, r=None, ri=None,
                    scan_rotation=0.0, flip_y=False,
                    regression=RegressionOptions.NO_REGRESSION,
                    ) -> "CoMUDF":
        if r is not None and ri is not None and ri >= r:
            raise ValueError(
                "inner radius must be less than the outer radius"
            )
        return cls(CoMParams(
            cy=cy, cx=cx, r=r, ri=ri, scan_rotation=scan_rotation,
            flip_y=flip_y, regression=regression,
        ))

    def get_result_buffers(self):
        if self.meta.dataset_shape.sig.dims != 2:
            raise ValueError("CoMUDF only works with 2D sig shape.")
        if self.meta.dataset_shape.nav.dims != 2:
            raise ValueError("CoMUDF only works with 2D nav shape.")
        self._regression_requested()
        # complex data gives complex centres and shifts: the dtype of
        # result_type(input, float32), complex128 clamped to complex64
        dtype = np.result_type(self.meta.input_dtype, np.float32)
        dtype = np.dtype(np.complex64 if dtype.kind == "c" else np.float32)
        return {
            "raw_mask_result": self.buffer(
                kind="nav", extra_shape=(3,), dtype=dtype, use="private",
            ),
            "raw_com": self.buffer(
                kind="nav", extra_shape=(2,), dtype=dtype,
                use="result_only",
            ),
            "raw_shifts": self.buffer(
                kind="nav", extra_shape=(2,), dtype=dtype,
                use="result_only",
            ),
            "field": self.buffer(
                kind="nav", extra_shape=(2,), dtype=dtype,
                use="result_only",
            ),
            "field_y": self.buffer(kind="nav", dtype=dtype,
                                   use="result_only"),
            "field_x": self.buffer(kind="nav", dtype=dtype,
                                   use="result_only"),
            "magnitude": self.buffer(kind="nav", dtype=dtype,
                                     use="result_only"),
            "divergence": self.buffer(kind="nav", dtype=dtype,
                                      use="result_only"),
            "curl": self.buffer(kind="nav", dtype=dtype,
                                use="result_only"),
            "regression": self.buffer(
                kind="single", extra_shape=(3, 2), use="result_only",
            ),
        }

    def _regression_requested(self) -> bool:
        """Whether a regression applies: a given array always does,
        ``NO_REGRESSION`` never; an unknown int raises."""
        mode = self.params.com_params.regression
        if not isinstance(mode, (int, np.integer)):
            return True
        if mode not in (RegressionOptions.NO_REGRESSION,
                        RegressionOptions.SUBTRACT_MEAN,
                        RegressionOptions.SUBTRACT_LINEAR):
            raise ValueError(f"unrecognized regression option {mode!r}")
        return mode != RegressionOptions.NO_REGRESSION

    def _center(self):
        p: CoMParams = self.params.com_params
        h, w = self.meta.sig_shape
        # the default centre is the integer h // 2, not (h - 1) / 2
        cy = p.cy if p.cy is not None else h // 2
        cx = p.cx if p.cx is not None else w // 2
        return cy, cx

    def _stack(self) -> np.ndarray:
        p: CoMParams = self.params.com_params
        cy, cx = self._center()
        return com_masks(self.meta.sig_shape, cy, cx, p.r, p.ri)

    def process_tile(self, tile):
        # complex data: complex projections
        cplx = tile.is_complex()
        flat = tile.reshape(tile.shape[0], -1).to(
            torch.complex64 if cplx else torch.float32)
        self.results.raw_mask_result += flat @ self._operand.get(
            self._stack, self.meta, np.complex64 if cplx else np.float32
        )

    def get_results(self):
        p: CoMParams = self.params.com_params
        cy, cx = self._center()
        raw = np.asarray(self.results.raw_mask_result)
        is_c = raw.dtype.kind == "c"
        work_dt = np.complex128 if is_c else np.float64
        out_dt = np.complex64 if is_c else np.float32
        raw = raw.astype(work_dt)
        # zero-sum frames report the reference centre (zero shift)
        nz = raw[:, 0] != 0
        com_y = np.full(raw.shape[0], cy, dtype=work_dt)
        com_x = np.full(raw.shape[0], cx, dtype=work_dt)
        np.divide(raw[:, 1], raw[:, 0], out=com_y, where=nz)
        np.divide(raw[:, 2], raw[:, 0], out=com_x, where=nz)
        raw_com = np.stack([com_y, com_x], axis=-1).astype(out_dt)
        raw_shifts = np.stack(
            [com_y - cy, com_x - cx], axis=-1
        ).astype(out_dt)
        # every derived field is a function of the stored shifts
        y_corr, x_corr = apply_com_correction(
            raw_shifts[..., 0].astype(work_dt),
            raw_shifts[..., 1].astype(work_dt),
            p.scan_rotation, p.flip_y,
        )
        # a plane through complex shifts means nothing: no regression
        # on complex data, and the buffer is marked invalid
        regression = np.zeros((3, 2), dtype=np.float32)
        want_regression = self._regression_requested() and not is_c
        if want_regression:
            y_corr, x_corr, regression = self._regress(
                y_corr, x_corr, p.regression)
        div, curl = self._div_curl(y_corr, x_corr)
        return {
            "raw_com": raw_com,
            "raw_shifts": raw_shifts,
            "field": np.stack([y_corr, x_corr], axis=-1).astype(out_dt),
            "field_y": y_corr.astype(out_dt),
            "field_x": x_corr.astype(out_dt),
            "magnitude": np.sqrt(y_corr ** 2 + x_corr ** 2).astype(out_dt),
            "divergence": div,
            "curl": curl,
            "regression": self.with_mask(regression,
                                         mask=want_regression),
        }

    def _nav_sel(self) -> np.ndarray:
        """The roi over the flat nav (every position without one)."""
        roi = self.meta.roi
        if roi is None:
            return np.ones(self.meta.dataset_shape.nav.size, dtype=bool)
        return roi.reshape(-1)

    def _embed_nav2d(self, flat) -> np.ndarray:
        """roi-compressed flat values on the full 2-D nav grid, nan
        outside the roi, in float64 (complex128)."""
        sel = self._nav_sel()
        is_c = np.asarray(flat).dtype.kind == "c"
        full = np.full(sel.size, np.nan,
                       dtype=np.complex128 if is_c else np.float64)
        full[sel] = flat
        return full.reshape(tuple(self.meta.dataset_shape.nav))

    def _compress_nav2d(self, grid) -> np.ndarray:
        return grid.reshape(-1)[self._nav_sel()]

    def _div_curl(self, y_corr, x_corr):
        """Divergence and curl on the 2-D nav grid; with a roi, the
        roi-compressed fields are embedded with nan gaps first (so a
        neighbour outside the roi gives nan), and compressed again."""
        nav_shape = tuple(self.meta.dataset_shape.nav)
        is_c = np.asarray(y_corr).dtype.kind == "c"
        out_dt = np.complex64 if is_c else np.float32
        if min(nav_shape) < 2:
            nanbuf = np.full(y_corr.shape[0], np.nan, dtype=out_dt)
            return nanbuf, nanbuf.copy()
        dy_dy, dy_dx = np.gradient(self._embed_nav2d(y_corr))
        dx_dy, dx_dx = np.gradient(self._embed_nav2d(x_corr))
        div = self._compress_nav2d((dy_dy + dx_dx).astype(out_dt))
        # curl_2d = dFy/dx - dFx/dy
        curl = self._compress_nav2d((dy_dx - dx_dy).astype(out_dt))
        return div, curl

    def _valid_nav2d(self) -> np.ndarray:
        """The 2-D nav positions both merged so far and inside the roi
        (the whole roi where no merge state is set)."""
        vm = self.meta.get_valid_nav_mask(full_nav=True)
        if vm is None:
            vm = np.zeros(self.meta.dataset_shape.nav.size, dtype=bool)
            vm[self._nav_sel()] = True
        return vm.reshape(tuple(self.meta.dataset_shape.nav))

    def _regress(self, y_corr, x_corr, mode):
        """Fit a constant (SUBTRACT_MEAN) or a plane (SUBTRACT_LINEAR)
        per component on the valid nav positions, or take the given
        (3, 2) coefficients, and subtract it there; positions not valid
        are neither fitted nor changed.  Returns the corrected
        components and the (3, 2) coefficients: rows (intercept,
        d/drow, d/dcol), columns (y, x)."""
        nav_shape = tuple(self.meta.dataset_shape.nav)
        regression = np.zeros((3, 2), dtype=np.float32)
        y2d = self._embed_nav2d(y_corr)
        x2d = self._embed_nav2d(x_corr)
        rows, cols = np.mgrid[0:nav_shape[0], 0:nav_shape[1]]
        valid = self._valid_nav2d() & np.isfinite(y2d) & np.isfinite(x2d)
        given = None
        if not isinstance(mode, (int, np.integer)):
            given = np.asarray(mode, dtype=np.float64)
            if given.shape != (3, 2):
                raise ValueError(
                    f"regression parameter {mode!r} doesn't have the "
                    f"required shape (3, 2)"
                )
            regression[:] = given
        elif valid.sum() < 3:
            return y_corr, x_corr, regression
        for ci, comp2d in enumerate((y2d, x2d)):
            if given is not None:
                coef = given[:, ci]
            elif mode == RegressionOptions.SUBTRACT_MEAN:
                coef = np.array([comp2d[valid].mean()])
            else:
                a = np.stack([np.ones(valid.sum()), rows[valid],
                              cols[valid]], axis=-1)
                coef, *_ = np.linalg.lstsq(a, comp2d[valid], rcond=None)
            if given is None:
                regression[:len(coef), ci] = coef
            if len(coef) > 1 and not np.allclose(coef[1:], 0):
                fit = coef[0] + coef[1] * rows + coef[2] * cols
            else:
                fit = np.full(nav_shape, coef[0])
            comp2d[valid] -= fit[valid]
        return (self._compress_nav2d(y2d), self._compress_nav2d(x2d),
                regression)

    def fused_moments_spec(self):
        """Join the fused pass with the 3-row CoM mask stack."""
        return {
            "mode": "masks",
            "operand": self._stack().reshape(3, -1).astype(np.float32),
            "name": "raw_mask_result",
        }


# -- the CoM helpers of the public API, in float64 numpy ------------------

class GuessResult(NamedTuple):
    """A guess of the CoM parameters; unpacks positionally, and reads
    like a mapping too (``guess["cy"]``, ``dict(guess)``)."""

    scan_rotation: float
    flip_y: bool
    cy: float
    cx: float

    def __getitem__(self, k):
        if isinstance(k, str):
            return getattr(self, k)
        return tuple.__getitem__(self, k)

    def keys(self):
        return self._fields

    def get(self, k, default=None):
        return getattr(self, k, default)

    def __contains__(self, k):
        return k in self._fields


def guess_corrections(y_centers, x_centers, roi=None) -> GuessResult:
    """Guess scan_rotation, flip_y and the centre from CoM fields: the
    rotation (0..359) and flip with the least RMS curl, then the
    180-degree ambiguity resolved by the divergence's polarity (the
    beam deflects towards nuclei, so the divergence skews negative)."""
    y2d = np.asarray(y_centers, dtype=np.float64)
    x2d = np.asarray(x_centers, dtype=np.float64)
    if roi is None:
        # the last row and column of a scan carry flyback artefacts
        roi = (slice(0, -1), slice(0, -1))
    cy = np.nanmean(y2d[roi])
    cx = np.nanmean(x2d[roi])
    sy = y2d - cy
    sx = x2d - cx

    def rms_curl(ry, rx):
        curl = np.gradient(ry, axis=1) - np.gradient(rx, axis=0)
        return np.sqrt(np.nanmean(curl[roi] ** 2))

    best = None
    for flip in (False, True):
        for rot in range(360):
            score = rms_curl(*apply_com_correction(sy, sx, rot, flip))
            if best is None or score < best[0]:
                best = (score, rot, flip)
    _, rot, flip = best
    ry, rx = apply_com_correction(sy, sx, rot, flip)
    div = (np.gradient(ry, axis=0) + np.gradient(rx, axis=1))[roi]
    div = div[np.isfinite(div)]
    if div.size:
        rng = max(-div.min(), div.max())
        hist, _ = np.histogram(div, range=(-rng, rng), bins=5)
        if hist[0] < hist[-1]:  # the wrong polarity: turn by 180
            rot += 180
    if rot > 180:
        rot -= 360
    return GuessResult(scan_rotation=float(rot), flip_y=bool(flip),
                       cy=float(cy), cx=float(cx))


def com_masks_generic(detector_y, detector_x, base_mask_factory):
    """The CoM mask factories [base, y * base, x * base] of a
    selection-mask factory."""
    return [
        base_mask_factory,
        lambda: gradient_y(imageSizeX=detector_x, imageSizeY=detector_y)
        * base_mask_factory(),
        lambda: gradient_x(imageSizeX=detector_x, imageSizeY=detector_y)
        * base_mask_factory(),
    ]


def com_masks_factory(detector_y, detector_x, cy, cx, r):
    """The CoM mask factories of a disk of radius ``r``."""
    return com_masks_generic(
        detector_y, detector_x,
        lambda: circular(centerX=cx, centerY=cy, imageSizeX=detector_x,
                         imageSizeY=detector_y, radius=r),
    )


def center_shifts(img_sum, img_y, img_x, ref_y, ref_x):
    """(y, x) shift fields from the three mask projections, relative to
    the reference centre; zero-intensity positions shift by zero."""
    img_sum = np.asarray(img_sum)
    nz = img_sum != 0
    y_centers = np.divide(img_y, img_sum, where=nz)
    x_centers = np.divide(img_x, img_sum, where=nz)
    y_centers[~nz] = ref_y
    x_centers[~nz] = ref_x
    return (y_centers - ref_y, x_centers - ref_x)


def apply_correction(y_centers, x_centers, scan_rotation, flip_y,
                     forward=True):
    """The rotation/flip correction of the shifts; ``forward=False``
    applies its inverse (rotate back, then unflip)."""
    if forward:
        return apply_com_correction(y_centers, x_centers, scan_rotation,
                                    flip_y)
    theta = np.deg2rad(scan_rotation)
    y_r = y_centers * np.cos(theta) - x_centers * np.sin(theta)
    x_r = y_centers * np.sin(theta) + x_centers * np.cos(theta)
    if flip_y:
        y_r = -y_r
    return y_r, x_r


def divergence(y_centers, x_centers):
    """dFy/dy + dFx/dx of the shift field."""
    return np.gradient(y_centers, axis=0) + np.gradient(x_centers, axis=1)


def curl_2d(y_centers, x_centers):
    """dFy/dx - dFx/dy of the shift field."""
    return np.gradient(y_centers, axis=1) - np.gradient(x_centers, axis=0)


def magnitude(y_centers, x_centers):
    """The length of the shift vector at each scan position."""
    return np.sqrt(y_centers ** 2 + x_centers ** 2)


def coordinate_check(y_centers, x_centers, roi=None):
    """RMS curl over scan_rotation 0..359, without and with flip: its
    minima mark the consistent descan parameters.  Returns
    (straight, flipped)."""
    if roi is None:
        roi = (slice(0, -1), slice(0, -1))
    straight = np.zeros(360)
    flipped = np.zeros(360)
    for angle in range(360):
        for flip, out in ((False, straight), (True, flipped)):
            ry, rx = apply_com_correction(y_centers, x_centers, angle,
                                          flip)
            out[angle] = float(np.sqrt(np.mean(curl_2d(ry, rx)[roi] ** 2)))
    return (straight, flipped)
