"""CoMUDF: centre of mass (counterpart of ``libertem_tpu/udf/com.py``).

Device side: three projections per frame (total, y-weighted,
x-weighted), on the fused path as rows of the fused mask stack, on the
generic path as a float32 matmul of the tile with the stack.  Every
derived field (shifts, rotation/flip correction, magnitude,
divergence, curl) is computed on the host in ``get_results``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

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
        if self.params.com_params.regression != \
                RegressionOptions.NO_REGRESSION:
            raise NotImplementedError(
                "CoM regression is not ported yet"
            )
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
            "regression": self.with_mask(
                np.zeros((3, 2), dtype=np.float32), mask=False,
            ),
        }

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
        roi = self.meta.roi
        sel = (
            np.ones(int(np.prod(nav_shape)), dtype=bool) if roi is None
            else roi.reshape(-1)
        )

        def embed(flat):
            full = np.full(sel.size, np.nan,
                           dtype=np.complex128 if is_c else np.float64)
            full[sel] = flat
            return full.reshape(nav_shape)

        dy_dy, dy_dx = np.gradient(embed(y_corr))
        dx_dy, dx_dx = np.gradient(embed(x_corr))
        div = (dy_dy + dx_dx).astype(out_dt).reshape(-1)[sel]
        # curl_2d = dFy/dx - dFx/dy
        curl = (dy_dx - dx_dy).astype(out_dt).reshape(-1)[sel]
        return div, curl

    def fused_moments_spec(self):
        """Join the fused pass with the 3-row CoM mask stack."""
        return {
            "mode": "masks",
            "operand": self._stack().reshape(3, -1).astype(np.float32),
            "name": "raw_mask_result",
        }
