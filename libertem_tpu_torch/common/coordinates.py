"""2D coordinate-transform matrices in (y, x) order (counterpart of
``libertem_tpu/common/coordinates.py``; numpy only).

Transform matrices act on (y, x) column vectors; compositions apply
right to left, e.g. ``rotate_deg(theta) @ flip_y()`` flips first and
rotates second (the CoM correction convention, udf/com.py).
"""
from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(2)


def scale(factor) -> np.ndarray:
    return np.eye(2) * factor


def rotate(radians) -> np.ndarray:
    c, s = np.cos(radians), np.sin(radians)
    # (y, x) axis order: positive angle rotates y toward x
    return np.array([(c, s), (-s, c)])


def rotate_deg(degrees) -> np.ndarray:
    return rotate(np.deg2rad(degrees))


def flip_y() -> np.ndarray:
    return np.array([(-1.0, 0.0), (0.0, 1.0)])


def flip_x() -> np.ndarray:
    return np.array([(1.0, 0.0), (0.0, -1.0)])


def scale_rotate_flip_y(mat: np.ndarray):
    """Decompose ``scale(s) @ rotate(a) @ flip_y()**f`` back into
    ``(s, a, f)`` — raises ValueError when ``mat`` carries shear or
    anisotropic scale (i.e. was not built from those factors)."""
    mat = np.asarray(mat, dtype=np.float64)
    col_norms = np.linalg.norm(mat, axis=0)
    if not np.allclose(col_norms[0], col_norms[1]):
        raise ValueError(
            f"y scale {col_norms[0]} and x scale {col_norms[1]} "
            "are different."
        )
    s = col_norms[0]
    unit = mat / s
    det = np.linalg.det(unit)
    if not np.allclose(abs(det), 1.0):
        raise ValueError(
            f"Contains shear: determinant of the unit part is {det}."
        )
    flipped = bool(det < 0)
    rot = unit @ (flip_y() if flipped else identity())
    # rot is now a pure rotation in (y, x) convention:
    # [[cos, sin], [-sin, cos]]
    angle = float(np.arctan2(rot[0, 1], rot[0, 0]))
    if not np.allclose(rotate(angle), rot):
        raise ValueError(
            f"Rotation part is inconsistent: {rot!r}."
        )
    return (float(s), angle, flipped)
