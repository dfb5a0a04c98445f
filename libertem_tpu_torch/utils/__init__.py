"""Coordinate and vector helpers of the CoM and blobfinder workflows
(counterpart of ``libertem_tpu/utils/__init__.py``): polar/cartesian
conversion, rotation, and lattice peaks in a frame.

Conventions: vectors are (y, x) tuples in pixel coordinates (y down,
x right); polar vectors are (r, phi) with phi measured from the +x
axis towards +y.
"""
from __future__ import annotations

import numpy as np


def make_cartesian(polar: np.ndarray) -> np.ndarray:
    """(..., (r, phi)) -> (..., (y, x))."""
    polar = np.asarray(polar)
    y = np.sin(polar[..., 1]) * polar[..., 0]
    x = np.cos(polar[..., 1]) * polar[..., 0]
    return np.stack((y, x), axis=-1)


def make_polar(cartesian: np.ndarray) -> np.ndarray:
    """(..., (y, x)) -> (..., (r, phi))."""
    cartesian = np.asarray(cartesian)
    r = np.linalg.norm(cartesian, axis=-1)
    phi = np.arctan2(cartesian[..., 0], cartesian[..., 1])
    return np.stack((r, phi), axis=-1)


def rotate_precalc(y, x, cos_angle, sin_angle):
    """Rotate with precomputed rotation-matrix entries, the form
    rotate_deg and rotate_rad delegate to."""
    return (
        sin_angle * x + cos_angle * y,
        cos_angle * x - sin_angle * y,
    )


def rotate_rad(y, x, radians):
    """Rotate (y, x) clockwise in pixel coordinates (y down, x right)
    by ``radians``."""
    return rotate_precalc(
        y, x, cos_angle=np.cos(radians), sin_angle=np.sin(radians)
    )


def rotate_deg(y, x, degrees: float):
    """Rotate (y, x) clockwise in pixel coordinates (y down, x right)
    by ``degrees``: +x rotates towards +y."""
    return rotate_rad(y, x, np.deg2rad(degrees))


def frame_peaks_polar(zero, a, b, indices):
    """Lattice points zero + i*a + j*b as polar vectors relative to
    zero."""
    idx = np.asarray(indices).reshape(2, -1).T
    zero = np.asarray(zero, dtype=np.float64)
    pts = (
        zero
        + idx[:, 0:1] * np.asarray(a, dtype=np.float64)
        + idx[:, 1:2] * np.asarray(b, dtype=np.float64)
    )
    return make_polar(pts - zero)


def regularize_indices(indices):
    """Lattice indices as an (n, 2) list, from the (2, n, m) output of
    ``np.mgrid`` or an (n, 2) pair list."""
    indices = np.asarray(indices)
    s = indices.shape
    if len(s) == 3 and s[0] == 2:
        return np.concatenate(indices.T)
    if len(s) == 2 and s[1] == 2:
        return indices
    raise ValueError(
        f"Shape of indices is {s}, expected (n, 2) or (2, n, m)"
    )


def calc_coords(zero, a, b, indices):
    """Pixel coordinates of lattice points ``zero + i*a + j*b``."""
    return zero + np.dot(indices, np.array((a, b)))


def within_frame(peaks, r, fy, fx):
    """Boolean selector of the peaks whose (r, r) neighbourhood lies
    inside an (fy, fx) frame."""
    selector = (peaks >= (r, r)) * (peaks < (fy - r, fx - r))
    return selector.all(axis=-1)


def frame_peaks(fy, fx, zero, a, b, r, indices):
    """Lattice peaks that fit in an (fy, fx) frame with margin ``r``:
    (kept indices, kept coordinates)."""
    indices = regularize_indices(indices)
    peaks = calc_coords(zero, a, b, indices)
    selector = within_frame(peaks, r, fy, fx)
    return indices[selector], peaks[selector]
