"""Mask factories for virtual detectors (counterpart of
``libertem_tpu/masks.py``).  All return dense numpy arrays of shape
(imageSizeY, imageSizeX); the non-antialiased disk and ring are bool,
like the JAX package's."""
from __future__ import annotations

import numpy as np


def _disk_aa(centerX, centerY, imageSizeX, imageSizeY, radius,
             antialiased=True):
    """Disk mask; antialiased by 4x4 oversampling of the pixels that
    straddle the edge only (a full-frame oversample costs GBs on
    large detectors)."""
    y, x = np.ogrid[0:imageSizeY, 0:imageSizeX]
    d2 = (y - centerY) ** 2 + (x - centerX) ** 2
    if not antialiased:
        return d2 <= radius ** 2
    d = np.sqrt(d2)
    out = (d <= radius).astype(np.float64)
    by, bx = np.nonzero(np.abs(d - radius) <= 0.75)
    if by.size:
        os_ = 4
        offs = (np.arange(os_) + 0.5) / os_ - 0.5
        sy = by[:, None, None] + offs[None, :, None] - centerY
        sx = bx[:, None, None] + offs[None, None, :] - centerX
        hit = (sy ** 2 + sx ** 2) <= radius ** 2
        out[by, bx] = hit.mean(axis=(1, 2))
    return out


def circular(centerX, centerY, imageSizeX, imageSizeY, radius,
             antialiased=False):
    return _disk_aa(centerX, centerY, imageSizeX, imageSizeY, radius,
                    antialiased=antialiased)


def ring(centerX, centerY, imageSizeX, imageSizeY, radius,
         radius_inner, antialiased=False):
    outer = _disk_aa(centerX, centerY, imageSizeX, imageSizeY, radius,
                     antialiased=antialiased)
    inner = _disk_aa(centerX, centerY, imageSizeX, imageSizeY,
                     radius_inner, antialiased=antialiased)
    if not antialiased:
        return outer & ~inner
    return (outer - inner).astype(np.float64)


def gradient_x(imageSizeX, imageSizeY, dtype=np.float32):
    return np.broadcast_to(
        np.arange(imageSizeX, dtype=dtype), (imageSizeY, imageSizeX)
    ).copy()


def gradient_y(imageSizeX, imageSizeY, dtype=np.float32):
    return np.broadcast_to(
        np.arange(imageSizeY, dtype=dtype)[:, None],
        (imageSizeY, imageSizeX),
    ).copy()
