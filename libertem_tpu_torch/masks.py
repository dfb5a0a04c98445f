"""Mask factories for virtual detectors (counterpart of
``libertem_tpu/masks.py``).  All return numpy arrays of shape
(imageSizeY, imageSizeX), or (n, imageSizeY, imageSizeX) stacks; the
non-antialiased disk, ring and rectangle are bool, like the JAX
package's.  The "sparse" stacks are dense arrays of the
:class:`_DenseStack` type, which answers ``.todense()``: mask stacks
are packed into a dense (or block-compacted) operand anyway."""
from __future__ import annotations

import numpy as np

# the sparse helpers are importable from here too, as in the JAX package
from .common.sparse import is_sparse, to_dense, to_sparse  # noqa: F401


class _DenseStack(np.ndarray):
    """Dense stand-in for a sparse.COO mask stack: indexing and
    reductions keep the type, so ``stack.sum(axis=0).todense()`` and
    ``stack[i].todense()`` both work."""

    def todense(self):
        return np.asarray(self)

    @property
    def density(self) -> float:
        return float(np.count_nonzero(self)) / max(1, self.size)


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


def rectangular(X, Y, Width, Height, imageSizeX, imageSizeY):
    """Rectangle from corner (X, Y) extending Width/Height (either
    sign); the far corner is inclusive and a zero-area rectangle
    selects nothing."""
    mask = np.zeros((imageSizeY, imageSizeX), dtype=bool)
    if Height == 0 or Width == 0:
        return mask
    y0, y1 = sorted((int(Y), int(Y + Height)))
    x0, x1 = sorted((int(X), int(X + Width)))
    mask[
        max(0, y0):min(y1 + 1, imageSizeY),
        max(0, x0):min(x1 + 1, imageSizeX),
    ] = True
    return mask


def radial_gradient(centerX, centerY, imageSizeX, imageSizeY, radius,
                    antialiased=False):
    y, x = np.ogrid[0:imageSizeY, 0:imageSizeX]
    r = np.sqrt((y - centerY) ** 2 + (x - centerX) ** 2)
    disk = _disk_aa(
        centerX, centerY, imageSizeX, imageSizeY, radius,
        antialiased=antialiased,
    ).astype(np.float64)
    return r * disk / radius


def polar_map(centerX, centerY, imageSizeX, imageSizeY,
              stretchY=1.0, angle=0.0):
    """(r, phi) maps of the detector pixels, with an optional
    elliptical stretch in a frame rotated by ``angle`` (not rotated
    back); phi = arctan2(dy, dx) in [-pi, pi]."""
    y, x = np.mgrid[0:imageSizeY, 0:imageSizeX].astype(np.float64)
    dy, dx = y - centerY, x - centerX
    if angle != 0.0 or stretchY != 1.0:
        c, s = np.cos(angle), np.sin(angle)
        dy, dx = (
            (dy * c - dx * s) / stretchY,
            dx * c + dy * s,
        )
    r = np.sqrt(dy ** 2 + dx ** 2)
    phi = np.arctan2(dy, dx)
    return r, phi


def bounding_radius(centerX, centerY, imageSizeX, imageSizeY):
    """Radius around the centre that covers the whole frame."""
    dy = max(centerY, imageSizeY - centerY)
    dx = max(centerX, imageSizeX - centerX)
    return int(np.ceil(np.sqrt(dy ** 2 + dx ** 2))) + 1


def radial_bins(
    centerX, centerY, imageSizeX, imageSizeY,
    radius=None, radius_inner=0, n_bins=None,
    normalize=False, use_sparse=None, dtype=None,
):
    """Antialiased stack of concentric ring masks: each ring has the
    trapezoid radial profile ``clip(width/2 + 0.5 - |r - r0|, 0, 1)``,
    so adjacent bins overlap and sum to exactly 1, with the centre
    pixel patched into bin 0.  A (n_bins, Y, X) stack; a
    :class:`_DenseStack` when ``use_sparse`` or when the rings are
    thin (each under a tenth of the frame)."""
    if radius is None:
        radius = bounding_radius(
            centerX, centerY, imageSizeX, imageSizeY
        )
    if n_bins is None:
        n_bins = int(np.round(radius - radius_inner))
    n_bins = max(1, int(n_bins))
    r, _ = polar_map(centerX, centerY, imageSizeX, imageSizeY)
    width = (radius - radius_inner) / n_bins
    centers = np.linspace(
        radius_inner, radius - width, n_bins
    ) + width / 2
    stack = np.empty(
        (n_bins, imageSizeY, imageSizeX),
        dtype=np.float64 if dtype is None else dtype,
    )
    for b, r0 in enumerate(centers):
        diff = np.abs(r - r0)
        vals = np.maximum(0, np.minimum(1, width / 2 + 0.5 - diff))
        if b == 0 and radius_inner < 0.5:
            # the r=0 singularity goes into bin 0 before normalization,
            # so normalize=True keeps summing to 1
            yy = int(np.round(centerY))
            xx = int(np.round(centerX))
            if 0 <= yy < imageSizeY and 0 <= xx < imageSizeX:
                vals[yy, xx] = 1 - radius_inner
        if normalize:
            s = vals.sum()
            if not np.isclose(s, 0):
                vals = vals / s
        stack[b] = vals
    width_frac = np.pi * (
        radius ** 2 - (radius - width) ** 2
    ) / (imageSizeX * imageSizeY)
    if use_sparse or (use_sparse is None and width_frac < 0.1):
        return stack.view(_DenseStack)
    return stack


def background_subtraction(
    centerX, centerY, imageSizeX, imageSizeY,
    radius, radius_inner, antialiased=False,
):
    """Disk minus the surrounding ring scaled to the disk's weight:
    zero total weight."""
    disk = _disk_aa(
        centerX, centerY, imageSizeX, imageSizeY, radius_inner,
        antialiased=antialiased,
    )
    outer = ring(
        centerX, centerY, imageSizeX, imageSizeY,
        radius, radius_inner, antialiased=antialiased,
    )
    disk = disk.astype(np.float64)
    outer = outer.astype(np.float64)
    s_outer = outer.sum()
    if s_outer > 0:
        outer = outer * (disk.sum() / s_outer)
    return disk - outer


def radial_gradient_background_subtraction(r, r0, r_outer, delta=1.0):
    """On a radius map ``r``: a linear gradient 0..1 inside
    ``r0 - delta/2``, a linear transition on ``[r0 - delta/2,
    r0 + delta/2)`` and -1 on ``[r0 + delta/2, r_outer]``."""
    r = np.asarray(r)
    result = np.zeros_like(r, dtype=np.float64)
    within = r < r0 - delta / 2
    result[within] = r[within] / max(r0, 1e-12)
    transition = (r >= r0 - delta / 2) & (r < r0 + delta / 2)
    result[transition] = (r0 - r[transition]) / max(delta / 2, 1e-12)
    without = (r >= r0 + delta / 2) & (r <= r_outer)
    result[without] = -1.0
    return result


def gradient_x(imageSizeX, imageSizeY, dtype=np.float32):
    return np.broadcast_to(
        np.arange(imageSizeX, dtype=dtype), (imageSizeY, imageSizeX)
    ).copy()


def gradient_y(imageSizeX, imageSizeY, dtype=np.float32):
    return np.broadcast_to(
        np.arange(imageSizeY, dtype=dtype)[:, None],
        (imageSizeY, imageSizeX),
    ).copy()


def sparse_template_multi_stack(
    mask_index, offsetX, offsetY, template, imageSizeX, imageSizeY,
):
    """Stamp a small template at per-mask offsets into a
    (n_masks, Y, X) :class:`_DenseStack`, clipped at the frame's
    edges."""
    n_masks = int(np.max(mask_index)) + 1
    stack = np.zeros((n_masks, imageSizeY, imageSizeX), dtype=np.float64)
    th, tw = template.shape
    for i, m in enumerate(np.atleast_1d(mask_index)):
        ox = int(np.atleast_1d(offsetX)[i])
        oy = int(np.atleast_1d(offsetY)[i])
        y0, x0 = max(0, oy), max(0, ox)
        y1, x1 = min(imageSizeY, oy + th), min(imageSizeX, ox + tw)
        if y1 <= y0 or x1 <= x0:
            continue
        stack[m, y0:y1, x0:x1] += template[
            y0 - oy:y1 - oy, x0 - ox:x1 - ox
        ]
    return stack.view(_DenseStack)


def sparse_circular_multi_stack(
    mask_index, centerX, centerY, imageSizeX, imageSizeY, radius,
):
    """One circular template, built once in a tight bounding box,
    stamped at per-mask centres."""
    bbox = int(2 * np.ceil(radius) + 1)
    bc = (bbox - 1) // 2
    template = circular(
        centerX=bc, centerY=bc,
        imageSizeX=bbox, imageSizeY=bbox, radius=radius,
    )
    return sparse_template_multi_stack(
        mask_index=mask_index,
        offsetX=np.asarray(centerX, dtype=int) - bc,
        offsetY=np.asarray(centerY, dtype=int) - bc,
        template=template,
        imageSizeX=imageSizeX,
        imageSizeY=imageSizeY,
    )


def balance(template):
    """Scale the negative part of a mixed-sign template so that the
    total is zero (such masks null a uniform background); integer
    templates are promoted to float."""
    result = np.array(
        template, copy=True,
        dtype=np.result_type(np.asarray(template).dtype, np.float32),
    )
    pos = result > 0
    neg = result < 0
    neg_sum = result[neg].sum()
    if neg_sum != 0:
        result[neg] *= -result[pos].sum() / neg_sum
    return result


_make_circular_mask = circular
