"""Rendering of result arrays (counterpart of the part of
``libertem_tpu/viz/base.py`` that the analyses call): damage-aware
normalisation into RGBA images with matplotlib, imported only when an
image is rendered, and a 2-D vector field on an isoluminant colour
wheel in pure numpy (built in CIE L*u*v*: constant lightness, hue the
vector's angle, chroma its scaled magnitude).
"""
from __future__ import annotations

import math

import numpy as np


def _get_stat_limits(
    data: np.ndarray, quantile: float = 0.001, snip_factor: float = 10.0,
) -> tuple:
    """Robust vmin/vmax for auto-ranging (reference viz/base.py:23).

    Outliers ("bad" pixels) are snipped when the quantile-filtered
    limits differ from the raw limits by more than ``snip_factor``
    (relative to the filtered limit).  Zeros are excluded from the
    quantile statistics so very sparse data keeps its real dynamic
    range; bool and complex inputs skip the quantile step entirely
    (complex limits are the real parts of the lexicographic min/max).
    """
    data = np.asarray(data)
    data = data[np.isfinite(data)]
    if data.size == 0:
        return 1.0, math.nextafter(1.0, math.inf)
    vmin = float(np.real(data.min()))
    vmax = float(np.real(data.max()))
    zeros = data == 0
    quantile_applies = (
        not np.all(zeros)
        and np.issubdtype(data.dtype, np.number)
        and not np.issubdtype(data.dtype, np.complexfloating)
    )
    if quantile_applies:
        q = float(quantile)
        lower, upper = np.quantile(data[~zeros], (q, 1.0 - q))
        if np.any(zeros):
            # zeros were held out of the statistics but must stay
            # inside the displayed range
            lower = min(lower, 0.0)
            upper = max(upper, 0.0)
        filtered = data[(data >= lower) & (data <= upper)]
        if filtered.size > 0:
            fmin = float(filtered.min())
            fmax = float(filtered.max())
            # snip only REAL outliers: raw limit far outside the
            # filtered limit, measured relative to the filtered one
            if abs(fmin) > 0 and abs(fmin - vmin) / abs(fmin) > snip_factor:
                vmin = fmin
            if abs(fmax) > 0 and abs(fmax - vmax) / abs(fmax) > snip_factor:
                vmax = fmax
    if vmin == vmax:
        vmax = math.nextafter(vmin, math.inf)
    return vmin, vmax


def _stat_limits(data: np.ndarray, damage=None):
    """vmin/vmax over the valid (damaged = merged) region — internal
    helper for the live plots; routes through :func:`_get_stat_limits`
    so live views and static renders share the outlier policy."""
    data = np.asarray(data)
    if np.iscomplexobj(data):
        data = np.abs(data)
    if damage is not None:
        damage = np.broadcast_to(np.asarray(damage), data.shape)
        sel = data[damage & np.isfinite(data)]
    else:
        sel = data[np.isfinite(data)]
    if sel.size == 0:
        return 0.0, 1.0
    return _get_stat_limits(sel)


def _get_norm(result, norm_cls=None, vmin=None, vmax=None, damage=None):
    """Matplotlib Normalize over the damaged region (reference
    viz/base.py:99) — damage defaults to the nonzero pixels."""
    from matplotlib import colors
    if norm_cls is None:
        norm_cls = colors.Normalize
    if (vmin is not None) and (vmax is not None):
        return norm_cls(vmin=vmin, vmax=vmax)
    result = np.asarray(result).astype(np.float32)
    if damage is None:
        damage = (result != 0)
    damage = damage & np.isfinite(result)
    if damage.sum() == 0:
        return norm_cls(vmin=1, vmax=1)  # all-NaN or all-zero
    qmin, qmax = _get_stat_limits(result[damage])
    if vmin is None:
        vmin = qmin
    if vmax is None:
        vmax = qmax
    return norm_cls(vmin=vmin, vmax=vmax)


def visualize_simple(
    result: np.ndarray,
    colormap=None,
    logarithmic: bool = False,
    vmin=None,
    vmax=None,
    damage=None,
) -> np.ndarray:
    """Normalize a 2D array to an RGBA uint8 image (reference
    viz/base.py:121 — same norm/damage semantics; complex input is
    rendered as magnitude)."""
    from matplotlib import cm, colors
    result = np.asarray(result)
    if np.iscomplexobj(result):
        result = np.abs(result)
    if logarithmic:
        # smallest dtype that supports subtraction, shifted positive
        # for the log scale
        dtype = np.result_type(result, np.int8)
        result = result.astype(dtype)
        cnorm = colors.LogNorm
        result = result - np.min(result) + 1
    else:
        cnorm = colors.Normalize
    if colormap is None:
        colormap = cm.gist_earth
    norm = _get_norm(
        result, norm_cls=cnorm, vmin=vmin, vmax=vmax, damage=damage
    )
    shape = result.shape
    normalized = norm(result.reshape((-1,))).reshape(shape)
    return colormap(normalized, bytes=True)


# -- isoluminant 2D-vector color wheel (pure numpy LUV) ----------------

# D65 white point in u'v' chromaticity
_UN_PRIME = 0.19783982482140777
_VN_PRIME = 0.46833630293240970
# lightness of the wheel: chosen so zero-magnitude renders as the
# exact mid-grey (127, 127, 127)
_WHEEL_L = 53.386
# maximum chroma (u*v* radius) at full magnitude — vivid but within
# the sRGB gamut at _WHEEL_L for every hue after clipping
_WHEEL_CHROMA = 62.0
# hue offset aligning the wheel with the conventional reading:
# +x → red, +y → green, -x → cyan-blue, -y → purple
_WHEEL_HUE_OFFSET = 0.38  # radians


def _luv_to_srgb(L, u_star, v_star) -> np.ndarray:
    """CIE L*u*v* → sRGB (float in [0, 1], gamut-clipped), stacked on
    a new trailing axis."""
    L = np.asarray(L, dtype=np.float64)
    u_star = np.asarray(u_star, dtype=np.float64)
    v_star = np.asarray(v_star, dtype=np.float64)
    # L is always well above the CIE linear toe here (L* ≈ 53)
    Y = ((L + 16.0) / 116.0) ** 3
    with np.errstate(divide="ignore", invalid="ignore"):
        up = u_star / (13.0 * L) + _UN_PRIME
        vp = v_star / (13.0 * L) + _VN_PRIME
        X = Y * (9.0 * up) / (4.0 * vp)
        Z = Y * (12.0 - 3.0 * up - 20.0 * vp) / (4.0 * vp)
    # XYZ → linear sRGB (IEC 61966-2-1 matrix)
    r = 3.2404542 * X - 1.5371385 * Y - 0.4985314 * Z
    g = -0.9692660 * X + 1.8760108 * Y + 0.0415560 * Z
    b = 0.0556434 * X - 0.2040259 * Y + 1.0572252 * Z
    lin = np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)
    srgb = np.where(
        lin <= 0.0031308,
        12.92 * lin,
        1.055 * np.power(lin, 1.0 / 2.4) - 0.055,
    )
    return np.clip(srgb, 0.0, 1.0)


def rgb_from_2dvector(y, x, vmax=None):
    """2D vector field → RGB: hue encodes the angle on an isoluminant
    wheel, chroma encodes the magnitude; zero vectors render mid-grey
    (reference viz/base.py:160 — same API and orientation contract:
    +x red, +y green, -y blue-purple, -x cyan-blue)."""
    y = np.asarray(y)
    x = np.asarray(x)
    mag = np.sqrt(np.abs(y) ** 2 + np.abs(x) ** 2)
    if vmax is None:
        finite = mag[np.isfinite(mag)]
        vmax = float(finite.max()) if finite.size else 1.0
    if vmax == 0:
        vmax = 1.0
    scaled = np.minimum(np.nan_to_num(mag / vmax), 1.0)
    hue = np.arctan2(
        np.nan_to_num(y), np.nan_to_num(x)
    ) + _WHEEL_HUE_OFFSET
    chroma = _WHEEL_CHROMA * scaled
    rgb = _luv_to_srgb(
        np.broadcast_to(_WHEEL_L, chroma.shape),
        chroma * np.cos(hue),
        chroma * np.sin(hue),
    )
    return (rgb * 255).astype(np.uint8)
