"""Synthetic test data (counterpart of
``libertem_tpu/utils/generate.py``): CBED frames on a lattice,
off-axis holograms, a linear gradient and excluded pixels."""
from __future__ import annotations

import numpy as np

from .. import masks as mask_lib


def cbed_frame(
    fy=128, fx=128, zero=None, a=None, b=None, indices=None,
    radius=4, all_equal=False, margin=None,
):
    """A simulated convergent-beam electron diffraction frame: disks of
    ``radius`` at the lattice positions zero + i*a + j*b that keep
    ``margin`` (default ``radius``) from the border.  Returns a
    (1, fy, fx) float32 stack, the kept indices and their positions.
    The peaks' intensities fall with the distance from ``zero``, offset
    by the peak's index so that no two are equal (all 1 with
    ``all_equal``)."""
    if zero is None:
        zero = (fy // 2, fx // 2)
    zero = np.array(zero, dtype=np.float64)
    if a is None:
        a = (fy // 8, 0)
    a = np.array(a, dtype=np.float64)
    if b is None:
        b = make_cartesian(make_polar(a) - (0, np.pi / 2))
    b = np.array(b, dtype=np.float64)
    if indices is None:
        indices = np.mgrid[-10:11, -10:11]
    indices, peaks = frame_peaks(
        fy=fy, fx=fx, zero=zero, a=a, b=b,
        r=margin if margin is not None else radius,
        indices=indices,
    )
    frame = np.zeros((1, fy, fx), dtype=np.float32)
    dists = np.linalg.norm(peaks - zero, axis=-1)
    max_val = max(dists.max() + 1, len(peaks) + 1) if len(peaks) \
        else 1.0
    for i, p in enumerate(peaks):
        intensity = (
            1.0 if all_equal
            else max(1.0, max_val - dists[i] + i)
        )
        frame += intensity * mask_lib.circular(
            p[1], p[0], fx, fy, radius, antialiased=True
        )
    return frame, indices, peaks


def make_polar(y_x):
    y, x = y_x
    return np.array([np.hypot(y, x), np.arctan2(y, x)])


def make_cartesian(r_phi):
    """Inverse of :func:`make_polar`: phi = arctan2(y, x)."""
    r, phi = r_phi
    return np.array([r * np.sin(phi), r * np.cos(phi)])


def regularize_indices(indices) -> np.ndarray:
    """An (n, 2) list of (i, j) pairs, or mgrid output (2, n, m), as
    (n, 2)."""
    indices = np.asarray(indices)
    s = indices.shape
    if len(s) == 3 and s[0] == 2:
        return np.concatenate(indices.T)
    if len(s) == 2 and s[1] == 2:
        return indices
    raise ValueError(
        f"shape of indices is {s}, expected (n, 2) or (2, n, m)"
    )


def frame_peaks(fy, fx, zero, a, b, r=0, indices=None):
    if indices is None:
        indices = np.mgrid[-10:11, -10:11]
    idx = regularize_indices(indices)
    peaks = zero + idx[:, 0:1] * a + idx[:, 1:2] * b
    sel = (
        (peaks[:, 0] >= r) & (peaks[:, 0] < fy - r)
        & (peaks[:, 1] >= r) & (peaks[:, 1] < fx - r)
    )
    return idx[sel], peaks[sel]


def hologram_frame(
    amp, phi,
    counts=1000.0, sampling=5.0, visibility=1.0,
    f_angle=30.0, gaussian_noise=None, poisson_noise=None,
):
    """A simulated off-axis electron hologram (float64) of an object of
    amplitude ``amp`` and phase ``phi``: fringes of period ``sampling``
    pixels along y*cos(f_angle) + x*sin(f_angle).  ``poisson_noise``
    scales shot noise (drawn from numpy's global generator) as
    ``poisson_noise * counts``; ``gaussian_noise`` is the sigma of a
    Gaussian smoothing (a focus spread or detector blur), not additive
    noise."""
    amp = np.asarray(amp)
    phi = np.asarray(phi)
    if amp.shape != phi.shape:
        raise ValueError(
            "Amplitude and phase should be 2d arrays of the same "
            "shape."
        )
    sy, sx = phi.shape
    y, x = np.mgrid[0:sy, 0:sx].astype(np.float64)
    f_angle_rad = np.deg2rad(f_angle)
    carrier = 2 * np.pi / sampling * (
        y * np.cos(f_angle_rad) + x * np.sin(f_angle_rad)
    )
    holo = counts / 2 * (
        1.0 + amp ** 2 + 2 * amp * visibility
        * np.cos(carrier - phi)
    )
    if poisson_noise:
        if not isinstance(poisson_noise, (int, float)):
            raise ValueError(
                "poisson_noise parameter should be float or int or "
                "None."
            )
        noise_scale = poisson_noise * counts
        holo = noise_scale * np.random.poisson(holo / noise_scale)
    if gaussian_noise:
        if not isinstance(gaussian_noise, (int, float)):
            raise ValueError(
                "gaussian_noise parameter should be float or int or "
                "None."
            )
        from scipy.ndimage import gaussian_filter
        holo = gaussian_filter(holo, gaussian_noise)
    return holo.astype(np.float64)


def gradient_data(nav_dims, sig_dims):
    """Linearly increasing float32 values, (*nav_dims, *sig_dims)."""
    data = np.linspace(
        start=5, stop=30, num=int(np.prod(nav_dims))
        * int(np.prod(sig_dims)), dtype=np.float32,
    )
    return data.reshape(tuple(nav_dims) + tuple(sig_dims))


def exclude_pixels(sig_dims, num_excluded, rng=None):
    """Excluded-pixel coordinates, (ndim, n), that a linear gradient
    repairs exactly from their radius-1 neighbours: interior pixels
    only, none within another's neighbourhood.  None for 0 pixels."""
    if num_excluded == 0:
        return None
    if rng is None:
        rng = np.random.default_rng(9)
    free = np.ones(tuple(sig_dims), dtype=bool)
    for dim in range(len(sig_dims)):
        border = tuple(
            slice(None) if i != dim else (0, -1)
            for i in range(len(sig_dims))
        )
        free[border] = False
    picked = []
    while len(picked) < num_excluded:
        cand = tuple(
            int(rng.integers(1, s - 1)) for s in sig_dims
        )
        if free[cand]:
            picked.append(cand)
            free[tuple(slice(c - 1, c + 2) for c in cand)] = False
    return np.array(picked).T
