"""A strained crystal's diffraction disks, rendered into a cell's frames.

``yardstick/data.py`` draws the frames as a flat Poisson field (the
background).  :func:`render` adds to them, in place, the disks of a
square lattice whose strain and rotation vary over the scan, as the
configuration's ``specimen`` states them:

* the lattice: reflections ``zero + h a + k b`` (``y, x`` pixels) for
  ``|h|, |k| <= orders``, the zero order among them;
* the strain field: at scan row ``i`` of ``ny`` the lattice vector
  ``a`` is stretched by ``strain * i / (ny - 1)`` (uniaxial, along
  ``a``), and at scan column ``j`` of ``nx`` both vectors are turned by
  ``rotation_deg * j / (nx - 1)`` degrees;
* the disks: radius ``radius``, ``zero_counts`` counts a pixel in the
  zero order, and in a reflection from ``counts[0]`` at the shortest
  ``|g|`` down to ``counts[1]`` at the longest, linear in ``|g|`` of the
  unstrained lattice;
* each disk's centre is rounded to the nearest ``1 / snap`` of a pixel,
  so that no centre lies half-way between two pixels (the correlation
  maximum would then be a tie, which float32 and float64 break
  differently);
* a disk's counts are not drawn: a pixel gets the disk's counts times
  the share of it that the disk covers (4 x 4 points a pixel), rounded
  to a whole count.  With ``snap`` 3 a disk lies on the pixel grid in
  one of nine ways, so nine patches serve every disk.

The frames change on the device in chunks, as ``data.py`` draws them,
and are written back to the host array.  The inputs are marked as
rendered, so that a second call (the reference's, after the program's)
changes nothing: both sides read the same bytes.  Plain PyTorch and
NumPy; nothing of the program is imported.
"""
from __future__ import annotations

import math

import numpy as np

CHUNK_FRAMES = 1024
OVERSAMPLE = 4
MARK = "lattice_rendered"


def lattice_hk(orders: int) -> np.ndarray:
    """(n, 2) the indices ``(h, k)`` of every reflection, ``h`` outer."""
    r = np.arange(-orders, orders + 1)
    return np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)


def disk_counts(spec: dict) -> np.ndarray:
    """(n,) the counts a pixel of each reflection's disk."""
    hk = lattice_hk(int(spec["orders"]))
    a = np.asarray(spec["a"], dtype=np.float64)
    b = np.asarray(spec["b"], dtype=np.float64)
    g = np.linalg.norm(hk[:, :1] * a + hk[:, 1:] * b, axis=-1)
    top, low = (float(c) for c in spec["counts"])
    ring = g > 0
    g_min, g_max = g[ring].min(), g[ring].max()
    out = np.full(len(hk), float(spec["zero_counts"]))
    out[ring] = top + (low - top) * (g[ring] - g_min) / (g_max - g_min)
    return out


def nominal(spec: dict) -> np.ndarray:
    """(n, 2) the unstrained lattice's reflections ``zero + h a + k b``,
    ``y, x``, in the order of :func:`lattice_hk`."""
    hk = lattice_hk(int(spec["orders"]))
    return (np.asarray(spec["zero"], dtype=np.float64)
            + hk[:, :1] * np.asarray(spec["a"], dtype=np.float64)
            + hk[:, 1:] * np.asarray(spec["b"], dtype=np.float64))


def centres(spec: dict, nav) -> np.ndarray:
    """(ny * nx, n, 2) every frame's disk centres, ``y, x``, rounded to
    the nearest ``1 / snap`` of a pixel (float64)."""
    ny, nx = (int(n) for n in nav)
    hk = lattice_hk(int(spec["orders"])).astype(np.float64)
    a = np.asarray(spec["a"], dtype=np.float64)
    b = np.asarray(spec["b"], dtype=np.float64)
    stretch = 1.0 + float(spec["strain"]) * np.arange(ny) / max(ny - 1, 1)
    turn = np.deg2rad(float(spec["rotation_deg"])) * np.arange(nx) / max(
        nx - 1, 1)
    # (ny, nx, 2) lattice vectors of each frame; a turn of t maps
    # (y, x) to (y cos t + x sin t, x cos t - y sin t)
    a_s = stretch[:, None, None] * a
    a_f = np.broadcast_to(a_s, (ny, nx, 2))
    b_f = np.broadcast_to(b, (ny, nx, 2))
    c, s = np.cos(turn)[None, :], np.sin(turn)[None, :]

    def turned(v):
        return np.stack([v[..., 0] * c + v[..., 1] * s,
                         v[..., 1] * c - v[..., 0] * s], -1)

    a_t, b_t = turned(a_f), turned(b_f)
    zero = np.asarray(spec["zero"], dtype=np.float64)
    pos = (zero + hk[:, 0, None] * a_t[:, :, None, :]
           + hk[:, 1, None] * b_t[:, :, None, :])
    snap = float(spec["snap"])
    return (np.round(pos * snap) / snap).reshape(ny * nx, len(hk), 2)


def patches(radius: float, snap: int) -> tuple:
    """``(table, size)``: ``table`` (snap, snap, size, size) the share
    of each pixel of a ``size`` x ``size`` patch that a disk of
    ``radius`` covers, its centre ``fy / snap, fx / snap`` of a pixel
    below and right of the patch's middle pixel."""
    half = int(math.ceil(radius)) + 1
    size = 2 * half + 1
    offs = (np.arange(OVERSAMPLE) + 0.5) / OVERSAMPLE - 0.5
    grid = np.arange(size) - half
    table = np.empty((snap, snap, size, size))
    for fy in range(snap):
        for fx in range(snap):
            y = (grid[:, None, None, None] + offs[None, None, :, None]
                 - fy / snap)
            x = (grid[None, :, None, None] + offs[None, None, None, :]
                 - fx / snap)
            table[fy, fx] = ((y ** 2 + x ** 2) <= radius ** 2).mean(
                axis=(2, 3))
    return table, size


def render(config: dict, inputs, device="cpu") -> None:
    """Add the specimen's disks to ``inputs.frames`` (u16, nav + sig) in
    place; a second call does nothing."""
    import torch

    if getattr(inputs, MARK, False):
        return
    spec = config["specimen"]
    nav = tuple(int(n) for n in config["nav"])
    h, w = (int(n) for n in config["sig"])
    snap = int(spec["snap"])
    table, size = patches(float(spec["radius"]), snap)
    # (n, snap, snap, size * size) whole counts of each disk's patch
    counts = np.floor(disk_counts(spec)[:, None, None, None]
                      * table.reshape(1, snap, snap, -1) + 0.5)
    counts_t = torch.from_numpy(counts.astype(np.int32)).to(device)
    pos = centres(spec, nav)
    whole = np.floor(pos)
    frac = np.rint((pos - whole) * snap).astype(np.int64)
    # a centre that rounds up to the next pixel
    whole += frac // snap
    frac %= snap
    n_frames = pos.shape[0]
    host = torch.from_numpy(
        inputs.frames.reshape(n_frames, h * w).view(np.int16))
    grid = torch.arange(size, device=device) - size // 2
    k = torch.arange(pos.shape[1], device=device)[None, :]
    whole_t = torch.from_numpy(whole.astype(np.int64)).to(device)
    frac_t = torch.from_numpy(frac).to(device)
    for lo in range(0, n_frames, CHUNK_FRAMES):
        hi = min(n_frames, lo + CHUNK_FRAMES)
        iy = (whole_t[lo:hi, :, 0, None, None] + grid[:, None]) % h
        ix = (whole_t[lo:hi, :, 1, None, None] + grid[None, :]) % w
        add = counts_t[k, frac_t[lo:hi, :, 0], frac_t[lo:hi, :, 1]]
        # u16 counts cross as int16, the same bits for counts < 2**15
        x = host[lo:hi].to(device).to(torch.int32) & 0xFFFF
        x.scatter_add_(1, (iy * w + ix).reshape(hi - lo, -1),
                       add.reshape(hi - lo, -1))
        if int(x.max()) >= 1 << 15:
            raise ValueError("rendered counts above 2**15 - 1")
        host[lo:hi].copy_(x.to(torch.int16).cpu())
    setattr(inputs, MARK, True)
