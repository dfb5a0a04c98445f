"""Detector corrections: dark frame, gain map, excluded-pixel repair
(counterpart of ``libertem_tpu/io/corrections.py``).

The correction is applied on the device to each block, before any UDF
or the fused kernel sees it (``UDFRunner._apply_corrections``):

    y = (x - dark) * gain
    y[..., excluded] = mean(y[..., neighbors(excluded)])

The neighbour environments are planned here on the host, in numpy, as
static gather index matrices (growing square environments that skip
other excluded pixels); the plan is bit for bit the JAX package's, so
the device repair is one gather, one weighted sum and one scatter.

The standalone functions :func:`correct` and :func:`correct_dot_masks`
correct an array, or fold the correction into masks, on the host with
numpy; they repair with fixed radius-1 environments
(:class:`RepairDescriptor`), as the JAX package's do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..common.math import prod


class CorrectError(Exception):
    """Invalid input for the standalone correction functions."""


class RepairValueError(ValueError):
    """An excluded pixel has no usable repair environment."""


def check_repair_environments(sig_shape, coords):
    """Raise RepairValueError if any excluded pixel's radius-1
    neighbourhood consists entirely of other excluded pixels or
    out-of-bounds positions.  The repair itself grows its environment
    until it finds a pixel, so it could repair such pixels anyway; the
    check is part of the CorrectionSet contract.  Out-of-bounds
    excluded coordinates raise ValueError."""
    coords = np.asarray(coords, np.int64)  # (n, ndim)
    if coords.size == 0:
        return
    _, _, counts = _radius1_environments(coords, sig_shape)
    empty = np.flatnonzero(counts == 0)
    if len(empty):
        raise RepairValueError(
            f"Empty repair environments for pixel(s) number "
            f"[[{empty[0]}]]."
        )


def _conflict_free_multiple(excluded, extent, base, target):
    """The multiple of ``base`` closest to ``target`` none of whose
    positive multiples below ``extent`` lands on an ``excluded``
    position.  The search alternates outward from the rounded target
    (+0, -1, +2, ...) in steps of ``base``; when nothing qualifies it
    returns the first multiple of ``base`` past the largest excluded
    position (at most ``extent``)."""
    if len(excluded) == 0:
        return max(base, int(round(target / base)) * base)
    max_excluded = int(np.max(excluded))
    excluded_set = set(int(e) for e in excluded)
    current = base * int(round(target / base))
    sign = 1 if current >= target else -1
    for offset in range(max_excluded // base + 1):
        current += offset * sign * base
        sign *= -1
        if current <= 0:
            continue
        clear = all(
            (current * k) not in excluded_set
            for k in range(1, max_excluded // current + 1)
            if current * k < extent
        )
        if clear:
            return current
    return min((max_excluded // base + 1) * base, extent)


class CorrectionSet:
    def __init__(
        self,
        dark: Optional[np.ndarray] = None,
        gain: Optional[np.ndarray] = None,
        excluded_pixels: Optional[np.ndarray] = None,
        allow_empty: bool = False,
    ):
        """
        dark: (*sig) array subtracted from each frame
        gain: (*sig) array multiplied into each frame
        excluded_pixels: a boolean (*sig) mask, an object with a
            ``.coords`` attribute (sparse COO, ``(ndim, n)``), a
            scipy.sparse matrix, or an integer coordinate array of
            defective pixels to repair, ``(ndim, n)`` or ``(n, ndim)``
            (a square array reads as ``(ndim, n)``).
        allow_empty: when False, check at construction that every
            excluded pixel has a non-empty radius-1 repair environment,
            raising RepairValueError otherwise.
        """
        self._dark = None if dark is None else np.asarray(dark, np.float32)
        self._gain = None if gain is None else np.asarray(gain, np.float32)
        self._excluded_coords: Optional[np.ndarray] = None
        if excluded_pixels is not None:
            if hasattr(excluded_pixels, "coords"):
                coords = np.asarray(excluded_pixels.coords).T
            elif hasattr(excluded_pixels, "toarray"):
                coords = np.argwhere(
                    np.asarray(excluded_pixels.toarray()).astype(bool)
                )
            else:
                ex = np.asarray(excluded_pixels)
                if ex.dtype == bool:
                    coords = np.argwhere(ex)  # (n, ndim)
                else:
                    ex = np.atleast_2d(ex)
                    sig_ndim = (
                        self._dark.ndim if self._dark is not None
                        else (
                            self._gain.ndim
                            if self._gain is not None else 2
                        )
                    )
                    coords = ex.T if ex.shape[0] == sig_ndim else ex
            self._excluded_coords = coords.astype(np.int64)
        if not allow_empty and self._excluded_coords is not None:
            sig_shape = None
            if hasattr(excluded_pixels, "shape") and not isinstance(
                excluded_pixels, np.ndarray
            ):
                sig_shape = tuple(excluded_pixels.shape)
            elif (
                isinstance(excluded_pixels, np.ndarray)
                and excluded_pixels.dtype == bool
            ):
                sig_shape = excluded_pixels.shape
            elif self._dark is not None:
                sig_shape = self._dark.shape
            elif self._gain is not None:
                sig_shape = self._gain.shape
            if sig_shape is not None:
                check_repair_environments(
                    sig_shape, self._excluded_coords
                )
        self._cache = {}

    @property
    def dark(self) -> Optional[np.ndarray]:
        return self._dark

    @property
    def gain(self) -> Optional[np.ndarray]:
        return self._gain

    @property
    def excluded_coords(self) -> Optional[np.ndarray]:
        return self._excluded_coords

    def have_corrections(self) -> bool:
        return (
            self._dark is not None
            or self._gain is not None
            or (
                self._excluded_coords is not None
                and len(self._excluded_coords) > 0
            )
        )

    def make_plan(self, sig_shape: Sequence[int]) -> Optional[dict]:
        """Static numpy arrays of the device correction, or None when
        there is nothing to correct:

          dark (*sig) f32 | None
          gain (*sig) f32 | None
          repair_idx (k,) int32 flat sig indices of excluded pixels
          nbr_idx (k, m) int32 flat sig indices of repair neighbours
          nbr_w (k, m) f32 normalized weights (0 for padding)
        """
        sig_shape = tuple(int(s) for s in sig_shape)
        if sig_shape in self._cache:
            return self._cache[sig_shape]
        if not self.have_corrections():
            self._cache[sig_shape] = None
            return None
        for name, arr in (("dark", self._dark), ("gain", self._gain)):
            if arr is not None and arr.shape != sig_shape:
                # broadcastable-but-wrong arrays ((1, w), (w,)) would
                # silently apply the same row everywhere
                raise ValueError(
                    f"{name} frame shape {arr.shape} != detector sig "
                    f"shape {sig_shape}"
                )
        plan = {
            "dark": self._dark,
            "gain": self._gain,
            "repair_idx": None,
            "nbr_idx": None,
            "nbr_w": None,
        }
        if (
            self._excluded_coords is not None
            and len(self._excluded_coords) > 0
        ):
            idx, nbr, w = _neighbor_plan(self._excluded_coords, sig_shape)
            plan["repair_idx"] = idx
            plan["nbr_idx"] = nbr
            plan["nbr_w"] = w
        self._cache[sig_shape] = plan
        return plan

    def adjust_scheme(self, scheme, dataset_shape):
        """Veto sig tiling that would split pixel-repair environments:
        fall back to whole-frame tiles, shrinking the block depth so
        the staged block stays within the budget the sig split existed
        to protect."""
        from ..common.shape import Shape
        from .tiling import Negotiator, TilingScheme
        if (
            self._excluded_coords is None
            or len(self._excluded_coords) == 0
            or len(scheme) <= 1
        ):
            return scheme
        frame_bytes = dataset_shape.sig.size * 4  # f32 on device
        depth = scheme.depth
        budget = Negotiator.TARGET_BLOCK_BYTES
        if depth * frame_bytes > budget:
            depth = max(1, budget // frame_bytes)
        tileshape = Shape(
            (depth,) + tuple(dataset_shape.sig),
            sig_dims=dataset_shape.sig.dims,
        )
        return TilingScheme.make_for_shape(
            tileshape, dataset_shape, intent=scheme.intent
        )

    def adjust_tileshape(self, tile_shape, sig_shape, base_shape):
        """A per-axis tile size (a multiple of ``base_shape``, close to
        ``tile_shape``) whose tile borders never fall on an excluded
        pixel or its right neighbour, so radius-1 repair environments
        stay inside one tile.  An axis without such a multiple, or with
        excluded pixels in more than a third of its positions, gets the
        whole extent."""
        coords = self._excluded_coords
        if coords is None or len(coords) == 0:
            return tile_shape
        adjusted = [int(t) for t in tile_shape]
        for dim in range(len(adjusted)):
            extent = int(sig_shape[dim])
            if extent <= 1:
                continue
            unique = np.unique(coords[:, dim])
            if len(unique) > extent / 3:
                adjusted[dim] = extent
                continue
            # a border at p splits the environment of a pixel at p or
            # at p - 1
            forbidden = np.concatenate((unique, unique + 1))
            forbidden = forbidden[forbidden <= extent]
            nonzero = forbidden[forbidden != 0]
            m = min(extent, _conflict_free_multiple(
                nonzero, extent, int(base_shape[dim]), adjusted[dim],
            ))
            # every tiling has a border at 0: a pixel there cannot be
            # protected, only a size of 1 avoided
            min_size = max(m, 2) if len(nonzero) != len(forbidden) \
                else m
            if adjusted[dim] < min_size or adjusted[dim] % m != 0:
                adjusted[dim] = m
        return tuple(
            int(sig_shape[dim]) if (a <= 0 or a > int(sig_shape[dim]))
            else a
            for dim, a in enumerate(adjusted)
        )

    def apply_numpy(self, frames: np.ndarray) -> np.ndarray:
        """Plain numpy version of the device correction (for tests)."""
        sig_shape = frames.shape[1:]
        out = frames.astype(np.float32, copy=True)
        if self._dark is not None:
            out -= self._dark
        if self._gain is not None:
            out *= self._gain
        plan = self.make_plan(sig_shape)
        if plan is not None and plan["repair_idx"] is not None:
            flat = out.reshape(out.shape[0], -1)
            vals = flat[:, plan["nbr_idx"]]  # (n, k, m)
            mean = (vals * plan["nbr_w"]).sum(axis=-1)
            flat[:, plan["repair_idx"]] = mean
        return out


def _neighbor_plan(
    coords: np.ndarray, sig_shape: tuple
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Growing-environment neighbour indices for each excluded pixel.

    For each excluded pixel, grow a centred square/cube environment
    (radius 1, 2, ...) until it contains at least one valid (in-bounds,
    non-excluded) pixel; average over all valid pixels at that radius.
    """
    ndim = len(sig_shape)
    excluded_set = {tuple(c) for c in coords}
    k = len(coords)
    nbr_lists = []
    max_m = 0
    for c in coords:
        found: list[int] = []
        for radius in range(1, max(sig_shape) + 1):
            ranges = [
                range(
                    max(0, int(c[d]) - radius),
                    min(sig_shape[d], int(c[d]) + radius + 1),
                )
                for d in range(ndim)
            ]
            pts = np.stack(
                np.meshgrid(*ranges, indexing="ij"), axis=-1
            ).reshape(-1, ndim)
            found = [
                int(np.ravel_multi_index(tuple(p), sig_shape))
                for p in pts
                if tuple(p) not in excluded_set
            ]
            if found:
                break
        if not found:  # everything excluded: repair with itself
            found = [int(np.ravel_multi_index(tuple(c), sig_shape))]
        nbr_lists.append(found)
        max_m = max(max_m, len(found))
    nbr_idx = np.zeros((k, max_m), dtype=np.int32)
    nbr_w = np.zeros((k, max_m), dtype=np.float32)
    for i, lst in enumerate(nbr_lists):
        nbr_idx[i, :len(lst)] = lst
        nbr_w[i, :len(lst)] = 1.0 / len(lst)
    repair_idx = np.array(
        [np.ravel_multi_index(tuple(c), sig_shape) for c in coords],
        dtype=np.int32,
    )
    return repair_idx, nbr_idx, nbr_w


# -- the standalone corrections -------------------------------------------


def _radius1_environments(coords, sig_shape):
    """Per excluded pixel, the flat indices of its in-bounds radius-1
    neighbours that are not excluded themselves: ``(exclude_flat (k,),
    repair_flat (k, 3^ndim - 1), repair_counts (k,))``, rows packed to
    the left and padded with 0."""
    coords = np.asarray(coords, np.int64)  # (k, ndim)
    k, ndim = coords.shape
    sig_shape = tuple(int(s) for s in sig_shape)
    offsets = np.stack(np.meshgrid(
        *([np.array([-1, 0, 1])] * ndim), indexing="ij"
    ), axis=-1).reshape(-1, ndim)
    offsets = offsets[np.any(offsets != 0, axis=1)]
    excluded_flat = np.ravel_multi_index(tuple(coords.T), sig_shape)
    excluded_set = set(int(e) for e in excluded_flat)
    repair_flat = np.zeros((k, len(offsets)), dtype=np.intp)
    repair_counts = np.zeros(k, dtype=np.intp)
    for i in range(k):
        env = coords[i][None, :] + offsets
        env = env[np.all((env >= 0) & (env < np.array(sig_shape)), axis=1)]
        if len(env):
            flat = np.ravel_multi_index(tuple(env.T), sig_shape)
            flat = flat[[int(f) not in excluded_set for f in flat]]
            repair_flat[i, :len(flat)] = flat
            repair_counts[i] = len(flat)
    return excluded_flat.astype(np.intp), repair_flat, repair_counts


class RepairDescriptor:
    """The radius-1 repair environments of a set of excluded pixels
    (``(ndim, k)`` sig coordinates), reusable across calls of
    :func:`correct`."""

    def __init__(self, sig_shape, excluded_pixels=None,
                 allow_empty=False):
        if excluded_pixels is None:
            excluded_pixels = np.zeros((len(sig_shape), 0), np.intp)
        coords = np.asarray(excluded_pixels).T  # (k, ndim)
        self.exclude_flat, self.repair_flat, self.repair_counts = (
            _radius1_environments(coords, sig_shape)
        )
        self.check_empty_repairs(allow_empty=allow_empty)

    def empty_repairs(self):
        return np.argwhere(self.repair_counts == 0)

    def check_empty_repairs(self, allow_empty):
        if not allow_empty:
            empty = self.empty_repairs()
            if len(empty) > 0:
                raise RepairValueError(
                    f"Empty repair environments for pixel(s) number "
                    f"{empty}."
                )


def _apply_repairs(flat, desc):
    """Each excluded pixel of the (n, n_sig) ``flat`` (in place) set to
    the mean of its (corrected) repair environment."""
    if len(desc.exclude_flat) == 0:
        return
    reparable = desc.repair_counts > 0
    if not np.any(reparable):
        return
    ex = desc.exclude_flat[reparable]
    env = desc.repair_flat[reparable]           # (k, m)
    counts = desc.repair_counts[reparable]      # (k,)
    vals = flat[:, env]                         # (n, k, m)
    # the padding entries index pixel 0: weight 0
    w = (np.arange(env.shape[1])[None, :] < counts[:, None])
    means = (vals * w[None, :, :]).sum(axis=-1) / counts[None, :]
    flat[:, ex] = means.astype(flat.dtype, copy=False)


def correct(buffer, dark_image=None, gain_map=None,
            excluded_pixels=None, repair_descriptor=None,
            inplace=False, sig_shape=None, allow_empty=False):
    """Dark subtraction, gain and excluded-pixel repair of an
    (\\*nav, \\*sig) array, in float32 at least.

    ``excluded_pixels`` is an (ndim, k) index array in sig space.
    ``inplace=True`` needs float data (TypeError otherwise) and a
    C-contiguous buffer (CorrectError otherwise).
    """
    if dark_image is not None:
        dark_image = np.asarray(dark_image)
        sig_shape = dark_image.shape
    if gain_map is not None:
        gain_map = np.asarray(gain_map)
        sig_shape = gain_map.shape
    if sig_shape is None:
        raise ValueError(
            "need either `dark_image`, `gain_map`, or `sig_shape`")
    sig_shape = tuple(int(s) for s in sig_shape)
    nav_shape = buffer.shape[:buffer.ndim - len(sig_shape)]
    if inplace:
        if buffer.dtype.kind not in ("f", "c"):
            raise TypeError(
                "In-place correction only supported for floating "
                "point data.")
        out = buffer
    else:
        out = buffer.astype(np.result_type(np.float32, buffer))
    if not out.flags["C_CONTIGUOUS"] or np.isfortran(buffer):
        raise CorrectError(
            "For in-place operation, the buffer given must be "
            "C-contiguous")
    if repair_descriptor is None:
        repair_descriptor = RepairDescriptor(
            sig_shape=sig_shape, excluded_pixels=excluded_pixels,
            allow_empty=allow_empty,
        )
    else:
        repair_descriptor.check_empty_repairs(allow_empty=allow_empty)
        if excluded_pixels is not None:
            raise ValueError(
                "Invalid arguments: both repair_descriptor and "
                "excluded_pixels set")
    flat = out.reshape((prod(nav_shape), prod(sig_shape)))
    # the operands in the output's precision, as the device correction
    # carries dark and gain in float32
    if dark_image is not None:
        flat -= dark_image.reshape(-1).astype(out.dtype, copy=False)
    if gain_map is not None:
        flat *= gain_map.reshape(-1).astype(out.dtype, copy=False)
    _apply_repairs(flat, repair_descriptor)
    return out


def correct_dot_masks(masks, gain_map, excluded_pixels=None,
                      allow_empty=False):
    """The gain and the repair folded into masks instead of the data:
    each excluded pixel's mask weight is shared equally among its
    repair environment, then the gain multiplies in, so that
    ``(data - dark) @ corrected.T`` equals ``correct(data, dark, gain,
    excluded) @ masks.T``.  A sparse stack comes back as its own
    type."""
    from ..common.sparse import is_sparse
    mask_shape = masks.shape
    sig_shape = gain_map.shape
    sparse_in = is_sparse(masks)
    dense = np.asarray(masks).reshape((-1, prod(sig_shape)))
    if excluded_pixels is not None:
        desc = RepairDescriptor(sig_shape, excluded_pixels=excluded_pixels,
                                allow_empty=allow_empty)
        result = dense.copy()
        reparable = desc.repair_counts > 0
        result[:, desc.exclude_flat] = 0
        if np.any(reparable):
            ex = desc.exclude_flat[reparable]
            env = desc.repair_flat[reparable]       # (k, m)
            counts = desc.repair_counts[reparable]
            share = dense[:, ex] / counts[None, :]  # (n_masks, k)
            valid = (np.arange(env.shape[1])[None, :] < counts[:, None])
            np.add.at(
                result,
                (slice(None), env.reshape(-1)),
                (share[:, :, None] * valid[None, :, :]).reshape(
                    result.shape[0], -1),
            )
    else:
        result = dense
    result = (result * gain_map.reshape(-1)).reshape(mask_shape)
    if sparse_in:
        result = type(masks)(result)
    return result
