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
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RepairValueError(ValueError):
    """An excluded pixel has no usable repair environment."""


def check_repair_environments(sig_shape, coords):
    """Raise RepairValueError if any excluded pixel's radius-1
    neighbourhood consists entirely of other excluded pixels or
    out-of-bounds positions.  The repair itself grows its environment
    until it finds a pixel, so it could repair such pixels anyway; the
    check is part of the CorrectionSet contract."""
    coords = np.asarray(coords, np.int64)  # (n, ndim)
    if coords.size == 0:
        return
    ndim = coords.shape[1]
    sig_shape = tuple(int(s) for s in sig_shape)
    # out-of-bounds excluded coordinates fail loudly (mode='raise')
    excluded_flat = {
        int(i) for i in np.ravel_multi_index(tuple(coords.T), sig_shape)
    }
    offsets = np.stack(np.meshgrid(
        *([np.array([-1, 0, 1])] * ndim), indexing="ij"
    ), axis=-1).reshape(-1, ndim)
    offsets = offsets[np.any(offsets != 0, axis=1)]
    for i, c in enumerate(coords):
        env = c[None, :] + offsets
        ok = np.all((env >= 0) & (env < np.array(sig_shape)), axis=1)
        env = env[ok]
        flat = np.ravel_multi_index(tuple(env.T), sig_shape)
        if all(int(f) in excluded_flat for f in flat):
            raise RepairValueError(
                f"Empty repair environments for pixel(s) number "
                f"[[{i}]]."
            )


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
