"""Slice: an n-D hyperrectangle (origin + Shape) into a dataset
(counterpart of ``libertem_tpu/common/slice.py``).

Partitions describe the flat-nav frame range they cover with one; a
tiling scheme lists the sig slices of its tiles (``subslices`` cuts
the frame into them).  A UDF reads its sig tile as
``self.meta.sig_slice`` and cuts a frame-shaped array to it with
``self.meta.sig_slice.get(arr, sig_only=True)``.
"""
from __future__ import annotations

import itertools
from typing import Iterator, Optional, Sequence

import numpy as np

from .math import prod
from .shape import Shape


class SliceUsageError(ValueError):
    """A Slice built or used the wrong way."""


class Slice:
    __slots__ = ("origin", "shape")

    def __init__(self, origin: Sequence[int], shape: Shape):
        if not isinstance(shape, Shape):
            raise SliceUsageError(
                f"shape must be a Shape, got {type(shape).__name__}"
            )
        origin = tuple(int(o) for o in origin)
        if len(origin) != shape.dims:
            raise SliceUsageError(
                f"origin {origin} and shape {shape} dims mismatch"
            )
        self.origin = origin
        self.shape = shape

    def __repr__(self) -> str:
        return f"<Slice origin={self.origin} shape={self.shape}>"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Slice)
            and self.origin == other.origin
            and self.shape == other.shape
        )

    def __hash__(self) -> int:
        return hash((self.origin, self.shape.to_tuple(), self.shape.sig_dims))

    @property
    def nav(self) -> "Slice":
        """The nav part (sig axes dropped)."""
        nd = self.shape.nav_dims
        return Slice(self.origin[:nd], self.shape.nav)

    @property
    def sig(self) -> "Slice":
        """The sig part (nav axes dropped)."""
        nd = self.shape.nav_dims
        return Slice(self.origin[nd:], self.shape.sig)

    def intersection_with(self, other: "Slice") -> "Slice":
        """The overlap of two slices of the same dims; a null slice
        (every extent 0) where they do not overlap."""
        if len(self.origin) != len(other.origin):
            raise SliceUsageError("dimension mismatch")
        if self.shape.sig_dims != other.shape.sig_dims:
            raise SliceUsageError(
                f"sig_dims mismatch ({self.shape.sig_dims} vs "
                f"{other.shape.sig_dims})"
            )
        origin = tuple(max(a, b) for a, b in zip(self.origin, other.origin))
        ends = tuple(
            min(a + sa, b + sb)
            for a, b, sa, sb in zip(
                self.origin, other.origin, self.shape, other.shape
            )
        )
        shape = tuple(max(0, e - o) for o, e in zip(origin, ends))
        if any(s == 0 for s in shape):
            shape = (0,) * len(shape)
        return Slice(origin, Shape(shape, sig_dims=self.shape.sig_dims))

    def is_null(self) -> bool:
        return self.shape.size == 0

    def shift(self, other: "Slice") -> "Slice":
        """This slice relative to ``other``'s origin."""
        if len(self.origin) != len(other.origin):
            raise SliceUsageError(
                "cannot shift slices with different dimensionality "
                f"({self.origin} vs {other.origin})"
            )
        return Slice(
            tuple(o - oo for o, oo in zip(self.origin, other.origin)),
            self.shape,
        )

    def shift_by(self, offset) -> "Slice":
        """The origin moved by ``offset`` (a Slice: as :meth:`shift`)."""
        if isinstance(offset, Slice):
            return self.shift(offset)
        offset = tuple(int(o) for o in offset)
        if len(self.origin) != len(offset):
            raise SliceUsageError(
                "cannot shift slices with different dimensionality "
                f"({self.origin} vs {offset})"
            )
        return Slice(
            tuple(o + d for o, d in zip(self.origin, offset)), self.shape
        )

    def clip_to(self, shape: Shape) -> "Slice":
        """The part of this slice inside a zero-origin ``shape``."""
        return self.intersection_with(Slice((0,) * shape.dims, shape))

    def get(self, arr=None, sig_only: bool = False, nav_only: bool = False):
        """A tuple of python slices (of the sig or nav axes only, with
        ``sig_only`` / ``nav_only``); or ``arr`` sliced with it, where a
        sig-only cut addresses the trailing axes of ``arr``."""
        nd = self.shape.nav_dims
        if sig_only:
            origin, shape = self.origin[nd:], self.shape.sig
        elif nav_only:
            origin, shape = self.origin[:nd], self.shape.nav
        else:
            origin, shape = self.origin, self.shape
        slices = tuple(slice(o, o + s) for o, s in zip(origin, shape))
        if arr is None:
            return slices
        if sig_only:
            return arr[(Ellipsis,) + slices]
        return arr[slices]

    def discard_nav(self) -> "Slice":
        """The sig part (nav origin dropped)."""
        return self.sig

    @classmethod
    def from_shape(cls, shape: Sequence[int], sig_dims: int) -> "Slice":
        s = Shape(shape, sig_dims=sig_dims)
        return cls((0,) * s.dims, s)

    def subslices(self, shape: Sequence[int]) -> Iterator["Slice"]:
        """Sub-slices tiling this slice in a grid of ``shape`` (the
        last ones along each axis cut at the edge)."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != self.shape.dims:
            raise SliceUsageError("subslice shape dims mismatch")
        ranges = [
            range(o, o + full, step)
            for o, full, step in zip(self.origin, self.shape, shape)
        ]
        for origin in itertools.product(*ranges):
            sub_shape = tuple(
                min(step, o + full - oo)
                for oo, o, full, step in zip(
                    origin, self.origin, self.shape, shape
                )
            )
            yield Slice(
                origin, Shape(sub_shape, sig_dims=self.shape.sig_dims)
            )

    def flatten_nav(self, containing_shape) -> "Slice":
        """This slice in flat-nav coordinates of ``containing_shape`` (a
        Shape, or a shape whose leading entries are the nav shape).
        Valid where the nav region is contiguous in C order, as a
        partition's is."""
        nd = self.shape.nav_dims
        if isinstance(containing_shape, Shape):
            nav_shape = tuple(containing_shape.nav)
        else:
            nav_shape = tuple(containing_shape)[:nd]
        strides = [prod(nav_shape[i + 1:]) for i in range(len(nav_shape))]
        flat_origin = sum(o * s for o, s in zip(self.origin[:nd], strides))
        return Slice(
            (flat_origin,) + self.origin[nd:],
            Shape((prod(self.shape.nav),) + tuple(self.shape.sig),
                  sig_dims=self.shape.sig_dims),
        )

    def adjust_for_roi(self, roi: Optional[np.ndarray]) -> "Slice":
        """This flat-nav slice in roi-compressed coordinates: its nav
        origin and extent count the selected frames only (``roi`` a
        bool mask over the whole nav)."""
        if roi is None:
            return self
        if self.shape.nav_dims != 1:
            raise SliceUsageError("adjust_for_roi requires flat nav")
        roi = np.asarray(roi).reshape(-1)
        o, s = self.origin[0], self.shape[0]
        return Slice(
            (int(np.count_nonzero(roi[:o])),) + self.origin[1:],
            Shape((int(np.count_nonzero(roi[o:o + s])),)
                  + tuple(self.shape.sig), sig_dims=self.shape.sig_dims),
        )
