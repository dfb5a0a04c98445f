"""Slice: an n-D hyperrectangle (origin + Shape) into a dataset
(counterpart of ``libertem_tpu/common/slice.py``).

Partitions describe the flat-nav frame range they cover with one; a
tiling scheme lists the sig slices of its tiles (``subslices`` cuts
the frame into them).
"""
from __future__ import annotations

import itertools
from typing import Iterator, Sequence

from .shape import Shape


class Slice:
    __slots__ = ("origin", "shape")

    def __init__(self, origin: Sequence[int], shape: Shape):
        if not isinstance(shape, Shape):
            raise TypeError(
                f"shape must be a Shape, got {type(shape).__name__}"
            )
        origin = tuple(int(o) for o in origin)
        if len(origin) != shape.dims:
            raise ValueError(
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
        return hash(
            (self.origin, self.shape.to_tuple(), self.shape.sig.dims)
        )

    def get(self, arr=None):
        """A tuple of python slices; or ``arr`` sliced with it."""
        slices = tuple(
            slice(o, o + s) for o, s in zip(self.origin, self.shape)
        )
        return slices if arr is None else arr[slices]

    @classmethod
    def from_shape(cls, shape: Sequence[int], sig_dims: int) -> "Slice":
        s = Shape(shape, sig_dims=sig_dims)
        return cls((0,) * s.dims, s)

    def subslices(self, shape: Sequence[int]) -> Iterator["Slice"]:
        """Sub-slices tiling this slice in a grid of ``shape`` (the
        last ones along each axis cut at the edge)."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != self.shape.dims:
            raise ValueError("subslice shape dims mismatch")
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
                origin, Shape(sub_shape, sig_dims=self.shape.sig.dims)
            )
