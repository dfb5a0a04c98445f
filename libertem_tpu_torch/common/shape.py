"""Shape: a tuple split into navigation and signal dimensions
(counterpart of ``libertem_tpu/common/shape.py``).

A 4D-STEM scan of 256x256 positions with 128x128 detector frames has
``Shape((256, 256, 128, 128), sig_dims=2)``: nav = (256, 256),
sig = (128, 128).
"""
from __future__ import annotations

from typing import Iterator, Sequence

from .math import prod


class Shape:
    """An n-D shape whose trailing ``sig_dims`` axes are the signal axes."""

    __slots__ = ("_nav", "_sig")

    def __init__(self, shape: Sequence[int], sig_dims: int):
        shape = tuple(int(s) for s in shape)
        sig_dims = int(sig_dims)
        if sig_dims < 0 or sig_dims > len(shape):
            raise ValueError(
                f"sig_dims={sig_dims} out of range for shape {shape}"
            )
        nav_dims = len(shape) - sig_dims
        self._nav = shape[:nav_dims]
        self._sig = shape[nav_dims:]

    @property
    def nav(self) -> "Shape":
        return Shape(self._nav, sig_dims=0)

    @property
    def sig(self) -> "Shape":
        return Shape(self._sig, sig_dims=len(self._sig))

    @property
    def size(self) -> int:
        t = self._nav + self._sig
        # an empty shape covers no elements (not the prod(()) == 1
        # convention)
        return prod(t) if t else 0

    @property
    def dims(self) -> int:
        return len(self._nav) + len(self._sig)

    @property
    def nav_dims(self) -> int:
        return len(self._nav)

    @property
    def sig_dims(self) -> int:
        return len(self._sig)

    def flatten_nav(self) -> "Shape":
        """The nav axes collapsed into one."""
        return Shape((prod(self._nav),) + self._sig, sig_dims=len(self._sig))

    def flatten_sig(self) -> "Shape":
        """The sig axes collapsed into one."""
        return Shape(self._nav + (prod(self._sig),), sig_dims=1)

    def to_tuple(self) -> tuple[int, ...]:
        return self._nav + self._sig

    def __iter__(self) -> Iterator[int]:
        return iter(self.to_tuple())

    def __getitem__(self, key):
        return self.to_tuple()[key]

    def __len__(self) -> int:
        return self.dims

    def __eq__(self, other):
        if isinstance(other, Shape):
            return self._nav == other._nav and self._sig == other._sig
        if isinstance(other, (tuple, list)):
            return self.to_tuple() == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self._nav, self._sig))

    def __add__(self, other) -> "Shape":
        """``shape + (a, b)`` appends sig axes."""
        if not isinstance(other, tuple):
            return NotImplemented
        return Shape(self._nav + self._sig + other,
                     sig_dims=len(self._sig) + len(other))

    def __radd__(self, other) -> "Shape":
        """``(a, b) + shape`` appends nav axes."""
        if not isinstance(other, tuple):
            return NotImplemented
        return Shape(self._nav + other + self._sig, sig_dims=len(self._sig))

    def __repr__(self) -> str:
        return repr(self.to_tuple())


class SigOnlyShape(Shape):
    """A Shape of sig axes only (what ``shape.sig`` is)."""

    def __init__(self, shape: Sequence[int]):
        shape = tuple(int(s) for s in shape)
        super().__init__(shape, sig_dims=len(shape))


class NavOnlyShape(Shape):
    """A Shape of nav axes only (what ``shape.nav`` is)."""

    def __init__(self, shape: Sequence[int]):
        super().__init__(tuple(int(s) for s in shape), sig_dims=0)
