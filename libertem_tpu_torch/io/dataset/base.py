"""DataSet / Partition base machinery (counterpart of
``libertem_tpu/io/dataset/base.py``).

A dataset is split along the flattened navigation axis into
contiguous-frame :class:`Partition` s.  Each partition streams its
frames as fixed-depth :class:`Block` s in the raw on-disk dtype,
zero-padded at the tail, with a ``valid`` count of real frames.  The
cast to float happens on the device, inside the fused kernel, so
narrow detector data crosses PCIe at its raw width.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from ...common.shape import Shape
from ..tiling import TilingScheme

MAX_PARTITION_SIZE = 512 * 1024 * 1024  # bytes


class DataSetException(Exception):
    pass


@dataclass
class DataSetMeta:
    shape: Shape
    raw_dtype: np.dtype
    # frames actually present in the data; frames of nav beyond it
    # read as zeros
    image_count: Optional[int] = None

    def __post_init__(self):
        self.raw_dtype = np.dtype(self.raw_dtype)
        if self.image_count is None:
            self.image_count = self.shape.nav.size

    @property
    def native_dtype(self) -> np.dtype:
        """``raw_dtype`` in native byte order."""
        return np.dtype(self.raw_dtype.newbyteorder("="))


@dataclass
class Block:
    """One fixed-depth chunk of frames headed for the device.

    data:          (depth, *sig) raw-dtype array, zero-padded
    global_offset: first frame's position in the flat nav order
    valid:         number of non-padding frames (<= depth)
    """

    data: np.ndarray
    global_offset: int
    valid: int


class Partition:
    """A contiguous flat-nav frame range of a dataset."""

    def __init__(self, meta: DataSetMeta, start_frame: int,
                 num_frames: int, idx: int = 0):
        self.meta = meta
        self.start_frame = int(start_frame)
        self.num_frames = int(num_frames)
        self.idx = int(idx)

    def __repr__(self):
        return (
            f"<{type(self).__name__} #{self.idx} "
            f"[{self.start_frame}:{self.start_frame + self.num_frames})>"
        )

    def _read_raw_frames(self, start: int, stop: int,
                         out: np.ndarray) -> None:
        """Read frames [start, stop) into ``out`` ((stop - start,
        *sig), native dtype).  Indices lie within [0, image_count)."""
        raise NotImplementedError()

    def read_frames_into(self, start: int, stop: int,
                         out: np.ndarray) -> None:
        """Fill ``out`` with frames [start, stop); frames past the
        data's ``image_count`` are zero."""
        c1 = max(start, min(self.meta.image_count, stop))
        if c1 > start:
            self._read_raw_frames(start, c1, out[:c1 - start])
        out[c1 - start:] = 0

    def gen_blocks(
        self,
        scheme: TilingScheme,
        out: Optional[Callable[[], np.ndarray]] = None,
    ) -> Iterator[Block]:
        """Stream this partition as zero-padded fixed-depth blocks.

        ``out`` hands out the destination array of each block (the
        host feed passes its pinned staging buffers, so frames are
        read straight into memory the card can copy from); by default
        every block gets a fresh array.
        """
        depth = scheme.depth
        sig = tuple(self.meta.shape.sig)
        for off in range(0, self.num_frames, depth):
            valid = min(depth, self.num_frames - off)
            data = (
                np.empty((depth,) + sig, self.meta.native_dtype)
                if out is None else out()
            )
            start = self.start_frame + off
            self.read_frames_into(start, start + valid, data[:valid])
            data[valid:] = 0
            yield Block(data=data, global_offset=start, valid=valid)


class DataSet:
    """Base class of the dataset formats: subclasses fill
    ``self._meta`` in :meth:`initialize` and yield their Partition
    subclass from :meth:`get_partitions`."""

    def __init__(self, num_partitions: Optional[int] = None):
        self._meta: Optional[DataSetMeta] = None
        self._num_partitions = num_partitions

    def initialize(self) -> "DataSet":
        raise NotImplementedError()

    @property
    def meta(self) -> DataSetMeta:
        if self._meta is None:
            raise DataSetException("dataset not initialized")
        return self._meta

    @property
    def shape(self) -> Shape:
        return self.meta.shape

    def get_num_partitions(self) -> int:
        """Each partition at most MAX_PARTITION_SIZE bytes, unless the
        caller fixed the count."""
        if self._num_partitions is not None:
            n = max(1, self._num_partitions)
        else:
            total = self.meta.shape.size * self.meta.raw_dtype.itemsize
            n = max(1, -(-total // MAX_PARTITION_SIZE))
        return min(n, max(1, self.meta.shape.nav.size))

    def get_partition_ranges(self) -> list[tuple[int, int]]:
        n_frames = self.meta.shape.nav.size
        bounds = np.linspace(
            0, n_frames, self.get_num_partitions() + 1
        ).astype(np.int64)
        return [
            (int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
            if b > a
        ]

    def get_partitions(self) -> Iterator[Partition]:
        raise NotImplementedError()

    def __repr__(self):
        if self._meta is None:
            return f"<{type(self).__name__} (uninitialized)>"
        return f"<{type(self).__name__} shape={self.shape}>"


def pread_into(fd: int, view: memoryview, offset: int, path: str) -> None:
    """Fill ``view`` from ``fd`` at ``offset``: one ``preadv`` is
    capped near 2 GiB by the kernel and may return early, so loop;
    a read that ends before the view is full is an error."""
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        if n <= 0:
            raise IOError(
                f"short read: {got} of {len(view)} bytes at offset "
                f"{offset} ({path})"
            )
        got += n
