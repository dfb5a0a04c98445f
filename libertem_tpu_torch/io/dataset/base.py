"""DataSet / Partition base machinery (counterpart of
``libertem_tpu/io/dataset/base.py``).

A dataset is split along the flattened navigation axis into
contiguous-frame :class:`Partition` s.  Each partition streams its
frames (those of a roi only, when the run has one) as fixed-depth
:class:`Block` s in the raw on-disk dtype, zero-padded at the tail,
with a ``valid`` count of real frames.  The cast to float happens on
the device, so narrow detector data crosses PCIe at its raw width.
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
    global_offset: first frame's position in the (roi-compressed)
                   flat nav order
    coords:        (depth, nav_dims) int32 nav coordinates of the
                   frames, zeros in the padding rows
    valid:         number of non-padding frames (<= depth)
    """

    data: np.ndarray
    global_offset: int
    coords: np.ndarray
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

    def local_frame_ids(self, roi: Optional[np.ndarray]) -> np.ndarray:
        """Flat-nav ids of the frames this partition contributes
        (roi-filtered), in order."""
        if roi is None:
            return np.arange(
                self.start_frame, self.start_frame + self.num_frames,
                dtype=np.int64,
            )
        roi = np.asarray(roi).reshape(-1)
        sel = np.flatnonzero(
            roi[self.start_frame:self.start_frame + self.num_frames]
        )
        return (sel + self.start_frame).astype(np.int64)

    def roi_offset(self, roi: Optional[np.ndarray]) -> int:
        """Position of this partition's first selected frame in the
        roi-compressed global ordering."""
        if roi is None:
            return self.start_frame
        roi = np.asarray(roi).reshape(-1)
        return int(np.count_nonzero(roi[:self.start_frame]))

    def frames_in_roi(self, roi: Optional[np.ndarray]) -> int:
        if roi is None:
            return self.num_frames
        return len(self.local_frame_ids(roi))

    def gen_blocks(
        self,
        scheme: TilingScheme,
        roi: Optional[np.ndarray] = None,
        out: Optional[Callable[[], np.ndarray]] = None,
    ) -> Iterator[Block]:
        """Stream this partition's (roi-selected) frames as
        zero-padded fixed-depth blocks.

        A roi is read run by run: each stretch of consecutive selected
        frames is one read straight into the block, so no frame
        outside the roi is read.  ``out`` hands out the destination
        array of each block (the host feed passes its pinned staging
        buffers, so frames are read straight into memory the card can
        copy from); by default every block gets a fresh array.
        """
        ids = self.local_frame_ids(roi)
        depth = scheme.depth
        goff = self.roi_offset(roi)
        nav_shape = tuple(self.meta.shape.nav)
        sig = tuple(self.meta.shape.sig)
        for off in range(0, len(ids), depth):
            chunk = ids[off:off + depth]
            valid = len(chunk)
            data = (
                np.empty((depth,) + sig, self.meta.native_dtype)
                if out is None else out()
            )
            breaks = np.flatnonzero(np.diff(chunk) != 1) + 1
            starts = np.concatenate(([0], breaks))
            stops = np.concatenate((breaks, [valid]))
            for a, b in zip(starts, stops):
                self.read_frames_into(
                    int(chunk[a]), int(chunk[b - 1]) + 1, data[a:b]
                )
            data[valid:] = 0
            coords = np.zeros((depth, len(nav_shape)), dtype=np.int32)
            if nav_shape:
                for d, u in enumerate(np.unravel_index(chunk, nav_shape)):
                    coords[:valid, d] = u
            yield Block(
                data=data, global_offset=goff + off, coords=coords,
                valid=valid,
            )


class DataSet:
    """Base class of the dataset formats: subclasses fill
    ``self._meta`` in :meth:`initialize` and yield their Partition
    subclass from :meth:`get_partitions`."""

    def __init__(self, num_partitions: Optional[int] = None):
        self._meta: Optional[DataSetMeta] = None
        self._num_partitions = num_partitions
        self._cores = 1

    def set_num_cores(self, cores: int) -> None:
        """The least partition count without a fixed ``num_partitions``
        (``Context.load`` asks for 4, as the JAX package's does)."""
        self._cores = max(1, int(cores))

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
        """At least ``set_num_cores`` partitions, each at most
        MAX_PARTITION_SIZE bytes, unless the caller fixed the count."""
        if self._num_partitions is not None:
            n = max(1, self._num_partitions)
        else:
            total = self.meta.shape.size * self.meta.raw_dtype.itemsize
            n = max(self._cores, -(-total // MAX_PARTITION_SIZE))
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
