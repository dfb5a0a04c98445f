"""RAW binary dataset: plain uncompressed frames on disk (counterpart
of ``libertem_tpu/io/dataset/raw.py``).

Frames are read with ``preadv`` straight into the destination the
host feed hands out (a pinned staging buffer on the CUDA path), so a
block costs one copy from the page cache and one DMA to the card.
"""
from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from ...common.math import prod
from ...common.shape import Shape
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    Partition,
    pread_into,
)


class RawPartition(Partition):
    def __init__(self, path, dtype, sig_shape, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._path = path
        self._frame_bytes = prod(sig_shape) * np.dtype(dtype).itemsize

    def _read_raw_frames(self, start, stop, out):
        if not out.flags.c_contiguous:
            raise ValueError("read destination must be C-contiguous")
        fd = os.open(self._path, os.O_RDONLY)
        try:
            pread_into(
                fd, memoryview(out).cast("B"),
                start * self._frame_bytes, self._path,
            )
        finally:
            os.close(fd)


class RawFileDataSet(DataSet):
    def __init__(
        self,
        path: str,
        dtype,
        nav_shape: Sequence[int],
        sig_shape: Sequence[int],
        num_partitions=None,
    ):
        super().__init__(num_partitions=num_partitions)
        self._path = path
        self._dtype = np.dtype(dtype)
        if not self._dtype.isnative:
            raise DataSetException(
                "non-native byte order is not supported yet"
            )
        self._nav_shape = tuple(int(s) for s in nav_shape)
        self._sig_shape = tuple(int(s) for s in sig_shape)

    def initialize(self) -> "RawFileDataSet":
        frame_bytes = prod(self._sig_shape) * self._dtype.itemsize
        # trailing bytes short of a whole frame are ignored; frames of
        # nav past the end of the file read as zeros
        image_count = os.path.getsize(self._path) // frame_bytes
        self._meta = DataSetMeta(
            shape=Shape(
                self._nav_shape + self._sig_shape,
                sig_dims=len(self._sig_shape),
            ),
            raw_dtype=self._dtype,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[RawPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield RawPartition(
                self._path, self._dtype, self._sig_shape,
                self.meta, start, stop - start, idx=idx,
            )
