"""In-memory dataset (counterpart of
``libertem_tpu/io/dataset/memory.py``): wraps a numpy array, with a
controllable partition count, a sync offset, a forced tile shape and
an artificial read delay for tests."""
from __future__ import annotations

import time
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import DataSet, DataSetException, DataSetMeta, Partition


class MemPartition(Partition):
    def __init__(self, data_flat: np.ndarray, tiledelay, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._data = data_flat  # (n_frames, *sig)
        self._tiledelay = tiledelay

    def _read_raw_frames(self, start, stop, out):
        if self._tiledelay:
            time.sleep(self._tiledelay)
        # the assignment converts non-native data to native byte order
        out[...] = self._data[start:stop]


class MemoryDataSet(DataSet):
    """``data`` of any byte order; without it, ``datashape`` gives a
    float32 dataset of zeros.  ``tileshape`` ``(depth, *sig tile)`` is
    the tiling of every run, as given; ``tiledelay`` sleeps that many
    seconds before each read."""

    def __init__(
        self,
        data: Optional[np.ndarray] = None,
        sig_dims: Optional[int] = None,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        num_partitions: Optional[int] = None,
        tileshape=None,
        tiledelay=None,
        sync_offset: int = 0,
        datashape=None,
        **kwargs,
    ):
        super().__init__(num_partitions=num_partitions)
        if data is None:
            if datashape is None:
                raise DataSetException(
                    "MemoryDataSet needs either data or datashape")
            data = np.zeros(tuple(int(s) for s in datashape), np.float32)
        data = np.asarray(data)
        if sig_shape is not None:
            sig_shape = tuple(int(s) for s in sig_shape)
            if sig_dims is not None and len(sig_shape) != sig_dims:
                raise ValueError(
                    f"sig_shape {sig_shape} and sig_dims {sig_dims} "
                    "disagree"
                )
        elif sig_dims is not None:
            sig_shape = data.shape[data.ndim - sig_dims:]
        elif nav_shape is not None:
            sig_shape = data.shape[len(tuple(nav_shape)):]
        else:
            sig_shape = data.shape[data.ndim - 2:]
        sig_shape = tuple(int(s) for s in sig_shape)
        if nav_shape is None:
            nav_shape = data.shape[:data.ndim - len(sig_shape)]
        nav_shape = tuple(int(s) for s in nav_shape)
        self._data = data.reshape((-1,) + sig_shape)
        self._meta = DataSetMeta(
            shape=Shape(nav_shape + sig_shape, sig_dims=len(sig_shape)),
            raw_dtype=data.dtype,
            sync_offset=sync_offset,
            image_count=self._data.shape[0],
        )
        self._tileshape = tileshape
        self._tiledelay = tiledelay

    @property
    def data(self) -> np.ndarray:
        return self._data.reshape(self.shape.to_tuple())

    @property
    def tileshape(self) -> Optional[Shape]:
        """The forced tile shape, or None."""
        if self._tileshape is None:
            return None
        return Shape(tuple(int(s) for s in self._tileshape),
                     sig_dims=self.shape.sig.dims)

    def initialize(self) -> "MemoryDataSet":
        return self

    @classmethod
    def get_supported_io_backends(cls) -> list:
        return []

    def adjust_tileshape(self, tileshape, roi):
        """The forced ``tileshape`` verbatim, when one was given."""
        if self._tileshape is None:
            return tileshape
        return tuple(int(s) for s in self._tileshape)

    def get_partitions(self) -> Iterator[MemPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield MemPartition(
                self._data, self._tiledelay,
                self.meta, start, stop - start, idx=idx,
            )


class MemoryFile:
    """A file-table entry for data in memory: frames ``start_idx`` to
    ``end_idx`` of ``data``.  The partitions read the array itself;
    this carries the fileset of code written against the file-table
    API."""

    def __init__(self, path, start_idx, end_idx, native_dtype,
                 sig_shape, data, check_cast=True):
        self.path = path
        self.start_idx = int(start_idx)
        self.end_idx = int(end_idx)
        self.native_dtype = native_dtype
        self.sig_shape = tuple(sig_shape)
        self.data = data
        self.check_cast = check_cast

    @property
    def num_frames(self) -> int:
        return self.end_idx - self.start_idx


class FileSet:
    """An ordered collection of file-table entries."""

    def __init__(self, files, frame_header_bytes=0, frame_footer_bytes=0):
        self._files = list(files)
        self.frame_header_bytes = frame_header_bytes
        self.frame_footer_bytes = frame_footer_bytes

    def __iter__(self):
        return iter(self._files)

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx):
        return self._files[idx]
