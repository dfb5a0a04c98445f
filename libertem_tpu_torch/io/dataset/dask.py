"""A dataset over any array-like (counterpart of
``libertem_tpu/io/dataset/dask.py``): a dask array, a numpy array or
memmap, or anything with ``shape``, ``dtype``, ``reshape`` and slicing
along the first axis.  An array with ``.chunks`` (a dask array) gets
one partition per chunk of the first axis of its flat-nav view; a
slice of it with ``.compute()`` is computed when read.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ...common.shape import Shape
from .base import DataSet, DataSetException, DataSetMeta, Partition


class DaskPartition(Partition):
    def __init__(self, array_flat, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._array = array_flat

    def _read_raw_frames(self, start, stop, out):
        chunk = self._array[start:stop]
        if hasattr(chunk, "compute"):
            chunk = chunk.compute()
        # the assignment converts non-native data to native byte order
        out[...] = np.asarray(chunk)


class DaskDataSet(DataSet):
    """``dask_array`` (or ``array``): the data, ``sig_dims`` trailing
    axes of it the frame.  ``preserve_dimensions`` and ``min_size``
    are accepted for the JAX package's signature and not used."""

    def __init__(self, dask_array=None, array=None, sig_dims: int = 2,
                 preserve_dimensions: bool = True,
                 min_size: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self._array = dask_array if dask_array is not None else array
        if self._array is None:
            raise DataSetException("dask_array (or array) is required")
        self._sig_dims = int(sig_dims)
        self._chunk_sizes = None

    def initialize(self) -> "DaskDataSet":
        arr = self._array
        shape = tuple(int(s) for s in arr.shape)
        nav_shape = shape[:len(shape) - self._sig_dims]
        sig_shape = shape[len(shape) - self._sig_dims:]
        self._flat = arr.reshape((-1,) + sig_shape)
        if hasattr(arr, "chunks"):
            self._chunk_sizes = [int(c) for c in self._flat.chunks[0]]
        self._meta = DataSetMeta(
            shape=Shape(nav_shape + sig_shape, sig_dims=self._sig_dims),
            raw_dtype=np.dtype(arr.dtype),
            image_count=int(np.prod(nav_shape)),
        )
        return self

    @classmethod
    def get_supported_io_backends(cls) -> list:
        return []

    def get_num_partitions(self) -> int:
        if self._chunk_sizes is not None:
            return len(self._chunk_sizes)
        return super().get_num_partitions()

    def get_partition_ranges(self) -> list[tuple[int, int]]:
        if self._chunk_sizes is None:
            return super().get_partition_ranges()
        bounds = np.cumsum([0] + self._chunk_sizes)
        return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]

    def get_partitions(self) -> Iterator[DaskPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield DaskPartition(
                self._flat, self.meta, start, stop - start, idx=idx,
            )
