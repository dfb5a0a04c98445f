"""In-memory dataset (counterpart of
``libertem_tpu/io/dataset/memory.py``): wraps a numpy array, with a
controllable partition count."""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import DataSet, DataSetException, DataSetMeta, Partition


class MemPartition(Partition):
    def __init__(self, data_flat: np.ndarray, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._data = data_flat  # (n_frames, *sig)

    def _read_raw_frames(self, start, stop, out):
        out[...] = self._data[start:stop]


class MemoryDataSet(DataSet):
    def __init__(
        self,
        data: np.ndarray,
        sig_dims: Optional[int] = None,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        num_partitions: Optional[int] = None,
    ):
        super().__init__(num_partitions=num_partitions)
        data = np.asarray(data)
        if not data.dtype.isnative:
            raise DataSetException(
                "non-native byte order is not supported yet"
            )
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
            image_count=self._data.shape[0],
        )

    def initialize(self) -> "MemoryDataSet":
        return self

    def get_partitions(self) -> Iterator[MemPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield MemPartition(
                self._data, self.meta, start, stop - start, idx=idx,
            )
