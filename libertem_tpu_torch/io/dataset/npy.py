"""NPY dataset: numpy .npy files (counterpart of
``libertem_tpu/io/dataset/npy.py``), parsed with numpy's public header
readers and read straight into the destination (swapped there when the
file's dtype is of the other byte order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ...common.shape import Shape
from .converters import NPYDatasetParams
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    Partition,
    RangeReader,
    byteswap,
)


@dataclass
class NPYInfo:
    """A parsed npy header."""
    dtype: np.dtype
    shape: Tuple[int, ...]
    count: int
    offset: int


def read_npy_info(path: str) -> NPYInfo:
    """The npy header; raises DataSetException for Fortran-ordered
    files (column-major frames cannot stream as row-major blocks)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        # numpy's public header readers
        if version == (1, 0):
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f)
            )
        else:
            shape, fortran, dtype = (
                np.lib.format.read_array_header_2_0(f)
            )
        offset = f.tell()
    if fortran:
        raise DataSetException(
            "fortran-ordered npy files are not supported"
        )
    return NPYInfo(
        dtype=np.dtype(dtype), shape=tuple(shape),
        count=int(np.prod(shape)) if shape else 1, offset=offset,
    )


class NPYFile:
    """The file-table entry of an npy file (always one file)."""

    def __init__(self, path, start_idx, end_idx, native_dtype,
                 sig_shape, file_header):
        self._path = path
        self.path = path
        self.start_idx = int(start_idx)
        self.end_idx = int(end_idx)
        self.native_dtype = native_dtype
        self.sig_shape = tuple(sig_shape)
        self.file_header = int(file_header)


class NPYPartition(Partition):
    def __init__(self, path, offset, dtype, sig_shape, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._offset = offset
        self._dtype = np.dtype(dtype)
        self._frame_bytes = int(np.prod(sig_shape)) * self._dtype.itemsize
        self._reader = RangeReader(path, self.io_backend)

    def _read_raw_frames(self, start, stop, out):
        self._reader.read_into(
            self._offset + start * self._frame_bytes, out)
        byteswap(out, self._dtype)


class NPYDataSet(DataSet):
    """``sig_dims`` (default 2) or ``sig_shape`` say which trailing
    axes are the frame; ``nav_shape`` and ``sig_shape`` may re-view the
    array at the same frame size."""

    def __init__(
        self,
        path: str,
        sig_dims: Optional[int] = 2,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        # the sig_shape / sig_dims algebra is checked here, before the
        # file is opened
        if sig_shape is not None:
            sig_shape = tuple(sig_shape)
            if sig_dims is not None and len(sig_shape) != sig_dims:
                raise DataSetException(
                    f"sig_shape {sig_shape} and sig_dims {sig_dims} "
                    "disagree")
            sig_dims = len(sig_shape)
        elif sig_dims is None:
            raise DataSetException(
                "need at least one of sig_shape or sig_dims")
        self._sig_dims = sig_dims
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = sig_shape
        self._sync_offset = int(sync_offset)

    def initialize(self, executor=None) -> "NPYDataSet":
        info = read_npy_info(self._path)
        shape, dtype, offset = info.shape, info.dtype, info.offset
        if self._sig_shape is not None:
            sig_shape = self._sig_shape
        else:
            sig_shape = shape[len(shape) - self._sig_dims:]
        sig_size = int(np.prod(sig_shape))
        if sig_size == 0:
            raise DataSetException(f"empty sig_shape {tuple(sig_shape)}")
        # extra data at the end of the file is cut off
        image_count = info.count // sig_size
        file_nav = shape[:len(shape) - self._sig_dims]
        nav_shape = self._nav_shape or (
            file_nav if (
                self._sig_shape is None
                or sig_size == int(np.prod(
                    shape[len(shape) - self._sig_dims:]))
            ) and file_nav else (image_count,)
        )
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + tuple(sig_shape),
                        sig_dims=len(sig_shape)),
            raw_dtype=dtype,
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        self._offset = offset
        return self

    def _get_fileset(self):
        """The one-file file table of the npy file."""
        from .memory import FileSet
        return FileSet([
            NPYFile(
                path=self._path, start_idx=0,
                end_idx=self.meta.image_count,
                native_dtype=self.meta.raw_dtype,
                sig_shape=tuple(self.meta.shape.sig),
                file_header=self._offset,
            ),
        ])

    def get_cache_key(self) -> dict:
        return {
            "path": self._path,
            "shape": tuple(self.shape),
            "sync_offset": int(self.meta.sync_offset),
        }

    def get_diagnostics(self) -> list:
        return [
            {"name": "dtype", "value": str(self.meta.raw_dtype)},
            {"name": "header offset", "value": int(self._offset)},
        ]

    def get_partitions(self) -> Iterator[NPYPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield NPYPartition(
                self._path, self._offset, self.meta.raw_dtype,
                tuple(self.meta.shape.sig),
                self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str, executor=None):
        """``{"parameters": ..., "info": ...}``: the loader's arguments
        (two sig dims assumed) and the file's frame count and sig."""
        try:
            if not str(path).lower().endswith(".npy"):
                return False
            info = read_npy_info(path)
            if len(info.shape) < 3:
                return False
            shape = Shape(info.shape, sig_dims=2)
            return {
                "parameters": {
                    "path": path,
                    "nav_shape": tuple(shape.nav),
                    "sig_shape": tuple(shape.sig),
                },
                "info": {
                    "image_count": int(shape.nav.size),
                    "native_sig_shape": tuple(shape.sig),
                },
            }
        except Exception:
            return False

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"npy"}

    @classmethod
    def get_msg_converter(cls):
        return NPYDatasetParams
