"""MRC / MRC2014 dataset (counterpart of
``libertem_tpu/io/dataset/mrc.py``): the standard 1024-byte header of
little-endian i32 words, nx/ny/nz at words 0-2, mode at word 3, the
NSYMBT extended-header size at byte 92; data from 1024 + NSYMBT on.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    Partition,
    RangeReader,
    resolve_sig_override,
)

MRC_MODES = {
    0: np.int8,
    1: np.int16,
    2: np.float32,
    6: np.uint16,
    12: np.float16,
}


def read_mrc_header(path: str) -> dict:
    with open(path, "rb") as f:
        head = f.read(1024)
    if len(head) < 1024:
        raise DataSetException("file too small for an MRC header")
    nx, ny, nz, mode = struct.unpack("<4i", head[:16])
    nsymbt = struct.unpack("<i", head[92:96])[0]
    # MRC2014 exttyp/machine stamp checks omitted; assume LE
    if mode not in MRC_MODES:
        raise DataSetException(f"unsupported MRC mode {mode}")
    return {
        "nx": nx, "ny": ny, "nz": nz,
        "dtype": np.dtype(MRC_MODES[mode]),
        "data_offset": 1024 + max(0, nsymbt),
    }


class MRCPartition(Partition):
    def __init__(self, path, offset, dtype, sig_shape, *args, **kw):
        super().__init__(*args, **kw)
        self._offset = offset
        self._frame_bytes = int(np.prod(sig_shape)) * np.dtype(dtype).itemsize
        self._reader = RangeReader(path, self.io_backend)

    def _read_raw_frames(self, start, stop, out):
        self._reader.read_into(
            self._offset + start * self._frame_bytes, out)


class MRCDataSet(DataSet):
    """Without ``nav_shape`` the nav is (nz,)."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)

    def initialize(self) -> "MRCDataSet":
        h = read_mrc_header(self._path)
        sig = resolve_sig_override(self._sig_shape, (h["ny"], h["nx"]))
        nav_shape = self._nav_shape or (h["nz"],)
        self._h = h
        # the header's nz clamped to the frames the file holds: a
        # truncated stack reads zeros past its end
        stored = max(0, (
            os.path.getsize(self._path) - h["data_offset"]
        ) // (h["ny"] * h["nx"] * h["dtype"].itemsize))
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig, sig_dims=len(sig)),
            raw_dtype=h["dtype"],
            sync_offset=self._sync_offset,
            image_count=min(int(h["nz"]), stored),
        )
        return self

    def get_partitions(self) -> Iterator[MRCPartition]:
        h = self._h
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield MRCPartition(
                self._path, h["data_offset"], h["dtype"],
                (h["ny"], h["nx"]), self.meta, start, stop - start,
                idx=idx, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str):
        if not path.lower().endswith((".mrc", ".mrcs", ".rec", ".ali",
                                      ".st")):
            return False
        try:
            read_mrc_header(path)
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"mrc", "mrcs", "rec", "ali", "st"}
