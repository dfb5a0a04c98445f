"""NanoMegas .blo (blockfile) dataset (counterpart of
``libertem_tpu/io/dataset/blo.py``): a header of 'ID' (6s), MAGIC u2
(258|259), Data_offset_1/2 u4, flags u4, DP_SZ u2, DP_rotation u2,
NX u2, NY u2, ...; frames are uint8, DP_SZ x DP_SZ, each preceded by a
6-byte frame header, from Data_offset_2 on.
"""
from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    FileRecords,
    Partition,
    resolve_sig_override,
)

MAGIC_EXPECT = (258, 259)
FRAME_HEADER_BYTES = 6


def blo_header_dtype(endianess="<"):
    e = endianess
    return np.dtype([
        ("ID", "S6"),
        ("MAGIC", e + "u2"),
        ("Data_offset_1", e + "u4"),
        ("Data_offset_2", e + "u4"),
        ("UNKNOWN1", e + "u4"),
        ("DP_SZ", e + "u2"),
        ("DP_rotation", e + "u2"),
        ("NX", e + "u2"),
        ("NY", e + "u2"),
        ("Scan_rotation", e + "u2"),
        ("SX", e + "f8"),
        ("SY", e + "f8"),
        ("Beam_energy", e + "u4"),
        ("SDP", e + "u2"),
        ("Camera_length", e + "u4"),
        ("Acquisition_time", e + "f8"),
    ])


def read_blo_header(path: str, endianess="<"):
    with open(path, "rb") as f:
        return np.frombuffer(
            f.read(blo_header_dtype(endianess).itemsize),
            dtype=blo_header_dtype(endianess), count=1,
        )[0]


class BloPartition(Partition):
    def __init__(self, path, data_offset, dp_sz, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._records = FileRecords(
            [(path, 0, self.meta.image_count, data_offset)],
            FRAME_HEADER_BYTES + dp_sz * dp_sz, FRAME_HEADER_BYTES,
            dp_sz * dp_sz, self.io_backend,
        )

    def _read_raw_frames(self, start, stop, out):
        flat = out.reshape(stop - start, -1)
        for rows, a, b in self._records.rows(start, stop):
            flat[a:b] = rows


class BloDataSet(DataSet):
    """Without ``nav_shape`` the nav is the header's (NY, NX)."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        endianess: str = "<",
        tileshape=None,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        if tileshape is not None:
            warnings.warn("tileshape is ignored (tiling is negotiated per "
                          "run)", FutureWarning)
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)
        self._endianess = endianess

    def initialize(self, executor=None) -> "BloDataSet":
        h = read_blo_header(self._path, self._endianess)
        if int(h["MAGIC"]) not in MAGIC_EXPECT:
            raise DataSetException(
                f"unexpected blo magic {int(h['MAGIC'])}")
        dp_sz = int(h["DP_SZ"])
        sig = resolve_sig_override(self._sig_shape, (dp_sz, dp_sz))
        nav_shape = self._nav_shape or (int(h["NY"]), int(h["NX"]))
        self._data_offset = int(h["Data_offset_2"])
        self._dp_sz = dp_sz
        filesize = os.path.getsize(self._path)
        stride = FRAME_HEADER_BYTES + dp_sz * dp_sz
        image_count = max(0, (filesize - self._data_offset) // stride)
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig, sig_dims=len(sig)),
            raw_dtype=np.dtype(np.uint8),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[BloPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield BloPartition(
                self._path, self._data_offset, self._dp_sz,
                self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str, executor=None):
        if not path.lower().endswith(".blo"):
            return False
        try:
            h = read_blo_header(path)
        except Exception:
            return False
        if int(h["MAGIC"]) not in MAGIC_EXPECT:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"blo"}
