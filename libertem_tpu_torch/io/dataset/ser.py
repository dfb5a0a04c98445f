"""FEI SER dataset (counterpart of ``libertem_tpu/io/dataset/ser.py``):
the TIA series format, parsed directly: a little-endian header
[i16 byte_order=0x4949, i16 series_id=0x0197, i16 version,
i32 data_type_id (0x4122=2D), i32 tag_type_id, i32 total_elements,
i32 valid_elements, offset_array_offset (i32 for version<0x220 else
i64), i32 n_dimensions, dimension records], an offset array pointing
at each element, and per 2D element [calibration x/y, i16 data_type,
i32 size_x, i32 size_y, data].  Elements at evenly spaced offsets (as
TIA writes them) are read with one read a run.
"""
from __future__ import annotations

import struct
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    FileRecords,
    Partition,
    RangeReader,
    resolve_sig_override,
)

SER_DTYPES = {
    1: np.uint8, 2: np.uint16, 3: np.uint32,
    4: np.int8, 5: np.int16, 6: np.int32,
    7: np.float32, 8: np.float64,
    9: np.complex64, 10: np.complex128,
}


def read_ser_index(path: str) -> dict:
    with open(path, "rb") as f:
        head = f.read(30)
        (byte_order, series_id, version, data_type_id,
         tag_type_id, total, valid) = struct.unpack(
            "<hhhiiii", head[:22]
        )
        if byte_order != 0x4949 or series_id != 0x0197:
            raise DataSetException(f"{path}: not a SER file")
        if data_type_id != 0x4122:
            # 0x4120 = 1D elements (spectra, 26-byte element header);
            # parsing them with the 2D layout would read payload bytes
            # as shape/dtype
            raise DataSetException(
                f"{path}: only 2D-element SER series are supported "
                f"(data_type_id={data_type_id:#x}, expected 0x4122)"
            )
        f.seek(22)
        if version >= 0x0220:
            offset_array_offset, n_dims = struct.unpack(
                "<qi", f.read(12)
            )
            off_dtype = "<i8"
        else:
            offset_array_offset, n_dims = struct.unpack(
                "<ii", f.read(8)
            )
            off_dtype = "<i4"
        f.seek(offset_array_offset)
        offsets = np.fromfile(f, dtype=off_dtype, count=total)
        if len(offsets) == 0 or offsets[0] <= 0:
            # an aborted TIA acquisition writes an empty element table
            raise DataSetException(
                f"{path}: SER element table is empty "
                "(aborted acquisition?)"
            )
        # probe the first element for shape/dtype
        f.seek(int(offsets[0]))
        cal = f.read(50)
        data_type, size_x, size_y = struct.unpack(
            "<hii", cal[40:50]
        )
        if data_type not in SER_DTYPES:
            raise DataSetException(
                f"unsupported SER data type {data_type}"
            )
    return {
        "offsets": offsets[:valid],
        "dtype": np.dtype(SER_DTYPES[data_type]),
        "sig_shape": (size_y, size_x),
        "valid": valid,
        "element_header": 50,
    }


class SERPartition(Partition):
    def __init__(self, path, index, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._index = index
        h, w = index["sig_shape"]
        nbytes = h * w * index["dtype"].itemsize
        head = index["element_header"]
        offsets = index["offsets"].astype(np.int64)
        steps = np.diff(offsets)
        self._records = None
        if len(steps) and steps.min() == steps.max() \
                and steps[0] >= nbytes + head:
            # evenly spaced elements: whole runs in one read
            self._records = FileRecords(
                [(path, 0, len(offsets), int(offsets[0]))],
                int(steps[0]), head, nbytes, self.io_backend)
        else:
            self._reader = RangeReader(path, self.io_backend)

    def _read_raw_frames(self, start, stop, out):
        flat = out.reshape(stop - start, -1).view(np.uint8)
        if self._records is not None:
            for rows, a, b in self._records.rows(start, stop):
                flat[a:b] = rows
            return
        head = self._index["element_header"]
        for i, off in enumerate(self._index["offsets"][start:stop]):
            self._reader.read_into(int(off) + head, flat[i])


class SERDataSet(DataSet):
    """Without ``nav_shape`` the nav is square when the element count
    is a square, else 1-D."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        emipath=None,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)

    def initialize(self) -> "SERDataSet":
        idx = read_ser_index(self._path)
        sig = resolve_sig_override(self._sig_shape, idx["sig_shape"])
        self._index = idx
        image_count = len(idx["offsets"])
        nav_shape = self._nav_shape
        if not nav_shape:
            side = int(np.sqrt(image_count))
            nav_shape = ((side, side) if side * side == image_count
                         else (image_count,))
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig, sig_dims=len(sig)),
            raw_dtype=idx["dtype"],
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[SERPartition]:
        for i, (start, stop) in enumerate(self.get_partition_ranges()):
            yield SERPartition(
                self._path, self._index, self.meta, start, stop - start,
                idx=i, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str):
        if not path.lower().endswith(".ser"):
            return False
        try:
            read_ser_index(path)
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"ser"}
