"""Gatan Digital Micrograph DM3/DM4 datasets (counterpart of
``libertem_tpu/io/dataset/dm.py``): a tag-tree parser of its own.

DM tag-stream layout (public format): big-endian header
[i32 version (3|4), i32/i64 root length, i32 byte order (1 = LE
data)], then the root tag group [u8 sorted, u8 open, i32/i64 n_tags]
of tags [u8 kind (0x14 group / 0x15 data), i16 name_len, name,
(DM4: i64 tag total bytes), '%%%%', i32/i64 def_len, def ints,
payload].  Type codes: 2 i16, 3 i32, 4 u16, 5 u32, 6 f32, 7 f64,
8 u8-bool, 9/10 i8, 11 i64, 12 u64, 15 struct, 18 string, 20 array.

The dataset array is the **largest** 'Data' array tag (ImageList[0]
usually holds the thumbnail), its shape from the sibling 'Dimensions'
group (x fastest, reversed into C order).  4D data is read as
(scan_y, scan_x, sig_y, sig_x) C-order; sig-major ("transposed") DM4
files raise.  Frames are read straight into the destination and
swapped there when the file's data is big-endian.
"""
from __future__ import annotations

import os
import re
import struct
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    Partition,
    RangeReader,
    byteswap,
    resolve_sig_override,
)

_SIMPLE_SIZES = {
    2: 2, 3: 4, 4: 2, 5: 4, 6: 4, 7: 8, 8: 1, 9: 1, 10: 1,
    11: 8, 12: 8,
}
_SIMPLE_DTYPES = {
    2: "i2", 3: "i4", 4: "u2", 5: "u4", 6: "f4", 7: "f8",
    8: "u1", 9: "i1", 10: "i1", 11: "i8", 12: "u8",
}


class _DMParser:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.version = struct.unpack(">i", self.f.read(4))[0]
        if self.version not in (3, 4):
            raise DataSetException(f"{path}: not a DM3/DM4 file")
        if self.version == 4:
            self.f.read(8)  # root length
        else:
            self.f.read(4)
        self.little_endian = (
            struct.unpack(">i", self.f.read(4))[0] == 1
        )
        self.arrays: list = []   # (path, offset, dtype_code, count)
        self.tags: dict = {}     # flat path -> simple value

    def _read_len(self):
        if self.version == 4:
            return struct.unpack(">q", self.f.read(8))[0]
        return struct.unpack(">i", self.f.read(4))[0]

    def parse(self):
        try:
            self._parse_group(prefix="")
        finally:
            # closed on failure too: detect_params probes many files
            self.f.close()
        return self

    def _parse_group(self, prefix: str):
        self.f.read(2)  # sorted, open flags
        n_tags = self._read_len()
        unnamed = 0
        for _ in range(n_tags):
            kind = self.f.read(1)
            if not kind:
                return
            kind = kind[0]
            name_len = struct.unpack(">h", self.f.read(2))[0]
            name = (
                self.f.read(name_len).decode("latin1")
                if name_len else None
            )
            if name is None:
                name = str(unnamed)
                unnamed += 1
            path = f"{prefix}.{name}" if prefix else name
            if self.version == 4:
                self.f.read(8)  # total tag bytes
            if kind == 0x14:
                self._parse_group(path)
            elif kind == 0x15:
                self._parse_data(path)
            else:
                raise DataSetException(
                    f"bad tag kind {kind:#x} at {path}"
                )

    def _parse_data(self, path: str):
        magic = self.f.read(4)
        if magic != b"%%%%":
            raise DataSetException(f"bad tag magic at {path}")
        def_len = self._read_len()
        defs = [self._read_len() for _ in range(def_len)]
        self._read_payload(path, defs)

    def _defs_size(self, defs, i=0):
        """(element byte size, next def index) for defs[i:]."""
        t = defs[i]
        if t in _SIMPLE_SIZES:
            return _SIMPLE_SIZES[t], i + 1
        if t == 15:  # struct: [15, namelen, nfields, {nlen, type}...]
            n_fields = defs[i + 2]
            size = 0
            j = i + 3
            for _ in range(n_fields):
                fsize, _ = self._defs_size(defs, j + 1)
                size += fsize
                j += 2
            return size, j
        raise DataSetException(f"unhandled def type {t}")

    def _read_payload(self, path, defs):
        t = defs[0]
        end = " LE" if self.little_endian else " BE"
        bo = "<" if self.little_endian else ">"
        if t in _SIMPLE_SIZES:
            raw = self.f.read(_SIMPLE_SIZES[t])
            val = np.frombuffer(
                raw, dtype=bo + _SIMPLE_DTYPES[t]
            )[0]
            self.tags[path] = val
        elif t == 18:  # string
            length = defs[1]
            self.tags[path] = self.f.read(length)
        elif t == 20:  # array
            elem_size, next_i = self._defs_size(defs, 1)
            count = defs[next_i]
            offset = self.f.tell()
            elem_code = defs[1]
            self.arrays.append((path, offset, elem_code, count))
            self.f.seek(elem_size * count, os.SEEK_CUR)
        elif t == 15:
            size, _ = self._defs_size(defs, 0)
            self.f.seek(size, os.SEEK_CUR)
        else:
            raise DataSetException(f"unhandled payload type {t}")


def parse_dm(path: str, dataset_index=None) -> dict:
    """The main image array: the largest 'Data' array tag, or the
    ``dataset_index``-th ImageList entry when given (a DM file can hold
    several datasets; index 0 is usually the thumbnail)."""
    p = _DMParser(path).parse()
    candidates = [
        a for a in p.arrays if a[0].endswith(".ImageData.Data")
    ]
    if not candidates:
        raise DataSetException(f"{path}: no image data found")
    if dataset_index is not None:
        def _il_index(tag):
            m = re.search(r"ImageList\.(\d+)\.", tag)
            return int(m.group(1)) if m else 0

        ordered = sorted(candidates, key=lambda a: _il_index(a[0]))
        if not 0 <= int(dataset_index) < len(ordered):
            raise DataSetException(
                f"{path}: dataset_index {dataset_index} out of "
                f"range — the file holds {len(ordered)} datasets"
            )
        best = ordered[int(dataset_index)]
    else:
        best = max(candidates, key=lambda a: a[3])
    tag_prefix = best[0][:-len(".Data")]
    dims = []
    i = 0
    while f"{tag_prefix}.Dimensions.{i}" in p.tags:
        dims.append(int(p.tags[f"{tag_prefix}.Dimensions.{i}"]))
        i += 1
    if not dims:
        raise DataSetException(f"{path}: no dimensions found")
    elem_code = best[2]
    if elem_code not in _SIMPLE_DTYPES:
        raise DataSetException(
            f"unsupported DM element type {elem_code}"
        )
    bo = "<" if p.little_endian else ">"
    # 2D/3D data is C-ordered; 4D STEM data is taken as transposed
    # (sig-major) unless the 'Data Order Swapped' tag says it was
    # rewritten in C order at save time
    ndims = len(dims)
    c_order = ndims in (2, 3)
    img_prefix = best[0].split(".ImageData.")[0]
    for key, val in p.tags.items():
        if (
            key.startswith(img_prefix)
            and key.endswith("Data Order Swapped")
        ):
            try:
                c_order = bool(int(val))
            except (TypeError, ValueError):
                pass
            break
    return {
        "offset": best[1],
        "dtype": np.dtype(bo + _SIMPLE_DTYPES[elem_code]),
        # DM lists x fastest; reverse into C order
        "shape": tuple(reversed(dims)),
        "count": best[3],
        "c_order": c_order,
    }


class DMPartition(Partition):
    def __init__(self, path, offset, dtype, sig_shape, *args, **kw):
        super().__init__(*args, **kw)
        self._offset = offset
        self._dtype = np.dtype(dtype)
        self._frame_bytes = int(np.prod(sig_shape)) * self._dtype.itemsize
        self._reader = RangeReader(path, self.io_backend)

    def _read_raw_frames(self, start, stop, out):
        self._reader.read_into(
            self._offset + start * self._frame_bytes, out)
        byteswap(out, self._dtype)


class SingleDMDataSet(DataSet):
    """A single DM3/DM4 file holding a 3D/4D stack."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        sig_dims: int = 2,
        force_c_order: bool = False,
        dataset_index=None,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sig_dims = sig_dims
        self._sync_offset = int(sync_offset)
        self._force_c_order = force_c_order
        self._dataset_index = dataset_index

    @classmethod
    def _read_metadata(cls, path, use_ds=None):
        """The DM tag tree's image description, without a dataset."""
        return parse_dm(path, use_ds)

    def initialize(self, executor=None) -> "SingleDMDataSet":
        info = parse_dm(self._path, self._dataset_index)
        if not info.get("c_order", True) and not self._force_c_order:
            raise DataSetException(
                f"{self._path}: DM file is stored sig-major "
                "('transposed'); convert it with "
                "libertem_tpu.contrib.convert_transposed."
                "convert_dm4_transposed(), or pass "
                "force_c_order=True if the metadata is wrong"
            )
        shape = info["shape"]
        sig_shape = resolve_sig_override(
            self._sig_shape, shape[len(shape) - self._sig_dims:])
        nav_shape = self._nav_shape or shape[:len(shape) - self._sig_dims]
        if not nav_shape:
            nav_shape = (1,)
        self._info = info
        # the frames stored in the Data array, not prod(nav_shape): a
        # larger nav or a sync offset reads zeros past them
        sig_px = int(np.prod(sig_shape))
        image_count = int(info["count"]) // sig_px if sig_px else 0
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + tuple(sig_shape),
                        sig_dims=len(sig_shape)),
            raw_dtype=info["dtype"].newbyteorder("="),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[DMPartition]:
        info = self._info
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield DMPartition(
                self._path, info["offset"], info["dtype"],
                tuple(self.meta.shape.sig),
                self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str, executor=None):
        if not path.lower().endswith((".dm3", ".dm4")):
            return False
        try:
            parse_dm(path)
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"dm3", "dm4"}


class StackedDMPartition(Partition):
    """One frame (or sub-stack) per DM file."""

    def __init__(self, file_infos, sig_shape, *args, **kw):
        super().__init__(*args, **kw)
        # [(path, first_frame, n_frames, offset, dtype)]
        self._infos = file_infos
        self._px = int(np.prod(sig_shape))
        self._readers: dict = {}

    def _read_raw_frames(self, start, stop, out):
        for path, first, count, offset, dtype in self._infos:
            lo, hi = max(start, first), min(stop, first + count)
            if hi <= lo:
                continue
            if path not in self._readers:
                self._readers[path] = RangeReader(path, self.io_backend)
            dest = out[lo - start:hi - start]
            item = np.dtype(dtype).itemsize
            self._readers[path].read_into(
                offset + (lo - first) * self._px * item, dest)
            byteswap(dest, dtype)


class StackedDMDataSet(DataSet):
    """A stack of DM3/DM4 files, one or more frames each."""

    def __init__(self, files=None, nav_shape=None, sig_shape=None,
                 sync_offset: int = 0, sig_dims: int = 2,
                 scan_size=None, same_offset: bool = False,
                 io_backend=None, num_partitions: Optional[int] = None):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        if not files:
            raise DataSetException("files list is required")
        if scan_size is not None:
            warnings.warn(
                "scan_size is deprecated, specify nav_shape instead",
                FutureWarning,
            )
            if nav_shape is not None:
                raise ValueError(
                    "cannot specify both scan_size and nav_shape")
            nav_shape = scan_size
        self._file_paths = list(files)
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sig_dims = sig_dims
        self._sync_offset = int(sync_offset)
        # all files share the first one's layout: parse it alone
        self._same_offset = bool(same_offset)

    def initialize(self, executor=None) -> "StackedDMDataSet":
        infos = []
        first = 0
        sig_shape = None
        dtype = None
        first_info = None
        for path in self._file_paths:
            if self._same_offset and first_info is not None:
                info = first_info
            else:
                info = parse_dm(path)
                first_info = info
            shape = info["shape"]
            f_sig = shape[len(shape) - self._sig_dims:]
            n = int(np.prod(
                shape[:len(shape) - self._sig_dims]
            )) if len(shape) > self._sig_dims else 1
            if sig_shape is None:
                sig_shape = f_sig
                dtype = info["dtype"]
            elif f_sig != sig_shape:
                raise DataSetException(
                    f"{path}: sig shape {f_sig} != {sig_shape}")
            infos.append((path, first, n, info["offset"], info["dtype"]))
            first += n
        self._infos = infos
        nav_shape = self._nav_shape or (first,)
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + tuple(sig_shape),
                        sig_dims=len(sig_shape)),
            raw_dtype=np.dtype(dtype).newbyteorder("="),
            sync_offset=self._sync_offset,
            image_count=first,
        )
        return self

    def get_partitions(self) -> Iterator[StackedDMPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield StackedDMPartition(
                self._infos, tuple(self.meta.shape.sig),
                self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )


class DMDataSet(SingleDMDataSet):
    """The 'dm' format: a single 3D/4D stack file, or a stack of DM
    files with ``files=[...]``."""

    def __new__(cls, path=None, files=None, **kwargs):
        if path is None and files and len(files) > 1:
            return StackedDMDataSet(files=files, **kwargs)
        return super().__new__(cls)

    def __init__(self, path=None, files=None, **kwargs):
        if path is None and files:
            path = files[0]
        super().__init__(path=path, **kwargs)
