"""TVIPS binary series dataset (counterpart of
``libertem_tpu/io/dataset/tvips.py``): a 256-byte series header of i4
fields: ISize (=256), IVersion (1|2), IXDim, IYDim, IBPP (8|16), IXOff,
IYOff, IXBin, IYBin, IPixelSize, IHT, IMagTotal, IImgHeaderBytes; the
frame header is 12 bytes for v1 or IImgHeaderBytes for v2; a series
may span _000.tvips, _001.tvips, ... files, of which only the first
carries the series header.
"""
from __future__ import annotations

import glob
import os
import re
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
    resolve_sig_override,
)

SERIES_HEADER_SIZE = 256


def read_tvips_header(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read(SERIES_HEADER_SIZE)
    fields = struct.unpack("<13i", raw[:52])
    h = dict(zip((
        "size", "version", "xdim", "ydim", "bpp", "xoff", "yoff",
        "xbin", "ybin", "pixel_size", "ht", "mag",
        "img_header_bytes",
    ), fields))
    if h["size"] != SERIES_HEADER_SIZE:
        raise DataSetException(
            f"invalid TVIPS header size {h['size']}"
        )
    if h["version"] not in (1, 2):
        raise DataSetException(
            f"unknown TVIPS version {h['version']}"
        )
    if h["version"] == 1:
        h["img_header_bytes"] = 12
    if h["bpp"] not in (8, 16):
        # a packed/corrupt bpp would silently produce wrong frame
        # strides (same validation as SEQ bit_depth)
        raise DataSetException(
            f"unsupported TVIPS bits-per-pixel {h['bpp']} "
            "(expected 8 or 16)"
        )
    h["frame_bytes"] = (
        h["img_header_bytes"] + h["bpp"] // 8 * h["xdim"] * h["ydim"]
    )
    return h


def _get_suffix(path: str) -> int:
    """Series index of one chunk file: the suffix is an underscore and
    a three-digit zero-padded number."""
    return int(os.path.splitext(os.fspath(path))[0][-3:])


def get_filenames(path) -> list:
    """All chunk files of the series ``path`` belongs to, in series
    order: the trailing counter is stripped and every sibling
    ``*.tvips`` collected."""
    base, ext = os.path.splitext(os.fspath(path))
    if ext.lower() != ".tvips":
        raise DataSetException("unknown extension")
    pattern = re.sub(r"[0-9]+$", "", glob.escape(base)) + "*.tvips"
    return list(sorted(glob.glob(pattern), key=_get_suffix))


def _series_files(path: str) -> list:
    m = re.match(r"^(.*)_(\d{3})\.tvips$", path)
    if not m:
        return [path]
    files = sorted(glob.glob(
        glob.escape(m.group(1)) + "_[0-9][0-9][0-9].tvips"
    ))
    return files or [path]


class TVIPSPartition(Partition):
    def __init__(self, files, header, *args, **kwargs):
        super().__init__(*args, **kwargs)
        h = header
        self._records = FileRecords(
            files, h["frame_bytes"], h["img_header_bytes"],
            h["frame_bytes"] - h["img_header_bytes"], self.io_backend,
        )

    def _read_raw_frames(self, start, stop, out):
        flat = out.reshape(stop - start, -1).view(np.uint8)
        for rows, a, b in self._records.rows(start, stop):
            flat[a:b] = rows


class TVIPSDataSet(DataSet):
    """``path``: any file of the series.  Without ``nav_shape`` the nav
    is square when the frame count is a square, else 1-D."""

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

    def initialize(self) -> "TVIPSDataSet":
        files = _series_files(self._path)
        h = read_tvips_header(files[0])
        sig = resolve_sig_override(self._sig_shape, (h["ydim"], h["xdim"]))
        self._h = h
        # (path, first frame, frame count, offset of the first frame)
        self._files = []
        first = 0
        for i, f in enumerate(files):
            data_off = SERIES_HEADER_SIZE if i == 0 else 0
            count = (os.path.getsize(f) - data_off) // h["frame_bytes"]
            self._files.append((f, first, count, data_off))
            first += count
        image_count = first
        nav_shape = self._nav_shape
        if not nav_shape:
            side = int(np.sqrt(image_count))
            nav_shape = ((side, side) if side * side == image_count
                         else (image_count,))
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig, sig_dims=len(sig)),
            raw_dtype=np.dtype(f"<u{h['bpp'] // 8}"),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[TVIPSPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield TVIPSPartition(
                self._files, self._h, self.meta, start, stop - start,
                idx=idx, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str):
        if not path.lower().endswith(".tvips"):
            return False
        try:
            read_tvips_header(_series_files(path)[0])
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"tvips"}
