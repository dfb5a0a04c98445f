"""PNDetector FRMS6 dataset (counterpart of
``libertem_tpu/io/dataset/frms6.py``): a 1024-byte file header
[u2 header_size=1024, u2 frame_header_size=64, 3 pad bytes,
u1 version=6, 80 comment, u2 width, u2 height, 928 comment,
u4 num_frames], 64-byte frame headers, u16 pixel data.

Frames are stored *folded*: a stored (h, w) frame holds the top half
in columns [0, w/2) and the vertically flipped bottom half in
[w/2, w); the unfolded signal is (2h, w/2).  ``*_000.frms6`` holds
dark frames; their unfolded mean becomes the dark correction
(``get_correction_data``).  A read unfolds straight from the read's
cover into the destination.
"""
from __future__ import annotations

import glob
import os
import re
import struct
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from ..corrections import CorrectionSet
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    FileRecords,
    Partition,
    resolve_sig_override,
)
from .decode import Decoder

FILE_HEADER_SIZE = 1024
FRAME_HEADER_SIZE = 64


def read_frms6_header(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read(FILE_HEADER_SIZE)
    header_size, frame_header_size = struct.unpack("<HH", raw[:4])
    version = raw[7]
    width, height = struct.unpack("<HH", raw[88:92])
    num_frames = struct.unpack("<I", raw[1020:1024])[0]
    if header_size != 1024 or frame_header_size != 64 or version != 6:
        raise DataSetException(f"{path}: not an FRMS6 file")
    filesize = os.path.getsize(path)
    if num_frames == 0:
        per_frame = width * height * 2 + FRAME_HEADER_SIZE
        num_frames = (filesize - FILE_HEADER_SIZE) // per_frame
    return {
        "width": int(width), "height": int(height),
        "num_frames": int(num_frames), "path": path,
    }


def unfold(frames: np.ndarray, out=None) -> np.ndarray:
    """(n, h, w) folded -> (n, 2h, w/2) unfolded, into ``out`` when
    given.

    The bottom half is the folded frame's right half rotated 180
    degrees: rows bottom-up and columns reversed (the sensor's two
    readout directions oppose)."""
    n, h, w = frames.shape
    w2 = w // 2
    if out is None:
        out = np.empty((n, 2 * h, w2), dtype=frames.dtype)
    out[:, :h] = frames[:, :, :w2]
    out[:, h:] = frames[:, ::-1, w2:][:, :, ::-1]
    return out


def _pattern(path: str) -> str:
    """Sibling-chunk glob: ``scan.hdr`` opens ``scan_*.frms6``;
    ``scan_001.frms6`` opens ``scan_*.frms6`` (the trailing chunk
    counter is stripped); anything else is an error."""
    base, ext = os.path.splitext(os.fspath(path))
    ext = ext.lower()
    if ext == ".hdr":
        return glob.escape(base) + "_*.frms6"
    if ext == ".frms6":
        return glob.escape(re.sub(r"[0-9]+$", "", base)) + "*.frms6"
    raise DataSetException(f"unknown extension: {ext}")


def get_filenames(path, disable_glob: bool = False) -> list:
    """All sibling chunks of a multi-file acquisition."""
    if disable_glob:
        return [os.fspath(path)]
    return list(sorted(glob.glob(_pattern(path))))


def _map_y(y, xs, binning, num_rows):
    """Folded-row mapping: stored row ``y`` lands at ``(row,
    x_offset)`` in the unfolded frame; the bottom detector half is
    read out mirrored, so its rows count back from the end and shift
    right by ``xs``.  ``unfold`` applies the same mapping vectorized;
    this scalar form is its per-row oracle."""
    half = num_rows // 2 // binning
    if y < half:
        return (y, 0)
    return ((num_rows // binning) - y - 1, xs)


class FRMS6Decoder(Decoder):
    """Row-for-row decoder of the tile protocol: each read is one
    stored row; rows of the bottom detector half write x-reversed,
    and binned rows broadcast over ``binning`` output rows.  The block
    reader unfolds whole frames vectorized (``unfold``); this decoder
    is the tile protocol's, and an independent oracle of the row
    mapping."""

    def __init__(self, binning):
        self._binning = binning

    def get_decode(self, native_dtype, read_dtype):
        binning = self._binning

        def _decode(inp, out, idx, native_dtype, rr, origin, shape,
                    ds_shape):
            row = inp.reshape((-1,)).view(native_dtype)
            out3 = out.reshape(out.shape[0], -1, shape[-1])
            rows_binned = ds_shape[-2] // binning
            rows_in_tile = shape[1] // binning
            start = (idx % rows_in_tile) * binning
            depth = idx // rows_in_tile
            top = (
                origin[1] // binning + (idx % rows_in_tile)
                < rows_binned // 2
            )
            out3[depth, start:start + binning, :] = (
                row if top else row[::-1]
            )

        return _decode


def _discover(path: str) -> tuple:
    """(dark_file | None, [data files]) from any member path."""
    m = re.match(r"^(.*)_(\d+)\.frms6$", path)
    base = m.group(1) if m else os.path.splitext(path)[0]
    all_files = sorted(glob.glob(f"{glob.escape(base)}_*.frms6"))
    if not all_files:
        all_files = [path]
    dark = None
    data = []
    for f in all_files:
        fm = re.match(r"^.*_(\d+)\.frms6$", f)
        if fm and int(fm.group(1)) == 0:
            dark = f
        else:
            data.append(f)
    if not data:
        data = [dark] if dark else [path]
        dark = None
    return dark, data


class FRMS6Partition(Partition):
    def __init__(self, files, stored_shape, *args, **kwargs):
        super().__init__(*args, **kwargs)
        h, w = stored_shape  # folded
        self._stored = (h, w)
        self._records = FileRecords(
            [(path, first, count, FILE_HEADER_SIZE)
             for path, first, count in files],
            FRAME_HEADER_SIZE + h * w * 2, FRAME_HEADER_SIZE, h * w * 2,
            self.io_backend,
        )

    def _read_raw_frames(self, start, stop, out):
        h, w = self._stored
        frames = out.reshape(stop - start, 2 * h, w // 2)
        for rows, a, b in self._records.rows(start, stop):
            unfold(rows.view("<u2").reshape(b - a, h, w), out=frames[a:b])


class FRMS6DataSet(DataSet):
    """``path``: any ``.frms6`` file of the acquisition; its ``_000``
    file is the dark frames (subtracted through ``get_correction_data``
    unless ``enable_offset_correction`` is False), the others the
    data."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        enable_offset_correction: bool = True,
        gain_map_path: Optional[str] = None,
        dest_dtype=None,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        if dest_dtype is not None:
            warnings.warn("dest_dtype is ignored here", FutureWarning)
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)
        self._enable_offset_correction = enable_offset_correction
        self._gain_map_path = gain_map_path

    def initialize(self) -> "FRMS6DataSet":
        dark_file, data_files = _discover(self._path)
        self._dark_file = dark_file
        h0 = read_frms6_header(data_files[0])
        self._stored = (h0["height"], h0["width"])
        sig_shape = resolve_sig_override(
            self._sig_shape, (2 * h0["height"], h0["width"] // 2))
        self._files = []
        first = 0
        for f in data_files:
            h = read_frms6_header(f)
            self._files.append((f, first, h["num_frames"]))
            first += h["num_frames"]
        image_count = first
        nav_shape = self._nav_shape
        if not nav_shape:
            side = int(np.sqrt(image_count))
            nav_shape = ((side, side) if side * side == image_count
                         else (image_count,))
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig_shape,
                        sig_dims=len(sig_shape)),
            raw_dtype=np.dtype(np.uint16),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_correction_data(self) -> CorrectionSet:
        """The dark frame (the mean of the ``_000`` file's unfolded
        frames) and the gain map of ``gain_map_path`` (``.npy`` or
        CSV), both in the dataset's sig shape."""
        dark = gain = None
        sig = tuple(self.meta.shape.sig)
        if self._enable_offset_correction and self._dark_file:
            h = read_frms6_header(self._dark_file)
            n = h["num_frames"]
            part = FRMS6Partition(
                [(self._dark_file, 0, n)], self._stored,
                self.meta, 0, n,
            )
            h2, w = self._stored
            frames = np.empty((n, 2 * h2, w // 2), np.uint16)
            part._read_raw_frames(0, n, frames)
            dark = frames.astype(np.float64).mean(axis=0).astype(
                np.float32).reshape(sig)
        if self._gain_map_path and os.path.exists(self._gain_map_path):
            if self._gain_map_path.endswith(".npy"):
                gain = np.load(self._gain_map_path)
            else:
                gain = np.loadtxt(self._gain_map_path,
                                  delimiter=",").astype(np.float32)
            gain = np.asarray(gain).reshape(sig)
        return CorrectionSet(dark=dark, gain=gain)

    def get_partitions(self) -> Iterator[FRMS6Partition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield FRMS6Partition(
                self._files, self._stored, self.meta, start, stop - start,
                idx=idx, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str):
        if not path.lower().endswith(".frms6"):
            return False
        try:
            read_frms6_header(path)
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"frms6", "hdr"}
