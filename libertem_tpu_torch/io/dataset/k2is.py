"""Gatan K2 IS dataset (counterpart of
``libertem_tpu/io/dataset/k2is.py``): 8 sector .bin files, each a
stream of 0x5758-byte blocks: a 40-byte big-endian header [sync
0xFFFF0055, version u1, flags u1 (bit0 = shutter active), block_count
u4, width u2 (256), height u2 (1860), frame_id u4, pixel_x_start/
y_start/x_end/y_end u2, block_size u4] and 930x16 pixels packed as
12-bit little-endian.

A frame is 1860x2048: 8 sectors of 256 columns, each sector receiving
32 blocks per frame (16 x-positions x 2 y-halves).  Sector streams may
start mid-frame and at different frames; all block headers are
scanned vectorized and grouped by frame_id: the frames with a complete
8x32 block set are the usable ones, from the first shutter-active
frame.

A read of frames [start, stop) reads, per sector, the span of file
that holds their blocks (or each block alone where the span would be
much longer) and decodes every block of it into the destination with
one C++ call (``ops/decode.py`` ``k2is_place_blocks``): 8 calls a
read, not one a block.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from ...ops.decode import decode_uint12_le as _decode_uint12_le
from ...ops.decode import k2is_place_blocks
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    Partition,
    RangeReader,
)


def decode_uint12_le(inp, out=None):
    """Unpack little-endian 12-bit pairs to u16; fills ``out`` (as far
    as both reach) when given."""
    vals = _decode_uint12_le(np.ascontiguousarray(inp))
    if out is None:
        return vals
    n = min(len(vals), len(out))
    out[:n] = vals[:n]
    return out


HEADER_SIZE = 40
BLOCK_SIZE = 0x5758
DATA_SIZE = BLOCK_SIZE - HEADER_SIZE
BLOCK_SHAPE = (930, 16)
BLOCKS_PER_SECTOR_PER_FRAME = 32
NUM_SECTORS = 8
SECTOR_SIZE = (2 * 930, 256)
SHUTTER_ACTIVE_MASK = 0x1
SYNC_MAGIC = 0xFFFF0055


def get_filenames(path, disable_glob: bool = False) -> list:
    """Sector-file discovery: the .gtg sidecar or any sector .bin
    yields every sibling ``*.bin`` (a trailing sector counter on a .bin
    is stripped first)."""
    path = os.fspath(path)
    if disable_glob:
        return [path]
    base, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext == ".gtg":
        pattern = glob.escape(base) + "*.bin"
    elif ext == ".bin":
        pattern = glob.escape(re.sub(r"[0-9]+$", "", base)) + "*.bin"
    else:
        raise DataSetException(f"unrecognized k2is path {path}")
    return glob.glob(pattern)


def _sector_files(path: str) -> list:
    files = sorted(get_filenames(path))
    if len(files) != NUM_SECTORS:
        raise DataSetException(
            f"expected {NUM_SECTORS} sector files, found "
            f"{len(files)} for {path}"
        )
    return files


def _gtg_path(path: str):
    base, ext = os.path.splitext(path)
    if ext.lower() == ".gtg":
        return path
    return re.sub(r"\d+$", "", base) + ".gtg"


def _nav_shape_from_gtg(path: str):
    """Scan shape from the .gtg metadata file (a DM3 container: its
    'SI Dimensions.Size X/Y' tags)."""
    gtg = _gtg_path(path)
    if not os.path.exists(gtg):
        return None
    try:
        from .dm import _DMParser
        p = _DMParser(gtg).parse()
        y = p.tags.get("SI Dimensions.Size Y")
        x = p.tags.get("SI Dimensions.Size X")
        if y is not None and x is not None:
            return (int(y), int(x))
    except Exception:
        return None
    return None


def _scan_sector(path: str, limit_bytes: int = None) -> dict:
    """Vectorized block-header scan of one sector file.

    Returns arrays (per block): offset, frame_id, x_start, y_start,
    shutter.
    """
    size = os.path.getsize(path)
    # find the first valid block: search for the sync magic on any
    # byte offset (robust against truncated stream starts)
    first = 0
    magic = np.array([0xFF, 0xFF, 0x00, 0x55], dtype=np.uint8)
    if limit_bytes is not None:
        size = min(size, int(limit_bytes))
    with open(path, "rb") as f:
        head = np.frombuffer(
            f.read(min(size, 2 * BLOCK_SIZE + 4)), dtype=np.uint8
        )
    limit = min(size - BLOCK_SIZE, 2 * BLOCK_SIZE)
    for off in range(0, max(1, limit)):
        if np.array_equal(head[off:off + 4], magic):
            first = off
            break
    n_blocks = (size - first) // BLOCK_SIZE
    if n_blocks <= 0:
        raise DataSetException(f"{path}: no complete blocks")
    # every block header, with chunked sequential preads (strided mmap
    # faulting is much slower on virtualized hosts)
    blocks = np.empty((n_blocks, HEADER_SIZE), dtype=np.uint8)
    per_chunk = max(1, (32 * 1024 * 1024) // BLOCK_SIZE)
    fd = os.open(path, os.O_RDONLY)
    try:
        for b0 in range(0, n_blocks, per_chunk):
            b1 = min(n_blocks, b0 + per_chunk)
            span0 = first + b0 * BLOCK_SIZE
            want = (b1 - b0 - 1) * BLOCK_SIZE + HEADER_SIZE
            raw = os.pread(fd, want, span0)
            buf = np.frombuffer(raw, dtype=np.uint8)
            got = (len(buf) - HEADER_SIZE) // BLOCK_SIZE + 1 \
                if len(buf) >= HEADER_SIZE else 0
            got = min(got, b1 - b0)
            if got <= 0:
                blocks = blocks[:b0]
                n_blocks = b0
                break
            blocks[b0:b0 + got] = np.lib.stride_tricks.as_strided(
                buf, shape=(got, HEADER_SIZE),
                strides=(BLOCK_SIZE, 1),
            )
            if got < b1 - b0:
                blocks = blocks[:b0 + got]
                n_blocks = b0 + got
                break
    finally:
        os.close(fd)

    def be(col, width):
        v = np.zeros(n_blocks, dtype=np.uint32)
        for i in range(width):
            v = (v << 8) | blocks[:, col + i]
        return v

    # the block header's layout:
    # sync u4 @0, padding1 @4-7, version u1 @8, flags u1 @9,
    # padding2 @10-15, block_count u4 @16, width u2 @20,
    # height u2 @22, frame_id u4 @24, pixel_x_start u2 @28,
    # pixel_y_start u2 @30, x_end @32, y_end @34, block_size u4 @36
    sync = be(0, 4)
    flags = blocks[:, 9].astype(np.uint32)
    width = be(20, 2)
    height = be(22, 2)
    frame_id = be(24, 4)
    x_start = be(28, 2)
    y_start = be(30, 2)
    valid = (
        (sync == SYNC_MAGIC)
        & (width == SECTOR_SIZE[1])
        & (height == SECTOR_SIZE[0])
    )
    offsets = first + np.arange(n_blocks, dtype=np.int64) * BLOCK_SIZE
    return {
        "offset": offsets[valid],
        "frame_id": frame_id[valid],
        "x_start": x_start[valid],
        "y_start": y_start[valid],
        "shutter": (flags[valid] & SHUTTER_ACTIVE_MASK) == 1,
    }


class K2ISPartition(Partition):
    def __init__(self, files, offsets, xs, ys, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._files = files
        # (frames, NUM_SECTORS, BLOCKS_PER_SECTOR_PER_FRAME): each
        # block's file offset and its place in the sector
        self._offsets = offsets
        self._xs = xs
        self._ys = ys
        self._readers: dict = {}
        self._buf = None

    def _reader(self, s: int) -> RangeReader:
        if s not in self._readers:
            self._readers[s] = RangeReader(self._files[s], self.io_backend)
        return self._readers[s]

    def _buffer(self, nbytes: int) -> np.ndarray:
        if self._buf is None or len(self._buf) < nbytes:
            self._buf = np.empty(nbytes, dtype=np.uint8)
        return self._buf[:nbytes]

    def _read_raw_frames(self, start, stop, out):
        n = stop - start
        h, w = SECTOR_SIZE
        frames = out.reshape(n, h, NUM_SECTORS * w)
        per = BLOCKS_PER_SECTOR_PER_FRAME
        frame_idx = np.repeat(np.arange(n, dtype=np.int64), per)
        for s in range(NUM_SECTORS):
            offs = self._offsets[start:stop, s].reshape(-1)
            lo = int(offs.min())
            span = int(offs.max()) + BLOCK_SIZE - lo
            reader = self._reader(s)
            if span <= (len(offs) + 2 * n) * BLOCK_SIZE:
                # the blocks lie together on disk (the usual case):
                # one read of their span
                cover = self._buffer(span)
                reader.read_into(lo, cover)
                payload = offs - lo + HEADER_SIZE
            else:
                cover = self._buffer(len(offs) * DATA_SIZE)
                for i, off in enumerate(offs):
                    reader.read_into(
                        int(off) + HEADER_SIZE,
                        cover[i * DATA_SIZE:(i + 1) * DATA_SIZE])
                payload = np.arange(len(offs), dtype=np.int64) * DATA_SIZE
            k2is_place_blocks(
                cover, payload, frame_idx,
                self._ys[start:stop, s].reshape(-1),
                self._xs[start:stop, s].reshape(-1) + s * w,
                BLOCK_SHAPE, frames,
            )


class K2ISDataSet(DataSet):
    """``path``: the ``.gtg`` file or any sector ``.bin``.  Without
    ``nav_shape`` the nav comes from the ``.gtg``, else is square when
    the frame count is a square, else 1-D; ``sig_shape`` re-views the
    (1860, 2048) frames at the same pixel count."""

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

    def initialize(self, executor=None) -> "K2ISDataSet":
        files = _sector_files(self._path)
        scans = [_scan_sector(f) for f in files]
        # the blocks of each frame_id, per sector
        frame_ids = None
        per_sector: list = []
        for scan in scans:
            groups: dict = {}
            for off, fid, xs, ys, sh in zip(
                scan["offset"], scan["frame_id"], scan["x_start"],
                scan["y_start"], scan["shutter"],
            ):
                groups.setdefault(int(fid), []).append(
                    (int(off), int(xs), int(ys), bool(sh)))
            complete = {
                fid: blocks for fid, blocks in groups.items()
                if len(blocks) == BLOCKS_PER_SECTOR_PER_FRAME
            }
            per_sector.append(complete)
            ids = set(complete)
            frame_ids = ids if frame_ids is None else frame_ids & ids
        if not frame_ids:
            raise DataSetException("no complete frames found")
        ordered = sorted(frame_ids)
        # from the first frame with the shutter-active flag
        start_idx = 0
        for i, fid in enumerate(ordered):
            if any(b[3] for b in per_sector[0][fid]):
                start_idx = i
                break
        gtg_nav = (None if self._nav_shape
                   else _nav_shape_from_gtg(self._path))
        if gtg_nav and start_idx > 0:
            # scan-mode acquisitions set the shutter flag one frame
            # late: the scan's first frame is the one before
            start_idx -= 1
        ordered = ordered[start_idx:]
        table = np.array([
            [[b[:3] for b in per_sector[s][fid]]
             for s in range(NUM_SECTORS)]
            for fid in ordered
        ], dtype=np.int64)
        self._files = files
        self._offsets = np.ascontiguousarray(table[..., 0])
        self._xs = np.ascontiguousarray(table[..., 1])
        self._ys = np.ascontiguousarray(table[..., 2])
        image_count = len(ordered)
        nav_shape = self._nav_shape or gtg_nav
        if not nav_shape:
            side = int(np.sqrt(image_count))
            nav_shape = ((side, side) if side * side == image_count
                         else (image_count,))
        sig_shape = (SECTOR_SIZE[0], NUM_SECTORS * SECTOR_SIZE[1])
        if self._sig_shape is not None:
            if int(np.prod(self._sig_shape)) != int(np.prod(sig_shape)):
                raise DataSetException(
                    f"sig_shape {tuple(self._sig_shape)} does not "
                    f"match the K2 IS detector size {sig_shape}")
            sig_shape = tuple(self._sig_shape)
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig_shape,
                        sig_dims=len(sig_shape)),
            raw_dtype=np.dtype(np.uint16),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    @property
    def diagnostics(self):
        return [
            {"name": "sectors", "value": str(NUM_SECTORS)},
            {"name": "complete frames",
             "value": str(self.meta.image_count)},
            {"name": "blocks per frame",
             "value": str(NUM_SECTORS * BLOCKS_PER_SECTOR_PER_FRAME)},
        ]

    def get_partitions(self) -> Iterator[K2ISPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield K2ISPartition(
                self._files, self._offsets, self._xs, self._ys,
                self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str, executor=None):
        if not path.lower().endswith((".gtg", ".bin")):
            return False
        try:
            files = _sector_files(path)
            # a handful of blocks: detection reads no whole sector file
            scan = _scan_sector(files[0], limit_bytes=8 * BLOCK_SIZE)
            if len(scan["offset"]) == 0:
                return False
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"gtg", "bin"}
