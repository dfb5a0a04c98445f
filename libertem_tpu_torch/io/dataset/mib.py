"""Quantum Detectors Merlin/Medipix MIB dataset (counterpart of
``libertem_tpu/io/dataset/mib.py``).

Every frame is an ASCII "MQ1,..." header followed by the payload; a
``.hdr`` sidecar describes the acquisition.  Header CSV fields used:
[2]=header size bytes, [3]=number of chips, [4]=width, [5]=height,
[6]=dtype ('U08'|'U16'|'U32'|'R64'), [7]=sensor layout ('1x1'|'2x2'),
[-1]=counter bit depth.

Processed ('U') data is big-endian unsigned; RAW ('R64') data is
bit-packed at 1/6/12/24 bits.  A read covers whole records of a file
(headers and payloads); the C++ decoders (``ops/decode.py``) take the
payloads straight out of that cover into the pinned slot, one call a
read, the 2x2 quad RAW layout (stored rows [Q4|Q3|Q2|Q1], bottom
quadrants rotated 180 degrees) through ``assemble_quad``.
"""
from __future__ import annotations

import glob
import os
import re
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from ...ops.decode import (
    decode_r1,
    decode_r6,
    decode_r12,
    decode_r24,
    swap_rows,
)
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    FileRecords,
    Partition,
)


def get_filenames(path, disable_glob: bool = False) -> list:
    """The files of a multi-file acquisition: ``acq_001.mib`` opens
    every ``acq_*.mib`` (the trailing frame counter is stripped),
    ``scan.hdr`` every ``scan*.mib``; any other extension is an error.
    The order comes from the headers' sequence numbers, not from this
    listing."""
    path = os.fspath(path)
    if disable_glob:
        return [path]
    base, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext == ".mib":
        pattern = re.sub(r"[0-9]+$", "", glob.escape(base)) + "*.mib"
    elif ext == ".hdr":
        pattern = glob.escape(base) + "*.mib"
    else:
        raise DataSetException("unknown extension")
    return glob.glob(pattern)


def parse_mib_header(path: str) -> dict:
    """The first frame header of a .mib file."""
    with open(path, "rb") as f:
        filesize = os.fstat(f.fileno()).st_size
        head = f.read(1024).decode("ascii", errors="ignore")
        parts = head.split(",")
        if not parts or parts[0] != "MQ1":
            raise DataSetException(f"{path}: not a MIB file")
        header_bytes = int(parts[2])
        if header_bytes > 1024:
            # extended headers (DAC/threshold sections) exceed 1 KB
            f.seek(0)
            head = f.read(header_bytes).decode("ascii", errors="ignore")
    # only the declared header region holds fields; empty fields stay
    # so that positions hold, pure NUL padding goes, and a last field's
    # trailing NULs are stripped
    parts = []
    for praw in head[:header_bytes].split(","):
        stripped = praw.strip("\x00 ")
        if "\x00" in praw and not stripped:
            continue
        parts.append(stripped)
    num_chips = int(parts[3])
    width = int(parts[4])
    height = int(parts[5])
    dtype_str = parts[6].upper()
    layout = parts[7].replace("G", "") if len(parts) > 7 else "1x1"
    try:
        bit_depth = int(parts[-1])
    except ValueError:
        bit_depth = int(dtype_str[1:]) if dtype_str[0] == "U" else 12
    kind = dtype_str[0].lower()
    if kind == "u":
        bytes_per_px = int(dtype_str[1:]) // 8
        payload = width * height * bytes_per_px
        out_dtype = np.dtype(f"uint{int(dtype_str[1:])}")
    elif kind == "r":
        factor = {1: 1 / 8, 6: 1, 12: 2, 24: 4}[bit_depth]
        if bit_depth == 24:
            # two 12-bit sub-frames (MSB first) at the final frame
            # size; the header declares the sub-frame width, so the
            # frame is half as wide
            width = width // 2
        payload = int(width * height * factor)
        out_dtype = np.dtype({
            1: np.uint8, 6: np.uint8, 12: np.uint16, 24: np.uint32,
        }[bit_depth])
    else:
        raise DataSetException(f"unknown MIB dtype {dtype_str}")
    frame_size = header_bytes + payload
    # RAW 2x2 quad: rows of width 4*chip stored as [Q4 | Q3 | Q2 | Q1];
    # the assembled frame is (2h, w/2), bottom quadrants flipped
    quad = kind == "r" and num_chips == 4 and layout == "2x2"
    if quad and bit_depth == 24:
        raise DataSetException("RAW 2x2 quad at 24 bit not supported")
    if quad:
        sig_shape = (2 * height, width // 2)
    else:
        sig_shape = (height, width)
    try:
        sequence_first_image = int(parts[1])
    except (ValueError, IndexError):
        sequence_first_image = 0
    return {
        "header_bytes": header_bytes,
        "sequence_first_image": sequence_first_image,
        "num_chips": num_chips,
        "width": width,
        "height": height,
        "kind": kind,
        "bit_depth": bit_depth,
        "payload": payload,
        "frame_size": frame_size,
        "num_images": filesize // frame_size,
        "out_dtype": out_dtype,
        "layout": layout,
        "quad": quad,
        "sig_shape": sig_shape,
    }


def parse_hdr_sidecar(path: str) -> dict:
    """The acquisition's .hdr sidecar (key: value lines): its nav."""
    out = {}
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            out[key.strip()] = value.strip()
    result = {}
    if "ScanX" in out and "ScanY" in out:
        result["nav_shape"] = (int(out["ScanY"]), int(out["ScanX"]))
        return result
    n_total = out.get("Frames in Acquisition (Number)")
    n_trigger = out.get("Frames per Trigger (Number)")
    if n_total is not None and n_trigger is not None:
        total, per = int(n_total), int(n_trigger)
        if per > 0 and total % per == 0 and total // per > 1:
            result["nav_shape"] = (total // per, per)
        else:
            result["nav_shape"] = (total,)
    return result


# -- encoders and decode adapters of the tile protocol ---------------------


def encode_u1(inp, out):
    """U08 processed data: plain bytes."""
    out[:] = inp


def encode_u2(inp, out):
    """U16 processed data: big-endian u16 byte pairs."""
    rows = inp.shape[0]
    out[:] = inp.astype(">u2").view(np.uint8).reshape(rows, -1)


def encode_r1(inp, out):
    """RAW 1-bit: 64-pixel stripes, bits little-endian within each
    byte, bytes reversed within the stripe."""
    rows = inp.shape[0]
    bits = (inp & 1).astype(np.uint8).reshape(rows, -1, 8, 8)
    packed = np.packbits(bits, axis=-1, bitorder="little")
    out[:] = packed[:, :, ::-1, 0].reshape(rows, -1)


def encode_r6(inp, out):
    """RAW 6-bit (one byte per pixel): bytes reversed in groups of 8."""
    rows = inp.shape[0]
    out[:] = inp.reshape(rows, -1, 8)[:, :, ::-1].reshape(rows, -1)


def encode_r12(inp, out):
    """RAW 12-bit: u16 values reversed in groups of 4, stored
    big-endian."""
    rows = inp.shape[0]
    reordered = inp.reshape(rows, -1, 4)[:, :, ::-1].reshape(rows, -1)
    out[:] = reordered.astype(">u2").view(np.uint8).reshape(rows, -1)


def decode_r1_swap(inp, out, idx, native_dtype, rr, origin, shape,
                   ds_shape):
    """Decode-function adapter over the C++ r1 unpack."""
    out[idx, :] = decode_r1(inp.reshape(1, -1), out.shape[1])[0]


def decode_r6_swap(inp, out, idx, native_dtype, rr, origin, shape,
                   ds_shape):
    out[idx, :] = decode_r6(inp.reshape(1, -1), out.shape[1])[0]


def decode_r12_swap(inp, out, idx, native_dtype, rr, origin, shape,
                    ds_shape):
    out[idx, :] = decode_r12(inp.reshape(1, -1), out.shape[1])[0]


def assemble_quad(decoded: np.ndarray, out=None) -> np.ndarray:
    """(n, h, 4h) decoded stream rows -> (n, 2h, 2h) assembled quad
    frames (stored [Q4|Q3|Q2|Q1], bottom quadrants rotated 180
    degrees), into ``out`` when given."""
    n, h, w4 = decoded.shape
    half = w4 // 4
    if out is None:
        out = np.empty((n, 2 * h, 2 * half), dtype=decoded.dtype)
    out[:, :h, :half] = decoded[:, :, 3 * half:4 * half]       # Q1
    out[:, :h, half:] = decoded[:, :, 2 * half:3 * half]       # Q2
    out[:, h:, :half] = decoded[:, ::-1, 1 * half:2 * half][:, :, ::-1]
    out[:, h:, half:] = decoded[:, ::-1, 0:half][:, :, ::-1]   # Q4
    return out


_RAW_DECODERS = {1: decode_r1, 6: decode_r6, 12: decode_r12,
                 24: decode_r24}


class MIBPartition(Partition):
    def __init__(self, files, header, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # files: (path, first frame, frame count) in acquisition order
        self._hdr = header
        self._records = FileRecords(
            [(path, first, count, 0) for path, first, count in files],
            header["frame_size"], header["header_bytes"],
            header["payload"], self.io_backend,
        )
        self._quad_buf = None

    def _read_raw_frames(self, start, stop, out):
        h = self._hdr
        n_pix = h["width"] * h["height"]
        flat = out.reshape(stop - start, -1)
        for rows, a, b in self._records.rows(start, stop):
            dest = flat[a:b]
            if h["kind"] == "u":
                size = h["out_dtype"].itemsize
                if size == 1:
                    dest[:] = rows
                else:
                    swap_rows(rows, size, dest)
                continue
            decode = _RAW_DECODERS.get(h["bit_depth"])
            if decode is None:
                raise DataSetException(
                    f"unsupported bit depth {h['bit_depth']}")
            if not h["quad"]:
                decode(rows, n_pix, out=dest)
                continue
            need = (b - a) * n_pix
            if self._quad_buf is None or self._quad_buf.size < need:
                self._quad_buf = np.empty(need, h["out_dtype"])
            stream = self._quad_buf[:need].reshape(b - a, n_pix)
            decode(rows, n_pix, out=stream)
            assemble_quad(
                stream.reshape(b - a, h["height"], h["width"]),
                out=dest.reshape((b - a,) + tuple(h["sig_shape"])),
            )


class MIBDataSet(DataSet):
    """``path``: a ``.mib`` file (its siblings join unless
    ``disable_glob``), the ``.hdr`` sidecar or a directory.  Without
    ``nav_shape`` the nav comes from the sidecar, else is square when
    the frame count is a square, else 1-D.  ``sig_shape`` re-views the
    frames at the same pixel count."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        scan_size=None,
        disable_glob: bool = False,
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
        self._nav_shape = tuple(nav_shape or scan_size or ())
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)
        self._disable_glob = bool(disable_glob)
        self._hdr = None
        self._files = []

    def _discover_files(self):
        if self._path.lower().endswith(".hdr"):
            files = sorted(get_filenames(self._path))
            if not files:
                base = os.path.dirname(self._path)
                files = sorted(glob.glob(
                    os.path.join(glob.escape(base), "*.mib")))
        elif self._path.lower().endswith(".mib"):
            files = sorted(get_filenames(
                self._path, disable_glob=self._disable_glob
            )) or [self._path]
        else:
            files = sorted(glob.glob(
                os.path.join(glob.escape(self._path), "*.mib")))
        if not files:
            raise DataSetException(f"no .mib files for {self._path}")
        return files

    def initialize(self) -> "MIBDataSet":
        files = self._discover_files()
        hdr = parse_mib_header(files[0])
        if (hdr["kind"] == "r" and hdr["layout"] not in ("1x1", "Nx1")
                and not hdr["quad"]):
            raise DataSetException(
                f"unsupported RAW MIB layout {hdr['layout']}")
        self._hdr = hdr
        # acquisition order from the headers' sequence numbers, not the
        # names (scan10.mib sorts before scan2.mib)
        headers = [(f, parse_mib_header(f)) for f in files]
        headers.sort(key=lambda fh: fh[1]["sequence_first_image"])
        self._files = []
        first = 0
        for f, h in headers:
            self._files.append((f, first, h["num_images"]))
            first += h["num_images"]
        image_count = first

        nav_shape = self._nav_shape
        if not nav_shape:
            sidecar = (
                self._path if self._path.lower().endswith(".hdr")
                else os.path.splitext(files[0])[0] + ".hdr"
            )
            if os.path.exists(sidecar):
                nav_shape = parse_hdr_sidecar(sidecar).get("nav_shape")
            if not nav_shape:
                side = int(np.sqrt(image_count))
                if side * side == image_count:
                    nav_shape = (side, side)
                else:
                    nav_shape = (image_count,)
        sig_shape = tuple(self._sig_shape or hdr["sig_shape"])
        if int(np.prod(sig_shape)) != int(np.prod(hdr["sig_shape"])):
            raise DataSetException(
                f"sig_shape {sig_shape} (size {int(np.prod(sig_shape))}) "
                f"does not match the file's frame size "
                f"{int(np.prod(hdr['sig_shape']))} "
                f"{tuple(hdr['sig_shape'])}"
            )
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig_shape,
                        sig_dims=len(sig_shape)),
            raw_dtype=hdr["out_dtype"],
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    @property
    def diagnostics(self):
        h = self._hdr or {}
        return [
            {"name": "kind", "value": h.get("kind", "?")},
            {"name": "bit depth", "value": str(h.get("bit_depth", "?"))},
            {"name": "layout", "value": h.get("layout", "?")},
            {"name": "files", "value": str(len(self._files))},
            {"name": "frames on disk",
             "value": str(self.meta.image_count)},
        ]

    def get_partitions(self) -> Iterator[MIBPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield MIBPartition(
                self._files, self._hdr, self.meta, start, stop - start,
                idx=idx, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str):
        ext = path.split(".")[-1].lower()
        if ext not in ("mib", "hdr"):
            return False
        try:
            files = cls(path)._discover_files()
            parse_mib_header(files[0])
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"mib", "hdr"}
