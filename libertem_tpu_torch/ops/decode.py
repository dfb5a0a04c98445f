"""The host decoders of the detector formats (counterpart of
``libertem_tpu/native/__init__.py``): ``csrc/decode.cpp``, built by
``g++`` at first use (``ops/build.py``) and called through ``ctypes``.

Each decoder takes its input as a 2-D uint8 array of one row of bytes
per frame whose rows may lie apart (a view of a read's cover that
skips each frame's header), and writes into ``out`` when it is given
(the host feed's pinned slot), else into a new array.  A build that
fails raises with the compiler's output: nothing falls back to numpy.
The numpy bodies stay beside the C++ as ``*_plain``, the bits the
tests hold the C++ to.

``stats`` adds up the calls and seconds spent in the C++ decoders
(one call a read), for the reader's share of a pass.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np

from . import build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64

_SIGNATURES = {
    "decode_r1": [_u8p, _i64, _u8p, _i64, _i64],
    "decode_r6": [_u8p, _i64, _u8p, _i64, _i64],
    "decode_r12": [_u8p, _i64, _u16p, _i64, _i64],
    "decode_r24": [_u8p, _i64, _u32p, _i64, _i64],
    "byteswap16": [_u8p, _i64, _u16p, _i64, _i64],
    "byteswap32": [_u8p, _i64, _u32p, _i64, _i64],
    "byteswap64": [_u8p, _i64, _u64p, _i64, _i64],
    "decode_uint12_le": [_u8p, _u16p, _i64],
    "k2is_place_blocks": [_u8p, _i64p, _i64p, _i64p, _i64p, _i64, _i64,
                          _i64, _u16p, _i64, _i64],
}
_lib = None

stats = {"calls": 0, "decode_s": 0.0}


def library():
    """The loaded decoder library (``build/libdecode-<hash>.so``),
    built on the first call."""
    global _lib
    if _lib is None:
        lib = build.load("decode")
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = None
        _lib = lib
    return _lib


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def _call(name: str, *args) -> None:
    lib = library()
    t0 = time.perf_counter()
    getattr(lib, name)(*args)
    stats["decode_s"] += time.perf_counter() - t0
    stats["calls"] += 1


def _check_group(n_pix: int, group: int, fmt: str) -> None:
    if n_pix % group:
        # the bit-packed layouts order pixels in fixed groups: a frame
        # of another size is not decodable
        raise ValueError(
            f"{fmt}: n_pix={n_pix} must be a multiple of {group}"
        )


def _rows(raw: np.ndarray) -> np.ndarray:
    """``raw`` as (frames, bytes) uint8 rows, each row contiguous; the
    rows themselves may lie apart."""
    raw = np.asarray(raw)
    if raw.ndim != 2 or raw.dtype != np.uint8:
        raw = np.ascontiguousarray(raw).reshape(raw.shape[0], -1)
        raw = raw.view(np.uint8)
    if raw.strides[1] != 1 or raw.strides[0] < raw.shape[1]:
        raw = np.ascontiguousarray(raw)
    return raw


def _target(out, shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if (out.dtype != dtype or not out.flags.c_contiguous
            or out.size != int(np.prod(shape))):
        raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} "
                         f"array of {int(np.prod(shape))} items")
    return out


def _frames(name, raw, n_pix, group, fmt, dtype, bytes_per_px, out):
    _check_group(n_pix, group, fmt)
    rows = _rows(raw)
    n = rows.shape[0]
    if rows.shape[1] < n_pix * bytes_per_px:
        raise ValueError(f"{fmt}: rows of {rows.shape[1]} bytes, "
                         f"{n_pix * bytes_per_px} needed")
    dest = _target(out, (n, n_pix), dtype)
    if n:
        _call(name, _ptr(rows, ctypes.c_uint8), rows.strides[0],
              dest.ctypes.data_as(ctypes.POINTER(
                  np.ctypeslib.as_ctypes_type(dtype))), n, n_pix)
    return dest


def decode_r1(raw: np.ndarray, n_pix: int, out=None) -> np.ndarray:
    """(n, n_pix // 8) packed bytes -> (n, n_pix) u8."""
    return _frames("decode_r1", raw, n_pix, 64, "MIB r1", np.uint8,
                   1 / 8, out)


def decode_r6(raw: np.ndarray, n_pix: int, out=None) -> np.ndarray:
    """(n, n_pix) u8 -> (n, n_pix) u8, pixel order fixed."""
    return _frames("decode_r6", raw, n_pix, 8, "MIB r6", np.uint8, 1, out)


def decode_r12(raw: np.ndarray, n_pix: int, out=None) -> np.ndarray:
    """(n, 2 * n_pix) big-endian u16 bytes -> (n, n_pix) u16."""
    return _frames("decode_r12", raw, n_pix, 4, "MIB r12", np.uint16, 2,
                   out)


def decode_r24(raw: np.ndarray, n_pix: int, out=None) -> np.ndarray:
    """(n, 4 * n_pix) bytes (two r12 sub-frames, MSB first) ->
    (n, n_pix) u32."""
    return _frames("decode_r24", raw, n_pix, 4, "MIB r24", np.uint32, 4,
                   out)


def decode_uint12_le(raw: np.ndarray, out=None) -> np.ndarray:
    """12-bit little-endian packed pairs (3 bytes -> 2 pixels) -> u16
    (the K2 IS format); a trailing partial triplet is dropped."""
    raw = np.ascontiguousarray(np.asarray(raw).reshape(-1).view(np.uint8))
    n_pairs = raw.size // 3
    dest = _target(out, (n_pairs * 2,), np.uint16)
    if n_pairs:
        _call("decode_uint12_le", _ptr(raw, ctypes.c_uint8),
              _ptr(dest, ctypes.c_uint16), n_pairs)
    return dest


def swap_rows(raw: np.ndarray, itemsize: int, out: np.ndarray) -> None:
    """Rows of items of ``itemsize`` (2, 4 or 8) bytes in another byte
    order (``raw``, uint8 rows as ``decode_r12`` takes them) into
    ``out`` in native order; ``raw`` may be ``out``'s own bytes."""
    rows = _rows(raw)
    n, nbytes = rows.shape
    per_row = nbytes // itemsize
    typ = {2: ctypes.c_uint16, 4: ctypes.c_uint32, 8: ctypes.c_uint64}
    if itemsize not in typ:
        raise ValueError(f"no byte swap for {itemsize}-byte items")
    if (not out.flags.c_contiguous or out.nbytes != n * per_row * itemsize
            or out.dtype.itemsize != itemsize):
        raise ValueError("out must be C-contiguous and hold the rows")
    if n:
        _call(f"byteswap{8 * itemsize}", _ptr(rows, ctypes.c_uint8),
              rows.strides[0], out.ctypes.data_as(
                  ctypes.POINTER(typ[itemsize])), n, per_row)


def byteswap_inplace(arr: np.ndarray) -> None:
    """Swap the bytes of every item of the C-contiguous ``arr`` in
    place (2, 4 or 8-byte items; complex items swap each part)."""
    size = arr.dtype.itemsize
    if arr.dtype.kind == "c":
        size //= 2
    if size == 1 or not arr.size:
        return
    if not arr.flags.c_contiguous:
        raise ValueError("byteswap_inplace needs a C-contiguous array")
    flat = arr.reshape(-1).view(np.uint8).reshape(1, -1)
    swap_rows(flat, size, flat.view(f"u{size}").reshape(-1))


def byteswap(arr: np.ndarray) -> np.ndarray:
    """``arr`` in native byte order: a new array for data of the other
    order, ``arr`` itself (no copy) for native data."""
    dt = arr.dtype
    if dt.isnative:
        return arr
    out = np.ascontiguousarray(arr).copy().view(dt.newbyteorder("="))
    byteswap_inplace(out)
    return out


def k2is_place_blocks(cover: np.ndarray, payload_off: np.ndarray,
                      frame_idx: np.ndarray, y: np.ndarray, x: np.ndarray,
                      block_shape: tuple, out: np.ndarray) -> None:
    """Decode K2 IS blocks (12-bit little-endian payloads at
    ``cover[payload_off[b]:]``) into ``out`` ((frames, h, w) u16) at
    frame ``frame_idx[b]``, rows from ``y[b]``, columns from ``x[b]``,
    in order (a later block over the same pixels wins)."""
    bh, bw = block_shape
    if bw % 2 or not out.flags.c_contiguous or out.dtype != np.uint16:
        raise ValueError("k2is_place_blocks: even block width and a "
                         "C-contiguous u16 out needed")
    idx = [np.ascontiguousarray(a, dtype=np.int64)
           for a in (payload_off, frame_idx, y, x)]
    n = len(idx[0])
    need = bh * bw * 3 // 2
    if n and (int(idx[0].max()) + need > cover.size or idx[0].min() < 0
              or idx[1].max() >= out.shape[0] or idx[1].min() < 0
              or idx[2].min() < 0 or idx[2].max() + bh > out.shape[1]
              or idx[3].min() < 0 or idx[3].max() + bw > out.shape[2]):
        raise ValueError("k2is_place_blocks: a block lies outside the "
                         "cover or the frames")
    if n:
        cover = np.ascontiguousarray(cover.reshape(-1).view(np.uint8))
        _call("k2is_place_blocks", _ptr(cover, ctypes.c_uint8),
              *[_ptr(a, ctypes.c_int64) for a in idx], n, bh, bw,
              _ptr(out, ctypes.c_uint16), out.shape[1], out.shape[2])


# -- the plain numpy versions (the tests' reference) -----------------------


def decode_r1_plain(raw: np.ndarray, n_pix: int) -> np.ndarray:
    _check_group(n_pix, 64, "MIB r1")
    raw = np.ascontiguousarray(raw.reshape(raw.shape[0], -1))
    n = raw.shape[0]
    stripes = raw[:, :n_pix // 8].reshape(n, -1, 8)[:, :, ::-1]
    bits = np.unpackbits(stripes, axis=-1, bitorder="little")
    return bits.reshape(n, n_pix)


def decode_r6_plain(raw: np.ndarray, n_pix: int) -> np.ndarray:
    _check_group(n_pix, 8, "MIB r6")
    raw = np.ascontiguousarray(raw.reshape(raw.shape[0], -1))
    n = raw.shape[0]
    return raw[:, :n_pix].reshape(n, -1, 8)[:, :, ::-1].reshape(n, n_pix)


def decode_r12_plain(raw: np.ndarray, n_pix: int) -> np.ndarray:
    _check_group(n_pix, 4, "MIB r12")
    raw = np.ascontiguousarray(raw.reshape(raw.shape[0], -1).view(np.uint8))
    n = raw.shape[0]
    vals = raw[:, :2 * n_pix].copy().view(">u2").astype(np.uint16)
    return vals.reshape(n, -1, 4)[:, :, ::-1].reshape(n, n_pix)


def decode_r24_plain(raw: np.ndarray, n_pix: int) -> np.ndarray:
    _check_group(n_pix, 4, "MIB r24")
    raw = np.ascontiguousarray(raw.reshape(raw.shape[0], -1).view(np.uint8))
    n = raw.shape[0]
    halves = raw[:, :4 * n_pix].reshape(n, 2, n_pix * 2)
    msb = decode_r12_plain(halves[:, 0], n_pix).astype(np.uint32)
    lsb = decode_r12_plain(halves[:, 1], n_pix).astype(np.uint32)
    return (msb << 12) | lsb


def decode_uint12_le_plain(raw: np.ndarray) -> np.ndarray:
    raw = np.ascontiguousarray(np.asarray(raw).reshape(-1).view(np.uint8))
    n_pairs = raw.size // 3
    triplets = raw[:n_pairs * 3].reshape(-1, 3).astype(np.uint16)
    out = np.empty(n_pairs * 2, dtype=np.uint16)
    out[0::2] = triplets[:, 0] | ((triplets[:, 1] & 0x0F) << 8)
    out[1::2] = ((triplets[:, 1] & 0xF0) >> 4) | (triplets[:, 2] << 4)
    return out


def byteswap_plain(arr: np.ndarray) -> np.ndarray:
    dt = arr.dtype
    if dt.isnative:
        return arr
    return arr.astype(dt.newbyteorder("="))
