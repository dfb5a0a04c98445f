"""The decode-function protocol of the formats: raw file bytes into
native-order arrays (counterpart of ``libertem_tpu/io/dataset/decode.py``).

The readers' own hot decode is C++ (``ops/decode.py``), called once a
read into the pinned slot; this module carries the per-tile
decode-function protocol for the formats that implement it (FRMS6's
row decoder) and for callers that decode tiles themselves.  The
bodies are vectorized numpy.

Decode-function signature::

    decode(inp, out, idx, native_dtype, rr, origin, shape, ds_shape)

``inp`` is a flat uint8 view of one tile's raw bytes; the decoded
values land in ``out[idx]``.  ``rr``/``origin``/``shape``/``ds_shape``
carry read-range context that the default decoders do not need.
"""
from __future__ import annotations

import sys

import numpy as np


def default_decode(inp, out, idx, native_dtype, rr, origin, shape,
                   ds_shape):
    """No byte-order work needed: reinterpret and (implicitly on
    assignment) convert to the out dtype."""
    out[idx, :] = inp.view(native_dtype)


def _swap_decode(inp, out, idx, nbytes, acc_dtype):
    # big-endian compose: byte 0 is the most significant
    # (reference byteswap_N_decode)
    b = inp.reshape(-1, nbytes).astype(acc_dtype)
    vals = b[:, 0]
    for k in range(1, nbytes):
        vals = (vals << np.uint8(8)) | b[:, k]
    out[idx, :] = vals


def decode_swap_2(inp, out, idx, native_dtype, rr, origin, shape,
                  ds_shape):
    _swap_decode(inp, out, idx, 2, np.uint16)


def decode_swap_4(inp, out, idx, native_dtype, rr, origin, shape,
                  ds_shape):
    _swap_decode(inp, out, idx, 4, np.uint32)


def decode_swap_8(inp, out, idx, native_dtype, rr, origin, shape,
                  ds_shape):
    _swap_decode(inp, out, idx, 8, np.uint64)


def _swap_only(inp, out, idx, nbytes):
    # straight in-place byte reversal, dtype preserved
    out[idx].view(np.uint8)[:] = (
        inp.reshape(-1, nbytes)[:, ::-1].reshape(-1)
    )


def decode_swap_only_2(inp, out, idx, native_dtype, rr, origin,
                       shape, ds_shape):
    _swap_only(inp, out, idx, 2)


def decode_swap_only_4(inp, out, idx, native_dtype, rr, origin,
                       shape, ds_shape):
    _swap_only(inp, out, idx, 4)


def decode_swap_only_8(inp, out, idx, native_dtype, rr, origin,
                       shape, ds_shape):
    _swap_only(inp, out, idx, 8)


def _normalize_byteorder(order: str) -> str:
    if order != "=":
        return order
    return {"little": "<", "big": ">"}[sys.byteorder]


class Decoder:
    """Decoder protocol (reference decode.py:113)."""

    def do_clear(self) -> bool:
        return False

    def get_native_dtype(self, inp_native_dtype, read_dtype):
        return inp_native_dtype

    def get_decode(self, native_dtype, read_dtype):
        raise NotImplementedError()


class DtypeConversionDecoder(Decoder):
    """Byte-order- and dtype-converting decoder (reference
    decode.py:123): non-native byte order routes through a
    byte-composing swap decode (reading uint8), everything else is a
    plain view + cast."""

    def _need_byteswap(self, native_dtype, read_dtype) -> bool:
        native_dtype = np.dtype(native_dtype)
        read_dtype = np.dtype(read_dtype)
        return (
            _normalize_byteorder(native_dtype.byteorder)
            != _normalize_byteorder(read_dtype.byteorder)
            and native_dtype.itemsize > 1
        )

    def _swapping_decode(self, native_dtype):
        return {
            2: decode_swap_2,
            4: decode_swap_4,
            8: decode_swap_8,
        }[native_dtype.itemsize]

    def _swap_only_decode(self, native_dtype):
        return {
            2: decode_swap_only_2,
            4: decode_swap_only_4,
            8: decode_swap_only_8,
        }[native_dtype.itemsize]

    def get_decode(self, native_dtype, read_dtype):
        native_dtype = np.dtype(native_dtype)
        read_dtype = np.dtype(read_dtype)
        if not self._need_byteswap(native_dtype, read_dtype):
            return default_decode
        if native_dtype.kind in ("f", "c"):
            raise NotImplementedError(
                "byte swapping for floats not implemented yet"
            )
        return self._swapping_decode(native_dtype)

    def get_native_dtype(self, inp_native_dtype, read_dtype):
        if self._need_byteswap(inp_native_dtype, read_dtype):
            # the swap decode consumes raw bytes
            return np.dtype(np.uint8)
        return np.dtype(inp_native_dtype)
