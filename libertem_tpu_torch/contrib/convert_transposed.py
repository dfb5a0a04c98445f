"""Sig-major ("transposed") datasets into C-order ``.npy`` files
(counterpart of ``libertem_tpu/contrib/convert_transposed.py``)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..udf.record import RecordUDF


class ConvertTransposedDatasetUDF(RecordUDF):
    """Records a (sig, nav)-ordered dataset into a nav-major ``.npy``:
    the dataset is loaded with nav and sig swapped, so each input
    "frame" holds one true signal pixel's values over the scan, and a
    block fills columns of the output."""

    @property
    def _out_shape(self):
        ds = self.meta.dataset_shape
        # the input's nav dims are the file's sig dims and vice versa
        return tuple(ds.sig) + tuple(ds.nav)

    def _ensure_mmap(self):
        if self._mmap is None:
            self._mmap_base = np.lib.format.open_memmap(
                self.params.filename, mode="w+",
                dtype=self.meta.input_dtype, shape=self._out_shape)
            ds = self.meta.dataset_shape
            # (true nav, true sig), flat: a block fills sig columns
            self._mmap = self._mmap_base.reshape(
                (int(np.prod(tuple(ds.sig))), ds.nav.size))
        return self._mmap

    def process_tile(self, tile):
        mm = self._ensure_mmap()
        goff = int(self.meta.global_offset)
        flat = np.asarray(tile).reshape(len(tile), -1)
        mm[:, goff:goff + len(tile)] = flat.T


def _convert_transposed_ds(ctx, ds, out_path, **run_kwargs):
    ctx.run_udf(ds, ConvertTransposedDatasetUDF(str(out_path)),
                **run_kwargs)


def convert_dm4_transposed(dm4_path, out_path, ctx=None,
                           num_cpus: Optional[int] = None,
                           dataset_index: Optional[int] = None,
                           progress: bool = False):
    """A transposed Gatan ``.dm4`` STEM dataset into a nav-major
    ``.npy``.  A Context and a CPU count exclude each other; without
    a Context, ``Context.make_with("inline")`` (the card)."""
    if ctx is not None and num_cpus is not None:
        raise ValueError(
            "Either supply a Context or number of cpus to use in "
            "conversion")
    from ..io.dataset.dm import SingleDMDataSet
    meta = SingleDMDataSet._read_metadata(str(dm4_path),
                                          use_ds=dataset_index)
    if meta.get("c_order"):
        from ..io.dataset.base import DataSetException
        raise DataSetException("The DM4 data is not transposed")
    if ctx is None:
        from ..api import Context
        ctx = Context.make_with("inline")
    ds = ctx.load("dm", str(dm4_path), force_c_order=True,
                  dataset_index=dataset_index)
    return _convert_transposed_ds(ctx, ds, out_path, progress=progress)


def convert_transposed_to_npy(src_path: str, out_path: str, nav_shape,
                              sig_shape, dtype, data_offset: int = 0,
                              chunk_px: int = 1024):
    """A (sig..., nav...) file into a (nav..., sig...) ``.npy``, in
    bounded memory: ``chunk_px`` signal pixels' rows of the source at
    a time, transposed into columns of the output."""
    nav_shape = tuple(int(x) for x in nav_shape)
    sig_shape = tuple(int(x) for x in sig_shape)
    dtype = np.dtype(dtype)
    n_nav = int(np.prod(nav_shape))
    n_sig = int(np.prod(sig_shape))
    src = np.memmap(src_path, dtype=dtype, mode="r", offset=data_offset,
                    shape=(n_sig, n_nav))
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=dtype,
                                    shape=nav_shape + sig_shape)
    flat_out = out.reshape(n_nav, n_sig)
    for s0 in range(0, n_sig, chunk_px):
        s1 = min(n_sig, s0 + chunk_px)
        flat_out[:, s0:s1] = src[s0:s1, :].T
    out.flush()
    return out_path
