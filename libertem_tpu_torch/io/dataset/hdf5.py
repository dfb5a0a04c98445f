"""HDF5 dataset (counterpart of ``libertem_tpu/io/dataset/hdf5.py``):
one dataset of a file, read through h5py, its nav axes flattened.

Frames are read with ``read_direct`` straight into the destination
(the host feed's pinned slot), which also brings them to native byte
order; an nD nav is read as runs along its last axis.  h5py handles
are not shared between threads: each thread that reads opens its own.
``get_max_io_size`` keeps a block near 16 chunks for chunked files.
h5py is imported when a file is opened: without it, the format raises
DataSetException.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.math import prod
from ...common.shape import Shape
from .base import DataSet, DataSetException, DataSetMeta, Partition

# the clock of the dataset discovery walk, which is bounded in time (a
# huge tree on slow storage must not hang detection)
current_time = time.time

# seconds the discovery walk may take
_SCAN_TIMEOUT_S = 10.0


class _ScanTimeout(Exception):
    pass


def _open_h5(path):
    try:
        import h5py
    except ImportError as e:
        raise DataSetException(
            f"the hdf5 format needs h5py, which is not installed ({e})"
        ) from None
    return h5py.File(path, "r")


class H5Reader:
    """``get_h5ds()``: the file's dataset, open for a ``with`` block."""

    def __init__(self, path, ds_path):
        self._path = path
        self._ds_path = ds_path

    @contextlib.contextmanager
    def get_h5ds(self):
        with _open_h5(self._path) as f:
            yield f[self._ds_path]


class H5Partition(Partition):
    def __init__(self, path, ds_path, sig_dims, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._path = path
        self._ds_path = ds_path
        self._sig_dims = sig_dims
        self._local = threading.local()

    def _get_ds(self):
        """The dataset, through this thread's own file handle."""
        f = getattr(self._local, "file", None)
        if f is None:
            f = self._local.file = _open_h5(self._path)
        return f[self._ds_path]

    def _read_raw_frames(self, start, stop, out):
        ds = self._get_ds()
        nav_shape = ds.shape[:ds.ndim - self._sig_dims]
        if len(nav_shape) <= 1:
            ds.read_direct(out, source_sel=np.s_[start:stop])
            return
        # an nD nav: runs along its last axis
        i = start
        while i < stop:
            c = np.unravel_index(i, nav_shape)
            run = min(stop - i, nav_shape[-1] - int(c[-1]))
            sel = tuple(int(x) for x in c[:-1]) + (
                slice(int(c[-1]), int(c[-1]) + run),)
            ds.read_direct(out[i - start:i - start + run], source_sel=sel)
            i += run

    def read_selected_frames(self, ids: np.ndarray) -> np.ndarray:
        """Data frames ``ids`` (sorted, within the data), one read a
        frame: for a chunked (compressed) file this decodes only the
        chunks of those frames, not of the span that covers them."""
        ds = self._get_ds()
        nav_shape = ds.shape[:ds.ndim - self._sig_dims]
        out = np.empty((len(ids),) + tuple(self.meta.shape.sig),
                       self.meta.native_dtype)
        for i, fid in enumerate(ids):
            sel = tuple(int(c) for c in np.unravel_index(int(fid),
                                                          nav_shape))
            ds.read_direct(out[i:i + 1], source_sel=sel)
        return out

    def get_tiles(self, tiling_scheme, roi=None, dest_dtype=None,
                  array_backend=None):
        """The tile stream, its tiles never longer than a row of the
        last nav axis (reads stay within a row of chunks)."""
        nav = tuple(self.meta.shape.nav)
        row = int(nav[-1]) if nav else 1
        if tiling_scheme.depth > row:
            from ..tiling import TilingScheme
            tiling_scheme = TilingScheme(
                row, tiling_scheme.sig_slices, tiling_scheme.dataset_shape,
                tiling_scheme.intent,
            )
        yield from super().get_tiles(
            tiling_scheme, roi=roi, dest_dtype=dest_dtype,
            array_backend=array_backend,
        )


class H5DataSet(DataSet):
    """``ds_path``: the dataset in the file (the largest one of at least
    3 dims without it); ``sig_dims`` trailing axes are the frame;
    ``nav_shape`` re-views the nav; ``target_size`` (bytes a partition)
    sets the partition count unless ``num_partitions`` does, and
    ``min_num_partitions`` floors it.  No io backend: h5py reads."""

    def __init__(self, path: str, ds_path: Optional[str] = None,
                 sig_dims: int = 2,
                 nav_shape: Optional[Sequence[int]] = None,
                 sig_shape: Optional[Sequence[int]] = None,
                 sync_offset: int = 0, target_size: Optional[int] = None,
                 min_num_partitions: Optional[int] = None,
                 io_backend=None, num_partitions: Optional[int] = None):
        if io_backend is not None:
            raise ValueError(
                "H5DataSet does not support alternative I/O backends")
        super().__init__(num_partitions=num_partitions)
        self._path = path
        self._ds_path = ds_path
        self._sig_dims = sig_dims
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)
        self._target_size = target_size
        self._min_num_partitions = min_num_partitions
        self._chunks = None

    @property
    def path(self) -> str:
        return self._path

    @property
    def ds_path(self) -> str:
        return self._ds_path

    @classmethod
    def get_supported_io_backends(cls) -> list:
        return []

    def get_num_partitions(self) -> int:
        if self._num_partitions is not None or not self._target_size:
            n = super().get_num_partitions()
        else:
            total = self.meta.shape.size * self.meta.raw_dtype.itemsize
            n = max(1, int(np.ceil(total / self._target_size)))
        if self._min_num_partitions:
            n = max(n, int(self._min_num_partitions))
        return min(n, max(1, self.meta.shape.nav.size))

    @classmethod
    def _find_datasets(cls, f, min_dims=3, timeout=_SCAN_TIMEOUT_S) -> list:
        """The names of the datasets of at least ``min_dims`` dims,
        largest first; raises _ScanTimeout when the walk takes longer
        than ``timeout`` seconds."""
        import h5py
        found = []
        t0 = current_time()

        def visit(name, obj):
            if current_time() - t0 > timeout:
                raise _ScanTimeout()
            if isinstance(obj, h5py.Dataset) and obj.ndim >= min_dims:
                found.append((name, obj.size))

        try:
            f.visititems(visit)
        except TimeoutError:
            raise _ScanTimeout() from None
        found.sort(key=lambda t: -t[1])
        return [name for name, _ in found]

    def initialize(self) -> "H5DataSet":
        with _open_h5(self._path) as f:
            if self._ds_path is None:
                cands = self._find_datasets(f)
                if not cands:
                    raise DataSetException(
                        f"no >=3D dataset found in {self._path}")
                self._ds_path = cands[0]
            ds = f[self._ds_path]
            shape, dtype, self._chunks = ds.shape, ds.dtype, ds.chunks
        if len(shape) < 3:
            raise DataSetException(
                "2D HDF5 files are currently not supported")
        sig_shape = self._sig_shape or shape[len(shape) - self._sig_dims:]
        file_sig = tuple(shape[len(shape) - len(sig_shape):])
        if tuple(sig_shape) != file_sig:
            raise DataSetException(
                f"sig_shape {tuple(sig_shape)} does not match the "
                f"dataset's frame shape {file_sig} "
                f"({self._path}:{self._ds_path})"
            )
        file_nav = shape[:len(shape) - len(sig_shape)]
        nav_shape = self._nav_shape or file_nav
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + tuple(sig_shape),
                        sig_dims=len(sig_shape)),
            raw_dtype=dtype,
            sync_offset=self._sync_offset,
            image_count=prod(file_nav) if file_nav else 1,
        )
        return self

    def get_max_io_size(self) -> Optional[int]:
        """16 chunks' bytes for a chunked file (so the chunk cache
        serves a block), else no cap."""
        if self._chunks is None:
            return None
        return 16 * prod(self._chunks) * self.meta.raw_dtype.itemsize

    @property
    def diagnostics(self) -> list:
        diags = [
            {"name": "ds_path", "value": str(self._ds_path)},
            {"name": "chunks", "value": str(self._chunks)},
        ]
        try:
            with _open_h5(self._path) as f:
                names = self._find_datasets(f)
            diags.append({"name": "datasets", "value": ", ".join(names)})
        except Exception:  # the listing is informative only
            diags.append({"name": "datasets",
                          "value": "(listing timed out or failed)"})
        return diags

    def get_diagnostics(self) -> list:
        return self.diagnostics

    def get_reader(self) -> H5Reader:
        return H5Reader(self._path, self._ds_path)

    def get_base_shape(self, roi) -> tuple:
        """The smallest efficient tile: the sig chunk of a chunked file,
        a row of the frame otherwise; whole frames with a roi."""
        sig = tuple(self.shape.sig)
        if roi is not None:
            return (1,) + sig
        if self._chunks is not None:
            return (1,) + tuple(self._chunks[-len(sig):])
        return (1, 1) + (int(self.shape[-1]),)

    def adjust_tileshape(self, tileshape, roi):
        """Where the file's sig chunks are finer than the tile asked
        for, whole frames of the same size instead (a tile would decode
        each chunk many times)."""
        chunks = self._chunks
        sig = tuple(self.shape.sig)
        if roi is not None or chunks is None:
            return tileshape
        sig_chunks = tuple(chunks[-len(sig):])
        if sig_chunks == sig:
            return tileshape
        if any(t > c for t, c in zip(tuple(tileshape)[-len(sig):],
                                     sig_chunks)):
            depth = max(1, int(np.prod(tuple(tileshape))) // prod(sig))
            return (depth,) + sig
        return tileshape

    def get_partitions(self) -> Iterator[H5Partition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield H5Partition(
                self._path, self._ds_path, self.meta.shape.sig.dims,
                self.meta, start, stop - start, idx=idx,
            )

    @classmethod
    def detect_params(cls, path: str):
        """``{"parameters": ..., "info": ...}`` for an HDF5 file: its
        largest dataset of at least 3 dims, the nav as 2-D; the path
        alone where the walk timed out or found none."""
        ext = str(path).split(".")[-1].lower()
        if ext not in cls.get_supported_extensions():
            return False
        try:
            try:
                with _open_h5(path) as f:
                    cands = cls._find_datasets(f)
            except _ScanTimeout:
                return {"parameters": {"path": path}}
            if not cands:
                return {"parameters": {"path": path}}
            with _open_h5(path) as f:
                shape = tuple(f[cands[0]].shape)
            nav = shape[:-2]
            if len(nav) == 0:
                nav2d = (1, 1)
            elif len(nav) == 1:
                nav2d = (1, nav[0])
            else:
                nav2d = (math.prod(nav[:-1]), nav[-1])
            return {
                "parameters": {
                    "path": path, "ds_path": cands[0],
                    "nav_shape": nav2d, "sig_shape": shape[-2:],
                },
                "info": {"datasets": list(cands)},
            }
        except Exception:
            return False

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"h5", "hdf5", "hspy", "nxs", "emd"}
