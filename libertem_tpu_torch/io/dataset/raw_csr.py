"""Raw CSR dataset: sparse frames (event-counting detectors) in
compressed-sparse-row layout, one row a frame, in three files that a
TOML descriptor names (counterpart of
``libertem_tpu/io/dataset/raw_csr.py``): ``[params]`` filetype,
nav_shape, sig_shape; ``[raw_csr]`` indptr_file/indptr_dtype,
indices_file/indices_dtype, data_file/data_dtype.

A block leaves the host as its CSR entries, not as dense frames: the
run loops' block reader reads a block's ``(vals, rows, cols)``
(:meth:`RawCSRPartition.read_sparse_into`, by dataset frame id, so a
block may span partitions) into its slot's staging, sized once for the
largest entry budget of the run (:meth:`~RawCSRPartition.
sparse_nnz_budget`, a power of two), the host feed copies the block's
own entries (bytes that scale with the events, not the pixels) and
densifies them on the device (``io.dataset.base.densify_into``);
``gen_blocks`` yields the same sparse blocks in fresh arrays.  Reads on
the host (the host engine's ``Block.data``, ``read_dataset_frames``,
``get_tiles``) densify with ``np.add.at``: in both places duplicate
entries sum.
"""
from __future__ import annotations

import os
import tomllib
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from ...common.math import prod  # noqa: F401  (the JAX module's name)
from ...common.slice import Slice
from .base import (
    Block,
    DataSet,
    DataSetException,
    DataSetMeta,
    DataTile,
    Partition,
    RangeReader,
    _runs,
    nav_coords,
)

# detection parses no file larger than this as TOML
_DETECT_MAX_TOML_BYTES = 1024 * 1024
# the smallest entry budget of a block
_MIN_NNZ = 16


def load_toml(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


class CSRTriple(NamedTuple):
    """The three CSR arrays."""
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray


def _csr_for_span(triple: CSRTriple, a: int, b: int, n_sig: int,
                  dest_dtype=None):
    """A scipy CSR matrix of rows [a, b) of the triple."""
    import scipy.sparse as sp
    indptr = np.asarray(triple.indptr[a:b + 1])
    lo, hi = int(indptr[0]), int(indptr[-1])
    mat = sp.csr_matrix(
        (np.asarray(triple.data[lo:hi]), np.asarray(triple.indices[lo:hi]),
         indptr - lo),
        shape=(b - a, n_sig),
    )
    if dest_dtype is not None and mat.dtype != np.dtype(dest_dtype):
        mat = mat.astype(dest_dtype)
    return mat


def read_tiles_straight(triple: CSRTriple, partition_slice, tiling_scheme,
                        dest_dtype=None, sync_offset: int = 0):
    """Depth chunks of a partition's frames as whole-frame scipy CSR
    tiles (CSR does not split the frame).  Data row = dataset frame +
    ``sync_offset``; frames outside the data are left out."""
    n_frames = int(partition_slice.shape[0])
    origin = int(partition_slice.origin[0])
    sig_dims = partition_slice.shape.sig.dims
    n_sig = partition_slice.shape.sig.size
    depth = max(1, int(tiling_scheme.depth))
    n_rows = len(triple.indptr) - 1
    for off in range(0, n_frames, depth):
        a_ds = origin + off
        b_ds = min(origin + n_frames, a_ds + depth)
        a = max(0, a_ds + sync_offset)
        b = min(n_rows, b_ds + sync_offset)
        if b <= a:
            continue
        tile_slice = Slice(
            (a - sync_offset,) + (0,) * sig_dims,
            Shape((b - a,) + tuple(partition_slice.shape.sig),
                  sig_dims=sig_dims),
        )
        yield DataTile(_csr_for_span(triple, a, b, n_sig, dest_dtype),
                       tile_slice=tile_slice, scheme_idx=0)


def read_tiles_with_roi(triple: CSRTriple, partition_slice, tiling_scheme,
                        roi, dest_dtype=None, sync_offset: int = 0):
    """:func:`read_tiles_straight` of the roi's frames only, the tile
    origins roi-compressed."""
    roi = np.asarray(roi).reshape(-1)
    origin = int(partition_slice.origin[0])
    n_frames = int(partition_slice.shape[0])
    sig_dims = partition_slice.shape.sig.dims
    n_sig = partition_slice.shape.sig.size
    depth = max(1, int(tiling_scheme.depth))
    n_rows = len(triple.indptr) - 1
    sel = np.flatnonzero(roi[origin:origin + n_frames]) + origin
    stored = sel + sync_offset
    stored = stored[(stored >= 0) & (stored < n_rows)]
    goff0 = int(np.count_nonzero(roi[:origin]))
    part = None
    if len(stored):
        lo, hi = int(stored[0]), int(stored[-1]) + 1
        part = _csr_for_span(triple, lo, hi, n_sig, dest_dtype)[stored - lo]
    for off in range(0, len(stored), depth):
        chunk = part[off:off + depth]
        tile_slice = Slice(
            (goff0 + off,) + (0,) * sig_dims,
            Shape((chunk.shape[0],) + tuple(partition_slice.shape.sig),
                  sig_dims=sig_dims),
        )
        yield DataTile(chunk, tile_slice=tile_slice, scheme_idx=0)


def load_descriptor(path: str) -> dict:
    """The descriptor's shapes, and the three files (beside it) with
    their dtypes."""
    raw = load_toml(path)
    params = raw.get("params", {})
    csr = raw.get("raw_csr", {})
    base = os.path.dirname(os.path.abspath(path))
    if params.get("filetype", "raw_csr").lower() != "raw_csr":
        raise DataSetException("not a raw_csr descriptor")
    out = {
        "nav_shape": tuple(params.get("nav_shape", ())),
        "sig_shape": tuple(params.get("sig_shape", ())),
    }
    for key in ("indptr", "indices", "data"):
        out[f"{key}_file"] = os.path.join(base, csr[f"{key}_file"])
        out[f"{key}_dtype"] = np.dtype(csr[f"{key}_dtype"])
    return out


class _RangeArray:
    """A 1-D array of a file read by element ranges: ``a[lo:hi]``."""

    def __init__(self, reader: RangeReader, dtype):
        self._reader = reader
        self._dtype = np.dtype(dtype)

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("only contiguous slices are supported")
        lo, hi = int(key.start or 0), int(key.stop)
        item = self._dtype.itemsize
        if hi <= lo:
            return np.empty(0, dtype=self._dtype)
        return np.frombuffer(self._reader.read(lo * item, (hi - lo) * item),
                             dtype=self._dtype)


def nnz_budget(nnz: int) -> int:
    """A block's entry budget: the next power of two, at least 16."""
    return max(_MIN_NNZ, 1 << int(np.ceil(np.log2(max(nnz, 1)))))


class RawCSRPartition(Partition):
    def __init__(self, desc, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._desc = desc
        self._maps = None

    def _get_maps(self):
        """indptr (read whole: one entry a frame), and indices and data
        read by range."""
        if self._maps is None:
            d = self._desc
            self._maps = (
                np.fromfile(d["indptr_file"], dtype=d["indptr_dtype"]),
                _RangeArray(RangeReader(d["indices_file"], self.io_backend),
                            d["indices_dtype"]),
                _RangeArray(RangeReader(d["data_file"], self.io_backend),
                            d["data_dtype"]),
            )
        return self._maps

    def _read_raw_frames(self, start, stop, out):
        indptr, indices, data = self._get_maps()
        lo, hi = int(indptr[start]), int(indptr[stop])
        rows = np.repeat(np.arange(stop - start),
                         np.diff(np.asarray(indptr[start:stop + 1],
                                            dtype=np.int64)))
        flat = out.reshape(stop - start, -1)
        flat[...] = 0
        # add, not assign: duplicate entries sum, as on the device
        np.add.at(flat, (rows, np.asarray(indices[lo:hi], dtype=np.int64)),
                  data[lo:hi])

    def read_sparse_into(self, frame_ids: np.ndarray, vals: np.ndarray,
                         rows: np.ndarray, cols: np.ndarray) -> int:
        """The entries of dataset frames ``frame_ids`` (ascending, of
        any partition: the files are the dataset's) into ``vals``,
        ``rows`` (the frame's position in ``frame_ids``) and ``cols``,
        zero-padded to their length; returns how many there are.
        Under the sync offset, frames outside the data have no entries.
        Each run of consecutive stored frames is one read of each file;
        a big-endian ``data_dtype`` is swapped by the assignment."""
        indptr, indices, data = self._get_maps()
        so = self.meta.sync_offset
        n_stored = len(indptr) - 1
        stored = np.asarray(frame_ids, dtype=np.int64) + so
        ok = (stored >= 0) & (stored < n_stored)
        pos = 0
        # ascending ids: a run of consecutive stored frames is also a
        # run of neighbouring positions in frame_ids
        inside = np.flatnonzero(ok)
        for a, b in _runs(stored[inside]):
            r, r2 = int(inside[a]), int(inside[b - 1]) + 1
            s0, s1 = int(stored[r]), int(stored[r2 - 1]) + 1
            lo, hi = int(indptr[s0]), int(indptr[s1])
            k = hi - lo
            vals[pos:pos + k] = data[lo:hi]
            cols[pos:pos + k] = indices[lo:hi]
            rows[pos:pos + k] = np.repeat(
                np.arange(r, r2, dtype=np.int32),
                np.diff(np.asarray(indptr[s0:s1 + 1], dtype=np.int64)))
            pos += k
        vals[pos:] = 0
        rows[pos:] = 0
        cols[pos:] = 0
        return pos

    def sparse_nnz_budget(self, ids) -> Optional[int]:
        """The entry budget (:func:`nnz_budget`) of a block of dataset
        frames ``ids`` (ascending, of any partition)."""
        indptr = self._get_maps()[0]
        stored = np.asarray(ids, dtype=np.int64) + self.meta.sync_offset
        stored = stored[(stored >= 0) & (stored < len(indptr) - 1)]
        counts = indptr[stored + 1].astype(np.int64) - indptr[stored]
        return nnz_budget(int(counts.sum()))

    def gen_blocks(self, scheme, roi: Optional[np.ndarray] = None
                   ) -> Iterator[Block]:
        """Sparse blocks: each block's entries in fresh arrays,
        zero-padded to its budget (:meth:`sparse_nnz_budget`)."""
        depth = scheme.depth
        ids = self.local_frame_ids(roi)
        goff = self.roi_offset(roi)
        nav_shape = tuple(self.meta.shape.nav)
        sig = tuple(self.meta.shape.sig)
        for off in range(0, len(ids), depth):
            chunk = ids[off:off + depth]
            budget = self.sparse_nnz_budget(chunk)
            triple = (np.empty(budget, self.meta.native_dtype),
                      np.empty(budget, np.int32),
                      np.empty(budget, np.int32))
            nnz = self.read_sparse_into(chunk, *triple)
            yield Block(global_offset=goff + off,
                        coords=nav_coords(chunk, depth, nav_shape),
                        valid=len(chunk), sparse=triple,
                        block_shape=(depth,) + sig, nnz=nnz)


class RawCSRDataSet(DataSet):
    """``path``: the TOML descriptor; ``nav_shape`` and ``sig_shape``
    override its shapes."""

    def __init__(self, path: str,
                 nav_shape: Optional[Sequence[int]] = None,
                 sig_shape: Optional[Sequence[int]] = None,
                 sync_offset: int = 0, io_backend=None,
                 num_partitions: Optional[int] = None):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape) if nav_shape else None
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)

    def initialize(self, executor=None) -> "RawCSRDataSet":
        desc = load_descriptor(self._path)
        nav_shape = self._nav_shape or desc["nav_shape"]
        sig_shape = self._sig_shape or desc["sig_shape"]
        if not nav_shape or not sig_shape:
            raise DataSetException(
                "nav_shape and sig_shape required (TOML or kwargs)")
        image_count = (os.path.getsize(desc["indptr_file"])
                       // desc["indptr_dtype"].itemsize) - 1
        self._desc = desc
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + tuple(sig_shape),
                        sig_dims=len(sig_shape)),
            raw_dtype=desc["data_dtype"],
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[RawCSRPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield RawCSRPartition(
                self._desc, self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )

    def get_diagnostics(self) -> list:
        d = self._desc
        return [
            {"name": f"{key} dtype", "value": str(d[f"{key}_dtype"])}
            for key in ("data", "indptr", "indices")
        ]

    @property
    def diagnostics(self) -> list:
        return self.get_diagnostics()

    @classmethod
    def detect_params(cls, path: str, executor=None):
        try:
            if not str(path).lower().endswith(".toml"):
                return False
            if os.path.getsize(path) > _DETECT_MAX_TOML_BYTES:
                return False
            load_descriptor(path)
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"toml"}
