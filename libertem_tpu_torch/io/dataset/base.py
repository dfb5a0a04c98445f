"""DataSet / Partition base machinery (counterpart of
``libertem_tpu/io/dataset/base.py``).

A dataset is split along the flattened navigation axis into
contiguous-frame :class:`Partition` s.  Each partition streams its
frames (those of a roi only, when the run has one) as fixed-depth
:class:`Block` s in the raw on-disk dtype, zero-padded at the tail,
with a ``valid`` count of real frames.  The cast to float happens on
the device, so narrow detector data crosses PCIe at its raw width.

``sync_offset`` maps dataset frame ``i`` to data frame
``i + sync_offset``; dataset frames whose data frame lies outside
``[0, image_count)`` read as zeros.  Every read lands in native byte
order: a format whose bytes are in another order swaps them in place
in the destination, on the host, right after the read (in C++,
``ops/decode.py``).  File formats
read through a :class:`RangeReader`, with the strategy of one of the io
backends (``preadv``, the default; mmap; ``O_DIRECT``).
"""
from __future__ import annotations

import os
import threading
import warnings
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ...common.shape import Shape
from ...common.math import prod  # noqa: F401  (the JAX module's name)
from ...common.slice import Slice
from ..tiling import Negotiator  # noqa: F401  (the JAX module's name)
from ..tiling import TilingScheme

MAX_PARTITION_SIZE = 512 * 1024 * 1024  # bytes


class DataSetException(Exception):
    pass


@dataclass
class DataSetMeta:
    shape: Shape
    raw_dtype: np.dtype
    sync_offset: int = 0
    # frames actually present in the data; None means all of nav.  A
    # genuine 0 (a header-only file of an acquisition in progress)
    # stays 0, so every frame reads as zeros
    image_count: Optional[int] = None

    def __post_init__(self):
        self.raw_dtype = np.dtype(self.raw_dtype)
        if self.image_count is None:
            self.image_count = self.shape.nav.size
        # an offset at or past the frame count would select nothing but
        # zeros: a configuration error, not a valid sync
        if self.image_count and not (
            -self.image_count < self.sync_offset < self.image_count
        ):
            raise DataSetException(
                f"sync_offset should be in ({-self.image_count}, "
                f"{self.image_count}), which is "
                "(-image_count, image_count)"
            )

    @property
    def native_dtype(self) -> np.dtype:
        """``raw_dtype`` in native byte order: what every read yields."""
        return np.dtype(self.raw_dtype.newbyteorder("="))


def byteswap(out: np.ndarray, raw_dtype) -> None:
    """Bring a read of data of ``raw_dtype`` into native byte order, in
    place (the C++ ``byteswap16/32/64`` of ``ops/decode.py``): ``out``
    (C-contiguous, of the native dtype) holds the data's bytes as read.
    Nothing to do for data in native order."""
    if not np.dtype(raw_dtype).isnative:
        from ...ops.decode import byteswap_inplace
        byteswap_inplace(out)


def resolve_sig_override(sig_shape, native) -> tuple:
    """A format's sig shape under the caller's ``sig_shape``: ``None``
    keeps the file's own frame shape; another factorization of the
    same pixel count views the frame row-major; a product mismatch
    raises ("sig_shape must be of size: N")."""
    native = tuple(int(s) for s in native)
    if sig_shape is None:
        return native
    sig = tuple(int(s) for s in sig_shape)
    if sig == native:
        return native
    if int(np.prod(sig)) != int(np.prod(native)):
        raise DataSetException(
            f"sig_shape must be of size: {int(np.prod(native))}"
        )
    return sig


def _runs(ids: np.ndarray) -> list[tuple[int, int]]:
    """``(a, b)`` position ranges of the stretches of consecutive values
    in the sorted ``ids``."""
    if not len(ids):
        return []
    breaks = np.flatnonzero(np.diff(ids) != 1) + 1
    starts = np.concatenate(([0], breaks))
    stops = np.concatenate((breaks, [len(ids)]))
    return [(int(a), int(b)) for a, b in zip(starts, stops)]


class DataTile:
    """A slice-tagged tile of :meth:`Partition.get_tiles`: ``data``,
    ``(frames, *sig tile)`` (2-D with the sig axes flattened for the
    scipy.sparse backends), and its ``tile_slice`` in the flat nav."""

    def __init__(self, data, tile_slice: Slice, scheme_idx: int):
        if isinstance(data, DataTile):
            data = data.data
        flat2d = (tile_slice.shape.nav.size, tile_slice.shape.sig.size)
        if tuple(data.shape) != tuple(tile_slice.shape) and \
                tuple(data.shape) != flat2d:
            raise ValueError(
                f"shape mismatch: data {tuple(data.shape)} vs "
                f"tile_slice {tuple(tile_slice.shape)}"
            )
        self._data = data
        self.tile_slice = tile_slice
        self.scheme_idx = scheme_idx

    @property
    def data(self):
        return self._data

    @property
    def flat_data(self) -> np.ndarray:
        """(n_frames, n_sig_pixels) view of the tile."""
        shape = self.tile_slice.shape
        return self._data.reshape((shape.nav.size, shape.sig.size))

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def shape(self):
        return tuple(self.tile_slice.shape)

    @property
    def size(self):
        return self.tile_slice.shape.size

    def __repr__(self):
        return f"<DataTile {self.tile_slice!r} scheme_idx={self.scheme_idx}>"


class Block:
    """One fixed-depth chunk of frames headed for the device.

    data:          (depth, *sig) raw-dtype array, zero-padded; for a
                   sparse block densified on the host when first read
    sparse:        or None: ``(vals, rows, cols)``, the block's nonzero
                   entries (row in the block, flat pixel index; int32),
                   zero-padded to a power-of-two entry budget (the
                   padding adds 0 at (0, 0)).  The host feed ships
                   the first ``nnz`` of them (the block's own) to the
                   device instead of ``data`` and densifies them there
                   (:func:`densify_into`)
    nnz:           entries of ``sparse`` in use
    block_shape:   (depth, *sig) of a sparse block
    global_offset: first frame's position in the (roi-compressed)
                   flat nav order
    coords:        (depth, nav_dims) int32 nav coordinates of the
                   frames, zeros in the padding rows
    valid:         number of non-padding frames (<= depth)
    """

    def __init__(self, global_offset: int, coords: np.ndarray, valid: int,
                 data: Optional[np.ndarray] = None,
                 sparse: Optional[tuple] = None,
                 block_shape: Optional[tuple] = None,
                 nnz: Optional[int] = None):
        self.global_offset = global_offset
        self.coords = coords
        self.valid = valid
        self.sparse = sparse
        self.block_shape = block_shape
        self.nnz = nnz
        self._data = data

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            vals, rows, cols = self.sparse
            depth, sig = self.block_shape[0], tuple(self.block_shape[1:])
            out = np.zeros((depth, int(np.prod(sig))), dtype=vals.dtype)
            # add, not assign: duplicate entries sum, as on the device
            np.add.at(out, (rows, cols), vals)
            self._data = out.reshape((depth,) + sig)
        return self._data


# the signed type of each unsigned one's width: the device adds
# unsigned entries in it (the same bits, wrapping as the unsigned type
# would), since torch's accumulating index_put_ has no unsigned 16-64
# bit kernels
_SIGNED_OF = {
    torch.uint8: torch.int8, torch.uint16: torch.int16,
    torch.uint32: torch.int32, torch.uint64: torch.int64,
}


def densify_into(dense, vals, rows, cols) -> None:
    """Zero ``dense`` ((depth, pixels) tensor, padding rows included)
    and add ``vals`` at ``(rows, cols)``, on ``dense``'s device:
    duplicate entries sum in ``dense``'s dtype, as in the JAX package's
    ``zeros.at[r, c].add(v)``."""
    dense.zero_()
    signed = _SIGNED_OF.get(dense.dtype)
    if signed is not None:
        dense, vals = dense.view(signed), vals.view(signed)
    dense.index_put_((rows.long(), cols.long()), vals, accumulate=True)


def nav_coords(ids: np.ndarray, depth: int, nav_shape: tuple) -> np.ndarray:
    """The ``(depth, nav_dims)`` int32 nav coordinates of a block of
    dataset frames ``ids``, zeros in the rows past them."""
    coords = np.zeros((depth, len(nav_shape)), dtype=np.int32)
    if nav_shape:
        for k, u in enumerate(np.unravel_index(ids, nav_shape)):
            coords[:len(ids), k] = u
    return coords


def read_ids_across(partitions, ids: np.ndarray, out: np.ndarray) -> None:
    """Dataset frames ``ids`` (sorted; they may span partitions) into
    ``out`` (a block of ``len(ids)`` or more frames), zeros in the rows
    past them: each partition's share with its
    :meth:`Partition.read_ids_into`."""
    for p in partitions:
        if p.start_frame > ids[-1]:
            break
        a = int(np.searchsorted(ids, p.start_frame))
        b = int(np.searchsorted(ids, p.start_frame + p.num_frames))
        if b > a:
            p.read_ids_into(ids[a:b], out[a:b])
    out[len(ids):] = 0


class ReadCancelled(Exception):
    """The host feed stopped while a read waited for data (a live
    acquisition's ring) or for a staging slot."""


class Partition:
    """A contiguous flat-nav frame range of a dataset.  ``start_frame``
    and ``num_frames`` count dataset frames; the sync offset applies
    when reading."""

    def __init__(self, meta: DataSetMeta, start_frame: int,
                 num_frames: int, idx: int = 0,
                 io_backend: Optional["IOBackend"] = None):
        self.meta = meta
        self.start_frame = int(start_frame)
        self.num_frames = int(num_frames)
        self.idx = int(idx)
        self.io_backend = io_backend
        # set by the host feed that reads this partition: a read that
        # blocks waiting for data gives up (ReadCancelled) once it is
        self.stop_event: Optional[threading.Event] = None

    def __repr__(self):
        return (
            f"<{type(self).__name__} #{self.idx} "
            f"[{self.start_frame}:{self.start_frame + self.num_frames})>"
        )

    @property
    def slice(self) -> Slice:
        """The flat-nav slice of the dataset this partition covers."""
        sig = tuple(self.meta.shape.sig)
        return Slice(
            (self.start_frame,) + (0,) * len(sig),
            Shape((self.num_frames,) + sig,
                  sig_dims=self.meta.shape.sig.dims),
        )

    @property
    def shape(self) -> Shape:
        """(n_frames, *sig)."""
        return self.slice.shape

    @classmethod
    def make_slices(cls, shape: Shape, num_partitions: int,
                    sync_offset: int = 0):
        """Balanced flat-nav partition slices, each with the data frames
        ``(start + sync_offset, stop + sync_offset)`` it maps to; more
        partitions than frames are clamped, with a warning."""
        num_frames = shape.nav.size
        if num_partitions > num_frames:
            warnings.warn(
                "dataset contains fewer frames than specified "
                f"partitions, setting num_partitions == num_frames "
                f"== {num_frames} to avoid creating empty partitions",
                RuntimeWarning,
            )
            num_partitions = num_frames
        bounds = np.linspace(
            0, num_frames, num=max(2, num_partitions + 1),
            endpoint=True, dtype=int,
        )
        for start, stop in zip(bounds[:-1], bounds[1:]):
            start, stop = int(start), int(stop)
            yield (
                Slice(
                    (start,) + (0,) * shape.sig.dims,
                    Shape((stop - start,) + tuple(shape.sig),
                          sig_dims=shape.sig.dims),
                ),
                start + sync_offset,
                stop + sync_offset,
            )

    def get_ident(self) -> str:
        return f"part-{self.idx}"

    # -- reading -----------------------------------------------------------

    def _read_raw_frames(self, start: int, stop: int,
                         out: np.ndarray) -> None:
        """Read data frames [start, stop) into ``out`` ((stop - start,
        *sig), native dtype), in native byte order.  Indices lie within
        [0, image_count)."""
        raise NotImplementedError()

    def read_frames_into(self, start: int, stop: int,
                         out: np.ndarray) -> None:
        """Fill ``out`` with dataset frames [start, stop): one read of
        the data frames they map to under the sync offset, zeros where
        those lie outside [0, image_count)."""
        so = self.meta.sync_offset
        lo = min(max(start, -so), stop)
        hi = max(min(stop, self.meta.image_count - so), lo)
        out[:lo - start] = 0
        if hi > lo:
            self._read_raw_frames(lo + so, hi + so,
                                  out[lo - start:hi - start])
        out[hi - start:] = 0

    def read_dataset_frames(self, start: int, stop: int) -> np.ndarray:
        """Dataset frames [start, stop) as a new (n, *sig) array."""
        out = np.empty((stop - start,) + tuple(self.meta.shape.sig),
                       self.meta.native_dtype)
        self.read_frames_into(start, stop, out)
        return out

    def read_selected_frames(self, ids: np.ndarray) -> np.ndarray:
        """Data frames ``ids`` (sorted, within [0, image_count)) as
        ``(len(ids), *sig)``, one read per run of consecutive ids."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty((len(ids),) + tuple(self.meta.shape.sig),
                       self.meta.native_dtype)
        for a, b in _runs(ids):
            self._read_raw_frames(int(ids[a]), int(ids[b - 1]) + 1,
                                  out[a:b])
        return out

    def read_ids_into(self, ids: np.ndarray, out: np.ndarray) -> None:
        """Dataset frames ``ids`` (sorted, in this partition) into
        ``out[:len(ids)]``, under the sync offset: one read per run of
        consecutive ids, straight into ``out``.  For ids that cover
        less than half their span (a sparse roi) this is the JAX
        package's rule; where they cover more, the JAX package reads
        the covering span and takes the ids from it, which on an H100
        machine's host made ``chip_smoke.py``'s 7c (a roi of half the
        scan) 4.4 times slower than these runs: a fresh array and a
        gather a block, where the runs land in the pinned slot."""
        for a, b in _runs(ids):
            self.read_frames_into(int(ids[a]), int(ids[b - 1]) + 1,
                                  out[a:b])

    def _read_selected_with_offset(self, ids: np.ndarray) -> np.ndarray:
        """Dataset frames ``ids`` (sorted) as ``(len(ids), *sig)``,
        under the sync offset, one read per run of consecutive ids."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty((len(ids),) + tuple(self.meta.shape.sig),
                       self.meta.native_dtype)
        self.read_ids_into(ids, out)
        return out

    def local_frame_ids(self, roi: Optional[np.ndarray]) -> np.ndarray:
        """Flat-nav ids of the frames this partition contributes
        (roi-filtered), in order."""
        if roi is None:
            return np.arange(
                self.start_frame, self.start_frame + self.num_frames,
                dtype=np.int64,
            )
        roi = np.asarray(roi).reshape(-1)
        sel = np.flatnonzero(
            roi[self.start_frame:self.start_frame + self.num_frames]
        )
        return (sel + self.start_frame).astype(np.int64)

    def roi_offset(self, roi: Optional[np.ndarray]) -> int:
        """Position of this partition's first selected frame in the
        roi-compressed global ordering."""
        if roi is None:
            return self.start_frame
        roi = np.asarray(roi).reshape(-1)
        return int(np.count_nonzero(roi[:self.start_frame]))

    def frames_in_roi(self, roi: Optional[np.ndarray]) -> int:
        if roi is None:
            return self.num_frames
        return len(self.local_frame_ids(roi))

    def get_macrotile(self, dest_dtype=None, roi=None) -> DataTile:
        """The partition's (roi-selected) frames as one flat-nav tile,
        its origin roi-compressed."""
        data = self._read_selected_with_offset(self.local_frame_ids(roi))
        if dest_dtype is not None:
            data = data.astype(dest_dtype, copy=False)
        sig_dims = self.meta.shape.sig.dims
        tile_slice = Slice(
            (self.roi_offset(roi),) + (0,) * sig_dims,
            Shape(data.shape, sig_dims=sig_dims),
        )
        return DataTile(data, tile_slice=tile_slice, scheme_idx=0)

    def gen_blocks(
        self,
        scheme: TilingScheme,
        roi: Optional[np.ndarray] = None,
    ) -> Iterator[Block]:
        """Stream this partition's (roi-selected) frames as
        zero-padded fixed-depth blocks, each in a fresh array.

        A roi is read run by run (:meth:`read_ids_into`): each stretch
        of consecutive selected frames is one read straight into the
        block, so no frame outside the roi is read; the run loops' block
        reader reads its chunks the same way (:func:`read_ids_across`),
        into its pinned slots.
        """
        ids = self.local_frame_ids(roi)
        depth = scheme.depth
        goff = self.roi_offset(roi)
        nav_shape = tuple(self.meta.shape.nav)
        sig = tuple(self.meta.shape.sig)
        for off in range(0, len(ids), depth):
            chunk = ids[off:off + depth]
            data = np.empty((depth,) + sig, self.meta.native_dtype)
            self.read_ids_into(chunk, data)
            data[len(chunk):] = 0
            yield Block(
                data=data, global_offset=goff + off,
                coords=nav_coords(chunk, depth, nav_shape),
                valid=len(chunk),
            )

    def sparse_nnz_budget(self, ids: np.ndarray) -> Optional[int]:
        """For a format whose blocks are sparse, the entry budget of a
        block of dataset frames ``ids`` (sorted; a block of the
        multi-device loop may span partitions, and such a format's
        partition counts and reads any frame of the dataset); the block
        reader sizes its staging by the largest.  None for dense
        blocks."""
        return None

    def _get_read_ranges(self, tiling_scheme, roi=None) -> list:
        """Dataset-space (start, stop) spans of the depth-blocks
        :meth:`gen_blocks` reads (first and last selected frame + 1)."""
        ids = self.local_frame_ids(roi)
        depth = max(1, min(int(tiling_scheme.depth), self.num_frames))
        return [
            (int(ids[i]), int(ids[min(i + depth, len(ids)) - 1]) + 1)
            for i in range(0, len(ids), depth)
        ]

    def get_tiles(self, tiling_scheme: TilingScheme,
                  roi: Optional[np.ndarray] = None, dest_dtype=None,
                  array_backend=None) -> Iterator[DataTile]:
        """The public tile stream: depth-chunks of (roi-selected) frames
        split into the scheme's sig slices, as :class:`DataTile` s whose
        origins are flat-nav (roi-compressed with a roi).

        Without a roi, the stream covers stored frames only: the blank
        frames that a sync offset, or a file shorter than nav, inserts
        are left out of it (:meth:`gen_blocks` zero-fills them instead,
        and the engine's results mark them as zeros).  An acquisition in
        progress (``image_count`` 0) is not clipped."""
        from ...common.sparse import to_backend
        sig_dims = self.meta.shape.sig.dims
        so = self.meta.sync_offset
        ic = self.meta.image_count
        v0, v1 = -so, (ic or 0) - so
        clip = bool(ic) and (so != 0 or ic < self.meta.shape.nav.size)
        for block in self.gen_blocks(tiling_scheme, roi=roi):
            data = block.data[:block.valid]
            goff = block.global_offset
            if roi is None and clip:
                lo = max(goff, v0)
                hi = min(goff + len(data), v1)
                if hi <= lo:
                    continue
                data = data[lo - goff:hi - goff]
                goff = lo
            if dest_dtype is not None:
                data = data.astype(dest_dtype, copy=False)
            for idx, sig_slice in tiling_scheme.slices:
                sub = data[(slice(None),) + sig_slice.get()]
                if len(tiling_scheme) > 1:
                    sub = np.ascontiguousarray(sub)
                if array_backend not in (None, "numpy"):
                    sub = to_backend(sub, array_backend)
                tile_slice = Slice(
                    (goff,) + tuple(sig_slice.origin),
                    Shape((len(data),) + tuple(sig_slice.shape),
                          sig_dims=sig_dims),
                )
                yield DataTile(sub, tile_slice=tile_slice, scheme_idx=idx)


class FileRecords:
    """Frames stored as fixed-size records, each ``skip`` bytes of
    header and ``payload`` bytes of frame, ``stride`` bytes apart, in
    one or more files: ``files`` lists ``(path, first frame, frame
    count, offset of the first record)`` in frame order.

    :meth:`rows` reads the records of data frames [start, stop) file by
    file, one read a file into a buffer kept for the next read, and
    yields each file's payloads as a (frames, payload) uint8 view of
    that buffer (the headers skipped, nothing copied) with the frames'
    positions in the read.  The view is valid until the next read."""

    def __init__(self, files, stride: int, skip: int, payload: int,
                 io_backend: Optional["IOBackend"] = None):
        self.files = list(files)
        self.stride = int(stride)
        self.skip = int(skip)
        self.payload = int(payload)
        self._io_backend = io_backend
        self._readers: dict = {}
        self._buf = None

    def rows(self, start: int, stop: int):
        """``(rows, a, b)`` for every file holding frames of [start,
        stop): ``rows`` the payloads of frames start + a .. start + b."""
        for path, first, count, offset in self.files:
            lo, hi = max(start, first), min(stop, first + count)
            if hi <= lo:
                continue
            n = hi - lo
            # the last record's trailing bytes past its payload are
            # not read: a file may end right after it
            nbytes = (n - 1) * self.stride + self.skip + self.payload
            if self._buf is None or len(self._buf) < nbytes:
                self._buf = np.empty(nbytes, dtype=np.uint8)
            cover = self._buf[:nbytes]
            if path not in self._readers:
                self._readers[path] = RangeReader(path, self._io_backend)
            self._readers[path].read_into(
                offset + (lo - first) * self.stride, cover)
            rows = np.lib.stride_tricks.as_strided(
                cover[self.skip:], shape=(n, self.payload),
                strides=(self.stride, 1), writeable=False)
            yield rows, lo - start, hi - start


class RoiHelper:
    """``ds.roi[...]``: index nav space to build a boolean roi."""

    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, k) -> np.ndarray:
        roi = np.zeros(tuple(self._ds.shape.nav), dtype=bool)
        roi[k] = True
        return roi


class DataSet:
    """Base class of the dataset formats: subclasses fill
    ``self._meta`` in :meth:`initialize` and yield their Partition
    subclass from :meth:`get_partitions`."""

    MAX_PARTITION_SIZE = MAX_PARTITION_SIZE

    # whether frames may be read at any offset from several threads at
    # once (the multi-device loop's reader pool); a source that reads
    # in order only (the live ring) sets this False
    supports_concurrent_reads: bool = True

    def __init__(self, io_backend: Optional["IOBackend"] = None,
                 num_partitions: Optional[int] = None):
        self._meta: Optional[DataSetMeta] = None
        self._num_partitions = num_partitions
        self._io_backend = io_backend
        self._cores = 1

    def set_num_cores(self, cores: int) -> None:
        """The least partition count without a fixed ``num_partitions``
        (``Context.load`` asks for 4, as the JAX package's does)."""
        self._cores = max(1, int(cores))

    def initialize(self, executor=None) -> "DataSet":
        """Read the file's metadata; returns self.  ``executor`` (and
        every format's ``detect_params(path, executor)``) is accepted
        as in the JAX package and not used: the port reads in the
        calling process."""
        raise NotImplementedError()

    def get_task_comm_handler(self):
        """The comm handler of this dataset's partitions: a file-backed
        dataset streams no messages."""
        from ...executor.base import NoopCommHandler
        return NoopCommHandler()

    @property
    def meta(self) -> DataSetMeta:
        if self._meta is None:
            raise DataSetException("dataset not initialized")
        return self._meta

    @property
    def shape(self) -> Shape:
        return self.meta.shape

    @property
    def dtype(self) -> np.dtype:
        return self.meta.raw_dtype

    @property
    def raw_dtype(self) -> np.dtype:
        return self.meta.raw_dtype

    @property
    def roi(self) -> RoiHelper:
        """Boolean rois by indexing nav space: ``ds.roi[0:10]``."""
        return RoiHelper(self)

    def check_valid(self) -> bool:
        return True

    def supports_correction(self) -> bool:
        return True

    def get_diagnostics(self) -> list:
        """Format-specific ``{"name": ..., "value": ...}`` rows."""
        return []

    @property
    def diagnostics(self) -> list:
        """The format's diagnostics, then the partition layout and the
        sync offset's alignment."""
        try:
            p_shape = str(next(self.get_partitions()).shape)
            n_part = str(self.get_num_partitions())
        except Exception:
            p_shape, n_part = "n/a", "n/a"
        so = self.get_sync_offset_info()
        return self.get_diagnostics() + [
            {"name": "Partition shape", "value": p_shape},
            {"name": "Number of partitions", "value": n_part},
            {"name": "Number of frames skipped at the beginning",
             "value": so["frames_skipped_start"]},
            {"name": "Number of frames ignored at the end",
             "value": so["frames_ignored_end"]},
            {"name": "Number of blank frames inserted at the beginning",
             "value": so["frames_inserted_start"]},
            {"name": "Number of blank frames inserted at the end",
             "value": so["frames_inserted_end"]},
        ]

    def get_sync_offset_info(self) -> dict:
        """Frames of the data skipped or ignored, and blank frames
        inserted, under the sync offset."""
        so = self.meta.sync_offset
        image_count = self.meta.image_count or 0
        nav = self.meta.shape.nav.size
        return {
            "frames_skipped_start": max(0, so),
            "frames_ignored_end": max(0, image_count - nav - so),
            "frames_inserted_start": max(0, -so),
            "frames_inserted_end": max(0, nav - image_count + so),
        }

    def get_num_partitions(self) -> int:
        """At least ``set_num_cores`` partitions, each at most
        MAX_PARTITION_SIZE bytes, unless the caller fixed the count."""
        if self._num_partitions is not None:
            n = max(1, self._num_partitions)
        else:
            total = self.meta.shape.size * self.meta.raw_dtype.itemsize
            n = max(self._cores, -(-total // MAX_PARTITION_SIZE))
        return min(n, max(1, self.meta.shape.nav.size))

    def get_partition_ranges(self) -> list[tuple[int, int]]:
        n_frames = self.meta.shape.nav.size
        bounds = np.linspace(
            0, n_frames, self.get_num_partitions() + 1
        ).astype(np.int64)
        return [
            (int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
            if b > a
        ]

    def get_partitions(self) -> Iterator[Partition]:
        raise NotImplementedError()

    def get_slices(self) -> list[Slice]:
        return [p.slice for p in self.get_partitions()]

    def get_correction_data(self):
        """Corrections the dataset carries itself (none here)."""
        from ..corrections import CorrectionSet
        return CorrectionSet()

    def get_max_io_size(self) -> Optional[int]:
        """The most bytes of frames a block may hold for this dataset
        (None: no cap of its own); the tiling caps its depth by it."""
        return None

    def adjust_tileshape(self, tileshape, roi):
        """The dataset's say on a run's ``(depth, *sig tile)``: kept."""
        return tileshape

    @classmethod
    def get_default_io_backend(cls) -> str:
        """The id of the io backend a file format reads through when
        none is given: ``buffered`` (``preadv``)."""
        return BufferedBackend.id_

    @classmethod
    def get_supported_io_backends(cls) -> list:
        """Ids of the io backends a file format reads through."""
        return list(IOBackend.registry)

    @classmethod
    def get_supported_extensions(cls) -> set:
        return set()

    @classmethod
    def get_msg_converter(cls):
        """The GUI parameter schema class of this format
        (``io/dataset/converters.py``), None for a class without
        one."""
        from .converters import CLASS_CONVERTERS
        return CLASS_CONVERTERS.get(cls.__name__)

    @classmethod
    def detect_params(cls, path: str, executor=None):
        """The loader's arguments for the file at ``path`` if it is of
        this format, else False (``io.dataset.detect``)."""
        return False

    def __repr__(self):
        if self._meta is None:
            return f"<{type(self).__name__} (uninitialized)>"
        return f"<{type(self).__name__} shape={self.shape}>"


# -- io backends ---------------------------------------------------------


class IOBackend:
    """A read strategy for :class:`RangeReader`, by id: ``buffered``
    (``preadv``, the default), ``mmap`` or ``direct`` (``O_DIRECT``)."""

    registry: dict = {}
    id_: str = "base"

    def __init_subclass__(cls, id_=None, **kw):
        super().__init_subclass__(**kw)
        if id_ is not None:
            cls.id_ = id_
            IOBackend.registry[id_] = cls

    @classmethod
    def from_json(cls, data: dict) -> "IOBackend":
        kind = data.get("id", "buffered")
        kwargs = {k: v for k, v in data.items() if k != "id"}
        return cls.registry[kind](**kwargs)

    @classmethod
    def get_supported(cls) -> list:
        return list(cls.registry)


class MMapBackend(IOBackend, id_="mmap"):
    def __init__(self, enable_readahead_hints: bool = False):
        self.enable_readahead_hints = enable_readahead_hints


class BufferedBackend(IOBackend, id_="buffered"):
    def __init__(self, max_buffer_size: int = 16 * 1024 * 1024):
        self.max_buffer_size = max_buffer_size


class DirectBackend(IOBackend, id_="direct"):
    def __init__(self, max_buffer_size: int = 16 * 1024 * 1024):
        self.max_buffer_size = max_buffer_size


class RangeReader:
    """Reads byte ranges of one file into a destination buffer (the
    host feed's pinned slot), by the backend's ``strategy``:

    - ``buffered`` (no backend, or BufferedBackend): ``preadv`` straight
      into the destination, in calls of at most ``max_buffer_size``;
    - ``mmap``: a copy out of a read-only mapping of the file
      (``MADV_WILLNEED`` with ``enable_readahead_hints``);
    - ``direct``: the file opened with ``O_DIRECT``, which needs the
      file offset, the length and the destination address aligned to
      4096 bytes.  An aligned range is read straight into the
      destination; any other through an aligned bounce buffer, of which
      the range's part is copied.  Where the file system refuses
      ``O_DIRECT``, the file is opened without it and read as
      ``buffered``; ``direct_opened`` says which of the two happened
      (None before the first read).

    An IOBackend of another class raises RuntimeError: this reader has
    no implementation of it.
    """

    ALIGN = 4096

    def __init__(self, path: str, io_backend: Optional[IOBackend] = None):
        self._path = path
        self._mmap = None
        self._fd = None
        self._bounce = None
        self._lock = threading.Lock()
        self._max_read_bytes = 1 << 62
        self._readahead = False
        self.direct_opened: Optional[bool] = None
        if isinstance(io_backend, DirectBackend):
            self.strategy = "direct"
        elif isinstance(io_backend, MMapBackend):
            self.strategy = "mmap"
            self._readahead = bool(io_backend.enable_readahead_hints)
        elif io_backend is None or isinstance(io_backend, BufferedBackend):
            self.strategy = "buffered"
        else:
            raise RuntimeError(
                f"io_backend {type(io_backend).__name__!r} has no reader "
                "implementation in this framework"
            )
        if isinstance(io_backend, (BufferedBackend, DirectBackend)):
            mbs = int(io_backend.max_buffer_size or 0)
            if mbs >= self.ALIGN:
                self._max_read_bytes = mbs // self.ALIGN * self.ALIGN

    def read(self, start_byte: int, nbytes: int) -> np.ndarray:
        """``nbytes`` bytes from ``start_byte`` as a new uint8 array."""
        out = np.empty(nbytes, dtype=np.uint8)
        self.read_into(start_byte, out)
        return out

    def read_into(self, start_byte: int, out: np.ndarray) -> None:
        """Fill the C-contiguous array ``out`` with the file's bytes from
        ``start_byte``; a read that ends before ``out`` is full raises
        IOError."""
        if not out.flags.c_contiguous:
            raise ValueError("read destination must be C-contiguous")
        dest = out.reshape(-1).view(np.uint8)
        if self.strategy == "mmap":
            src = self._mapping()[start_byte:start_byte + len(dest)]
            if len(src) < len(dest):
                raise IOError(
                    f"short read: {len(src)} of {len(dest)} bytes at "
                    f"offset {start_byte} ({self._path})"
                )
            dest[:] = src
            return
        fd = self._open()
        if not self.direct_opened:
            self._pread(fd, dest, start_byte)
            return
        a = self.ALIGN
        if (start_byte % a == 0 and len(dest) % a == 0
                and dest.ctypes.data % a == 0):
            self._pread(fd, dest, start_byte)
            return
        # unaligned: aligned chunks through the bounce buffer
        end = start_byte + len(dest)
        pos = start_byte // a * a
        with self._lock:
            bounce = self._bounce_buffer(
                min(-(-end // a) * a - pos, self._max_read_bytes))
            while pos < end:
                want = min(len(bounce), -(-(end - pos) // a) * a)
                got = self._pread(fd, bounce[:want], pos, partial=True)
                lo, hi = max(pos, start_byte), min(pos + got, end)
                if hi > lo:
                    dest[lo - start_byte:hi - start_byte] = \
                        bounce[lo - pos:hi - pos]
                if pos + got < min(pos + want, end):
                    raise IOError(
                        f"short read: the file ends before byte {end} "
                        f"({self._path})")
                pos += want

    def _mapping(self) -> np.ndarray:
        with self._lock:
            if self._mmap is None:
                import mmap
                with open(self._path, "rb") as f:
                    mapping = mmap.mmap(f.fileno(), 0,
                                        access=mmap.ACCESS_READ)
                if self._readahead:
                    mapping.madvise(mmap.MADV_WILLNEED)
                self._mmap = np.frombuffer(mapping, dtype=np.uint8)
            return self._mmap

    def _open(self) -> int:
        with self._lock:
            if self._fd is None:
                fd = None
                if self.strategy == "direct":
                    try:
                        fd = os.open(self._path, os.O_RDONLY | os.O_DIRECT)
                    except OSError:
                        fd = None
                    self.direct_opened = fd is not None
                if fd is None:
                    fd = os.open(self._path, os.O_RDONLY)
                self._fd = fd
            return self._fd

    def _bounce_buffer(self, nbytes: int) -> np.ndarray:
        """An ALIGN-aligned uint8 buffer of ``nbytes``, kept for the next
        unaligned read."""
        if self._bounce is None or len(self._bounce) < nbytes:
            raw = np.empty(nbytes + self.ALIGN, dtype=np.uint8)
            shift = (-raw.ctypes.data) % self.ALIGN
            self._bounce = raw[shift:shift + nbytes]
        return self._bounce[:nbytes]

    def _pread(self, fd: int, dest: np.ndarray, offset: int,
               partial: bool = False) -> int:
        """``preadv`` into ``dest`` in calls of at most the backend's
        size (one call is capped near 2 GiB by the kernel and may
        return early); with ``partial``, the end of the file ends the
        read early, else it raises IOError."""
        view = memoryview(dest)
        got = 0
        while got < len(view):
            n = os.preadv(fd, [view[got:got + self._max_read_bytes]],
                          offset + got)
            if n <= 0:
                if partial:
                    break
                raise IOError(
                    f"short read: {got} of {len(view)} bytes at offset "
                    f"{offset} ({self._path})"
                )
            got += n
        return got

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        self._mmap = None

    def __del__(self):
        # partitions are made anew per run, each with its readers
        try:
            self.close()
        except Exception:
            pass
