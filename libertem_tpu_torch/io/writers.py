"""Dataset export and the result download formats (counterpart of
``libertem_tpu/io/writers.py``): ``Context.export_dataset``'s
:func:`write_dataset_npy`, :class:`WriteHandle` (a partition's frames
into a RAW file, atomically) and the formats of a result set (NPZ,
compressed NPZ, HDF5 (h5py), RAW, TIFF (PIL), the libraries imported
when a file is written).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np


def write_dataset_npy(ctx, dataset, path: str, progress=False) -> None:
    """The dataset's frames into a ``.npy`` file of its full shape,
    through RecordUDF on the host engine (which writes each block from
    the pinned slot in the same read pass).  Under a process group of
    several processes the host feed is split between them (numpy UDFs
    are refused there), so each process records the whole dataset on
    its own main device with an ``InlineJobExecutor``, as the JAX
    package's multi-host branch does: processes that share a file
    system give each its own ``path``."""
    from ..common.distributed import world
    from ..udf.record import RecordUDF
    if world()[1] > 1:
        from ..api import Context
        from ..executor.inline import InlineJobExecutor
        ctx = Context(executor=InlineJobExecutor(
            device=ctx.executor.main_device))
    ctx.run_udf(dataset, RecordUDF(filename=path), progress=progress)


class WriteHandle:
    """A partition's frames into a RAW file, atomically: tiles land in
    a memmap over a temporary file beside ``path``, in partition-local
    coordinates; a clean exit renames it into place, an exception or
    :meth:`abort` unlinks it."""

    def __init__(self, path: str, tmp_base_path: str, part_slice,
                 dtype):
        self._path = path
        self._tmp_base_path = tmp_base_path
        self._slice = part_slice
        self._dtype = np.dtype(dtype)
        self._dest = None
        self._tmp_file = None
        self._aborted = False

    def __enter__(self):
        assert self._tmp_file is None
        self._tmp_file = tempfile.NamedTemporaryFile(
            prefix=os.path.basename(".tmp-%s" % self._path),
            dir=self._tmp_base_path, delete=False,
        )
        self._dest = np.memmap(
            self._tmp_file.name, dtype=self._dtype, mode="write",
            shape=tuple(self._slice.shape),
        )
        return self

    def write_tile(self, tile):
        """Write one DataTile into its partition-local slot."""
        assert self._tmp_file is not None
        dest_slice = tile.tile_slice.shift(self._slice)
        self._dest[dest_slice.get()] = tile.data

    def write_tiles(self, tiles):
        """Write all tiles, re-yielding each for further use."""
        for tile in tiles:
            self.write_tile(tile)
            yield tile

    def write_frames(self, offset: int, frames: np.ndarray):
        """Frames by their offset in the partition."""
        self._dest[offset:offset + frames.shape[0]] = frames

    def abort(self):
        self._cleanup()
        self._aborted = True

    def _cleanup(self):
        self._dest = None
        if self._tmp_file is not None:
            self._tmp_file.close()
            os.unlink(self._tmp_file.name)
            self._tmp_file = None

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None or self._aborted:
            self._cleanup()
            return False
        self._dest.flush()
        self._tmp_file.close()
        os.replace(self._tmp_file.name, self._path)
        # temporary files are made 0600: give the umask's mode, as a
        # file opened normally gets
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(self._path, 0o666 & ~umask)
        self._dest = None
        self._tmp_file = None
        return False


# -- result download formats --------------------------------------------

class ResultFormat:
    """A file format of a result set (a dict of buffers, or an
    AnalysisResultSet); subclasses register under their ``id_``."""

    registry: dict = {}

    def __init_subclass__(cls, id_=None, **kw):
        super().__init_subclass__(**kw)
        if id_ is not None:
            cls.id_ = id_
            ResultFormat.registry[id_] = cls

    @classmethod
    def get_available_formats(cls):
        return {
            id_: f.description for id_, f in cls.registry.items()
        }

    @classmethod
    def get_format_by_id(cls, id_: str):
        return cls.registry[id_]

    def serialize_to_buffer(self, fileobj):
        return self.serialize_to(fileobj)

    def get_content_type(self) -> str:
        return "application/octet-stream"

    def get_filename(self) -> str:
        return f"result.{self.extension}"

    def __init__(self, result_set):
        self._result_set = result_set

    def _iter_arrays(self):
        for k in self._result_set.keys():
            buf = self._result_set[k]
            # a channel flagged include_in_download=False (CoM's field
            # tuple) stays out of the file
            if not getattr(buf, "include_in_download", True):
                continue
            data = getattr(buf, "data", buf)
            if data is not None:
                yield k, np.asarray(data)


class NpzFormat(ResultFormat, id_="NPZ"):
    description = "numpy .npz"
    extension = "npz"

    def serialize_to(self, fileobj, compressed=False):
        arrays = dict(self._iter_arrays())
        if compressed:
            np.savez_compressed(fileobj, **arrays)
        else:
            np.savez(fileobj, **arrays)


class NpzCompressedFormat(NpzFormat, id_="NPZ_COMPRESSED"):
    description = "numpy .npz (compressed)"

    def serialize_to(self, fileobj):
        super().serialize_to(fileobj, compressed=True)


class Hdf5Format(ResultFormat, id_="HDF5"):
    description = "HDF5"
    extension = "h5"

    def serialize_to(self, fileobj):
        import h5py
        with h5py.File(fileobj, "w") as f:
            for k, arr in self._iter_arrays():
                f.create_dataset(k, data=arr)


class RawFormat(ResultFormat, id_="RAW"):
    description = "raw binary (one file per channel, concatenated)"
    extension = "bin"

    def serialize_to(self, fileobj):
        for _, arr in self._iter_arrays():
            fileobj.write(np.ascontiguousarray(arr).tobytes())


class TiffFormat(ResultFormat, id_="TIFF"):
    description = "TIFF stack (float32)"
    extension = "tif"

    def serialize_to(self, fileobj):
        from PIL import Image
        images = []
        for _, arr in self._iter_arrays():
            arr = np.asarray(arr)
            if np.iscomplexobj(arr):
                arr = np.abs(arr)
            arr2d = arr.reshape(
                (-1,) + arr.shape[-2:]
            ) if arr.ndim >= 2 else arr.reshape(1, 1, -1)
            for plane in arr2d:
                images.append(
                    Image.fromarray(plane.astype(np.float32))
                )
        if images:
            images[0].save(
                fileobj, format="TIFF", save_all=True,
                append_images=images[1:],
            )


class ResultFormatRegistry:
    """The registry's lookups by the JAX package's name; the registry
    lives on ResultFormat."""

    @classmethod
    def get_available_formats(cls):
        return ResultFormat.get_available_formats()

    @classmethod
    def get_format_by_id(cls, id_: str):
        return ResultFormat.get_format_by_id(id_)
