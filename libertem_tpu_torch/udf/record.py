"""RecordUDF: write the dataset's frames to a ``.npy`` file
(counterpart of ``libertem_tpu/udf/record.py``).

Recording is a host side effect, and the host holds every block before
it goes to the card: RecordUDF is a numpy UDF on the host engine
(``udf/host.py``), writing each block's valid frames from the pinned
host slot into a memory-mapped npy file, in the same read pass as the
device UDFs.
"""
from __future__ import annotations

import numpy as np

from .base import UDF


class RecordUDF(UDF):
    def __init__(self, filename: str, _dtype=None):
        super().__init__(filename=filename, _dtype=_dtype)
        self._mmap = None
        self._mmap_base = None

    def get_backends(self):
        return (self.BACKEND_NUMPY,)

    def on_params_updated(self):
        # a patched filename opens a new file
        if self._mmap_base is not None:
            self._mmap_base.flush()
        self._mmap = None
        self._mmap_base = None

    def get_result_buffers(self):
        return {}

    def get_tiling_preferences(self):
        # whole frames: a frame's row of the file is written at once
        return {"whole_frames": True, "depth": self.TILE_DEPTH_DEFAULT,
                "total_size": self.TILE_SIZE_MAX}

    def get_preferred_input_dtype(self):
        if self._kwargs.get("_dtype") is not None:
            return np.dtype(self._kwargs["_dtype"])
        return self.USE_NATIVE_DTYPE

    @property
    def _out_shape(self) -> tuple:
        """The dataset's shape, or with a roi (selected frames,
        *sig)."""
        if self.meta.roi is not None:
            n = int(np.count_nonzero(self.meta.roi))
            return (n,) + tuple(self.meta.dataset_shape.sig)
        return tuple(self.meta.dataset_shape)

    def _ensure_mmap(self):
        if self._mmap is None:
            self._mmap_base = np.lib.format.open_memmap(
                self.params.filename, mode="w+",
                dtype=self.meta.input_dtype, shape=self._out_shape,
            )
            # rows by the frame's roi-compressed flat nav index
            self._mmap = self._mmap_base.reshape(
                (-1,) + tuple(self.meta.dataset_shape.sig))
        return self._mmap

    def preprocess(self):
        self._ensure_mmap()

    def process_tile(self, tile):
        # the host engine's tile holds the block's valid frames, from
        # meta.global_offset on
        mm = self._ensure_mmap()
        goff = int(self.meta.global_offset)
        mm[goff:goff + len(tile)] = tile

    def postprocess(self):
        if self._mmap_base is not None:
            self._mmap_base.flush()
