"""RAW binary dataset: plain uncompressed frames on disk (counterpart
of ``libertem_tpu/io/dataset/raw.py``).

Frames are read through a :class:`RangeReader` straight into the
destination the host feed hands out (a pinned staging buffer on the
CUDA path), so a block costs one copy from the page cache (none with
``O_DIRECT``) and one DMA to the card.  Big-endian (non-native) data
is swapped in place in that buffer right after the read, on the host
(the C++ byteswap of ``ops/decode.py``).
"""
from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.math import prod
from ...common.shape import Shape
from .converters import (  # noqa: F401  (the JAX module's names)
    RawDatasetParams, RawDatasetParams as RAWDatasetParams,
)
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    IOBackend,
    Partition,
    RangeReader,
    byteswap,
)


class RawPartition(Partition):
    def __init__(self, path, dtype, sig_shape, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._dtype = np.dtype(dtype)
        self._frame_bytes = prod(sig_shape) * self._dtype.itemsize
        self._reader = RangeReader(path, self.io_backend)

    def _read_raw_frames(self, start, stop, out):
        self._reader.read_into(start * self._frame_bytes, out)
        byteswap(out, self._dtype)


class RawFileDataSet(DataSet):
    """``dtype`` may be of either byte order (``">u2"``); without
    ``nav_shape`` the nav is 1-D, as many frames as the file holds.
    Bytes past the last whole frame are ignored; frames of nav past the
    end of the file (or the sync offset) read as zeros.

    ``scan_size``, ``detector_size``, ``tileshape``, ``enable_direct``,
    ``detector_size_raw`` and ``crop_detector_to`` are the deprecated
    spellings the JAX package takes, with its warnings and errors."""

    def __init__(
        self,
        path: str,
        dtype,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        scan_size=None,
        detector_size=None,
        tileshape=None,
        enable_direct: bool = False,
        detector_size_raw=None,
        crop_detector_to=None,
        io_backend: Optional[IOBackend] = None,
        num_partitions: Optional[int] = None,
    ):
        if scan_size is not None:
            warnings.warn("scan_size is deprecated, use nav_shape instead",
                          FutureWarning)
        if detector_size is not None:
            warnings.warn(
                "detector_size is deprecated, use sig_shape instead",
                FutureWarning)
        if tileshape is not None:
            warnings.warn("tileshape is ignored (tiling is negotiated per "
                          "run)", FutureWarning)
        if enable_direct:
            warnings.warn("enable_direct is deprecated; pass "
                          "io_backend=DirectBackend() instead",
                          FutureWarning)
            if io_backend is not None:
                raise ValueError("can't specify io_backend and "
                                 "enable_direct at the same time")
            io_backend = IOBackend.from_json({"id": "direct"})
        if detector_size_raw is not None:
            warnings.warn("detector_size_raw is deprecated, specify "
                          "sig_shape instead", FutureWarning)
        if crop_detector_to is not None:
            warnings.warn("crop_detector_to and detector_size_raw are "
                          "deprecated, specify sig_shape instead",
                          FutureWarning)
            if detector_size is not None:
                raise ValueError("cannot specify both detector_size and "
                                 "crop_detector_to")
            if (detector_size_raw is not None
                    and tuple(detector_size_raw) != tuple(crop_detector_to)):
                raise ValueError("cropping the detector is not supported; "
                                 "use the EMPAD DataSet")
            detector_size = crop_detector_to
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._dtype = np.dtype(dtype)
        self._nav_shape = tuple(int(s) for s in (nav_shape or scan_size
                                                 or ()))
        self._sig_shape = tuple(int(s) for s in (sig_shape or detector_size
                                                 or ()))
        if not self._sig_shape:
            raise TypeError(
                "__init__() missing 1 required argument: 'sig_shape'")
        self._sync_offset = int(sync_offset)

    def initialize(self, executor=None) -> "RawFileDataSet":
        filesize = os.path.getsize(self._path)
        total_items = filesize // self._dtype.itemsize
        # an empty file (an acquisition in progress) reads as zeros
        if total_items and prod(self._sig_shape) > total_items:
            raise DataSetException(
                f"sig_shape must be less than size: {total_items}")
        frame_bytes = prod(self._sig_shape) * self._dtype.itemsize
        image_count = filesize // frame_bytes
        if not self._nav_shape:
            self._nav_shape = (image_count,)
        self._meta = DataSetMeta(
            shape=Shape(self._nav_shape + self._sig_shape,
                        sig_dims=len(self._sig_shape)),
            raw_dtype=self._dtype,
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_diagnostics(self) -> list:
        return [{"name": "dtype", "value": str(self.meta.raw_dtype)}]

    def get_cache_key(self) -> dict:
        return {
            "path": self._path,
            "shape": tuple(self.shape),
            "dtype": str(self._dtype),
            "sync_offset": self._sync_offset,
        }

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"raw", "bin"}

    def get_partitions(self) -> Iterator[RawPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield RawPartition(
                self._path, self._dtype, self._sig_shape,
                self.meta, start, stop - start, idx=idx,
                io_backend=self._io_backend,
            )
