"""Tiling scheme + negotiation (counterpart of
``libertem_tpu/io/tiling.py``).

A scheme is one static block depth per run plus the sig slices of a
tile.  Blocks always hold whole frames; the sig slices only subdivide
the generic path's calls to ``process_tile`` (the fused path consumes
the whole frame).  Blocks shorter than ``depth`` (partition tails,
roi remainders) are zero-padded and carry a ``valid`` count.
"""
from __future__ import annotations

import enum
import math
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from ..common.math import prod
from ..common.shape import Shape
from ..common.slice import Slice

if TYPE_CHECKING:
    from ..udf.base import UDF


class TileDepthEnum(enum.Enum):
    TILE_DEPTH_DEFAULT = object()
    TILE_DEPTH_MAX = object()  # "whole partition" (PARTITION UDFs)


class TileSizeEnum(enum.Enum):
    TILE_SIZE_BEST_FIT = object()
    TILE_SIZE_MAX = object()


TILE_DEPTH_DEFAULT = TileDepthEnum.TILE_DEPTH_DEFAULT
TILE_DEPTH_MAX = TileDepthEnum.TILE_DEPTH_MAX
TILE_SIZE_BEST_FIT = TileSizeEnum.TILE_SIZE_BEST_FIT
TILE_SIZE_MAX = TileSizeEnum.TILE_SIZE_MAX


class TilingScheme:
    def __init__(
        self, depth: int, sig_slices: Sequence[Slice],
        dataset_shape: Shape, intent: str = "tile",
    ):
        self._depth = int(depth)
        self._sig_slices = list(sig_slices)
        self._dataset_shape = dataset_shape
        self._intent = intent  # 'tile' | 'frame' | 'partition'

    @classmethod
    def make_for_shape(
        cls, tileshape: Shape, dataset_shape: Shape, intent: str = "tile",
    ) -> "TilingScheme":
        """A scheme from a (depth, *sig_tile) shape, tiling the full
        sig space in a grid."""
        full_sig = Slice.from_shape(
            tuple(dataset_shape.sig), sig_dims=dataset_shape.sig.dims
        )
        sig_slices = list(full_sig.subslices(tuple(tileshape)[1:]))
        return cls(tuple(tileshape)[0], sig_slices, dataset_shape, intent)

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def intent(self) -> str:
        return self._intent

    @property
    def dataset_shape(self) -> Shape:
        return self._dataset_shape

    @property
    def slices(self):
        """Enumerated (idx, sig Slice) pairs."""
        return list(enumerate(self._sig_slices))

    @property
    def sig_slices(self) -> list[Slice]:
        return list(self._sig_slices)

    @property
    def shape(self) -> Shape:
        """Shape of the (largest) tile: (depth, *sig_tile)."""
        return Shape(
            (self._depth,) + tuple(self._sig_slices[0].shape),
            sig_dims=self._dataset_shape.sig.dims,
        )

    def __len__(self) -> int:
        return len(self._sig_slices)

    def __repr__(self):
        return (
            f"<TilingScheme depth={self._depth} "
            f"n_sig_slices={len(self._sig_slices)} intent={self._intent}>"
        )


class Negotiator:
    """Reconcile the UDFs' methods and tiling preferences with the
    staging budget into one static :class:`TilingScheme` per run.

    Same rules as the JAX package: about ``TARGET_BLOCK_BYTES`` of
    input-dtype data per block (less where the dataset caps a read), clamped to [8, 4096] frames unless a
    UDF asks for a depth, no deeper than the largest partition,
    rounded up to a multiple of 8; a PARTITION-method UDF gets whole
    partitions (at most 2 GB each); the frame splits into sig tiles
    only for tile-method UDFs that ask for small tiles or for frames
    over ``MAX_SIG_BYTES``.  On the H100 a block is staged in
    ``HostFeed.SLOTS`` pinned host buffers and as many device buffers
    at its RAW width (u16 detector data: 32 MiB per slot at the
    128x128 headline), a few hundred MiB of the card's 80 GB in all.
    """

    TARGET_BLOCK_BYTES = 64 * 1024 * 1024
    MAX_SIG_BYTES = 256 * 1024 * 1024  # split sig above this (per frame)

    def get_scheme(
        self,
        udfs: Sequence["UDF"],
        dataset_shape: Shape,
        read_dtype,
        max_partition_frames: Optional[int] = None,
        corrections=None,
        max_io_size: Optional[int] = None,
    ) -> TilingScheme:
        """``max_io_size``: the dataset's cap on a block's bytes
        (``DataSet.get_max_io_size``), below ``TARGET_BLOCK_BYTES``."""
        if max_partition_frames is None:
            max_partition_frames = dataset_shape.nav.size
        itemsize = np.dtype(read_dtype).itemsize
        frame_bytes = dataset_shape.sig.size * itemsize
        target_block_bytes = self.TARGET_BLOCK_BYTES
        if max_io_size is not None:
            target_block_bytes = min(target_block_bytes, int(max_io_size))

        methods = [str(u.get_method()) for u in udfs]
        prefs = [u.get_tiling_preferences() for u in udfs]

        intent = "tile"
        if "partition" in methods:
            intent = "partition"
        elif all(m == "frame" for m in methods):
            intent = "frame"

        if intent == "partition":
            depth = max(1, int(max_partition_frames))
            # whole partitions as one device block: refuse to run out
            # of device memory silently
            block_bytes = depth * frame_bytes
            if block_bytes > 2 * 1024 * 1024 * 1024:
                raise ValueError(
                    f"a PARTITION-method UDF needs whole partitions "
                    f"on the device, but the largest partition is "
                    f"{block_bytes / 1e9:.1f} GB ({depth} frames); "
                    f"increase the dataset's num_partitions (or use "
                    f"process_tile)"
                )
        else:
            depth = self._negotiate_depth(
                prefs, frame_bytes, target_block_bytes
            )
            depth = min(depth, max(1, int(max_partition_frames)))
        if depth > 8:
            depth = int(math.ceil(depth / 8) * 8)

        sig_shape = tuple(dataset_shape.sig)
        wanted_size = self._negotiate_size(prefs)
        sig_tile = sig_shape
        # FRAME/PARTITION-method UDFs get whole frames, even beside a
        # tile UDF that asks for small tiles; tile UDFs whose math needs
        # the whole frame declare `whole_frames: True`
        whole_sig_required = any(
            m in ("frame", "partition") for m in methods
        ) or any(p.get("whole_frames") for p in prefs)
        if not whole_sig_required and (
            frame_bytes > self.MAX_SIG_BYTES or (
                wanted_size is not None and wanted_size < frame_bytes
            )
        ):
            budget = (
                wanted_size if wanted_size is not None
                else self.MAX_SIG_BYTES
            )
            sig_tile = self._split_sig(sig_shape, itemsize, budget)
        elif (
            intent != "partition"
            and whole_sig_required
            and frame_bytes > self.MAX_SIG_BYTES
        ):
            # whole frames, but a shallower block so the staged block
            # still fits the budget
            depth = max(
                1, min(depth, target_block_bytes // frame_bytes or 1)
            )

        tileshape = Shape(
            (depth,) + sig_tile, sig_dims=dataset_shape.sig.dims
        )
        scheme = TilingScheme.make_for_shape(
            tileshape, dataset_shape, intent=intent
        )
        if corrections is not None and len(scheme) > 1:
            # keep excluded-pixel repair environments inside one tile
            scheme = corrections.adjust_scheme(scheme, dataset_shape)
        return scheme

    def _negotiate_depth(self, prefs, frame_bytes: int,
                         target_block_bytes: int) -> int:
        depth_default = max(1, target_block_bytes // max(1, frame_bytes))
        depth_default = int(min(4096, max(8, depth_default)))
        depths = []
        for p in prefs:
            d = p.get("depth", TILE_DEPTH_DEFAULT)
            if d is TILE_DEPTH_DEFAULT:
                continue
            depths.append(1 << 30 if d is TILE_DEPTH_MAX else int(d))
        if not depths:
            return depth_default
        # honour the smallest explicit request (all UDFs share one pass)
        return max(1, min(depths))

    def _negotiate_size(self, prefs) -> Optional[int]:
        sizes = [
            int(s) for s in (
                p.get("total_size", TILE_SIZE_MAX) for p in prefs
            )
            if s not in (TILE_SIZE_MAX, TILE_SIZE_BEST_FIT)
        ]
        return min(sizes) if sizes else None

    def _split_sig(self, sig_shape: tuple, itemsize: int,
                   budget: int) -> tuple:
        """Halve the first sig axis until a single-depth tile fits
        ``budget`` bytes (keeping the fast axes contiguous)."""
        sig = list(sig_shape)
        while prod(sig) * itemsize > budget and sig[0] > 1:
            sig[0] = (sig[0] + 1) // 2
        return tuple(sig)
