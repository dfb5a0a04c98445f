"""Tiling scheme + negotiation (counterpart of
``libertem_tpu/io/tiling.py``).

A scheme is one static block depth per run plus the sig slices of a
tile.  The fused path consumes whole frames, so the scheme this port
negotiates always holds exactly one sig slice covering the frame.
Blocks shorter than ``depth`` (partition tails) are zero-padded and
carry a ``valid`` count.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..common.shape import Shape
from ..common.slice import Slice


class TilingScheme:
    def __init__(
        self, depth: int, sig_slices: Sequence[Slice],
        dataset_shape: Shape,
    ):
        self._depth = int(depth)
        self._sig_slices = list(sig_slices)
        self._dataset_shape = dataset_shape

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def dataset_shape(self) -> Shape:
        return self._dataset_shape

    @property
    def sig_slices(self) -> list[Slice]:
        return list(self._sig_slices)

    def __repr__(self):
        return (
            f"<TilingScheme depth={self._depth} "
            f"n_sig_slices={len(self._sig_slices)}>"
        )


class Negotiator:
    """Pick the run's block depth from the staging budget.

    Same rule as the JAX package: about ``TARGET_BLOCK_BYTES`` of
    input-dtype data per block, clamped to [8, 4096] frames, no deeper
    than the largest partition, rounded up to a multiple of 8.  On the
    H100 a block is staged in ``HostFeed.SLOTS`` pinned host buffers
    and as many device buffers at its RAW width (u16 detector data:
    32 MiB per slot at the 128x128 headline), a few hundred MiB of the
    card's 80 GB in all.  The budget only has to amortize the
    per-block launch and copy overhead.
    """

    TARGET_BLOCK_BYTES = 64 * 1024 * 1024

    def get_scheme(
        self,
        dataset_shape: Shape,
        read_dtype,
        max_partition_frames: Optional[int] = None,
    ) -> TilingScheme:
        if max_partition_frames is None:
            max_partition_frames = dataset_shape.nav.size
        frame_bytes = dataset_shape.sig.size * np.dtype(read_dtype).itemsize
        depth = max(1, self.TARGET_BLOCK_BYTES // max(1, frame_bytes))
        depth = int(min(4096, max(8, depth)))
        depth = min(depth, max(1, int(max_partition_frames)))
        if depth > 8:
            depth = int(math.ceil(depth / 8) * 8)
        full_sig = Slice.from_shape(
            tuple(dataset_shape.sig), sig_dims=dataset_shape.sig.dims
        )
        return TilingScheme(depth, [full_sig], dataset_shape)
