"""Block-compacted sparse mask stacks (counterpart of
``libertem_tpu/ops/sparse_masks.py``).

A mask stack whose union support is small (tiny-template stacks,
point selectors, small virtual apertures) touches few pixels of the
frame.  Block compaction drops every ``BLOCK``-pixel block of the
flattened frame that is zero across the whole stack, gathers the
surviving blocks of each frame, and projects the gathered
``(depth, S * BLOCK)`` operand on the compacted stack.  Dropped
columns contribute exactly zero, so the result is the dense one.

The plan (:func:`plan_compaction`) is host numpy, equal bit for bit to
the JAX package's; the gather (:func:`gather_blocks`) is one torch
index gather on the run's device.  ``BLOCK = 128``: 256 bytes of a u16
row per block on the H100, a whole number of 32-byte sectors.

Whether a run uses a plan depends on where the product runs and on
which product it is (:func:`compaction_pays`).  On the CPU the plain
product costs in proportion to the pixels, as XLA's dot does on the
TPU, so the plan's own fill limit holds.  On a CUDA card the gather is
a pass of its own, and ``chip_smoke.py`` phase 7a times the gather
plus the product on the gathered block against the product on the
whole frame at several fills; ``CUDA_MAX_FILL`` holds, per product,
the largest fill up to which the compacted side won at every mask
count measured there.  The fused-moments kernel on a gathered block
runs a grid planned for the block's narrow width (16-row CTAs), and
compaction won for it up to a fill of 4 of 128 blocks (at 16 it lost
at one mask row); the float32 matmul of ApplyMasks' generic path
reads fewer bytes compacted and won up to a fill of 16 of 128 blocks.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 128
# the largest fill at which a run on a CUDA card uses a plan, by the
# product on the gathered block (see the module docstring)
CUDA_MAX_FILL = {"fused_moments": 4 / 128, "matmul": 16 / 128}


def _to_blocks(arr, block, pad_fn):
    """(rows, pixels) -> (rows, n_blocks, block): pad the pixel axis
    to a block multiple (via ``pad_fn(arr, pad)``) and reshape."""
    rows, p = arr.shape
    nb = -(-p // block)
    pad = nb * block - p
    if pad:
        arr = pad_fn(arr, pad)
    return arr.reshape(rows, nb, block), nb


def _np_pad(arr, pad):
    return np.concatenate(
        [arr, np.zeros((arr.shape[0], pad), dtype=arr.dtype)], axis=1
    )


def block_support(stack_flat: np.ndarray, block: int = BLOCK):
    """Indices of pixel blocks where any mask is nonzero.

    stack_flat: (n_masks, pixels) host array.
    Returns (support_idx (S,) int32, n_blocks); the tail block counts
    its existing pixels only.
    """
    blocks, nb = _to_blocks(np.abs(stack_flat), block, _np_pad)
    per_block = blocks.sum(axis=(0, 2))
    support = np.flatnonzero(per_block != 0).astype(np.int32)
    if support.size == 0:
        support = np.zeros(1, dtype=np.int32)
    return support, nb


def compact_operand(
    stack_flat: np.ndarray, support: np.ndarray, block: int = BLOCK,
) -> np.ndarray:
    """(n_masks, pixels) -> (S*block, n_masks) operand restricted to
    the support blocks (transposed, ready for ``gathered @ operand``)."""
    blocks, _ = _to_blocks(stack_flat, block, _np_pad)
    sel = blocks[:, support, :]
    m = stack_flat.shape[0]
    return np.ascontiguousarray(sel.reshape(m, -1).T)


_SAME_WIDTH_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}


def gather_blocks(flat_tile: torch.Tensor, support, block: int = BLOCK):
    """(depth, pixels) -> (depth, S*block): the support blocks of each
    row, zeros past the last pixel, in one index gather on the tile's
    device.  The gather moves bits only, so it runs on the signed
    integer view of the tile's width (PyTorch implements no gather for
    some unsigned types)."""
    d, p = flat_tile.shape
    if not isinstance(support, torch.Tensor):
        support = torch.from_numpy(np.asarray(support))
    support = support.to(device=flat_tile.device, dtype=torch.long)
    nb = -(-p // block)
    bits = flat_tile
    if not flat_tile.is_complex():
        bits = flat_tile.view(_SAME_WIDTH_INT[flat_tile.element_size()])
    if p == nb * block:
        out = bits.reshape(d, nb, block).index_select(1, support)
        out = out.reshape(d, -1)
    else:
        cols = (support[:, None] * block
                + torch.arange(block, device=flat_tile.device)).reshape(-1)
        out = bits.index_select(1, cols.clamp(max=p - 1))
        out = out.masked_fill((cols >= p)[None, :], 0)
    return out if out.dtype == flat_tile.dtype else out.view(flat_tile.dtype)


def plan_compaction(stack_flat: np.ndarray, block: int = BLOCK,
                    max_fill: float = 0.5):
    """None when compaction does not pay (union support > max_fill of
    the frame), else a dict with the support indices and the compacted
    (S*block, n_masks) operand."""
    support, nb = block_support(stack_flat, block)
    if support.size > max_fill * nb:
        return None
    return {
        "support": support,
        "n_blocks": nb,
        "block": block,
        "operand_c": compact_operand(stack_flat, support, block),
        "fill": support.size / nb,
    }


def compaction_pays(plan, device, product: str) -> bool:
    """Whether a run on ``device`` uses ``plan`` (a
    :func:`plan_compaction` result, or None) before ``product``
    ("fused_moments" or "matmul")."""
    if plan is None:
        return False
    return (torch.device(device).type != "cuda"
            or plan["fill"] <= CUDA_MAX_FILL[product])
