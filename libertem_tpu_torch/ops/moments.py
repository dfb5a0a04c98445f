"""Fused moments + mask projection (counterpart of
``libertem_tpu/ops/moments.py``).

In a single pass over a ``(depth, pixels)`` block of frames:

  * ``y = x @ masks_t.T``   per-frame mask projections, (depth, M)
  * ``colsum = sum_d x``    per-pixel first moment, (pixels,)
  * ``colvar``              per-pixel centred second moment over the
                            first ``valid_count`` rows, (pixels,)

This one read of each block replaces a pass per UDF (ApplyMasks, CoM,
SumSig, Sum, StdDev).  On a CUDA tensor :func:`fused_moments` launches
the hand-written kernel in ``csrc/fused_moments.cuh`` (built as
``fused_moments.cu`` and ``fused_moments_wide.cu``; the port of the
TPU kernel ``_fused_moments_pallas``, libertem_tpu/ops/moments.py:135);
on a CPU tensor it runs :func:`fused_moments_reference`, the plain
PyTorch version (counterpart of ``_fused_moments_xla``).

Contract, as in the JAX package: rows >= ``valid_count`` are zero on
input (the host feed zero-pads tails), so ``y`` and ``colsum`` need no
row mask; only the variance masks them.  ``compute_var=False`` returns
a zero ``colvar``.

The kernel takes any mask count in one partials launch (``launches``
counts those, one a call) and one combine launch follows.  Its
product runs on the tensor cores in TF32 at the precision the caller
asks for (``precision``; by default :func:`_matmul_precision`, from
``LIBERTEM_TPU_TORCH_MATMUL_PRECISION``, which the UDF runner reads
once a run): ``"highest"`` as 3xTF32 (each operand split into a TF32
hi and lo, up to three passes, a pass skipped where the data needs
none), about as exact as a float32 product; ``"default"`` as one pass
on the operands rounded to TF32, within 2^-9 of ``|x| @ |m|``, and
bit for bit the ``"highest"`` result where the data needs no lo pass
(counts below 2^11, 0/1 masks).  The plain version on a CPU tensor
ignores the precision, as XLA on the CPU does.  The kernel takes any
real input dtype of 1 to 8 bytes (u8 .. u64, i8 .. i64, f16, bf16,
f32, f64), cast to float32 once.  :func:`plan_grid` picks the
partials' CTA tile from the block, the mask count and the card's SM
count.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from . import build

# pixels a CTA may cover, the pixels of one sub-tile of its ring
# (SUB_PX in the source: a 32-pixel unit for each of 4 warps), the rows
# of an MMA tile and, at most, of a CTA
CHUNK_CHOICES = (1024, 512, 256)
SUB_PX = 128
TILE_ROWS = 16
MAX_ROWS = 128
# rows a CTA may cover, most first, and the CTAs an SM the plan aims
# at: measured on the H100 (chip_smoke.py's grid sweep), the main
# path's block runs fastest with the most rows the mask count allows
# (128 x 512 pixels at M = 6, 32 x 1024 at M = 40, 1.9 and 3.9 CTAs an
# SM), and 16-row CTAs lose by a third or more
ROW_CHOICES = (128, 64, 48, 32, 16)
TARGET_CTAS_PER_SM = 1.5
H100_SMS = 132
# shared memory a CTA may ask for on the H100, and what each of two
# CTAs on one SM may ask for (228 KB an SM, 1 KB of it kept a CTA)
SMEM_LIMIT = 232448
TWO_CTAS_SMEM = 233472 // 2 - 1024
_SMS: dict = {}
# TF32 passes of the kernel's product at each precision: the passes the
# data needs (three at most), or x_hi m_hi alone
PASSES = {"highest": 3, "default": 1}
# the library of each input dtype's entry point: the 1- and 2-byte types
# in csrc/fused_moments.cu, the 4- and 8-byte ones in
# csrc/fused_moments_wide.cu (two sources, so nvcc builds them at once)
LIBRARIES = ("fused_moments", "fused_moments_wide")
_DTYPE_CODES = {
    torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
    torch.int32: 4, torch.uint32: 5, torch.float32: 6, torch.float64: 7,
    torch.int64: 8, torch.uint64: 9, torch.float16: 10, torch.bfloat16: 11,
}


def n_tiles(n_masks: int) -> int:
    """The n-tiles of 8 masks a CTA accumulates at once (NT in the
    source): 1, 2, 4, 8 or 16; above 128 masks the CTA walks its block
    again for each further 128."""
    nt = -(-n_masks // 8)
    return next(c for c in (1, 2, 4, 8, 16) if nt <= c or c == 16)


def max_rows(n_masks: int) -> int:
    """The most rows a CTA takes with ``n_masks`` masks: what the
    accumulators of every row and mask leave room for in the
    registers (128 up to 8 masks, 64 up to 32, 32 up to 64, 16
    beyond)."""
    nt = n_tiles(n_masks)
    return 128 if nt == 1 else 64 if nt <= 4 else 32 if nt == 8 else 16


def smem_bytes(itemsize: int, n_masks: int, rows: int) -> int:
    """Dynamic shared memory of a partials CTA (``smem_bytes`` in the
    source): a ring of 3 slots (2 for 8-byte input, one n-tile or 16),
    each
    ``rows`` x 128 pixels of x and the block's mask rows (a multiple of
    8) x 128 float32, every row padded; the 4 warps' accumulators of a
    mask block share the ring unless x is walked more than once."""
    nt = n_tiles(n_masks)
    stride = SUB_PX * itemsize + {1: 32, 2: 64}.get(itemsize, 16)
    mrows = -(-min(n_masks, nt * 8) // 8) * 8
    stages = 2 if itemsize == 8 or nt in (1, 16) else 3
    ring = stages * (rows * stride + mrows * (SUB_PX * 4 + 16))
    red = 4 * rows * mrows * 4
    return ring + red if n_masks > nt * 8 else max(ring, red)


def _matmul_precision() -> str:
    """The fused product's precision, ``"highest"`` (the default) or
    ``"default"`` (one TF32 pass), from
    ``LIBERTEM_TPU_TORCH_MATMUL_PRECISION`` (counterpart of the JAX
    package's ``LIBERTEM_TPU_MATMUL_PRECISION``, which does not steer
    the port).  The UDF runner reads it once a run, in ``_prepare``,
    so a change takes effect at the next run."""
    v = os.environ.get("LIBERTEM_TPU_TORCH_MATMUL_PRECISION", "highest")
    return "default" if v.lower() == "default" else "highest"


def tf32_round(t):
    """``t`` in float32 rounded to TF32 (10 mantissa bits, to nearest,
    ties away from zero): the kernel's hi operand."""
    f = t.to(torch.float32).contiguous()
    return ((f.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_passes(x, masks_t) -> int:
    """Tensor-core passes the product of these inputs needs at the
    precision ``"highest"``: x_hi m_hi, and x_hi m_lo, x_lo m_hi where
    any lo of the masks or of x is not zero (the kernel skips a pass
    whose lo fragment is zero across a warp, so this is what the data
    asks for at most)."""
    def has_lo(t):
        return bool(torch.any(t.to(torch.float32) != tf32_round(t)))

    return 1 + has_lo(masks_t) + has_lo(x)


def fused_moments_reference(x, masks_t, valid_count: int,
                            compute_var: bool = True):
    """Plain PyTorch version: two-pass variance over the whole block.
    Computes in float32, like the kernel; a float32 product on the card
    must run without TF32 (the caller's
    ``torch.backends.cuda.matmul.allow_tf32`` stays False)."""
    xt = x.to(torch.float32)
    y = xt @ masks_t.T
    colsum = xt.sum(dim=0)
    if compute_var:
        row_valid = (
            torch.arange(xt.shape[0], device=xt.device) < valid_count
        ).to(torch.float32)[:, None]
        mean = colsum / max(int(valid_count), 1)
        diff = (xt - mean) * row_valid
        colvar = (diff * diff).sum(dim=0)
    else:
        colvar = torch.zeros_like(colsum)
    return y, colsum, colvar


class Grid(NamedTuple):
    """The kernel's tiling of a ``(depth, pixels)`` block: CTAs of
    ``rows`` rows x ``chunk`` pixels on an ``(n_pc, n_rc)`` grid."""

    rows: int
    n_pc: int
    n_rc: int
    chunk: int

    @property
    def ctas(self) -> int:
        return self.n_pc * self.n_rc

    def scratch_floats(self, depth: int, pixels: int, n_masks: int) -> int:
        """Floats of partials a call writes: y's ``(n_pc, depth, M)``
        padded to 64 floats, then sum, shift, mean and m2 of each row
        chunk of each pixel."""
        ypart = -(-self.n_pc * depth * n_masks // 64) * 64
        return ypart + 4 * self.n_rc * pixels


def partial_bytes(grid: Grid, depth: int, pixels: int, n_masks: int) -> int:
    """Bytes of partials a call writes (and the combine reads back):
    y's (n_pc, depth, M) and four floats a pixel of each row chunk."""
    return 4 * (grid.n_pc * depth * n_masks + 4 * grid.n_rc * pixels)


def tile_cost(grid: Grid, depth: int, pixels: int, n_masks: int,
              itemsize: int, sm_count: int) -> float:
    """What a tile is planned by: the bytes a call moves (x, and the
    partials written and read back) over the share of the SMs its
    CTAs keep busy, ``ctas / (waves * sm_count)`` with ``waves`` the
    CTAs an SM takes in turn.  Measured on the H100 (chip_smoke.py's
    grid sweep), the tile it picks is the fastest of the main path's
    block at M = 6 and 40, within 1% of it on the compacted sparse
    stack and within 6% on the corrected float32 block."""
    waves = -(-grid.ctas // sm_count)
    busy = grid.ctas / (waves * sm_count)
    moved = depth * pixels * itemsize + partial_bytes(grid, depth, pixels,
                                                      n_masks)
    return moved / busy


def plan_grid(depth: int, pixels: int, sm_count: int = H100_SMS,
              n_masks: int = 1, itemsize: int = 2) -> Grid:
    """The partials' CTA tile of a block of ``itemsize``-byte input with
    ``n_masks`` masks on a card with ``sm_count`` SMs.  The tiles: a
    chunk of ``CHUNK_CHOICES`` pixels by ``ROW_CHOICES`` rows, at most
    ``max_rows(n_masks)``, whose shared memory lets two CTAs share an
    SM (16 rows always qualify).  Of those that give the grid
    ``TARGET_CTAS_PER_SM`` CTAs an SM (all of them if none does), the
    one of least :func:`tile_cost` (ties: more rows, then wider
    chunks).  More CTAs put more warps on each SM to hide the product
    and the moments under the loads, and leave a smaller last wave;
    each writes partials, which the combine reads back."""
    tiles = []
    for chunk in CHUNK_CHOICES:
        n_pc = -(-pixels // chunk)
        for rows in ROW_CHOICES:
            if rows > max_rows(n_masks) or (
                    rows > TILE_ROWS and smem_bytes(
                        itemsize, n_masks, rows) > TWO_CTAS_SMEM):
                continue
            tiles.append(Grid(rows, n_pc, -(-depth // rows), chunk))
    reach = [g for g in tiles if g.ctas >= TARGET_CTAS_PER_SM * sm_count]
    return min(reach or tiles, key=lambda g: (
        tile_cost(g, depth, pixels, n_masks, itemsize, sm_count), -g.rows,
        -g.chunk))


def _sm_count(device) -> int:
    count = _SMS.get(device)
    if count is None:
        count = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = count
    return count


def grid_for(x, n_masks: int = 1) -> Grid:
    """The plan the kernel runs ``x`` with ``n_masks`` masks: its
    device's SM count on a CUDA tensor, the H100's on the CPU (where
    the plain versions that follow the tiling run)."""
    sms = _sm_count(x.device) if x.device.type == "cuda" else H100_SMS
    return plan_grid(x.shape[0], x.shape[1], sms, n_masks, x.element_size())


def _library(name: str = LIBRARIES[0]):
    """The loaded entry points of ``csrc/<name>.cu``, built if
    needed."""
    lib = build.load(name)
    fn = lib.fused_moments_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 8
            + [ctypes.c_void_p] * 5
        )
        fn.restype = ctypes.c_int
        lib.fused_moments_error_string.argtypes = [ctypes.c_int]
        lib.fused_moments_error_string.restype = ctypes.c_char_p
        lib.fused_moments_scratch_floats.argtypes = [ctypes.c_int] * 5
        lib.fused_moments_scratch_floats.restype = ctypes.c_long
        lib.fused_moments_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.fused_moments_smem_bytes.restype = ctypes.c_long
    return lib


def check_inputs(x, masks_t, valid_count, dtypes=_DTYPE_CODES) -> int:
    """Raise on what the CUDA kernel does not take (``dtypes``: the
    input dtypes it takes); returns ``valid_count`` as an int."""
    if x.dim() != 2 or masks_t.dim() != 2:
        raise ValueError("x must be (depth, pixels), masks_t (M, pixels)")
    depth, pixels = x.shape
    n_masks = masks_t.shape[0]
    if x.dtype not in dtypes:
        raise TypeError(f"the CUDA kernel does not take {x.dtype} input")
    if masks_t.dtype != torch.float32 or masks_t.shape[1] != pixels:
        raise ValueError(
            f"masks_t must be float32 of shape (M, {pixels}), got "
            f"{masks_t.dtype} {tuple(masks_t.shape)}"
        )
    if n_masks < 1:
        raise ValueError(f"the CUDA kernel needs a mask row, got {n_masks}")
    if masks_t.device != x.device:
        raise ValueError("x and masks_t must be on the same device")
    if not (x.is_contiguous() and masks_t.is_contiguous()):
        raise ValueError("x and masks_t must be contiguous")
    valid_count = int(valid_count)
    if not 0 <= valid_count <= depth:
        raise ValueError(f"valid_count {valid_count} not in [0, {depth}]")
    if depth == 0 or pixels == 0:
        raise ValueError(f"empty block {tuple(x.shape)}")
    return valid_count


def _fused_moments_cuda(x, masks_t, valid_count, compute_var, grid=None,
                        passes=3):
    valid_count = check_inputs(x, masks_t, valid_count)
    depth, pixels = x.shape
    n_masks = masks_t.shape[0]
    grid = grid or grid_for(x, n_masks)
    y = torch.empty((depth, n_masks), dtype=torch.float32, device=x.device)
    colsum = torch.empty(pixels, dtype=torch.float32, device=x.device)
    colvar = torch.empty(pixels, dtype=torch.float32, device=x.device)
    lib = _library(LIBRARIES[x.element_size() > 2])
    scratch = torch.empty(grid.scratch_floats(depth, pixels, n_masks),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_moments_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), masks_t.data_ptr(),
            depth, pixels, n_masks, grid.rows, grid.chunk, valid_count,
            int(bool(compute_var)), passes, scratch.data_ptr(), y.data_ptr(),
            colsum.data_ptr(), colvar.data_ptr(), stream,
        )
    if code != 0:
        msg = lib.fused_moments_error_string(code).decode()
        raise RuntimeError(f"fused_moments kernel launch failed: {msg}")
    fused_moments.launches += 1
    return y, colsum, colvar


def fused_moments(x, masks_t, valid_count: int,
                  compute_var: bool = True, precision=None):
    """``(y, colsum, colvar)`` of a ``(depth, pixels)`` block; see the
    module docstring.  ``x`` of any real dtype, ``masks_t`` (M, pixels)
    float32 on the same device, ``valid_count`` a Python int,
    ``precision`` ``"highest"`` or ``"default"`` (None: read from the
    environment now, :func:`_matmul_precision`)."""
    if precision is None:
        precision = _matmul_precision()
    if precision not in PASSES:
        raise ValueError(f"precision must be one of {sorted(PASSES)}, "
                         f"got {precision!r}")
    if x.device.type == "cpu":
        return fused_moments_reference(x, masks_t, valid_count,
                                       compute_var)
    return _fused_moments_cuda(x, masks_t, valid_count, compute_var,
                               passes=PASSES[precision])


# partials launches so far, one a call for any mask count (each call
# adds one combine launch); a run reads it to show it went through the
# kernel
fused_moments.launches = 0
