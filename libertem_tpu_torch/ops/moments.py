"""Fused moments + mask projection (counterpart of
``libertem_tpu/ops/moments.py``).

In a single pass over a ``(depth, pixels)`` block of frames:

  * ``y = x @ masks_t.T``   per-frame mask projections, (depth, M)
  * ``colsum = sum_d x``    per-pixel first moment, (pixels,)
  * ``colvar``              per-pixel centred second moment over the
                            first ``valid_count`` rows, (pixels,)

This one read of each block replaces a pass per UDF (ApplyMasks, CoM,
SumSig, Sum, StdDev).  On a CUDA tensor :func:`fused_moments` launches
the hand-written kernel in ``csrc/fused_moments.cu`` (the port of the
TPU kernel ``_fused_moments_pallas``, libertem_tpu/ops/moments.py:135);
on a CPU tensor it runs :func:`fused_moments_reference`, the plain
PyTorch version (counterpart of ``_fused_moments_xla``).

Contract, as in the JAX package: rows >= ``valid_count`` are zero on
input (the host feed zero-pads tails), so ``y`` and ``colsum`` need no
row mask; only the variance masks them.  ``compute_var=False`` returns
a zero ``colvar``.

The kernel takes any mask count: its partials kernel runs once per
group of ``MASK_GROUP`` mask rows (``launches`` counts each of those)
and one combine launch follows; and any real input dtype of 1 to 8
bytes (u8 .. u64, i8 .. i64, f16, bf16, f32, f64), cast to float32 in
registers.  :func:`plan_grid` picks the partials' CTA tile from the
card's SM count.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

# mask rows one kernel launch projects on (MASK_GROUP in the source)
MASK_GROUP = 8
# pixels and, at most, rows of a CTA (CHUNK_PX, MAX_ROWS in the source)
CHUNK_PX = 1024
MAX_ROWS = 64
# rows a CTA may cover, most first, and the CTAs an SM the plan aims
# at: measured on the H100 (chip_smoke.py's grid sweep), 64-row CTAs
# win at 1.9 CTAs an SM (the main path's block) and lose by a third to
# 16-row ones at 0.7 (a 45-block compacted one)
ROW_CHOICES = (64, 48, 32, 16)
TARGET_CTAS_PER_SM = 1.5
H100_SMS = 132
_SMS: dict = {}
_DTYPE_CODES = {
    torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
    torch.int32: 4, torch.uint32: 5, torch.float32: 6, torch.float64: 7,
    torch.int64: 8, torch.uint64: 9, torch.float16: 10, torch.bfloat16: 11,
}


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
    ``rows`` rows x ``CHUNK_PX`` pixels on an ``(n_pc, n_rc)`` grid."""

    rows: int
    n_pc: int
    n_rc: int

    @property
    def ctas(self) -> int:
        return self.n_pc * self.n_rc

    def scratch_floats(self, depth: int, pixels: int, n_masks: int) -> int:
        """Floats of partials a call writes: y's ``(n_pc, depth, M)``
        padded to 64 floats, then sum, shift, mean and m2 of each row
        chunk of each pixel."""
        ypart = -(-self.n_pc * depth * n_masks // 64) * 64
        return ypart + 4 * self.n_rc * pixels


def plan_grid(depth: int, pixels: int, sm_count: int = H100_SMS) -> Grid:
    """The partials' CTA tile of a block on a card with ``sm_count``
    SMs: the most rows a CTA (of ``ROW_CHOICES``) that still give the
    grid ``TARGET_CTAS_PER_SM`` CTAs an SM, else the fewest.  Fewer
    rows a CTA put more warps on each SM to hide the product and the
    variance under the loads; they also write more partials, which
    the combine reads back."""
    n_pc = -(-pixels // CHUNK_PX)
    for rows in ROW_CHOICES:
        if n_pc * -(-depth // rows) >= TARGET_CTAS_PER_SM * sm_count:
            break
    return Grid(rows, n_pc, -(-depth // rows))


def _sm_count(device) -> int:
    count = _SMS.get(device)
    if count is None:
        count = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = count
    return count


def grid_for(x) -> Grid:
    """The plan the kernel runs ``x`` with: its device's SM count on a
    CUDA tensor, the H100's on the CPU (where the plain versions that
    follow the tiling run)."""
    sms = _sm_count(x.device) if x.device.type == "cuda" else H100_SMS
    return plan_grid(x.shape[0], x.shape[1], sms)


def _library():
    lib = build.load("fused_moments")
    fn = lib.fused_moments_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p] * 5
        )
        fn.restype = ctypes.c_int
        lib.fused_moments_error_string.argtypes = [ctypes.c_int]
        lib.fused_moments_error_string.restype = ctypes.c_char_p
        lib.fused_moments_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.fused_moments_scratch_floats.restype = ctypes.c_long
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


def _fused_moments_cuda(x, masks_t, valid_count, compute_var, grid=None):
    valid_count = check_inputs(x, masks_t, valid_count)
    depth, pixels = x.shape
    n_masks = masks_t.shape[0]
    grid = grid or grid_for(x)
    y = torch.empty((depth, n_masks), dtype=torch.float32, device=x.device)
    colsum = torch.empty(pixels, dtype=torch.float32, device=x.device)
    colvar = torch.empty(pixels, dtype=torch.float32, device=x.device)
    lib = _library()
    scratch = torch.empty(grid.scratch_floats(depth, pixels, n_masks),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_moments_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), masks_t.data_ptr(),
            depth, pixels, n_masks, grid.rows, valid_count,
            int(bool(compute_var)), scratch.data_ptr(), y.data_ptr(),
            colsum.data_ptr(), colvar.data_ptr(), stream,
        )
    if code != 0:
        msg = lib.fused_moments_error_string(code).decode()
        raise RuntimeError(f"fused_moments kernel launch failed: {msg}")
    fused_moments.launches += -(-n_masks // MASK_GROUP)
    return y, colsum, colvar


def fused_moments(x, masks_t, valid_count: int,
                  compute_var: bool = True):
    """``(y, colsum, colvar)`` of a ``(depth, pixels)`` block; see the
    module docstring.  ``x`` of any real dtype, ``masks_t`` (M, pixels)
    float32 on the same device, ``valid_count`` a Python int."""
    if x.device.type == "cpu":
        return fused_moments_reference(x, masks_t, valid_count,
                                       compute_var)
    return _fused_moments_cuda(x, masks_t, valid_count, compute_var)


# partials launches so far, one per mask group of each call (each call
# adds one combine launch); a run reads it to show it went through the
# kernel
fused_moments.launches = 0
