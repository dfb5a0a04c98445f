"""Stage ablation of the fused-moments kernel (counterpart of the TPU
kernel ``ablated``, benchmarks/bench_kernel_ablation.py:48).

Each stage adds one piece of the production kernel
(``csrc/fused_moments.cuh``, ``moments_partials`` with a compile-time
``STAGE``), so the cost of a piece is the difference between the times
of successive stages of the code the main path runs:

  ========  =============================================  ==========
  stage     what it adds                                   JAX stage
  ========  =============================================  ==========
  load_min  the cp.async ring moves every byte of x; the   load_min
            first and last row of each row chunk (the grid
            plan's CTA rows) enter colsum
  load      the raw widen: an integer colsum per chunk     load_i32,
            (u8/u16; f32 input sums in f32)                load
  cast      to_float and the f32 colsum of the production  cast
            code
  dot       the 3xTF32 split of x and of the masks and the  dec, dot1,
            tensor-core product into y                     dot2
  var       the shifted moments with rows >= valid         var
            masked: the production partials kernel
  full      the combine: ``fused_moments`` itself          run_prod
  ========  =============================================  ==========

The JAX stages ``dec`` and ``dot2`` (the bf16 two-term split of x and
the second MXU pass) are not stages of their own here: the kernel
skips a TF32 pass whose lo operand is zero across a warp's fragment,
so the passes after the first follow the data, and ``dot`` times the
split and every pass the data needs.

:func:`fused_moments_stage` returns ``(y, colsum, colvar)`` with each
stage's contents and zeros for what the stage does not compute yet:
y from dot on, colvar from var on.  On a CUDA tensor it launches the
stage (u8, u16 or f32 input, any mask count, one partials launch a
call) and the combine; on a CPU tensor it runs
:func:`fused_moments_stage_reference`, the plain PyTorch version.

``python -m libertem_tpu_torch.ops.ablation`` times every stage on the
card at the JAX script's shape (u16, D = 1024, P = 128 x 128, M = 6,
8 distinct blocks from a numpy seed: 256 MiB, more than the 50 MB L2)
and prints one JSON line per stage.  It raises without a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import build
from .moments import (
    _DTYPE_CODES,
    check_inputs,
    fused_moments_reference,
    grid_for,
    plan_grid,
    tf32_passes,
)

STAGES = ("load_min", "load", "cast", "dot", "var", "full")
_STAGE_DTYPES = {t: _DTYPE_CODES[t]
                 for t in (torch.uint8, torch.uint16, torch.float32)}

# H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores
# and the dense TF32 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def _chunk_rows(depth: int, rows: int, last: bool, device) -> torch.Tensor:
    """The first (or last) row of every ``rows``-row chunk of a block."""
    first = torch.arange(0, depth, rows, device=device)
    return torch.clamp(first + rows - 1, max=depth - 1) if last else first


def fused_moments_stage_reference(x, masks_t, valid_count: int, stage: str):
    """Plain PyTorch version of each stage's ``(y, colsum, colvar)``,
    in float32 (integer chunk sums in int64, exact); the row chunks of
    load_min and load are the kernel's (``grid_for(x, M)``)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages are {STAGES}")
    if stage in ("var", "full"):
        return fused_moments_reference(x, masks_t, valid_count)
    depth, pixels = x.shape
    rows = grid_for(x, masks_t.shape[0]).rows
    zeros_y = torch.zeros((depth, masks_t.shape[0]), dtype=torch.float32,
                          device=x.device)
    zeros_p = torch.zeros(pixels, dtype=torch.float32, device=x.device)
    integer = not (x.dtype.is_floating_point or x.dtype.is_complex)
    # cast before indexing: PyTorch indexes few dtypes wider than u8
    # that are unsigned
    if stage == "load_min":
        first = _chunk_rows(depth, rows, False, x.device)
        last = _chunk_rows(depth, rows, True, x.device)
        xt = x.to(torch.float32)
        # a one-row chunk's first row is its last
        ends = xt[first] + torch.where((last != first)[:, None], xt[last],
                                       0.0)
        return zeros_y, ends.sum(dim=0), zeros_p
    if stage == "load" and integer and x.element_size() <= 2:
        pad = -depth % rows
        wide = torch.nn.functional.pad(x.to(torch.int64), (0, 0, 0, pad))
        chunks = wide.reshape(-1, rows, pixels).sum(dim=1)
        return zeros_y, chunks.to(torch.float32).sum(dim=0), zeros_p
    xt = x.to(torch.float32)
    colsum = xt.sum(dim=0)
    if stage in ("load", "cast"):
        return zeros_y, colsum, zeros_p
    return xt @ masks_t.T, colsum, zeros_p


def _ablation_library():
    lib = build.load("fused_moments_ablation")
    fn = lib.fused_moments_ablation_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 5
        )
        fn.restype = ctypes.c_int
        lib.fused_moments_error_string.argtypes = [ctypes.c_int]
        lib.fused_moments_error_string.restype = ctypes.c_char_p
    return lib


def _stage_cuda(x, masks_t, valid_count, stage, combine):
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages are {STAGES}")
    valid_count = check_inputs(x, masks_t, valid_count, _STAGE_DTYPES)
    depth, pixels = x.shape
    n_masks = masks_t.shape[0]
    dev = x.device
    # stages below dot do not write y
    y = (torch.empty if STAGES.index(stage) >= STAGES.index("dot")
         else torch.zeros)((depth, n_masks), dtype=torch.float32, device=dev)
    colsum = torch.empty(pixels, dtype=torch.float32, device=dev)
    colvar = torch.empty(pixels, dtype=torch.float32, device=dev)
    lib = _ablation_library()
    grid = grid_for(x, n_masks)
    scratch = torch.empty(grid.scratch_floats(depth, pixels, n_masks),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_moments_ablation_launch(
            STAGES.index(stage), int(not combine), _STAGE_DTYPES[x.dtype],
            x.data_ptr(), masks_t.data_ptr(), depth, pixels, n_masks,
            grid.rows, grid.chunk, valid_count, 1, scratch.data_ptr(),
            y.data_ptr(), colsum.data_ptr(), colvar.data_ptr(), stream,
        )
    if code != 0:
        msg = lib.fused_moments_error_string(code).decode()
        raise RuntimeError(f"fused_moments ablation launch failed: {msg}")
    fused_moments_stage.launches += 1
    return (y, colsum, colvar) if combine else None


def fused_moments_stage(x, masks_t, valid_count: int, stage: str,
                        combine: bool = True):
    """``(y, colsum, colvar)`` of ``stage`` (one of ``STAGES``) on a
    ``(depth, pixels)`` block; see the module docstring.
    ``combine=False`` (CUDA only) launches the stage's partials and
    skips the combine, to time them alone, and returns None; the
    ``full`` stage always combines."""
    if x.device.type == "cpu":
        return fused_moments_stage_reference(x, masks_t, valid_count, stage)
    return _stage_cuda(x, masks_t, valid_count, stage,
                       combine or stage == "full")


# partials launches so far, one a call
fused_moments_stage.launches = 0


def stage_bound(stage: str, depth: int, pixels: int, n_masks: int,
                itemsize: int, passes: int = 3) -> tuple[float, str]:
    """Least ms of a stage on the H100: x read once, the masks (from
    dot on) and the stage's outputs written once, over the HBM rate;
    or its arithmetic: the product's ``passes`` TF32 passes over the
    tensor cores' rate (three at most, fewer where the data's lo
    operands are zero), the adds and the variance over the fp32 rate
    (integer adds counted at that rate), whichever takes longer;
    whichever of bytes and arithmetic is larger, with what bounds
    it."""
    lvl = STAGES.index(stage)
    moved = depth * pixels * itemsize + pixels * 4
    fp32 = {0: 2 * plan_grid(depth, pixels, n_masks=n_masks).n_rc * pixels,
            1: depth * pixels, 2: depth * pixels}.get(lvl, depth * pixels)
    tf32 = 0
    if lvl >= STAGES.index("dot"):
        moved += n_masks * pixels * 4 + depth * n_masks * 4
        tf32 = passes * 2 * depth * pixels * n_masks
    if lvl >= STAGES.index("var"):
        moved += pixels * 4
        fp32 = 5 * depth * pixels
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(fp32 / FP32_FLOP_PER_S, tf32 / TF32_FLOP_PER_S) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def fp32_bound(depth: int, pixels: int, n_masks: int, itemsize: int) -> float:
    """Least ms of ``fused_moments`` were its product on the CUDA cores
    (the earlier design's bound): bytes as :func:`stage_bound`, or
    2 M + 5 FLOPs a pixel over the fp32 rate, whichever is larger."""
    moved = (depth * pixels * itemsize + n_masks * pixels * 4
             + depth * n_masks * 4 + 2 * pixels * 4)
    return max(moved / HBM_BYTES_PER_S,
               depth * pixels * (2 * n_masks + 5) / FP32_FLOP_PER_S) * 1e3


def library_call(stage: str):
    """One PyTorch call of (part of) the stage's outputs, a yardstick
    the port never calls, or None where there is none (load_min)."""
    def load(x, m):
        return x.sum(0, dtype=torch.int32)

    def cast(x, m):
        return x.float().sum(0)

    def dot(x, m):
        return x.float() @ m.T

    def moments(x, m):
        xf = x.float()
        return xf @ m.T, torch.var_mean(xf, dim=0, correction=0)

    return {"load": load, "cast": cast, "dot": dot, "var": moments,
            "full": moments}.get(stage)


def time_ms(fn, inputs, calls=32, replays=8) -> float:
    """Device ms per call of ``fn``, cycling over ``inputs``: ``calls``
    calls captured in a CUDA graph and replayed ``replays`` times."""
    for args in inputs:
        fn(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def measure(blocks, masks_t, valid_count: int, timer=time_ms) -> list:
    """Per stage: device ms of the stage (the partials alone below full,
    partials and combine at full), of its plain version and of its
    library call, and its bound, on ``blocks`` (CUDA tensors of one
    shape)."""
    depth, pixels = blocks[0].shape
    n_masks = masks_t.shape[0]
    passes = max(tf32_passes(b, masks_t) for b in blocks)
    rows = []
    for stage in STAGES:
        def kernel(x, _s=stage):
            fused_moments_stage(x, masks_t, valid_count, _s, combine=False)

        def plain(x, _s=stage):
            fused_moments_stage_reference(x, masks_t, valid_count, _s)

        inputs = [(b,) for b in blocks]
        lib = library_call(stage)
        b_ms, b_by = stage_bound(stage, depth, pixels, n_masks,
                                 blocks[0].element_size(), passes)
        rows.append({
            "stage": stage, "ms": timer(kernel, inputs),
            "plain_ms": timer(plain, inputs),
            "library_ms": (None if lib is None
                           else timer(lambda x: lib(x, masks_t), inputs)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the stage ablation needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    depth, pixels, n_masks, n_blocks = 1024, 128 * 128, 6, 8
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    blocks = [torch.from_numpy(rng.poisson(8.0, (depth, pixels)).astype(
        np.uint16)).to(dev) for _ in range(n_blocks)]
    masks_t = torch.from_numpy(rng.random((n_masks, pixels)).astype(
        np.float32)).to(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for row in measure(blocks, masks_t, depth):
        secs = row["ms"] / 1e3
        print(json.dumps({row.pop("stage"): dict(
            gbps=depth * pixels * 2 / secs / 1e9,
            ps_per_px=secs / (depth * pixels) * 1e12,
            card=card, **row,
        )}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
