"""The table of peaks and the least time a kernel's work needs.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A share of a roofline is stated
against these, with the card's power limit beside it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12


def fused_moments_bound_s(frames: int, pixels: int, n_masks: int,
                          itemsize: int, calls: int) -> tuple[float, str]:
    """Least seconds of ``calls`` fused-moments calls over ``frames``
    frames of ``pixels`` pixels (``itemsize`` bytes each) against
    ``n_masks`` mask rows, and which of "bytes" and "operations" sets
    it.

    Bytes: each input read once and each output written once: the
    frames, each call's float32 mask stack and its two float32 moments
    (sum and variance a pixel), and a float32 projection a frame and
    mask.  Operations: the product counted once, ``2 * frames * pixels
    * n_masks`` at the TF32 rate of the tensor cores, plus the moments'
    5 operations a pixel at the fp32 rate.  Nothing here depends on how
    the kernel computes (its passes, tiles or launches but the calls),
    so the bound stays when the kernel changes."""
    moved = (frames * pixels * itemsize
             + calls * (n_masks * pixels * 4 + 2 * pixels * 4)
             + frames * n_masks * 4)
    bytes_s = moved / HBM_BYTES_PER_S
    ops_s = (2.0 * frames * pixels * n_masks / TF32_FLOP_PER_S
             + 5.0 * frames * pixels / FP32_FLOP_PER_S)
    if bytes_s >= ops_s:
        return bytes_s, "bytes"
    return ops_s, "operations"
