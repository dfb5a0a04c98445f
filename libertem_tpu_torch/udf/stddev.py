"""StdDevUDF: per-pixel mean / variance / std in one pass (counterpart
of ``libertem_tpu/udf/stddev.py``).

Per-block and per-partition (count, sum, varsum) states fold with
the Chan/Golub/LeVeque parallel-variance combine; the generic path's
``process_tile`` counts only the block's valid frames, so zero-padded
tail rows do not enter the statistics.  Complex data keeps complex
sums and means; its variance is real, E|x - mean|^2 (``_abs2``).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import UDF


def _abs2(x):
    """|x|^2: real for complex ``x`` (without the sqrt of abs), x * x
    for real ``x``."""
    if x.is_complex():
        return (x * x.conj()).real
    return x * x


def _combine(n0, sum0, varsum0, n1, sum1, varsum1):
    """Combine two (count, sum, varsum) variance states (tensors)."""
    n = n0 + n1
    mean0 = sum0 / torch.clamp(n0, min=1)
    mean1 = sum1 / torch.clamp(n1, min=1)
    delta = mean1 - mean0
    corr = _abs2(delta) * (n0 * n1 / torch.clamp(n, min=1))
    varsum = torch.where(
        n0 == 0, varsum1,
        torch.where(n1 == 0, varsum0, varsum0 + varsum1 + corr),
    )
    return n, sum0 + sum1, varsum


class StdDevUDF(UDF):
    """Per-pixel mean / variance / std over all frames."""

    def get_result_buffers(self):
        # complex data: complex64 sums and means, real variance
        sum_dtype = np.result_type(self.meta.input_dtype, np.float32)
        sum_dtype = np.dtype(
            np.complex64 if sum_dtype.kind == "c" else np.float32
        )
        return {
            "num_frames": self.buffer(kind="single", dtype="float32"),
            "sum": self.buffer(kind="sig", dtype=sum_dtype),
            "varsum": self.buffer(kind="sig", dtype="float32"),
            "var": self.buffer(kind="sig", dtype="float32",
                               use="result_only"),
            "std": self.buffer(kind="sig", dtype="float32",
                               use="result_only"),
            "mean": self.buffer(kind="sig", dtype=sum_dtype,
                                use="result_only"),
        }

    def fused_moments_spec(self):
        """Consumes the fused pass's colsum/colvar moments."""
        return {"mode": "stats"}

    def process_tile(self, tile):
        valid = float(self.meta.valid_frames)
        n1 = torch.full_like(self.results.num_frames, valid)
        sum1 = tile.sum(dim=0)
        mean1 = sum1 / max(valid, 1.0)
        vmask = self.meta.tile_valid.reshape(
            (-1,) + (1,) * (tile.ndim - 1)
        )
        diff = (tile - mean1) * vmask
        n, s, v = _combine(
            self.results.num_frames, self.results.sum,
            self.results.varsum, n1, sum1, _abs2(diff).sum(dim=0),
        )
        # with a sig-tiled scheme every sig tile sees the same frames:
        # count them once, on the last tile, so earlier tiles still
        # read the old count
        scheme = self.meta.tiling_scheme
        if scheme is None or self.meta.tiling_scheme_idx == len(scheme) - 1:
            self.results.num_frames = n
        self.results.sum = s
        self.results.varsum = v

    def merge(self, dest, src):
        n, s, v = _combine(
            dest.num_frames, dest.sum, dest.varsum,
            src.num_frames, src.sum, src.varsum,
        )
        dest.num_frames = n
        dest.sum = s
        dest.varsum = v

    def get_results(self):
        n = max(float(np.asarray(self.results.num_frames).reshape(())), 1.0)
        var = self.results.varsum / n
        return {
            "var": var,
            "std": np.sqrt(var),
            "mean": self.results.sum / n,
        }


def run_stddev(ctx, dataset, roi=None, progress=False, use_numba=True):
    """``StdDevUDF`` over ``dataset`` (of ``roi``): its buffers by name,
    as arrays.  ``use_numba`` is accepted for the JAX package's
    signature and not used."""
    res = ctx.run_udf(dataset, StdDevUDF(), roi=roi, progress=progress)
    return {
        k: res[k].data
        for k in ("num_frames", "sum", "varsum", "var", "std", "mean")
    }
