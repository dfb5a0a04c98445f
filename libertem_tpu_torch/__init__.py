"""libertem_tpu_torch — the PyTorch/CUDA port of libertem_tpu.

The main path of the JAX package, on one NVIDIA H100: a 4D-STEM
dataset streamed from disk through virtual detectors (ApplyMasksUDF),
centre of mass (CoMUDF) and statistics (SumUDF, SumSigUDF, StdDevUDF)
in one fused pass, carried by a hand-written CUDA kernel
(``csrc/fused_moments.cu``).

Imports ``torch`` and ``numpy`` only, never ``jax`` or
``libertem_tpu``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
from . import masks
from .api import Context
from .udf import ApplyMasksUDF, CoMUDF, StdDevUDF, SumSigUDF, SumUDF

__all__ = [
    "Context", "masks", "ApplyMasksUDF", "CoMUDF", "StdDevUDF",
    "SumSigUDF", "SumUDF",
]
