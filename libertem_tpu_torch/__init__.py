"""libertem_tpu_torch — the PyTorch/CUDA port of libertem_tpu.

The main path of the JAX package, on one NVIDIA H100: a 4D-STEM
dataset streamed from disk through virtual detectors (ApplyMasksUDF),
centre of mass (CoMUDF) and statistics (SumUDF, SumSigUDF, StdDevUDF)
in one fused pass, carried by a hand-written CUDA kernel
(``csrc/fused_moments.cu``); any other UDF set (LogsumUDF, PickUDF,
FEMUDF, CrystallinityUDF, a user's own) on the generic path.  Both
take a roi and detector corrections (``io.corrections.CorrectionSet``).
UDFs written with numpy run on a host engine beside them, in the same
read pass; aux data (per-frame mask shifts), complex data and masks,
and block-compacted sparse mask stacks are supported.  Above the UDFs,
``Context.run`` runs the analyses (``Context.create_*_analysis``) and
``Context.map`` a function of one frame (AutoUDF); RecordUDF writes
the frames to a ``.npy`` file.  The FFT UDFs (``udf.blobfinder``'s
correlations, ``udf.holography``) run with ``torch.fft`` on the
device; datasets take a sync offset, an io backend and data of either
byte order.

Imports ``torch`` and ``numpy`` only, never ``jax`` or
``libertem_tpu``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
from . import analysis, masks
from .api import Context
from .common.exceptions import UDFException
from .io.corrections import CorrectionSet
from .udf import (
    ApplyMasksUDF,
    AutoUDF,
    CoMUDF,
    CrystallinityUDF,
    FEMUDF,
    LogsumUDF,
    NoOpUDF,
    PickUDF,
    RecordUDF,
    StdDevUDF,
    SumSigUDF,
    SumUDF,
)

__all__ = [
    "Context", "CorrectionSet", "masks", "ApplyMasksUDF", "CoMUDF",
    "StdDevUDF", "SumSigUDF", "SumUDF", "LogsumUDF", "PickUDF", "FEMUDF",
    "CrystallinityUDF", "NoOpUDF", "UDFException", "AutoUDF", "RecordUDF",
    "analysis",
]
