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
byte order.  Datasets come from files of the detector formats, HDF5
and raw CSR (sparse frames, densified on the card), any array-like
(``load("dask", array=...)``) and a live acquisition that pushes
frames into a ring while the pass runs (``io.dataset.live``).

Imports ``torch`` and ``numpy`` only, never ``jax`` or
``libertem_tpu``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
from . import analysis, masks
from .api import Context, ResultGenerator
from .common.analysis import AnalysisResult, AnalysisResultSet
from .common.buffers import AuxBufferWrapper, BufferWrapper
from .common.exceptions import UDFException
from .common.shape import Shape
from .common.slice import Slice
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
    UDF,
)

__version__ = "0.1.0"

__all__ = [
    "Context", "CorrectionSet", "masks", "ApplyMasksUDF", "CoMUDF",
    "StdDevUDF", "SumSigUDF", "SumUDF", "LogsumUDF", "PickUDF", "FEMUDF",
    "CrystallinityUDF", "NoOpUDF", "UDFException", "AutoUDF", "RecordUDF",
    "analysis", "ResultGenerator", "UDF", "Shape", "Slice", "BufferWrapper",
    "AuxBufferWrapper", "AnalysisResult", "AnalysisResultSet", "__version__",
]
