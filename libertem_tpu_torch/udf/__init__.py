"""The UDFs of the port: the five of the fused main path, the ones
that run on the generic path (among them the FFT UDFs: the blobfinder
correlations and holography), and AutoUDF and RecordUDF."""
from ..common.exceptions import UDFException, UDFRunCancelled  # noqa: F401
from .auto import AutoUDF
from .base import (
    NoOpUDF,
    UDF,
    UDFData,
    UDFFrameMixin,
    UDFMergeAllMixin,
    UDFMeta,
    UDFParams,
    UDFPartitionMixin,
    UDFPostprocessMixin,
    UDFPreprocessMixin,
    UDFResults,
    UDFRunner,
    UDFTileMixin,
)
from .blobfinder import (
    BackgroundSubtraction,
    Disk,
    FullFrameCorrelationUDF,
    MatchPattern,
    RadialGradient,
    SparseCorrelationUDF,
    run_blobfinder,
)
from .com import CoMParams, CoMUDF, RegressionOptions, guess_corrections
from .crystallinity import CrystallinityUDF
from .FEM import FEMUDF
from .holography import (
    HoloReconstructUDF,
    estimate_sideband_position,
    estimate_sideband_size,
)
from .logsum import LogsumUDF
from .masks import ApplyMasksUDF, MaskContainer
from .raw import PickUDF
from .record import RecordUDF
from .stddev import StdDevUDF, run_stddev
from .sum import SumUDF
from .sumsigudf import SumSigUDF

__all__ = [
    "UDF", "UDFData", "UDFMeta", "UDFParams", "UDFResults", "UDFRunner",
    "NoOpUDF", "UDFFrameMixin", "UDFTileMixin", "UDFPartitionMixin",
    "UDFPreprocessMixin", "UDFPostprocessMixin", "UDFMergeAllMixin",
    "CoMParams", "CoMUDF", "RegressionOptions", "guess_corrections",
    "ApplyMasksUDF", "MaskContainer", "StdDevUDF", "run_stddev", "SumUDF",
    "SumSigUDF", "LogsumUDF", "PickUDF", "FEMUDF", "CrystallinityUDF", "UDFException", "AutoUDF",
    "RecordUDF", "MatchPattern", "Disk", "RadialGradient",
    "BackgroundSubtraction", "FullFrameCorrelationUDF",
    "SparseCorrelationUDF", "run_blobfinder", "HoloReconstructUDF",
    "estimate_sideband_position", "estimate_sideband_size",
]
