"""The UDFs of the fused main path."""
from .base import UDF, UDFData, UDFMeta, UDFResults, UDFRunner
from .com import CoMParams, CoMUDF, RegressionOptions
from .masks import ApplyMasksUDF, MaskContainer
from .stddev import StdDevUDF
from .sum import SumUDF
from .sumsigudf import SumSigUDF

__all__ = [
    "UDF", "UDFData", "UDFMeta", "UDFResults", "UDFRunner",
    "CoMParams", "CoMUDF", "RegressionOptions", "ApplyMasksUDF",
    "MaskContainer", "StdDevUDF", "SumUDF", "SumSigUDF",
]
