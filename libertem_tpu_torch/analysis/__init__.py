"""The analyses: a UDF with GUI-style parameters and named, visualised
results, run with ``Context.run`` (counterpart of
``libertem_tpu/analysis``)."""
from .base import Analysis, BaseAnalysis
from .clust import ClusterAnalysis
from .com import COMAnalysis
from .disk import DiskMaskAnalysis
from .fem import FEMAnalysis
from .fft import ApplyFFTMask, PickFFTFrameAnalysis, SumfftAnalysis
from .masks import BaseMasksAnalysis, MasksAnalysis
from .point import PointMaskAnalysis
from .radialfourier import RadialFourierAnalysis
from .raw import PickFrameAnalysis
from .ring import RingMaskAnalysis
from .sd import SDAnalysis
from .sum import SumAnalysis
from .sumsig import SumSigAnalysis

__all__ = [
    "Analysis", "BaseAnalysis", "BaseMasksAnalysis",
    "MasksAnalysis", "DiskMaskAnalysis", "RingMaskAnalysis",
    "PointMaskAnalysis", "SumAnalysis", "SumSigAnalysis",
    "SDAnalysis", "PickFrameAnalysis", "PickFFTFrameAnalysis",
    "SumfftAnalysis", "ApplyFFTMask", "COMAnalysis",
    "RadialFourierAnalysis", "FEMAnalysis", "ClusterAnalysis",
]
