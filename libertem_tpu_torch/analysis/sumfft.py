"""Import alias, as in the JAX package: ``analysis.sumfft``."""
from .fft import SumfftAnalysis

__all__ = ["SumfftAnalysis"]
