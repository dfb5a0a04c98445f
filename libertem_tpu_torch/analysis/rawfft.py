"""Import alias, as in the JAX package: ``analysis.rawfft``."""
from .fft import PickFFTFrameAnalysis

__all__ = ["PickFFTFrameAnalysis"]
