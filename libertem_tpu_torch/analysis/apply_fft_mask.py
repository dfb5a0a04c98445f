"""Import alias, as in the JAX package: ``analysis.apply_fft_mask``."""
from .fft import ApplyFFTMask, ApplyFFTMaskUDF

__all__ = ["ApplyFFTMask", "ApplyFFTMaskUDF"]
