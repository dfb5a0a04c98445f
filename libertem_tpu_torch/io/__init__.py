"""Tiling and datasets."""
from .corrections import CorrectionSet
from .tiling import Negotiator, TilingScheme

__all__ = ["CorrectionSet", "TilingScheme", "Negotiator"]
