"""Visualisation of results: what the analyses render (the live plots
are not ported yet)."""
from .base import rgb_from_2dvector, visualize_simple

__all__ = ["visualize_simple", "rgb_from_2dvector"]
