"""Visualisation of results (counterpart of ``libertem_tpu/viz/``):
what the analyses render, and the live plots of
``Context.run_udf(plots=...)``."""
from .base import (
    Dummy2DPlot,
    Live2DPlot,
    encode_image,
    rgb_from_2dvector,
    visualize_simple,
)
from .mpl import MPLLive2DPlot

__all__ = [
    "Live2DPlot", "Dummy2DPlot", "MPLLive2DPlot",
    "visualize_simple", "encode_image", "rgb_from_2dvector",
    "libertem_cyclic",
]


def __getattr__(name):
    # building the cyclic colormap imports matplotlib
    if name == "libertem_cyclic":
        from . import base
        return base.libertem_cyclic
    raise AttributeError(name)
