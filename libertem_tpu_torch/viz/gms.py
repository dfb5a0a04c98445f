"""Gatan Digital Micrograph (GMS) live plot (counterpart of
``libertem_tpu/viz/gms.py``).  Only usable inside the GMS Python
environment (the ``DigitalMicrograph`` module, imported when a plot is
made).
"""
from __future__ import annotations

import numpy as np

from .base import Live2DPlot


class GMSLive2DPlot(Live2DPlot):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        try:
            import DigitalMicrograph as DM  # noqa: N817
        except ImportError as e:
            raise ImportError(
                "GMSLive2DPlot only works inside Gatan Digital "
                "Micrograph's Python environment"
            ) from e
        self._DM = DM
        self.image = None

    def display(self):
        data = self.data
        if data is None:
            data = np.zeros(tuple(self.dataset.shape.nav)[:2])
        self.image = self._DM.CreateImage(
            np.asarray(data, dtype=np.float32).copy()
        )
        self.image.SetName(self.title)
        self.image.ShowImage()

    def update(self, damage, force=False):
        if self.image is None:
            import warnings
            warnings.warn(
                "Plot is not displayed, not plotting. "
                "Call display() to display the plot."
            )
            return
        if self.data is None:
            return
        buf = self.image.GetNumArray()
        buf[:] = np.nan_to_num(np.asarray(self.data))
        self.image.UpdateImage()
