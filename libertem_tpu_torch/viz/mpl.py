"""Matplotlib live plot (counterpart of ``libertem_tpu/viz/mpl.py``);
matplotlib is imported when the plot is displayed."""
from __future__ import annotations

import logging
import warnings

import numpy as np

from .base import Live2DPlot, _stat_limits

log = logging.getLogger(__name__)


class MPLLive2DPlot(Live2DPlot):
    """A matplotlib live plot; ``**kwargs`` go to ``imshow``.  An
    update before :meth:`display` warns rather than dropping frames
    silently."""

    def __init__(self, dataset, udf, roi=None, channel=None,
                 title=None, min_delta=0.5, udfresult=None, **kwargs):
        super().__init__(
            dataset=dataset, udf=udf, roi=roi, channel=channel,
            title=title, min_delta=min_delta, udfresult=udfresult,
        )
        self.kwargs = kwargs
        self.fig = None
        self.axes = None
        self.im_obj = None

    def display(self):
        import matplotlib.pyplot as plt
        self.fig, self.axes = plt.subplots()
        data = self.data
        if data is None:
            data = np.zeros(tuple(self.dataset.shape.nav)[:2])
        self.im_obj = self.axes.imshow(data, **self.kwargs)
        self.axes.set_title(self.title)
        return self.fig

    def update(self, damage, force=False):
        if self.im_obj is None:
            warnings.warn(
                "Plot is not displayed, not plotting. "
                "Call display() to display the plot."
            )
            return
        raw = np.asarray(self.data, dtype=np.float64)
        # limits over the damage before nan_to_num: unmerged regions
        # are nan and must not pull the colour scale to zero
        lo, hi = _stat_limits(raw, damage)
        data = np.nan_to_num(raw)
        self.im_obj.set_data(data)
        if np.isfinite(lo) and np.isfinite(hi):
            self.im_obj.set_clim(lo, hi + 1e-30)
        if self.fig is not None:
            self.fig.canvas.draw_idle()
