"""bqplot-image-gl live plot (counterpart of
``libertem_tpu/viz/bqp.py``) for Jupyter widgets; bqplot and
bqplot-image-gl are imported when a plot is made, and their absence
raises ImportError then.
"""
from __future__ import annotations

import numpy as np

from .base import Live2DPlot


class BQLive2DPlot(Live2DPlot):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        try:
            import bqplot  # noqa: F401
            import bqplot_image_gl  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "BQLive2DPlot requires bqplot and bqplot-image-gl"
            ) from e
        self.figure = None
        self.image = None

    def display(self):
        import bqplot
        from bqplot_image_gl import ImageGL
        scale_x = bqplot.LinearScale()
        scale_y = bqplot.LinearScale()
        scales = {"x": scale_x, "y": scale_y}
        axis_x = bqplot.Axis(scale=scale_x)
        axis_y = bqplot.Axis(
            scale=scale_y, orientation="vertical"
        )
        self.figure = bqplot.Figure(
            axes=[axis_x, axis_y], title=self.title,
        )
        data = np.zeros(tuple(self.dataset.shape.nav)[:2])
        scales_image = {
            "x": scale_x, "y": scale_y,
            "image": bqplot.ColorScale(min=0, max=1),
        }
        self.image = ImageGL(image=data, scales=scales_image)
        self.figure.marks = (self.image,)
        return self.figure

    def update(self, damage, force=False):
        if self.image is None or self.data is None:
            return
        data = np.nan_to_num(
            np.asarray(self.data, dtype=np.float64)
        )
        self.image.image = data
        valid = data[np.isfinite(data)]
        if valid.size:
            cs = self.image.scales["image"]
            cs.min = float(valid.min())
            cs.max = float(valid.max() + 1e-30)
