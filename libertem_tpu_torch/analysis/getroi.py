"""A nav roi from the GUI's roi parameters (counterpart of
``libertem_tpu/analysis/getroi.py``)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def get_roi(params: dict, shape) -> Optional[np.ndarray]:
    """A bool nav-shaped roi from ``params["roi"]``:
    ``{"shape": "disk", "cx", "cy", "r"}`` or
    ``{"shape": "rect", "x", "y", "width", "height"}``; None for no
    roi or another shape.  The gestures are 2-D: they apply to the last
    two nav axes (broadcast over leading ones); a 1-D nav is x, with y
    at 0."""
    roi_params = params.get("roi", {})
    if not roi_params:
        return None
    nav = tuple(shape)
    kind = roi_params.get("shape")
    if kind == "disk":
        cx, cy, r = roi_params["cx"], roi_params["cy"], roi_params["r"]
        if len(nav) == 1:
            x = np.arange(nav[0])
            return ((0 - cy) ** 2 + (x - cx) ** 2) <= r ** 2
        y, x = np.ogrid[0:nav[-2], 0:nav[-1]]
        sel = ((y - cy) ** 2 + (x - cx) ** 2) <= r ** 2
        return np.broadcast_to(sel, nav).copy()
    if kind == "rect":
        x, y = roi_params["x"], roi_params["y"]
        w, h = roi_params["width"], roi_params["height"]
        mask = np.zeros(nav, dtype=bool)
        if len(nav) == 1:
            mask[int(x):int(x + w)] = True
        else:
            mask[..., int(y):int(y + h), int(x):int(x + w)] = True
        return mask
    return None
