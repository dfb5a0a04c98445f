"""Point-selector analysis, id APPLY_POINT_SELECTOR (counterpart of
``libertem_tpu/analysis/point.py``)."""
from __future__ import annotations

import numpy as np

from .masks import SingleMaskAnalysis


class PointMaskAnalysis(SingleMaskAnalysis, id_="APPLY_POINT_SELECTOR"):
    def get_parameters(self, parameters: dict) -> dict:
        h, w = tuple(self.dataset.shape.sig)
        return {
            **parameters,
            "cx": parameters.get("cx", w // 2),
            "cy": parameters.get("cy", h // 2),
        }

    def get_mask_factories(self):
        h, w = tuple(self.dataset.shape.sig)
        cx = int(round(self.parameters["cx"]))
        cy = int(round(self.parameters["cy"]))

        def point():
            mask = np.zeros((h, w), dtype=np.float32)
            mask[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)] = 1.0
            return mask

        return [point]

    def get_description(self):
        return "intensity at the selected detector pixel"
