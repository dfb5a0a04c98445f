"""Annular dark-field ring analysis, id APPLY_RING_MASK (counterpart of
``libertem_tpu/analysis/ring.py``)."""
from __future__ import annotations

from .. import masks as mask_lib
from .masks import SingleMaskAnalysis


class RingMaskAnalysis(SingleMaskAnalysis, id_="APPLY_RING_MASK"):
    def get_parameters(self, parameters: dict) -> dict:
        h, w = tuple(self.dataset.shape.sig)
        return {
            "cx": parameters.get("cx", w / 2),
            "cy": parameters.get("cy", h / 2),
            "ri": parameters.get("ri", min(h, w) / 4),
            "ro": parameters.get("ro", min(h, w) / 2),
            **{k: v for k, v in parameters.items()
               if k not in ("cx", "cy", "ri", "ro")},
        }

    def get_mask_factories(self):
        h, w = tuple(self.dataset.shape.sig)
        p = self.parameters

        def ring():
            return mask_lib.ring(p["cx"], p["cy"], w, h, p["ro"], p["ri"],
                                 antialiased=True)

        return [ring]

    def get_description(self):
        return "intensity within the ring (dark field)"
