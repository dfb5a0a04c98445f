"""Bright-field disk analysis, id APPLY_DISK_MASK (counterpart of
``libertem_tpu/analysis/disk.py``)."""
from __future__ import annotations

from .. import masks as mask_lib
from .masks import SingleMaskAnalysis


class DiskMaskAnalysis(SingleMaskAnalysis, id_="APPLY_DISK_MASK"):
    def get_parameters(self, parameters: dict) -> dict:
        h, w = tuple(self.dataset.shape.sig)
        return {
            "cx": parameters.get("cx", w / 2),
            "cy": parameters.get("cy", h / 2),
            "r": parameters.get("r", min(h, w) / 4),
            **{k: v for k, v in parameters.items()
               if k not in ("cx", "cy", "r")},
        }

    def get_mask_factories(self):
        h, w = tuple(self.dataset.shape.sig)
        p = self.parameters

        def disk():
            return mask_lib.circular(p["cx"], p["cy"], w, h, p["r"],
                                     antialiased=True)

        return [disk]

    def get_description(self):
        return "intensity within the disk (bright field)"
