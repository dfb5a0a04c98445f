"""Fluctuation-EM analysis, id FEM (counterpart of
``libertem_tpu/analysis/fem.py``)."""
from __future__ import annotations

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..udf.FEM import FEMUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


class FEMAnalysis(BaseAnalysis, id_="FEM"):
    def get_parameters(self, parameters: dict) -> dict:
        h, w = tuple(self.dataset.shape.sig)
        return {
            **parameters,
            "cx": parameters.get("cx", w / 2),
            "cy": parameters.get("cy", h / 2),
            "ri": parameters.get("ri", min(h, w) / 4),
            "ro": parameters.get("ro", min(h, w) / 2),
        }

    def get_udf(self):
        p = self.parameters
        return FEMUDF(center=(p["cy"], p["cx"]), rad_in=p["ri"],
                      rad_out=p["ro"])

    def get_udf_results(self, udf_results, roi, damage):
        data = udf_results["intensity"].data
        dmg = self.nav_damage(damage)
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(data, damage=dmg),
                key="intensity", title="intensity",
                desc="standard deviation over the ring per frame",
            ),
        ], raw_results=udf_results)
