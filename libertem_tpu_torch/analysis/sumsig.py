"""Sum-over-sig analysis, id SUM_SIG (counterpart of
``libertem_tpu/analysis/sumsig.py``)."""
from __future__ import annotations

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..udf.sumsigudf import SumSigUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


class SumSigAnalysis(BaseAnalysis, id_="SUM_SIG"):
    def get_udf(self):
        return SumSigUDF()

    def get_udf_results(self, udf_results, roi, damage):
        data = udf_results["intensity"].data
        dmg = self.nav_damage(damage)
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(data, damage=dmg),
                key="intensity", title="intensity",
                desc="sum over the signal axes per scan position",
            ),
        ], raw_results=udf_results)
