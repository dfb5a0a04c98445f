"""Standard-deviation analysis, id SD_FRAMES (counterpart of
``libertem_tpu/analysis/sd.py``)."""
from __future__ import annotations

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..udf.stddev import StdDevUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


class SDAnalysis(BaseAnalysis, id_="SD_FRAMES"):
    def get_udf(self):
        return StdDevUDF()

    def get_udf_results(self, udf_results, roi, damage):
        var = udf_results["var"].data
        std = udf_results["std"].data
        mean = udf_results["mean"].data
        # 'intensity' is the standard deviation, log-scaled
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=std,
                visualized=lambda: visualize_simple(std, logarithmic=True),
                key="intensity", title="intensity [log]",
                desc="standard deviation of frames log-scaled",
            ),
            AnalysisResult(
                raw_data=std,
                visualized=lambda: visualize_simple(std),
                key="intensity_lin", title="intensity [lin]",
                desc="standard deviation of frames lin-scaled",
            ),
            AnalysisResult(
                raw_data=var,
                visualized=lambda: visualize_simple(var),
                key="variance", title="variance",
                desc="per-pixel variance over all frames",
            ),
            AnalysisResult(
                raw_data=std,
                visualized=lambda: visualize_simple(std),
                key="std", title="std",
                desc="per-pixel standard deviation",
            ),
            AnalysisResult(
                raw_data=mean,
                visualized=lambda: visualize_simple(mean),
                key="mean", title="mean",
                desc="per-pixel mean",
            ),
        ], raw_results=udf_results)
