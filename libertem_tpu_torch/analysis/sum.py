"""Sum-of-frames analysis, id SUM_FRAMES (counterpart of
``libertem_tpu/analysis/sum.py``)."""
from __future__ import annotations

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..udf.sum import SumUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


class SumAnalysis(BaseAnalysis, id_="SUM_FRAMES"):
    def get_udf(self):
        return SumUDF()

    def get_udf_results(self, udf_results, roi, damage):
        data = udf_results["intensity"].data
        if np.iscomplexobj(data):
            return AnalysisResultSet(
                self.get_complex_results(
                    data, key_prefix="intensity", title="intensity",
                    desc="sum of frames", default_lin=False,
                ),
                raw_results=udf_results,
            )
        # 'intensity' is the log-scaled view, 'intensity_lin' the linear
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(data, logarithmic=True),
                key="intensity", title="intensity [log]",
                desc="sum of frames log-scaled",
            ),
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(data),
                key="intensity_lin", title="intensity [lin]",
                desc="sum of frames lin-scaled",
            ),
        ], raw_results=udf_results)
