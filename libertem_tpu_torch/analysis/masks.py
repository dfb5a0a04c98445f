"""Virtual-detector analyses over ApplyMasksUDF (counterpart of
``libertem_tpu/analysis/masks.py``): the mask stack joins the fused
pass where ApplyMasksUDF does."""
from __future__ import annotations

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..udf.masks import ApplyMasksUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


class BaseMasksAnalysis(BaseAnalysis):
    """Mask factories from the parameters, one ApplyMasksUDF run, one
    channel per mask."""

    def get_mask_factories(self):
        raise NotImplementedError()

    def get_use_sparse(self):
        return self.parameters.get("use_sparse", None)

    def get_udf(self):
        return ApplyMasksUDF(
            mask_factories=self.get_mask_factories(),
            use_sparse=self.get_use_sparse(),
            mask_count=self.parameters.get("mask_count"),
            mask_dtype=self.parameters.get("mask_dtype"),
            dtype=self.parameters.get("dtype"),
        )

    def get_udf_results(self, udf_results, roi, damage):
        data = udf_results["intensity"].data  # (*nav, n_masks)
        dmg = self.nav_damage(damage)
        results = []
        for i in range(data.shape[-1]):
            chan = data[..., i]
            key, title = f"mask_{i}", f"mask {i}"
            if np.iscomplexobj(chan):
                results.extend(self.get_complex_results(
                    chan, key_prefix=key, title=title,
                    desc="mask result", damage=dmg,
                ))
            else:
                results.append(AnalysisResult(
                    raw_data=chan,
                    visualized=lambda c=chan: visualize_simple(
                        c, damage=dmg),
                    key=key, title=title,
                    desc=f"integrated intensity for mask {i}",
                ))
        return AnalysisResultSet(results, raw_results=udf_results)


class MasksAnalysis(BaseMasksAnalysis, id_="MASKS"):
    def get_mask_factories(self):
        return self.parameters["factories"]


class SingleMaskAnalysis(BaseMasksAnalysis):
    """One mask: an ``intensity`` and an ``intensity_log`` channel."""

    def get_udf_results(self, udf_results, roi, damage):
        data = udf_results["intensity"].data[..., 0]
        dmg = self.nav_damage(damage)
        if np.iscomplexobj(data):
            return AnalysisResultSet(
                self.get_complex_results(
                    data, key_prefix="intensity", title="intensity",
                    desc=self.get_description(), damage=dmg,
                ),
                raw_results=udf_results,
            )
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(data, damage=dmg),
                key="intensity", title="intensity [lin]",
                desc=f"{self.get_description()} lin-scaled",
            ),
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(
                    data, logarithmic=True, damage=dmg),
                key="intensity_log", title="intensity [log]",
                desc=f"{self.get_description()} log-scaled",
            ),
        ], raw_results=udf_results)

    def get_description(self):
        return "intensity of the virtual detector"
