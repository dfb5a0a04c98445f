"""Analysis: a UDF with GUI-style parameters, a roi and the
post-processing of its buffers into named, visualised results
(counterpart of ``libertem_tpu/analysis/base.py``).

The port's ``Analysis.registry`` is its own: the JAX package's classes
never enter it, nor its classes the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..viz.base import rgb_from_2dvector, visualize_simple


class Analysis:
    # analysis id -> class, filled by ``class X(Analysis, id_="...")``
    registry: dict = {}

    def __init_subclass__(cls, id_=None, **kwargs):
        super().__init_subclass__(**kwargs)
        if id_ is not None:
            cls.TYPE = id_
            Analysis.registry[id_] = cls

    @classmethod
    def get_analysis_by_type(cls, id_: str) -> type:
        try:
            return cls.registry[id_]
        except KeyError:
            raise ValueError(
                f"unknown analysis type {id_!r}; known: "
                f"{sorted(cls.registry)}"
            ) from None

    def __init__(self, dataset, parameters: dict):
        self.dataset = dataset
        # GUI clients send explicit nulls for untouched fields: dropping
        # them lets each analysis's defaults apply
        parameters = {k: v for k, v in parameters.items() if v is not None}
        self.parameters = self.get_parameters(parameters)

    def get_parameters(self, parameters: dict) -> dict:
        return parameters

    def get_udf(self):
        raise NotImplementedError()

    def get_roi(self) -> Optional[np.ndarray]:
        """The GUI roi parameter, honoured by every analysis (PickFrame
        overrides it with its frame)."""
        from .getroi import get_roi
        return get_roi(self.parameters, self.dataset.shape.nav)

    def get_udf_results(self, udf_results, roi, damage
                        ) -> AnalysisResultSet:
        raise NotImplementedError()

    def need_rerun(self, old_params: dict, new_params: dict) -> bool:
        """Whether a parameter change needs the UDF run again, rather
        than a new post-processing of its results."""
        return old_params != new_params

    @classmethod
    def get_rpc_definitions(cls) -> dict:
        return {}


class BaseAnalysis(Analysis):
    def nav_damage(self, damage):
        return None if damage is None else damage.data

    def single_result(self, data, key="intensity", title="intensity",
                      desc="result", damage=None, logarithmic=False
                      ) -> AnalysisResultSet:
        data = np.asarray(data)
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=data,
                visualized=lambda: visualize_simple(
                    data, logarithmic=logarithmic, damage=damage),
                title=title, desc=desc, key=key,
            ),
        ])

    def get_complex_results(self, job_result, key_prefix, title, desc,
                            damage=None, default_lin=True) -> list:
        """A complex array as six channels: magnitude linear and
        logarithmic (``default_lin`` says which of them owns the bare
        ``key_prefix``), real, imaginary, angle, and the complex values
        on the 2-D vector colour wheel."""
        mag = np.abs(job_result)
        angle = np.angle(job_result)

        def wheel():
            vmax = None
            if damage is not None and np.count_nonzero(damage):
                vmax = float(np.max(mag[np.asarray(damage, dtype=bool)]))
            return rgb_from_2dvector(y=job_result.imag, x=job_result.real,
                                     vmax=vmax)

        return [
            AnalysisResult(
                raw_data=mag,
                visualized=lambda: visualize_simple(mag, damage=damage),
                key=key_prefix if default_lin else f"{key_prefix}_lin",
                title=f"{title} [magn]", desc=f"{desc} (magnitude)",
            ),
            AnalysisResult(
                raw_data=mag,
                visualized=lambda: visualize_simple(
                    mag, logarithmic=True, damage=damage),
                key=f"{key_prefix}_log" if default_lin else key_prefix,
                title=f"{title} [log(magn)]",
                desc=f"{desc} (log magnitude)",
            ),
            AnalysisResult(
                raw_data=job_result.real,
                visualized=lambda: visualize_simple(job_result.real,
                                                    damage=damage),
                key=f"{key_prefix}_real", title=f"{title} [real]",
                desc=f"{desc} (real part)",
            ),
            AnalysisResult(
                raw_data=job_result.imag,
                visualized=lambda: visualize_simple(job_result.imag,
                                                    damage=damage),
                key=f"{key_prefix}_imag", title=f"{title} [imag]",
                desc=f"{desc} (imaginary part)",
            ),
            AnalysisResult(
                raw_data=angle,
                visualized=lambda: visualize_simple(angle, damage=damage),
                key=f"{key_prefix}_angle", title=f"{title} [angle]",
                desc=f"{desc} (phase)",
            ),
            AnalysisResult(
                raw_data=job_result,
                visualized=wheel,
                key=f"{key_prefix}_complex", title=f"{title} [complex]",
                desc=f"{desc} (complex, color wheel)",
            ),
        ]
