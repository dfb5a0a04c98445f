"""Pick-frame analysis, id PICK_FRAME (counterpart of
``libertem_tpu/analysis/raw.py``)."""
from __future__ import annotations

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..common.math import prod  # noqa: F401  (the JAX module's name)
from ..udf.raw import PickUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


class PickFrameAnalysis(BaseAnalysis, id_="PICK_FRAME"):
    def get_coords(self) -> tuple:
        """The frame's nav coordinates; exactly as many as the nav has
        axes (x; x, y; or x, y, z)."""
        nav = tuple(self.dataset.shape.nav)
        p = self.parameters
        expected = {1: ("x",), 2: ("x", "y"),
                    3: ("x", "y", "z")}.get(len(nav))
        if expected is None:
            raise ValueError(
                f"cannot pick from a {len(nav)}D navigation shape")
        given = tuple(k for k in ("x", "y", "z") if p.get(k) is not None)
        if set(given) != set(expected):
            raise ValueError(
                f"for a {len(nav)}D navigation shape, pick needs exactly "
                f"the coordinates {expected}, got {given or ('nothing',)}"
            )
        if len(nav) == 1:
            return (int(p["x"]),)
        coords = (int(p["y"]), int(p["x"]))
        if len(nav) == 3:
            coords = (int(p["z"]),) + coords
        return coords

    def get_udf(self):
        return PickUDF()

    def get_roi(self):
        nav = tuple(self.dataset.shape.nav)
        roi = np.zeros(int(np.prod(nav)), dtype=bool)
        roi[np.ravel_multi_index(self.get_coords(), nav)] = True
        return roi

    def get_udf_results(self, udf_results, roi, damage):
        frame = np.asarray(udf_results["intensity"].data)[0]
        coords_str = ", ".join(str(c) for c in self.get_coords())
        if np.iscomplexobj(frame):
            results = self.get_complex_results(
                frame, key_prefix="intensity",
                title=f"frame ({coords_str})",
                desc="the frame at the selected scan position",
                default_lin=False,
            )
        else:
            # 'intensity' log-scaled, 'intensity_lin' linear
            results = [
                AnalysisResult(
                    raw_data=frame,
                    visualized=lambda: visualize_simple(frame,
                                                        logarithmic=True),
                    key="intensity",
                    title=f"frame ({coords_str}) [log]",
                    desc="the frame at the selected scan position (log)",
                ),
                AnalysisResult(
                    raw_data=frame,
                    visualized=lambda: visualize_simple(frame),
                    key="intensity_lin",
                    title=f"frame ({coords_str}) [lin]",
                    desc="the frame at the selected scan position",
                ),
            ]
        return AnalysisResultSet(results, raw_results=udf_results)
