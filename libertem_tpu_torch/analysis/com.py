"""Centre-of-mass analysis, id CENTER_OF_MASS, and its parameter-guess
RPC (counterpart of ``libertem_tpu/analysis/com.py``)."""
from __future__ import annotations

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
# the CoM helpers, importable from here as from the JAX package
from ..udf.com import (  # noqa: F401
    CoMUDF, GuessResult, apply_com_correction, apply_correction,
    center_shifts, com_masks_factory, com_masks_generic, coordinate_check,
    curl_2d, divergence, guess_corrections, magnitude,
)
from ..viz.base import rgb_from_2dvector, visualize_simple
from .base import BaseAnalysis


class COMAnalysis(BaseAnalysis, id_="CENTER_OF_MASS"):
    def get_parameters(self, parameters: dict) -> dict:
        h, w = tuple(self.dataset.shape.sig)
        cx = parameters.get("cx")
        cy = parameters.get("cy")
        return {
            "cx": w / 2 if cx is None else cx,
            "cy": h / 2 if cy is None else cy,
            "r": parameters.get("r"),
            "ri": parameters.get("ri"),
            "flip_y": parameters.get("flip_y") or False,
            "scan_rotation": parameters.get("scan_rotation") or 0.0,
            **{k: v for k, v in parameters.items()
               if k not in ("cx", "cy", "r", "ri", "flip_y",
                            "scan_rotation")},
        }

    def get_udf(self):
        p = self.parameters
        return CoMUDF.with_params(
            cy=p["cy"], cx=p["cx"], r=p["r"], ri=p["ri"],
            scan_rotation=p["scan_rotation"], flip_y=p["flip_y"],
        )

    def need_rerun(self, old_params: dict, new_params: dict) -> bool:
        """flip_y and scan_rotation change only the post-processing of
        the raw shifts: no new UDF pass for them."""
        ignore = {"flip_y", "scan_rotation"}

        def strip(p):
            return {k: v for k, v in p.items() if k not in ignore}

        return strip(old_params) != strip(new_params)

    def get_udf_results(self, udf_results, roi, damage):
        """The fields derived here from the uncorrected raw shifts with
        this analysis's flip_y and scan_rotation, not taken from the
        UDF's own: what makes the ``need_rerun`` short-cut sound."""
        p = self.parameters
        dmg = self.nav_damage(damage)
        raw_shifts = np.asarray(udf_results["raw_shifts"].data)
        is_c = raw_shifts.dtype.kind == "c"
        raw_shifts = raw_shifts.astype(np.complex128 if is_c
                                       else np.float64)
        fy, fx = apply_com_correction(raw_shifts[..., 0],
                                      raw_shifts[..., 1],
                                      p["scan_rotation"], p["flip_y"])
        if is_c:
            # complex data: the split channels only
            chans = []
            for key, title, arr in (
                ("x_real", "x [real]", np.real(fx)),
                ("y_real", "y [real]", np.real(fy)),
                ("x_imag", "x [imag]", np.imag(fx)),
                ("y_imag", "y [imag]", np.imag(fy)),
            ):
                arr32 = arr.astype(np.float32)
                chans.append(AnalysisResult(
                    raw_data=arr32,
                    visualized=lambda a=arr32: visualize_simple(
                        a, damage=dmg),
                    key=key, title=title,
                    desc=f"{title} component of the center",
                ))
            return AnalysisResultSet(chans, raw_results=udf_results)
        # derived in float64, cast after: the same bits as the UDF's own
        # post-processing
        mag = np.sqrt(fy ** 2 + fx ** 2).astype(np.float32)
        if fy.ndim == 2 and min(fy.shape) >= 2:
            div = (np.gradient(fy, axis=0)
                   + np.gradient(fx, axis=1)).astype(np.float32)
            curl = (np.gradient(fy, axis=1)
                    - np.gradient(fx, axis=0)).astype(np.float32)
        else:
            div = np.full_like(mag, np.nan)
            curl = np.full_like(mag, np.nan)
        fy = fy.astype(np.float32)
        fx = fx.astype(np.float32)
        return AnalysisResultSet([
            AnalysisResult(
                # an (x, y) tuple: np.asarray gives (2, *nav)
                raw_data=(fx, fy),
                visualized=lambda: rgb_from_2dvector(fy, fx),
                key="field", title="field",
                desc="center-of-mass shift vector field",
                include_in_download=False,
            ),
            AnalysisResult(
                raw_data=mag,
                visualized=lambda: visualize_simple(mag, damage=dmg),
                key="magnitude", title="magnitude",
                desc="magnitude of the CoM shift",
            ),
            AnalysisResult(
                raw_data=div,
                visualized=lambda: visualize_simple(div, damage=dmg),
                key="divergence", title="divergence",
                desc="divergence of the CoM field",
            ),
            AnalysisResult(
                raw_data=curl,
                visualized=lambda: visualize_simple(curl, damage=dmg),
                key="curl", title="curl",
                desc="curl of the CoM field",
            ),
            AnalysisResult(
                raw_data=fx,
                visualized=lambda: visualize_simple(fx, damage=dmg),
                key="x", title="x shift",
                desc="x component of the CoM shift",
            ),
            AnalysisResult(
                raw_data=fy,
                visualized=lambda: visualize_simple(fy, damage=dmg),
                key="y", title="y shift",
                desc="y component of the CoM shift",
            ),
        ], raw_results=udf_results)

    @classmethod
    def get_rpc_definitions(cls) -> dict:
        return {"guess_parameters": GuessParametersProc}


class GuessParametersProc:
    """The CoM parameter-guess RPC.

    A guessed flip conjugates the old rotation: with
    T(th, f) = R(th)·F(f) and F·R(th) = R(-th)·F, the composition
    T(g, f_g)·T(o, f_o) is R(g + o)·F(f_o) without a guessed flip and
    R(g - o)·F(not f_o) with one.  Adding the rotations in both cases
    would converge only over further guesses; this is exact in one.
    """

    async def __call__(self, rpc_context):
        """``rpc_context``: the web RPC context (the compound analysis,
        the analyses' details and results, ``run_analysis``,
        ``run_sync``).  Runs the CoM analysis if it has no results yet,
        then guesses from its y/x fields."""
        comp_ana = rpc_context.get_compound_analysis()
        analysis_details = [
            rpc_context.get_analysis_details(a)
            for a in comp_ana["details"]["analyses"]
        ]
        com_analyses = [
            a for a in analysis_details
            if a["details"]["analysisType"] == "CENTER_OF_MASS"
        ]
        if not com_analyses:
            return {"status": "error", "message": "no CoM analysis found"}
        com_analysis_id = com_analyses[0]["analysis"]
        if not rpc_context.have_analysis_results(com_analysis_id):
            # with the analysis's parameters as set in the GUI
            await rpc_context.run_analysis(com_analysis_id)
        result_info = rpc_context.get_analysis_results(com_analysis_id)
        res = result_info.results
        old = result_info.details["parameters"]
        guess = await rpc_context.run_sync(
            guess_corrections, res["y"].raw_data, res["x"].raw_data)
        # the y/x fields carry the current rotation and flip, so the
        # guess is relative to them: back to absolute GUI values, the
        # guessed centre transformed into raw detector coordinates
        # (forward is flip, then rotate; the inverse rotates back, then
        # unflips)
        old_rot = float(old.get("scan_rotation", 0.0) or 0.0)
        old_flip = bool(old.get("flip_y", False))
        iy, ix = apply_com_correction(
            np.array([guess["cy"]]), np.array([guess["cx"]]),
            -old_rot, False,
        )
        if old_flip:
            iy = -iy
        if guess["flip_y"]:
            new_rot = guess["scan_rotation"] - old_rot
        else:
            new_rot = guess["scan_rotation"] + old_rot
        return {"status": "ok", "guess": {
            "cy": float(old["cy"]) + float(iy[0]),
            "cx": float(old["cx"]) + float(ix[0]),
            "scan_rotation": new_rot,
            "flip_y": old_flip != guess["flip_y"],
        }}
