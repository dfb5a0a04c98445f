"""Carry the JAX package's run parameters over to the port.

The system has no weights: what a run is parameterised by is the fused
mask stack and the per-UDF specs that ``_build_fused_plan`` derives
from the UDFs' parameters, and the detector-correction plan that
``CorrectionSet.make_plan`` derives from a dark frame, a gain map and
the excluded pixels.  :func:`fused_plan_from_numpy` and
:func:`correction_plan_from_numpy` take those plans as plain
numpy/dicts and give the port's, so the two packages' plans can be
held against each other.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .udf.base import FusedPlan


def fused_plan_from_numpy(masks_t, specs) -> FusedPlan:
    """``masks_t``: (M, pixels) mask stack; ``specs``: one dict per UDF
    with ``ui``, ``mode`` and, by mode, ``name``, ``off``, ``n``."""
    modes = {s["mode"] for s in specs}
    unknown = modes - {"masks", "sumsig", "colsum", "stats"}
    if unknown:
        raise ValueError(f"fused modes not ported: {sorted(unknown)}")
    return FusedPlan(
        masks_t=np.ascontiguousarray(masks_t, dtype=np.float32),
        specs=[dict(s) for s in specs],
        need_var="stats" in modes,
        need_colsum=bool(modes & {"colsum", "stats"}),
    )


_CORRECTION_DTYPES = {
    "dark": np.float32,
    "gain": np.float32,
    "repair_idx": np.int32,
    "nbr_idx": np.int32,
    "nbr_w": np.float32,
}


def correction_plan_from_numpy(plan: Optional[dict]) -> Optional[dict]:
    """``plan``: the dict of ``CorrectionSet.make_plan(sig_shape)``
    (``dark``, ``gain``, ``repair_idx``, ``nbr_idx``, ``nbr_w``, each
    an array or None), or None for no corrections; returns the port's
    plan, as ``io.corrections.CorrectionSet.make_plan`` gives it."""
    if plan is None:
        return None
    unknown = set(plan) - set(_CORRECTION_DTYPES)
    if unknown:
        raise ValueError(f"unknown correction plan keys: {sorted(unknown)}")
    return {
        key: None if plan.get(key) is None
        else np.ascontiguousarray(plan[key], dtype=dtype)
        for key, dtype in _CORRECTION_DTYPES.items()
    }
