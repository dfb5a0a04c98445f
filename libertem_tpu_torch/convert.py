"""Carry the JAX package's run parameters over to the port.

The system has no weights: what a run is parameterised by is the fused
mask stack and the per-UDF specs that ``_build_fused_plan`` derives
from the UDFs' parameters.  :func:`fused_plan_from_numpy` takes that
plan as plain numpy/dicts and gives the port's :class:`FusedPlan`,
so the two packages' plans can be held against each other.
"""
from __future__ import annotations

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
