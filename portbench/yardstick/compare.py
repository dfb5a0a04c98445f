"""The comparison that decides ``correct``.

Each UDF of a set is a group (``masks``, ``com``, ...), and each group
is one number compared: the largest, over the group's result buffers,
of a buffer's error, which is the largest absolute difference between
the program's value and the reference's, over the largest magnitude of
the reference's buffer, or of the buffer the reference names as the
group's scale (CoM's shifts, field, divergence and curl are
differences of centres of mass: their error is in pixels, as the
centres', and is taken over the centres' magnitude).  A buffer that one
side lacks, of another shape, or with a nan where the reference has
none, reads infinite.
Each group's number has a limit of its own, in the configuration's
``limits``.
"""
from __future__ import annotations

import math

import numpy as np


def buffer_error(got, want, scale=None) -> float:
    """``max |got - want|`` over the largest magnitude of ``scale``
    (default: ``want``)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return math.inf
    both_nan = np.isnan(got) & np.isnan(want)
    diff = np.where(both_nan, 0.0, np.abs(got - want))
    if np.isnan(diff).any():
        return math.inf
    worst = float(diff.max(initial=0.0))
    if worst == 0.0:
        return 0.0
    ref = want if scale is None else np.asarray(scale, dtype=np.float64)
    magnitude = float(np.nanmax(np.abs(ref), initial=0.0))
    return worst / magnitude if magnitude > 0 else math.inf


def group_errors(got: dict, want: dict, scales=None) -> dict:
    """``{group: error}`` of the program's buffers ``got`` against the
    reference's ``want`` (both ``{group: {buffer: array}}``);
    ``scales``: ``{group: buffer}``, the reference's buffer whose
    magnitude scales every error of the group."""
    scales = scales or {}
    out = {}
    for group in sorted(set(got) | set(want)):
        g, w = got.get(group), want.get(group)
        if g is None or w is None or set(g) != set(w):
            out[group] = math.inf
            continue
        scale = w[scales[group]] if group in scales else None
        out[group] = max([buffer_error(g[n], w[n], scale) for n in w]
                         or [0.0])
    return out


def checks(errors: dict, limits: dict) -> list:
    """``(name, value, limit, held)`` for every group compared; a group
    without a limit, or a limit without a group, does not hold."""
    out = []
    for name in sorted(set(errors) | set(limits)):
        value = errors.get(name, math.inf)
        limit = limits.get(name)
        held = limit is not None and value <= float(limit)
        out.append((name, value, limit, held))
    return out
