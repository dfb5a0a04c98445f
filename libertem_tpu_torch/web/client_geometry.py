"""Single source of truth for the GUI client's overlay and drag
geometry (counterpart of ``libertem_tpu/web/client_geometry.py``):
the formulas live in ONE table shared verbatim between the browser and
the server.

The client (``libertem_tpu_torch/web/client/index.html``, the port's
own copy of the page) embeds the SAME formula table as
``const GEOM_FORMULAS = {...}`` and evaluates entries with
``geomEval`` — a tiny expression evaluator whose semantics match
:func:`geom_eval` below (same function set, same halfway-rounding).
``tests/test_torch_gui_modules.py`` drift-guards the two tables
token-for-token and drives synthetic drag sequences through the
Python side, so a sign or scale change in the overlay math fails a
test even though no JS runtime exists in CI.

Expression subset: numeric literals, variable names, + - * / ( ),
and the functions hypot/min/max/abs/round — valid and identical in
both JS and Python.  ``round`` is floor(v + 0.5) on BOTH sides
(Python's banker rounding and JS's Math.round differ at halves;
the evaluators pin one behavior).
"""
from __future__ import annotations

import math

# ---------------------------------------------------------------
# THE formula table.  Keep in exact sync with the
# `const GEOM_FORMULAS` block in web/client/index.html -- the drift
# guard compares the two structurally (same keys, same expression
# token streams).

FORMULAS = {
    # mouse event -> image data coordinate (one axis): scale the
    # CSS-pixel offset into natural-image pixels
    "data_coord": "(client - rect_min) / rect_size * natural",
    # radius handle: distance from the selector center
    "radius_from_handle": "hypot(x - cx, y - cy)",
    # rect roi drawn corner-to-corner (either direction)
    "rect_x": "min(x0, x1)",
    "rect_y": "min(y0, y1)",
    "rect_w": "abs(x1 - x0)",
    "rect_h": "abs(y1 - y0)",
    # rect roi resize handle (bottom-right): the rect keeps its
    # origin, dimensions stay >= 1
    "rect_w_handle": "max(1, nx - x)",
    "rect_h_handle": "max(1, ny - y)",
    # disk roi drawn center-out
    "disk_r_draw": "hypot(x1 - x0, y1 - y0)",
    # nav picks snap to whole scan positions
    "pick_nav": "round(v)",
    # parameter fields display one decimal
    "snap_field": "round(v * 10) / 10",
    # ring/disk handle placement on the 45-degree diagonal
    "handle_pos": "c + r * 0.7071067811865476",
}


def _round_half_up(v: float) -> float:
    return math.floor(v + 0.5)


_FUNCS = {
    "hypot": math.hypot,
    "min": min,
    "max": max,
    "abs": abs,
    "round": _round_half_up,
}


def geom_eval(name: str, **scope: float) -> float:
    """Evaluate formula ``name`` with the given variables — the
    Python twin of the client's ``geomEval``."""
    expr = FORMULAS[name]
    return float(eval(  # noqa: S307 - fixed expression table
        expr, {"__builtins__": {}}, {**_FUNCS, **scope},
    ))


# ---------------------------------------------------------------
# Drag-flow mirrors: the same sequencing the client's handle
# callbacks perform (drawSigSelector/drawNavRoi/attachPick in
# index.html), expressed over the shared formulas.  Tests drive
# these with synthetic mouse tracks and post the resulting
# parameters to the server.

def event_to_data(client_x, client_y, rect, natural_w, natural_h):
    """Mouse event -> (x, y) in image data coordinates.  ``rect`` is
    (left, top, width, height) of the rendered <img>."""
    left, top, width, height = rect
    x = geom_eval("data_coord", client=client_x, rect_min=left,
                  rect_size=width, natural=natural_w)
    y = geom_eval("data_coord", client=client_y, rect_min=top,
                  rect_size=height, natural=natural_h)
    return x, y


def drag_center(params: dict, x: float, y: float) -> dict:
    """Center handle drag: cx/cy follow the pointer (snapped like
    the client's parameter fields)."""
    return {
        **params,
        "cx": geom_eval("snap_field", v=x),
        "cy": geom_eval("snap_field", v=y),
    }


def drag_radius(params: dict, key: str, x: float, y: float) -> dict:
    """Radius handle drag (r / ri / ro): new radius is the distance
    from the center to the pointer."""
    r = geom_eval("radius_from_handle", x=x, y=y,
                  cx=params["cx"], cy=params["cy"])
    return {**params, key: geom_eval("snap_field", v=r)}


def draw_rect_roi(x0, y0, x1, y1) -> dict:
    """Corner-to-corner rect roi draw (any drag direction)."""
    return {
        "shape": "rect",
        "x": geom_eval("snap_field",
                       v=geom_eval("rect_x", x0=x0, x1=x1)),
        "y": geom_eval("snap_field",
                       v=geom_eval("rect_y", y0=y0, y1=y1)),
        "width": geom_eval("snap_field",
                           v=geom_eval("rect_w", x0=x0, x1=x1)),
        "height": geom_eval("snap_field",
                            v=geom_eval("rect_h", y0=y0, y1=y1)),
    }


def resize_rect_roi(roi: dict, nx: float, ny: float) -> dict:
    """Bottom-right rect handle drag."""
    return {
        **roi,
        "width": geom_eval("snap_field", v=geom_eval(
            "rect_w_handle", nx=nx, x=roi["x"])),
        "height": geom_eval("snap_field", v=geom_eval(
            "rect_h_handle", ny=ny, y=roi["y"])),
    }


def draw_disk_roi(x0, y0, x1, y1) -> dict:
    """Center-out disk roi draw."""
    return {
        "shape": "disk",
        "cx": geom_eval("snap_field", v=x0),
        "cy": geom_eval("snap_field", v=y0),
        "r": geom_eval("snap_field", v=geom_eval(
            "disk_r_draw", x0=x0, y0=y0, x1=x1, y1=y1)),
    }


def pick_nav(x: float, y: float) -> dict:
    """Nav-space click: snap to the nearest scan position."""
    return {
        "x": geom_eval("pick_nav", v=x),
        "y": geom_eval("pick_nav", v=y),
    }


def radius_handle_pos(cx, cy, r):
    """Where the radius handle is rendered (45-degree diagonal) —
    dragging it without moving must keep the radius unchanged."""
    return (
        geom_eval("handle_pos", c=cx, r=r),
        geom_eval("handle_pos", c=cy, r=r),
    )
