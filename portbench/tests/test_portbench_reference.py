"""The plain reference against an independent float64 NumPy computation
of a tiny scan, for every configuration, and the lower precisions of
the controls against hand figures."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from yardstick import cells, compare, data  # noqa: E402


def _config(name, nav=(3, 5)):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    config["nav"] = list(nav)
    return config


def _dist2(sig, cy, cx):
    h, w = sig
    out = np.empty((h, w))
    for y in range(h):
        for x in range(w):
            out[y, x] = (y - cy) ** 2 + (x - cx) ** 2
    return out


def _masks_by_hand(config):
    sig = config["sig"]
    d, ring = config["masks"]["disk"], config["masks"]["ring"]
    d2 = _dist2(sig, d["cy"], d["cx"])
    r2 = _dist2(sig, ring["cy"], ring["cx"])
    return [d2 <= d["r"] ** 2,
            (r2 > ring["r_inner"] ** 2) & (r2 <= ring["r_outer"] ** 2)]


def _by_hand(config, inputs):
    nav = tuple(config["nav"])
    f = inputs.frames.reshape((-1,) + tuple(config["sig"])).astype(
        np.float64)
    n = f.shape[0]
    masks = _masks_by_hand(config)
    intensity = np.stack([(f * mk).sum(axis=(1, 2)) for mk in masks], -1)
    c = config["com"]
    disk = _dist2(config["sig"], c["cy"], c["cx"]) <= c["r"] ** 2
    ys, xs = np.nonzero(disk)
    mass = f[:, ys, xs].sum(axis=1)
    com_y = (f[:, ys, xs] * ys).sum(axis=1) / mass
    com_x = (f[:, ys, xs] * xs).sum(axis=1) / mass
    sy = (com_y - c["cy"]).reshape(nav)
    sx = (com_x - c["cx"]).reshape(nav)
    mean = f.mean(axis=0)
    var = f.var(axis=0)
    return {
        "masks": {"intensity": intensity.reshape(nav + (len(masks),))},
        "com": {
            "raw_com": np.stack([com_y, com_x], -1).reshape(nav + (2,)),
            "raw_shifts": np.stack([sy, sx], -1),
            "field": np.stack([sy, sx], -1),
            "field_y": sy, "field_x": sx,
            "magnitude": np.sqrt(sy ** 2 + sx ** 2),
            "divergence": np.gradient(sy, axis=0) + np.gradient(sx, axis=1),
            "curl": np.gradient(sy, axis=1) - np.gradient(sx, axis=0),
            "regression": np.zeros((3, 2)),
        },
        "sum": {"intensity": f.sum(axis=0)},
        "sumsig": {"intensity": f.sum(axis=(1, 2)).reshape(nav)},
        "stddev": {"num_frames": np.array([float(n)]),
                   "sum": f.sum(axis=0), "varsum": var * n, "var": var,
                   "std": np.sqrt(var), "mean": mean},
    }


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "configs").glob("*.json")))
def test_reference_against_numpy(name):
    config = _config(name)
    inputs = data.make_inputs(config, 2**32 + 7, "cpu")
    reference = cells.load_module("reference", config["udfset"])
    got = reference.expected(config, inputs, "float64", "cpu")
    want = _by_hand(config, inputs)
    assert set(got) == set(want)
    for group in want:
        assert set(got[group]) == set(want[group]), group
        for buf, arr in want[group].items():
            np.testing.assert_allclose(got[group][buf], arr, rtol=1e-12,
                                       atol=1e-9, err_msg=f"{group}.{buf}")


def test_tf32_rounding():
    import torch

    from reference.plain import _tf32
    x = torch.tensor([1 + 2**-12, 1 + 2**-11, 1 + 3 * 2**-11, -1 - 2**-11,
                      3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0, 1 + 2**-10, 1 + 2**-9, -1 - 2**-10,
                                 3.0]


def test_controls_differ_as_their_precision_does():
    config = _config("vdet-u16", nav=(4, 8))
    inputs = data.make_inputs(config, 11, "cpu")
    reference = cells.load_module("reference", config["udfset"])
    want = reference.expected(config, inputs, "float64", "cpu")
    tf32 = compare.group_errors(
        reference.expected(config, inputs, "tf32", "cpu"), want,
        reference.SCALES)
    bf16 = compare.group_errors(
        reference.expected(config, inputs, "bf16", "cpu"), want,
        reference.SCALES)
    # integer counts and 0/1 masks are exact in TF32; bfloat16 keeps 8
    # bits of every kept value
    assert tf32["masks"] == 0.0 and tf32["sum"] == 0.0
    assert min(bf16.values()) > 1e-4
