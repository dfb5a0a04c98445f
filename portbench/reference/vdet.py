"""The plain reference of the ``vdet`` UDF set: a bright-field disk and
an annular dark-field ring (ApplyMasks), CoM, Sum, SumSig and StdDev."""
from __future__ import annotations

import numpy as np

from reference.plain import SCALES  # noqa: F401
from reference.plain import expected as plain_expected


def disk(sig, cy, cx, r) -> np.ndarray:
    h, w = sig
    y, x = np.mgrid[0:h, 0:w]
    return (((y - cy) ** 2 + (x - cx) ** 2) <= r * r).astype(np.float64)


def ring(sig, cy, cx, r_inner, r_outer) -> np.ndarray:
    """Pixels farther than ``r_inner`` and no farther than ``r_outer``."""
    return disk(sig, cy, cx, r_outer) * (1.0 - disk(sig, cy, cx, r_inner))


def stack(config) -> np.ndarray:
    sig = config["sig"]
    d, r = config["masks"]["disk"], config["masks"]["ring"]
    return np.stack([
        disk(sig, d["cy"], d["cx"], d["r"]),
        ring(sig, r["cy"], r["cx"], r["r_inner"], r["r_outer"]),
    ])


def expected(config, inputs, precision="float64", device="cpu") -> dict:
    return plain_expected(inputs.frames, config["sig"], stack(config),
                          config["com"], precision, device)
