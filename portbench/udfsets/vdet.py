"""The ``vdet`` UDF set on the program: a bright-field disk and an
annular dark-field ring (ApplyMasks), CoM in a disk, Sum, SumSig and
StdDev, in one pass (the README quick start's set); no corrections."""
from __future__ import annotations

GROUPS = ("masks", "com", "sum", "sumsig", "stddev")


def build(lt, config, inputs):
    """``(groups, udfs, corrections)``: each UDF's group name, in
    order, the UDFs, and the CorrectionSet (None)."""
    h, w = config["sig"]
    d, r = config["masks"]["disk"], config["masks"]["ring"]
    c = config["com"]
    udfs = [
        lt.ApplyMasksUDF(mask_factories=[
            lambda: lt.masks.circular(d["cx"], d["cy"], w, h, d["r"]),
            lambda: lt.masks.ring(r["cx"], r["cy"], w, h, r["r_outer"],
                                  r["r_inner"]),
        ]),
        lt.CoMUDF.with_params(cy=c["cy"], cx=c["cx"], r=c["r"]),
        lt.SumUDF(), lt.SumSigUDF(), lt.StdDevUDF(),
    ]
    return GROUPS, udfs, None
