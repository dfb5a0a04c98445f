"""The ``strain`` UDF set on the program: ``SparseCorrelationUDF`` with
a radial-gradient template around the expected reflections of the
configuration's lattice, alone in its pass (LiberTEM-blobfinder's
strain-mapping step); no corrections.  The specimen's disks are
rendered into the inputs first (``specimens/lattice.py``), before the
dataset is opened."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

GROUPS = ("correlation",)
SPECIMEN = (Path(__file__).resolve().parent.parent / "specimens"
            / "lattice.py")


def build(lt, config, inputs):
    """``(groups, udfs, corrections)``: each UDF's group name, in
    order, the UDFs, and the CorrectionSet (None)."""
    import torch

    spec = importlib.util.spec_from_file_location(
        "portbench_specimen_lattice", SPECIMEN)
    specimen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(specimen)
    # the same bytes on either device: the card is only faster
    specimen.render(config, inputs,
                    "cuda" if torch.cuda.is_available() else "cpu")
    peaks = np.rint(specimen.nominal(config["specimen"])).astype(np.int32)
    udf = lt.udf.SparseCorrelationUDF(
        lt.udf.RadialGradient(float(config["template_radius"])), peaks,
        steps=int(config["steps"]))
    return GROUPS, [udf], None

