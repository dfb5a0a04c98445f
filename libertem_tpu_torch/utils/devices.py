"""Device detection (counterpart of ``libertem_tpu/utils/devices.py``):
the host's cores and the CUDA cards torch sees.  There is no CuPy and
no TPU here: ``has_cupy`` is False and ``tpus`` empty."""
from __future__ import annotations

import os
from typing import TypedDict

import torch


class DetectResult(TypedDict):
    cpus: list
    cudas: list
    has_cupy: bool
    tpus: list
    has_tpu: bool


def detect() -> DetectResult:
    """``cpus``: one index a physical core (psutil where it imports,
    else ``os.cpu_count()``); ``cudas``: the indices of the CUDA
    devices, ``range(torch.cuda.device_count())``."""
    cpus = None
    try:
        import psutil
        cpus = psutil.cpu_count(logical=False) or psutil.cpu_count()
    except Exception:
        pass
    if cpus is None:
        cpus = os.cpu_count() or 1
    cudas = list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []
    return {
        "cpus": list(range(int(cpus))),
        "cudas": cudas,
        "has_cupy": False,
        "tpus": [],
        "has_tpu": False,
    }


def has_cupy() -> bool:
    """Always False: the port's device arrays are torch tensors."""
    return False
