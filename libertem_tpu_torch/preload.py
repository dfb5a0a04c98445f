"""The LIBERTEM_TPU_TORCH_PRELOAD env hook (counterpart of
``libertem_tpu/preload.py``): imports modules named there, separated
by ";", e.g. hdf5plugin before h5py so compressed HDF5 datasets open.
"""
from __future__ import annotations

import importlib
import logging
import os

log = logging.getLogger(__name__)


def do_preloads(env_var: str = "LIBERTEM_TPU_TORCH_PRELOAD"):
    spec = os.environ.get(env_var, "")
    for name in filter(None, (s.strip() for s in spec.split(";"))):
        try:
            importlib.import_module(name)
        except ImportError as e:
            log.warning("preload of %s failed: %s", name, e)


def preload_modules(names):
    """Import the given modules, warning (not crashing) on failure:
    the CLI's --preload flag."""
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError as e:
            log.warning("preload of %s failed: %s", name, e)
