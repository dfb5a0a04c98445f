"""Structural helpers of the executors (counterpart of
``libertem_tpu/executor/utils/``)."""
from . import delayed_unpack  # noqa: F401
