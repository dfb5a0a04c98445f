"""Context: the public entry point (counterpart of
``libertem_tpu/api.py``)."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .common.backend import resolve_device
from .io.corrections import CorrectionSet
from .io.dataset.base import DataSet
from .udf.base import UDF, UDFRunner

# the least partition count of a loaded dataset: the JAX package's
# max(4, 2 x workers), with one worker (the card)
MIN_PARTITIONS = 4


class SingleUDFResults(dict):
    """One UDF's result buffers by name, with attribute access and the
    run's ``damage`` buffer."""

    def __init__(self, buffers: dict, damage):
        super().__init__(buffers)
        self.damage = damage

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


class Context:
    """Loads datasets and runs UDFs on one device: the CUDA card by
    default (raising when there is none), or the CPU when asked for
    with ``device="cpu"``."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        # host feed timings of the last run (HostFeed.stats)
        self.feed_stats: Optional[dict] = None

    def load(self, filetype: str, *args, **kwargs) -> DataSet:
        """``load("memory", data=..., ...)`` or ``load("raw", path=...,
        dtype=..., nav_shape=..., sig_shape=...)``.  Without a given
        ``num_partitions`` the dataset splits into at least
        ``MIN_PARTITIONS`` partitions, as in the JAX package."""
        if filetype == "memory":
            from .io.dataset.memory import MemoryDataSet
            ds = MemoryDataSet(*args, **kwargs)
        elif filetype == "raw":
            from .io.dataset.raw import RawFileDataSet
            ds = RawFileDataSet(*args, **kwargs)
        else:
            raise ValueError(f"unknown or not yet ported format {filetype!r}")
        ds.set_num_cores(MIN_PARTITIONS)
        return ds.initialize()

    def run_udf(
        self,
        dataset: DataSet,
        udf: Union[UDF, Sequence[UDF]],
        roi: Optional[np.ndarray] = None,
        corrections: Optional[CorrectionSet] = None,
    ):
        """Run one or more UDFs over a dataset in a single pass.

        ``roi``: a bool array over the nav positions (nav-shaped or
        flat) selecting the frames to process; nav results hold nan
        (0 for integers) elsewhere.  ``corrections``: dark frame, gain
        map and excluded pixels applied to every frame on the device.

        Returns a dict of result buffers for a single UDF, or a list of
        dicts for a sequence of UDFs."""
        single = isinstance(udf, UDF)
        udfs = [udf] if single else list(udf)
        if not udfs:
            raise ValueError("empty list of UDFs - nothing to do!")
        runner = UDFRunner(udfs)
        results = runner.run_for_dataset(
            dataset, self.device, roi=roi, corrections=corrections,
        )
        self.feed_stats = runner.feed_stats
        wrapped = [
            SingleUDFResults(b, results.damage) for b in results.buffers
        ]
        return wrapped[0] if single else wrapped
