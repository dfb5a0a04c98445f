"""DelayedJobExecutor: lazy UDF results (counterpart of
``libertem_tpu/executor/delayed.py``).

A delayed run returns :class:`DelayedResults` at once: the buffers'
declarations (names, kinds, dtypes, shapes) come from a dry run, which
reads no data and launches no kernel.  The pass runs once, on the
first access to any buffer's data (or ``compute()``), under a lock, so
two threads reaching for data at once run one pass between them.
``to_dask()`` gives a buffer as a ``dask.array`` over the same single
pass (it needs dask, imported there).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from .base import JobExecutor
from .inline import InlineJobExecutor


class DelayedBuffer:
    """A lazy result buffer: its declaration now, its data from the
    shared pass."""

    def __init__(self, name: str, decl, compute: Callable[[], dict],
                 data_shape=None, data_dtype=None):
        self._name = name
        self._decl = decl
        self._compute = compute
        self._data_shape = data_shape
        self._data_dtype = data_dtype

    @property
    def kind(self):
        return self._decl.kind

    @property
    def extra_shape(self):
        return self._decl.extra_shape

    @property
    def dtype(self):
        return self._decl.dtype

    def _materialized(self):
        return self._compute()[self._name]

    @property
    def data(self):
        return self._materialized().data

    @property
    def raw_data(self):
        return self._materialized().raw_data

    @property
    def masked_data(self):
        return self._materialized().masked_data

    @property
    def valid_mask(self):
        return self._materialized().valid_mask

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.data)
        return arr.astype(dtype) if dtype is not None else arr

    def to_dask(self):
        """A ``dask.array`` of the buffer's data; building it runs
        nothing, computing it runs the pass (once)."""
        import dask
        import dask.array as da

        lazy = dask.delayed(
            lambda: np.asarray(self._materialized().data))()
        return da.from_delayed(lazy, shape=self._data_shape,
                               dtype=self._data_dtype)

    def __repr__(self):
        return (f"<DelayedBuffer {self._name!r} kind={self._decl.kind} "
                f"dtype={self._decl.dtype}>")


class DelayedResults(dict):
    """The lazy buffers of one UDF by name."""

    def __init__(self, buffers: dict, compute: Callable[[], dict]):
        super().__init__(buffers)
        self._compute = compute

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def compute(self):
        """Run the pass (if it has not run) and give the eager results
        with the run's damage buffer."""
        from ..api import SingleUDFResults
        return SingleUDFResults(self._compute(),
                                self._compute.full_results().damage)


def make_delayed_results(context, dataset, udfs, single, roi, corrections,
                         progress=False, backends=None):
    """Lazy results of a run of ``udfs`` through ``context``: the pass
    runs once, on the context's devices, at the first access to
    data."""
    decls = [dict(b) for b in
             context._runner(udfs, backends).dry_run(dataset, roi).buffers]
    state = {}
    run_lock = threading.Lock()

    def run_once():
        with run_lock:
            if "results" not in state:
                runner = context._runner(udfs, backends)
                try:
                    state["results"] = runner.run_for_dataset(
                        dataset, context._run_device(), roi=roi,
                        corrections=corrections, progress=progress,
                        devices=context._run_devices())
                finally:
                    context.feed_stats = runner.feed_stats
                    context.run_info = runner.run_info
        return state["results"]

    nav_shape = tuple(dataset.meta.shape.nav)
    sig_shape = tuple(dataset.meta.shape.sig)

    def decl_shape(b):
        extra = tuple(b.extra_shape)
        if b.kind == "nav":
            return nav_shape + extra
        if b.kind == "sig":
            return sig_shape + extra
        return extra

    out = []
    for i, decl in enumerate(decls):
        def compute(i=i):
            return run_once().buffers[i]

        compute.full_results = run_once
        bufs = {
            name: DelayedBuffer(name, b, compute, data_shape=decl_shape(b),
                                data_dtype=np.dtype(b.dtype))
            for name, b in decl.items()
        }
        out.append(DelayedResults(bufs, compute))
    return out[0] if single else out


class DelayedJobExecutor(JobExecutor):
    """Selects the lazy run path; the pass runs on the wrapped eager
    executor (``InlineJobExecutor(device=device)`` without one)."""

    is_delayed = True

    def __init__(self, wrapped: Optional[JobExecutor] = None, device=None,
                 **kwargs):
        self._wrapped = wrapped or InlineJobExecutor(device=device)
        super().__init__(devices=self._wrapped.devices)

    @property
    def main_device(self):
        return self._wrapped.main_device

    @property
    def devices(self):
        return self._wrapped.devices

    @property
    def global_workers(self):
        return getattr(self._wrapped, "global_workers", None)

    def get_available_workers(self):
        return self._wrapped.get_available_workers()

    def run_function(self, fn, *args, **kwargs):
        return self._wrapped.run_function(fn, *args, **kwargs)

    def close(self):
        self._wrapped.close()
