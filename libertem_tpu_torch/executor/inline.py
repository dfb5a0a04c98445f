"""InlineJobExecutor: runs in the caller's process on one device
(counterpart of ``libertem_tpu/executor/inline.py``)."""
from __future__ import annotations

import os
from typing import Optional

from .base import JobExecutor, Worker, WorkerSet, _resource_key


class InlineJobExecutor(JobExecutor):
    """One device: the CUDA card without ``device`` (raising without
    one), or the device given (``"cpu"``, ``"cuda:1"``).  ``debug``
    round-trips the UDFs through pickle before every run, so an
    unpicklable parameter fails fast with UDFException.
    ``inline_threads`` is the UDFs' ``meta.threads_per_worker`` (else
    one a core); ``main_process_gpu`` is accepted as in the JAX
    package."""

    def __init__(self, device=None, debug: bool = False,
                 inline_threads: Optional[int] = None,
                 main_process_gpu=None, **kwargs):
        super().__init__(devices=[device])
        self._debug = debug
        self._inline_threads = inline_threads
        self._main_process_gpu = main_process_gpu

    @property
    def threads_per_worker(self) -> int:
        if self._inline_threads is not None:
            return int(self._inline_threads)
        return os.cpu_count() or 1

    def run_each_worker(self, fn, *args, **kwargs) -> dict:
        return {"inline": fn(*args, **kwargs)}

    def get_available_workers(self) -> WorkerSet:
        d = self.main_device
        return WorkerSet([Worker(
            name="inline", host="localhost", device=d,
            resources={"compute": 1, _resource_key(d): 1},
            nthreads=self.threads_per_worker,
        )])
