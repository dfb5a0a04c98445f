"""ShardedJobExecutor: every visible CUDA card (counterpart of
``libertem_tpu/executor/sharded.py``).

With one device a run takes the single-device loop, with the same
results and launches as :class:`InlineJobExecutor`.  With several, a
run takes the multi-device loop (``UDFRunner._run_loop_sharded``): one
worker per entry of ``devices``, each with its own shard of the nav
axis, reader, pinned slots and copy stream, in this process.  A device
given twice is two workers on it (``devices=["cuda:0", "cuda:0"]``,
or ``Context.make_with("sharded", tpus=[0, 0])``).

Under an initialised ``torch.distributed`` process group of several
processes (the JAX package's multi-host branch), ``devices`` are this
process's workers (by default the card ``LOCAL_RANK`` names, else
every visible card), and :attr:`global_workers` is every process's,
gathered once here in rank order; every run is one run over all of
them, and every process must construct the executor and make each call
alike (``common/distributed.py``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from ..common.distributed import global_workers, world
from .base import JobExecutor


class ShardedJobExecutor(JobExecutor):
    def __init__(self, devices: Optional[Sequence] = None, **kwargs):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if world()[1] > 1 and n and "LOCAL_RANK" in os.environ:
                devices = [torch.device("cuda",
                                        int(os.environ["LOCAL_RANK"]))]
            else:
                # without a card: [None], which raises naming
                # device="cpu"
                devices = [torch.device("cuda", i)
                           for i in range(n)] or [None]
        super().__init__(devices=devices)
        # (rank, device) of every worker of a run, in every process's
        # order; this process's devices alone with one process
        self.global_workers = global_workers(self._devices)

    @classmethod
    def make_local(cls, **kwargs) -> "ShardedJobExecutor":
        return cls()
