"""ShardedJobExecutor: every visible CUDA card (counterpart of
``libertem_tpu/executor/sharded.py``).

With one device a run takes the single-device loop, with the same
results and launches as :class:`InlineJobExecutor`.  With several, a
run takes the multi-device loop (``UDFRunner._run_loop_sharded``): one
worker per entry of ``devices``, each with its own shard of the nav
axis, reader, pinned slots and copy stream, in this process.  A device
given twice is two workers on it (``devices=["cuda:0", "cuda:0"]``,
or ``Context.make_with("sharded", tpus=[0, 0])``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .base import JobExecutor


class ShardedJobExecutor(JobExecutor):
    def __init__(self, devices: Optional[Sequence] = None, **kwargs):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            # without a card: [None], which raises naming device="cpu"
            devices = [torch.device("cuda", i) for i in range(n)] or [None]
        super().__init__(devices=devices)

    @classmethod
    def make_local(cls, **kwargs) -> "ShardedJobExecutor":
        return cls()
