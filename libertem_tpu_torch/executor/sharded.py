"""ShardedJobExecutor: every visible CUDA card (counterpart of
``libertem_tpu/executor/sharded.py``).

With one device a run takes the single-device loop, with the same
results and launches as :class:`InlineJobExecutor`.  The multi-device
loop (the JAX package's ``_run_loop_sharded``) is not ported yet: a
run on more than one device raises NotImplementedError rather than
using one of them.
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
