"""The JAX package's executor names (counterpart of
``libertem_tpu/executor/compat.py``): each maps onto the inline
executor (one device) or the sharded one (every card)."""
from __future__ import annotations

from .base import JobExecutor  # noqa: F401
from .delayed import DelayedJobExecutor  # noqa: F401
from .inline import InlineJobExecutor
from .sharded import ShardedJobExecutor


class ConcurrentJobExecutor(InlineJobExecutor):
    """One device, as the JAX package's: the host feed already
    overlaps reading with the device's work."""

    @classmethod
    def make_local(cls, **kwargs):
        return cls()


class DaskJobExecutor(ShardedJobExecutor):
    """Every card of this process in place of dask workers."""

    @classmethod
    def connect(cls, scheduler_uri=None, **kwargs):
        raise NotImplementedError(
            "connecting to a dask scheduler is not applicable here; "
            "ShardedJobExecutor uses the local CUDA devices"
        )


class PipelinedExecutor(ShardedJobExecutor):
    """The host feed's overlapped reading and copying plays the
    pipelined worker pool's part."""


def get_dask_integration_executor():
    """The executor for dask's scheduler configuration: inline."""
    return InlineJobExecutor()
