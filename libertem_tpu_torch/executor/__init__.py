"""Executors (counterpart of ``libertem_tpu/executor/``): which
devices a run uses, and the host-side utility API around it."""
from .base import Environment, JobExecutor, Worker, WorkerSet
from .compat import (
    ConcurrentJobExecutor,
    DaskJobExecutor,
    DelayedJobExecutor,
    PipelinedExecutor,
    get_dask_integration_executor,
)
from .inline import InlineJobExecutor
from .sharded import ShardedJobExecutor

__all__ = [
    "JobExecutor", "Environment", "Worker", "WorkerSet",
    "InlineJobExecutor", "ShardedJobExecutor",
    "ConcurrentJobExecutor", "DaskJobExecutor",
    "PipelinedExecutor", "DelayedJobExecutor",
    "get_dask_integration_executor",
]
