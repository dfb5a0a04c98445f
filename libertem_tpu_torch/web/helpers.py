"""Executor construction for the web API (counterpart of
``libertem_tpu/web/helpers.py``): a ``"local"`` GUI connection is
:meth:`ShardedJobExecutor.make_local`, every visible CUDA card, and
raises without one, as ``Context()`` does.
"""
from __future__ import annotations


def _int_or_zero(value) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return 0


def _convert_device_map(raw_cudas: dict) -> list:
    """{device_id: count} -> flat device list."""
    return [
        this_id
        for dev_id, num in raw_cudas.items()
        for this_id in [dev_id] * _int_or_zero(num)
    ]


def create_executor(*, connection: dict, local_directory=None,
                    preload=(), snooze_timeout=None):
    """The sync executor of a ``"local"`` GUI connection: every
    visible CUDA card (:meth:`ShardedJobExecutor.make_local`).

    ``numWorkers`` is validated (a positive int) and recorded on the
    executor as the advertised CPU-worker count of the cluster page.
    The GUI's ``cudas`` map is validated and then ignored, as in the
    JAX package: the executor takes every card.
    """
    num_workers = None
    if "numWorkers" in connection:
        num_workers = connection["numWorkers"]
        if not isinstance(num_workers, int) or num_workers < 1:
            raise ValueError(
                "Number of workers must be positive integer"
            )
    _convert_device_map(connection.get("cudas", {}) or {})
    from ..executor.sharded import ShardedJobExecutor
    executor = ShardedJobExecutor.make_local()
    if num_workers is not None:
        executor._cpu_workers = num_workers
    return executor


def create_executor_external(
    executor_spec: dict, local_directory=None, preload=(),
    snooze_timeout=None,
) -> tuple:
    """(AsyncAdapter-wrapped executor, connection params) from a
    ``--cpus``-style spec ``{"cpus": n, "cudas": m}``."""
    cudas: dict = {}
    if executor_spec.get("cudas"):
        cudas[0] = executor_spec["cudas"]
    params = {
        "connection": {
            "type": "LOCAL",
            "numWorkers": executor_spec["cpus"],
            "cudas": cudas,
        }
    }
    sync_executor = create_executor(
        connection=params["connection"],
        local_directory=local_directory,
        preload=preload,
        snooze_timeout=snooze_timeout,
    )
    from ..executor.async_adapter import AsyncAdapter
    pool = AsyncAdapter.make_pool()
    executor = AsyncAdapter(wrapped=sync_executor, pool=pool)
    return executor, params
