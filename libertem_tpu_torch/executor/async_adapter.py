"""AsyncAdapter: a synchronous executor for async callers (counterpart
of ``libertem_tpu/executor/async_adapter.py``); each call runs on a
thread of its pool."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from ..common.async_utils import sync_to_async


class AsyncAdapter:
    def __init__(self, wrapped, pool=None):
        self._wrapped = wrapped
        self._own_pool = pool is None
        self._pool = pool or ThreadPoolExecutor(max_workers=2)

    @staticmethod
    def make_pool():
        return ThreadPoolExecutor(max_workers=4)

    @property
    def snooze_manager(self):
        return getattr(self._wrapped, "_snooze_manager", None)

    @property
    def devices(self):
        return self._wrapped.devices

    @property
    def main_device(self):
        return self._wrapped.main_device

    def ensure_sync(self):
        return self._wrapped

    def ensure_async(self, pool=None):
        return self

    async def run_function(self, fn: Callable, *args, **kwargs):
        return await sync_to_async(fn, *args, pool=self._pool, **kwargs)

    async def get_available_workers(self):
        return await sync_to_async(self._wrapped.get_available_workers,
                                   pool=self._pool)

    async def get_resource_details(self):
        return await sync_to_async(self._wrapped.get_resource_details,
                                   pool=self._pool)

    async def cancel(self, cancel_id):
        """Forwarded where the wrapped executor can cancel; the
        in-process executors keep no job table, so nothing else."""
        fn = getattr(self._wrapped, "cancel", None)
        if fn is not None:
            await sync_to_async(fn, cancel_id, pool=self._pool)

    async def close(self):
        await sync_to_async(self._wrapped.close, pool=self._pool)
        if self._own_pool:
            # a pool handed in may be shared: only our own goes
            self._pool.shutdown(wait=False)
