"""Internal event bus: forward messages from any thread to the
websocket clients (counterpart of ``libertem_tpu/web/event_bus.py``).

The bus is a plain thread-safe queue so non-async code (snooze
timers, executor callbacks) can publish GUI messages; the pump
drains it on the web API's event loop and broadcasts.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import queue

log = logging.getLogger(__name__)


class EventBus:
    def __init__(self):
        self._queue: queue.Queue = queue.Queue()

    def send(self, msg: dict):
        self._queue.put(msg)

    def get(self, timeout: float = 1.0) -> dict:
        """Blocking get — call from a sync context or a dedicated
        thread only; raises ``queue.Empty`` on timeout."""
        return self._queue.get(block=True, timeout=timeout)


class MessagePump:
    """Drains an :class:`EventBus` onto an ``EventRegistry``
    (runs as a background task on the server's event loop)."""

    def __init__(self, event_bus: EventBus, event_registry):
        self._event_bus = event_bus
        self._event_registry = event_registry

    async def run(self):
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=1
        ) as pool:
            loop = asyncio.get_running_loop()
            while True:
                try:
                    msg = await loop.run_in_executor(
                        pool, self._event_bus.get
                    )
                    await self._event_registry.broadcast_event(msg)
                except queue.Empty:
                    pass
