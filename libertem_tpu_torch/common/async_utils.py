"""Bridges between synchronous code and asyncio (counterpart of
``libertem_tpu/common/async_utils.py``): a call on a pool thread, a
generator drained lazily or eagerly into an async generator, and the
last item of either kind of generator."""
from __future__ import annotations

import asyncio
import queue as queue_mod
import threading
from typing import AsyncGenerator, Callable, Generator, TypeVar

T = TypeVar("T")


class MyStopIteration(Exception):
    """Carries ``StopIteration`` across a future (raising
    StopIteration into a Future is a TypeError)."""


async def sync_to_async(fn: Callable[..., T], *args, pool=None,
                        **kwargs) -> T:
    """``fn(*args, **kwargs)`` on a thread of ``pool`` (the loop's
    default pool without one)."""
    loop = asyncio.get_running_loop()

    def _call():
        try:
            return fn(*args, **kwargs)
        except StopIteration as e:
            raise MyStopIteration() from e

    return await loop.run_in_executor(pool, _call)


async def async_generator(gen: Generator, pool=None) -> AsyncGenerator:
    """Lazy bridge: each ``__anext__`` advances ``gen`` by one item on
    a pool thread.  :func:`async_generator_eager` lets it run ahead."""
    loop = asyncio.get_running_loop()

    def _next():
        try:
            return next(gen)
        except StopIteration:
            raise MyStopIteration()

    while True:
        try:
            item = await loop.run_in_executor(pool, _next)
        except MyStopIteration:
            break
        yield item


async def async_generator_eager(gen: Generator, pool=None,
                                queue_size: int = 0) -> AsyncGenerator:
    """Drain ``gen`` on a producer thread of its own and yield its
    items asynchronously; the producer runs ahead without bound, or by
    at most ``queue_size`` items.  ``gen`` runs, and is closed, on the
    producer thread only: when the consumer goes away (``aclose()``, an
    exception) the producer stops at its next put -- a put blocked on a
    full queue included -- and closes ``gen`` there, so its cleanup
    runs where it ran.  ``pool`` is accepted as in the JAX package."""
    # a plain thread-safe queue: put/get are atomic, so no timeout or
    # cancellation can duplicate or drop an item
    q: queue_mod.Queue = queue_mod.Queue(maxsize=queue_size)
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def produce():
        try:
            try:
                for item in gen:
                    if not _put(("item", item)):
                        return
                _put(("done", done))
            except BaseException as e:
                _put(("error", e))
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    thread = threading.Thread(target=produce, daemon=True,
                              name="async-generator-producer")
    thread.start()

    def _get():
        # bounded waits: to_thread's cancellation does not interrupt a
        # blocking get
        while True:
            try:
                return q.get(timeout=0.1)
            except queue_mod.Empty:
                if stop.is_set() or not thread.is_alive():
                    # abandoned, or the producer died without a word
                    if q.empty():
                        return ("done", done)

    try:
        while True:
            kind, payload = await asyncio.to_thread(_get)
            if kind == "done":
                break
            if kind == "error":
                raise payload
            yield payload
    finally:
        # no join on the event loop: the producer sees `stop` within
        # its put timeout and closes `gen` itself
        stop.set()


def run_gen_get_last(gen: Generator[T, None, None]) -> T:
    """Exhaust a generator, return its last item."""
    have = False
    result = None
    for result in gen:
        have = True
    if not have:
        raise RuntimeError("generator produced no items")
    return result


async def run_agen_get_last(gen: AsyncGenerator[T, None]) -> T:
    """Exhaust an async generator, return its last item."""
    have = False
    result = None
    async for result in gen:
        have = True
    if not have:
        raise RuntimeError("async generator produced no items")
    return result
