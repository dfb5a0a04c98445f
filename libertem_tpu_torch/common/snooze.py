"""Release the device's idle resources after a timeout (counterpart of
``libertem_tpu/common/snooze.py``).

:class:`SnoozeManager` calls ``down()`` after ``timeout`` seconds
without activity and ``up()`` on the next touch.  The port's Context
passes a ``down`` that makes the CUDA caching allocator release its free
blocks (``torch.cuda.empty_cache()``), and nothing on the CPU.

Concurrency:

- ``_snooze_lock`` serializes the up/down transitions, so the
  callbacks never overlap; concurrent calls beyond the first return
  once they see the state changed.
- ``keep_alive`` counts the runs in flight; snooze is refused while
  any runs.
- The background timer only ever calls :meth:`snooze`.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from enum import Enum
from typing import Callable, Optional


class SnoozeMessage(Enum):
    SNOOZE = "snooze"
    UNSNOOZE_START = "unsnooze_start"
    UNSNOOZE_DONE = "unsnooze_done"
    UPDATE_ACTIVITY = "update_activity"


class SnoozeManager:
    def __init__(self, up: Optional[Callable] = None,
                 down: Optional[Callable] = None, timeout: float = 300.0,
                 subscriptions=None):
        if timeout <= 0:
            raise ValueError(f"snooze timeout must be > 0, got {timeout}")
        self._up = up or (lambda: None)
        self._down = down or (lambda: None)
        self._snooze_timeout = timeout
        self._snooze_check_interval = min(1.0, timeout * 0.1)
        self._subs = subscriptions
        # (topics, callback) pairs added with subscribe()
        self._subscribers: list = []
        self._last_activity = time.monotonic()
        self._snoozed = False
        self._keep_alive = 0
        self._closed = False
        # counters and timestamps; never held across a callback
        self._lock = threading.Lock()
        # the up/down transitions; held across the callbacks
        self._snooze_lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._schedule()

    @property
    def is_snoozing(self) -> bool:
        return self._snoozed

    @property
    def keep_alive(self) -> int:
        """The number of runs in flight."""
        return self._keep_alive

    def _emit(self, msg: SnoozeMessage):
        payload = {"timestamp": time.monotonic()}
        if self._subs is not None:
            self._subs.send(msg, payload)
        for topics, callback in self._subscribers:
            if msg in topics:
                try:
                    callback(msg, payload)
                except Exception:  # pragma: no cover
                    pass

    def subscribe(self, topics, callback):
        """``callback(topic, msg_dict)`` for the given
        :class:`SnoozeMessage` topics."""
        self._subscribers.append((tuple(topics), callback))

    def _schedule(self):
        with self._lock:
            if self._closed:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self._snooze_check_interval,
                                          self._check)
            self._timer.daemon = True
            self._timer.start()

    def _check(self):
        if self._closed:
            return
        idle = time.monotonic() - self._last_activity
        if (not self._snoozed and self._keep_alive == 0
                and idle >= self._snooze_timeout):
            self.snooze()
        self._schedule()

    def snooze(self):
        """Release now; refused while a run is in flight."""
        with self._snooze_lock:
            if self._snoozed or self._keep_alive > 0 or self._closed:
                return
            self._snoozed = True
            self._emit(SnoozeMessage.SNOOZE)
            self._down()

    def unsnooze(self):
        with self._snooze_lock:
            if not self._snoozed:
                return
            # the flag flips before up(): an up() that touches the
            # manager must not re-enter this lock
            self._snoozed = False
            self._emit(SnoozeMessage.UNSNOOZE_START)
            self._up()
            self._emit(SnoozeMessage.UNSNOOZE_DONE)
        with self._lock:
            self._last_activity = time.monotonic()

    def _update_last_activity(self):
        with self._lock:
            self._last_activity = time.monotonic()
        self._emit(SnoozeMessage.UPDATE_ACTIVITY)

    def touch(self):
        self._update_last_activity()
        if self._snoozed:
            self.unsnooze()

    @contextlib.contextmanager
    def in_use(self):
        """Snooze is refused inside the block."""
        self.keep_alive_enter()
        try:
            yield
        finally:
            self.keep_alive_exit()

    def keep_alive_enter(self):
        with self._lock:
            self._keep_alive += 1
        self.touch()

    def keep_alive_exit(self):
        with self._lock:
            self._keep_alive = max(0, self._keep_alive - 1)
            self._last_activity = time.monotonic()

    def close(self):
        with self._lock:
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None


def keep_alive(fn):
    """Method decorator: the owner's ``snooze_manager`` (if any) stays
    awake, and is woken, for the call."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        manager = getattr(self, "snooze_manager", None)
        if manager is None:
            return fn(self, *args, **kwargs)
        manager.keep_alive_enter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            manager.keep_alive_exit()
    return wrapper
