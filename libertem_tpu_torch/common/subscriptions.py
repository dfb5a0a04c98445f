"""Topic -> callback subscriptions (counterpart of
``libertem_tpu/common/subscriptions.py``): the executor's run events
(``run_udf:start``/``run_udf:end``) and the snooze messages go
through one of these."""
from __future__ import annotations

import logging
import threading
import uuid
from typing import Any, Callable

log = logging.getLogger(__name__)


class SubscriptionManager:
    def __init__(self):
        self._subs: dict[str, dict[str, Callable]] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, callback: Callable) -> str:
        """Call ``callback(topic, message)`` on every message of
        ``topic``; returns the key for :meth:`unsubscribe`."""
        key = str(uuid.uuid4())
        with self._lock:
            self._subs.setdefault(topic, {})[key] = callback
        return key

    def unsubscribe(self, key: str) -> bool:
        with self._lock:
            for name, topic in list(self._subs.items()):
                if key in topic:
                    del topic[key]
                    if not topic:
                        del self._subs[name]
                    return True
        return False

    def send(self, topic: str, message: Any):
        """Deliver ``message`` to the topic's subscribers, outside the
        lock; a subscriber that raises is logged, not propagated."""
        with self._lock:
            callbacks = list(self._subs.get(topic, {}).values())
        for cb in callbacks:
            try:
                cb(topic, message)
            except Exception:
                log.exception("subscriber for topic %r raised", topic)
