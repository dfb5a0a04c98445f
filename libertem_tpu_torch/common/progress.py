"""Progress reporting (the port's copy of
``libertem_tpu/common/progress.py``).

The run loop reports synchronously: a partition's start, its frames
after each block (at most every ``min_delta`` seconds) and its
completion.  A dataset with task comms may also stream messages
(``ProgressManager.connect`` subscribes the ``handle_*`` callbacks;
a ``PartitionProgressTracker`` sends them).  Per-partition frame
counters are clamped to each partition's frame budget, so a
completion never counts twice.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import NamedTuple, Optional


def get_time():
    """The clock of :class:`PartitionProgressTracker` (a module-level
    function, so tests can patch it)."""
    return time.time()


class ProgressState(NamedTuple):
    """Snapshot passed from ProgressManager to ProgressReporter."""
    #: frames processed
    num_frames_complete: float
    num_frames_total: int
    num_part_complete: int
    num_part_in_progress: int
    num_part_total: int
    progress_id: str


class ProgressReporter:
    """Receives ProgressState snapshots; subclass for UIs."""

    def start(self, state: ProgressState):
        pass

    def update(self, state: ProgressState):
        pass

    def end(self, state: ProgressState):
        pass


class TQDMProgressReporter(ProgressReporter):
    """A tqdm bar (tqdm is imported when the bar starts)."""

    def __init__(self):
        self._bar = None

    def start(self, state: ProgressState):
        import tqdm
        self._bar = tqdm.tqdm(
            total=state.num_frames_total, unit="frame",
            desc=f"run {state.progress_id[:8]}",
        )

    def update(self, state: ProgressState):
        if self._bar is not None:
            delta = state.num_frames_complete - self._bar.n
            if delta > 0:
                self._bar.update(delta)

    def end(self, state: ProgressState):
        if self._bar is not None:
            self.update(state)
            self._bar.close()


class ProgressManager:
    """Tracks completion and forwards updates to a reporter.
    ``task_max`` maps partition idents to their frame budgets;
    ``sig_size``, the pixels of a frame, turns the element counts of
    ``tile_complete`` messages into frames."""

    def __init__(
        self,
        num_frames_total: int,
        num_part_total: int,
        reporter: Optional[ProgressReporter] = None,
        progress_id: str = "",
        min_delta: float = 0.1,
        task_max: Optional[dict] = None,
        sig_size: int = 1,
    ):
        self._num_frames_total = int(num_frames_total)
        self._num_part_total = int(num_part_total)
        self._progress_id = progress_id
        self._task_max = dict(task_max or {})
        self._counters = {k: 0.0 for k in self._task_max}
        self._sig_size = max(1, int(sig_size))
        self._complete: set = set()
        self._in_progress: set = set()
        # frames and partitions reported without a known ident
        self._anon_frames = 0.0
        self._anon_parts = 0
        self._lock = threading.Lock()
        self._reporter = reporter or ProgressReporter()
        self._min_delta = min_delta
        self._last = 0.0
        self._reporter.start(self.state)

    @property
    def state(self) -> ProgressState:
        return ProgressState(
            sum(self._counters.values()) + self._anon_frames,
            self._num_frames_total,
            len(self._complete) + self._anon_parts,
            len(self._in_progress),
            self._num_part_total,
            self._progress_id,
        )

    def partition_start(self, ident):
        with self._lock:
            if ident not in self._complete:
                self._in_progress.add(ident)
        self._reporter.update(self.state)

    def frames_done(self, n: int, ident=None):
        with self._lock:
            if ident is not None and ident in self._task_max:
                self._counters[ident] = min(
                    self._task_max[ident],
                    self._counters.get(ident, 0.0) + n,
                )
            else:
                self._anon_frames += n
        now = time.monotonic()
        if now - self._last >= self._min_delta:
            self._last = now
            self._reporter.update(self.state)

    def partition_done(self, n_frames: int, ident=None):
        """Snap the partition's counter to its budget and report."""
        with self._lock:
            if ident is not None and ident in self._task_max:
                self._counters[ident] = self._task_max[ident]
                self._in_progress.discard(ident)
                self._complete.add(ident)
            else:
                self._anon_frames += n_frames
                self._anon_parts += 1
        self._reporter.update(self.state)

    # -- the message path: a TaskCommHandler's topics -------------------

    def connect(self, comms):
        """Subscribe the ``handle_*`` callbacks on a TaskCommHandler."""
        comms.subscribe("partition_start", self.handle_start_task)
        comms.subscribe("partition_complete", self.handle_end_task)
        comms.subscribe("tile_complete", self.handle_tile_update)

    def handle_start_task(self, topic: str, message: dict):
        if topic != "partition_start":
            raise RuntimeError("Unrecognized topic")
        self.partition_start(message["ident"])

    def handle_end_task(self, topic: str, message: dict):
        if topic != "partition_complete":
            raise RuntimeError("Unrecognized topic")
        t_id = message["ident"]
        with self._lock:
            if t_id in self._task_max:
                self._counters[t_id] = self._task_max[t_id]
            self._in_progress.discard(t_id)
            self._complete.add(t_id)
        self._reporter.update(self.state)

    def handle_tile_update(self, topic: str, message: dict):
        if topic != "tile_complete":
            raise RuntimeError("Unrecognized topic")
        t_id = message["ident"]
        with self._lock:
            if t_id not in self._task_max:
                return
            if self._counters[t_id] >= self._task_max[t_id]:
                return
            self._counters[t_id] = min(
                self._task_max[t_id],
                self._counters[t_id] + message["elements"] / self._sig_size,
            )
        self._reporter.update(self.state)

    def close(self, complete: Optional[bool] = None):
        """End the progress stream.  ``complete`` snaps the counters to
        the totals; by default only when no exception is in flight
        (close also runs when a run fails or its iterator is
        abandoned, which must not report 100%)."""
        if complete is None:
            complete = sys.exc_info()[0] is None
        if complete:
            with self._lock:
                for k in self._task_max:
                    self._counters[k] = self._task_max[k]
                    self._complete.add(k)
                self._in_progress.clear()
                self._anon_frames = (
                    self._num_frames_total - sum(self._counters.values())
                )
                self._anon_parts = (
                    self._num_part_total - len(self._complete)
                )
        self._reporter.end(self.state)


class CommsDispatcher:
    """Drains a WorkerQueue on a background thread, handing each
    ``(topic, message)`` to the topic's callbacks; used by
    ``executor.base.TaskCommHandler.monitor``."""

    def __init__(self, queue, subscriptions: dict):
        self._queue = queue
        self._subscriptions = subscriptions
        self._thread = None

    def __enter__(self):
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._queue.put(("STOP", {}))
        self._thread.join(timeout=10)
        self._thread = None
        return False

    def _drain(self):
        while True:
            with self._queue.get(block=True) as ((topic, msg), _):
                if topic == "STOP":
                    return
                for callback in self._subscriptions.get(topic, ()):
                    try:
                        callback(topic, msg)
                    except Exception:
                        pass


class PartitionTrackerNoOp:
    """The tracker of a partition whose dataset has no task comms: it
    signals nothing."""

    def signal_start(self, *a, **kw):
        pass

    def signal_frames_complete(self, *a, **kw):
        pass

    def signal_complete(self, *a, **kw):
        pass


class PartitionProgressTracker(PartitionTrackerNoOp):
    """Sends one partition's progress through a worker context, at most
    once every ``min_message_interval`` seconds, with the elements done
    since the last message; the first frames are never sent (they
    carry the start-up costs)."""

    def __init__(self, ident: str, worker_context, sig_size: int,
                 min_message_interval: float = 1.0):
        self._ident = ident
        self._worker_context = worker_context
        self._sig_size = int(sig_size)
        self._min_message_interval = min_message_interval
        self._elements_complete = 0
        self._last_message_t = None

    def signal_start(self):
        if self._worker_context is not None:
            self._worker_context.signal(self._ident, "partition_start", {})

    def _should_send(self, elements: int) -> int:
        current_t = get_time()
        self._elements_complete += elements
        if self._last_message_t is None:
            self._last_message_t = current_t
            return 0
        if current_t - self._last_message_t > self._min_message_interval:
            out = self._elements_complete
            self._elements_complete = 0
            self._last_message_t = current_t
            return out
        return 0

    def signal_frames_complete(self, n_frames: int):
        if self._worker_context is None:
            return
        for _ in range(int(n_frames)):
            send = self._should_send(self._sig_size)
            if send:
                self._worker_context.signal(
                    self._ident, "tile_complete", {"elements": send})

    def signal_complete(self):
        if self._worker_context is not None:
            self._worker_context.signal(
                self._ident, "partition_complete", {})
