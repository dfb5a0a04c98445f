"""Progress reporting (the port's copy of
``libertem_tpu/common/progress.py``).

The run loop reports synchronously: a partition's start, its frames
after each block (at most every ``min_delta`` seconds) and its
completion.  Per-partition frame counters are clamped to each
partition's frame budget, so a completion never counts twice.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import NamedTuple, Optional


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
    ``task_max`` maps partition idents to their frame budgets."""

    def __init__(
        self,
        num_frames_total: int,
        num_part_total: int,
        reporter: Optional[ProgressReporter] = None,
        progress_id: str = "",
        min_delta: float = 0.1,
        task_max: Optional[dict] = None,
    ):
        self._num_frames_total = int(num_frames_total)
        self._num_part_total = int(num_part_total)
        self._progress_id = progress_id
        self._task_max = dict(task_max or {})
        self._counters = {k: 0.0 for k in self._task_max}
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
