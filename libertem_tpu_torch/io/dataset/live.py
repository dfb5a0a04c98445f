"""A live acquisition as a dataset (counterpart of
``libertem_tpu/io/dataset/live.py``): a detector pushes frames into a
bounded ring (``push_frames``, from any thread) while a run reads them
in order, so frames go from host memory to the device without landing
on disk.

The scan's nav shape is declared up front.  An acquisition that stops
early calls ``finish()``: the frames that never came read as zeros, and
the run's damage marks only the frames that did.  The block depth is
capped at half the ring (``get_max_io_size``), so the producer stays a
block ahead of the reader; reads are in ascending order, and a read
skips (frees) the frames below it, so a roi gap wider than the ring
does not deadlock.  A read that waits for frames gives up when the
host feed stops (an abandoned ``run_udf_iter``).
"""
from __future__ import annotations

import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from .base import DataSet, DataSetMeta, Partition, ReadCancelled

# seconds between looks at the feed's stop while a read waits
_POLL_S = 0.1


class FrameRing:
    """A bounded, ordered frame buffer: producers push frames, one
    consumer reads contiguous ranges in ascending order, blocking until
    they are pushed (or the ring is finished)."""

    def __init__(self, n_total: int, sig_shape, dtype,
                 capacity: int = 1024):
        self._n_total = n_total
        self._sig = tuple(sig_shape)
        self._dtype = np.dtype(dtype)
        self._capacity = int(capacity)
        self._buf = np.zeros((self._capacity,) + self._sig, self._dtype)
        self._written = 0   # frames pushed so far
        self._consumed = 0  # frames the reader is done with
        self._finished = False
        self._cv = threading.Condition()

    @property
    def capacity(self) -> int:
        return self._capacity

    def _pieces(self, first: int, n: int) -> tuple:
        """``(ring slice, run slice)`` pairs of frames ``first`` to
        ``first + n``: the run wraps around the ring at most once."""
        pos = first % self._capacity
        head = min(n, self._capacity - pos)
        return ((slice(pos, pos + head), slice(0, head)),
                (slice(0, n - head), slice(head, n)))

    def push_frames(self, frames: np.ndarray) -> None:
        """Append frames, waiting while the ring is full."""
        frames = np.asarray(frames, dtype=self._dtype).reshape(
            (-1,) + self._sig)
        i = 0
        while i < len(frames):
            with self._cv:
                self._cv.wait_for(
                    lambda: self._written - self._consumed < self._capacity)
                take = min(self._capacity - (self._written - self._consumed),
                           len(frames) - i)
                run = frames[i:i + take]
                for ring, part in self._pieces(self._written, take):
                    self._buf[ring] = run[part]
                self._written += take
                i += take
                self._cv.notify_all()

    def finish(self) -> None:
        """No more frames: reads past the last pushed one get zeros."""
        with self._cv:
            self._finished = True
            self._cv.notify_all()

    @property
    def frames_received(self) -> int:
        with self._cv:
            return self._written

    def read(self, start: int, stop: int, out: Optional[np.ndarray] = None,
             cancel: Optional[threading.Event] = None) -> np.ndarray:
        """Frames [start, stop) into ``out`` (a new array without one),
        zeros for frames that never arrive before ``finish()``; blocks
        until they are pushed, or raises ReadCancelled once ``cancel``
        is set.  A read of more frames than the ring holds raises
        ValueError, one below a frame already freed RuntimeError."""
        if stop - start > self._capacity:
            # the producer cannot get more than the ring ahead of the
            # reader: this read could never be served
            raise ValueError(
                f"read of {stop - start} frames exceeds the ring "
                f"capacity {self._capacity}; raise ring_capacity or "
                "lower the block size"
            )
        if out is None:
            out = np.empty((stop - start,) + self._sig, self._dtype)
        with self._cv:
            if start < self._consumed:
                raise RuntimeError(
                    f"FrameRing read at {start} regresses behind "
                    f"already-freed frame {self._consumed}; ring "
                    "reads must be in ascending order"
                )
            # everything below `start` (frames a roi skips) is done
            # with: free it before waiting, or a gap wider than the
            # ring would deadlock producer and reader
            if start > self._consumed:
                self._consumed = start
                self._cv.notify_all()
            while not (self._written >= stop or self._finished):
                if cancel is not None and cancel.is_set():
                    raise ReadCancelled()
                self._cv.wait(_POLL_S)
            hi = max(start, min(stop, self._written))
            for ring, part in self._pieces(start, hi - start):
                out[part] = self._buf[ring]
            out[hi - start:] = 0
            self._consumed = max(self._consumed, hi)
            self._cv.notify_all()
        return out


class LivePartition(Partition):
    def __init__(self, ring: FrameRing, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ring = ring

    def _read_raw_frames(self, start, stop, out):
        self._ring.read(start, stop, out, cancel=self.stop_event)


class LiveDataSet(DataSet):
    """Declare the acquisition's shape, then ``push_frames`` (in
    acquisition order, from any thread) while a run reads them; the
    ring's capacity is the backpressure.  The ring has one reader, in
    order: ``supports_concurrent_reads`` is False."""

    supports_concurrent_reads = False

    def __init__(self, nav_shape: Sequence[int], sig_shape: Sequence[int],
                 dtype="float32", ring_capacity: int = 1024, **kwargs):
        super().__init__(**kwargs)
        nav_shape = tuple(int(x) for x in nav_shape)
        sig_shape = tuple(int(x) for x in sig_shape)
        self._meta = DataSetMeta(
            shape=Shape(nav_shape + sig_shape, sig_dims=len(sig_shape)),
            raw_dtype=np.dtype(dtype),
        )
        self.ring = FrameRing(self._meta.shape.nav.size, sig_shape, dtype,
                              capacity=ring_capacity)

    def initialize(self) -> "LiveDataSet":
        return self

    @classmethod
    def get_supported_io_backends(cls) -> list:
        return []

    def get_max_io_size(self) -> int:
        """Half the ring's frames: the block depth stays below the
        ring's capacity, and the producer a block ahead."""
        frame_bytes = (self._meta.shape.sig.size
                       * self._meta.raw_dtype.itemsize)
        return self.max_inflight_frames * frame_bytes

    @property
    def max_inflight_frames(self) -> int:
        """The largest read a consumer may have outstanding."""
        return max(1, self.ring.capacity // 2)

    def frames_valid_count(self) -> int:
        """Frames pushed so far: the run's damage stops there after an
        early ``finish()``."""
        return self.ring.frames_received

    def push_frames(self, frames: np.ndarray) -> None:
        self.ring.push_frames(frames)

    def finish(self) -> None:
        self.ring.finish()

    def get_partitions(self) -> Iterator[LivePartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield LivePartition(
                self.ring, self.meta, start, stop - start, idx=idx,
            )
