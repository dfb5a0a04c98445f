"""Frame-index to file lookup of a fileset (counterpart of
``libertem_tpu/io/dataset/utils.py``): ``FileTree.make(files)`` over
objects with ``start_idx``/``end_idx``, ``search_start(frame)`` by a
bisect of the sorted starts.
"""
from __future__ import annotations

import bisect
from typing import Any, List, Tuple


class FileTree:
    """Interval index over a fileset: ``search_start(frame)`` returns
    ``(index, file)`` of the file whose [start_idx, end_idx) covers
    the frame."""

    def __init__(self, lows: List[int], highs: List[int],
                 values: List[Any]):
        self._lows = lows
        self._highs = highs
        self._values = values

    @classmethod
    def make(cls, files) -> "FileTree":
        files = list(files)
        if not files:
            raise ValueError("empty fileset")
        lows = [f.start_idx for f in files]
        highs = [f.end_idx for f in files]
        for lo, hi in zip(lows, highs):
            if lo >= hi:
                raise ValueError("low should be < high")
        return cls(lows, highs, files)

    def search_start(self, value: int) -> Tuple[int, Any]:
        i = bisect.bisect_right(self._lows, value) - 1
        if i < 0 or value >= self._highs[i]:
            raise KeyError(
                f"no file covers frame {value}"
            )
        return i, self._values[i]

    def __str__(self):
        return "\n".join(
            f"[{lo}, {hi}) -> #{i}"
            for i, (lo, hi) in enumerate(
                zip(self._lows, self._highs)
            )
        )
