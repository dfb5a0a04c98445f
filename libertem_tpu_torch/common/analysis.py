"""AnalysisResult and AnalysisResultSet: what ``Context.run`` returns
(counterpart of ``libertem_tpu/common/analysis.py``)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np


class AnalysisResult:
    """One named result channel: its raw data and a visualised image,
    rendered at first access of ``visualized`` (it needs matplotlib)."""

    def __init__(
        self,
        raw_data: np.ndarray,
        visualized: Union[np.ndarray, Callable, None],
        title: str,
        desc: str,
        key: str,
        include_in_download: bool = True,
    ):
        self.raw_data = raw_data
        self._visualized = visualized
        self.title = title
        self.desc = desc
        self.key = key
        self.include_in_download = include_in_download

    @property
    def visualized(self):
        if callable(self._visualized):
            self._visualized = self._visualized()
        return self._visualized

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.raw_data)
        if dtype is not None:
            arr = arr.astype(dtype)
        return arr

    def __repr__(self):
        return (f"<AnalysisResult: {self.key} "
                f"{np.asarray(self.raw_data).shape}>")


class AnalysisResultSet:
    """A sequence of AnalysisResults, also indexed by key, as an
    attribute or with ``[]``."""

    def __init__(self, results: Sequence[AnalysisResult],
                 raw_results: Optional[dict] = None):
        self._results = list(results)
        self.raw_results = raw_results

    def __getattr__(self, key):
        results = object.__getattribute__(self, "_results")
        for r in results:
            if r.key == key:
                return r
        raise AttributeError(
            "result with key '{}' not found, have: {}".format(
                key, ", ".join(r.key for r in results)
            )
        )

    def __getitem__(self, k):
        if isinstance(k, str):
            return getattr(self, k)
        return self._results[k]

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def keys(self):
        return [r.key for r in self._results]

    def __repr__(self):
        keys = ", ".join(r.key for r in self._results)
        return f"<AnalysisResultSet: [{keys}]>"
