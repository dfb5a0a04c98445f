"""Reading a ``torch.profiler`` trace (its Chrome-trace JSON).

Device activity is every kernel, copy and memset on a card.  They
overlap (a copy on a side stream runs under a kernel), so a card's busy
time is the length of the union of their intervals, never their sum.
The window is the host annotation the harness put around the traced
passes.  Each card's device intervals, clipped to the window, are kept
with their category and name, so that a metric's reader can take its
own union of them (say, of the kernels alone).  An idle gap of a card
is named by what the host's main thread (the one that opened the
window) was doing at its middle: the innermost host event that covers
that instant.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
H2D = re.compile(r"HtoD")


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint
    intervals."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def union_length(intervals) -> float:
    return sum(end - start for start, end in merge(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out = []
    at = lo
    for start, end in merge(intervals):
        if end <= lo or start >= hi:
            continue
        if start > at:
            out.append((at, min(start, hi)))
        at = max(at, end)
    if at < hi:
        out.append((at, hi))
    return out


def innermost(host_events, points) -> list:
    """For each instant of ``points``, the name of the shortest of
    ``host_events`` ((start, end, name), one thread's, so nested) that
    covers it, or None."""
    evs = sorted(host_events, key=lambda e: (e[0], -e[1]))
    labels: list = [None] * len(points)
    stack: list = []
    i = 0
    for qi in sorted(range(len(points)), key=points.__getitem__):
        at = points[qi]
        while i < len(evs) and evs[i][0] <= at:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        labels[qi] = stack[-1][2] if stack else None
    return labels


@dataclass
class Summary:
    """A traced window, times in seconds: each card's busy time (the
    union of its device activity inside the window), device time by
    operation name summed over the cards, the host-to-device copies'
    bytes and time (on each card the union of its copies' intervals,
    since copies on side streams overlap; summed over the cards), and
    the idle time of a card by what the host was doing, averaged over
    the cards.  ``intervals``: each card's device activity as
    ``(start, end, category, name)``, clipped to the window, in seconds
    from its start, in the trace's order."""
    window_s: float
    busy_s: dict
    op_s: dict = field(default_factory=dict)
    h2d_bytes: int = 0
    h2d_s: float = 0.0
    idle_by_host: dict = field(default_factory=dict)
    intervals: dict = field(default_factory=dict)

    def matching_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.op_s.items() if rx.search(name))


def summarize(events: list, window_name: str, devices) -> Summary:
    """The :class:`Summary` of Chrome-trace ``events`` inside the host
    annotation ``window_name``, for the cards ``devices``."""
    window = [e for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == window_name]
    if len(window) != 1:
        raise ValueError(f"{len(window)} annotations {window_name!r} "
                         "in the trace, not one")
    w = window[0]
    lo = float(w["ts"])
    hi = lo + float(w["dur"])
    main = (w.get("pid"), w.get("tid"))

    per_dev = defaultdict(list)
    named = defaultdict(list)
    op_us: dict = defaultdict(float)
    h2d = defaultdict(list)
    h2d_bytes = 0
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        start = float(e["ts"])
        end = start + float(e["dur"])
        if cat in DEVICE_CATS:
            args = e.get("args") or {}
            dev = int(args.get("device", e.get("pid", -1)))
            cut = start < lo or end > hi
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            per_dev[dev].append((start, end))
            named[dev].append(((start - lo) / 1e6, (end - lo) / 1e6, cat,
                               e["name"]))
            op_us[e["name"]] += end - start
            if cat == "gpu_memcpy" and H2D.search(e["name"]):
                nbytes = int(args.get("bytes", 0))
                if cut:
                    # a copy cut by the window counts its share of bytes
                    nbytes = round(nbytes * (end - start) / float(e["dur"]))
                h2d_bytes += nbytes
                h2d[dev].append((start, end))
        elif (cat in HOST_CATS and (e.get("pid"), e.get("tid")) == main
              and e is not w):
            host.append((start, end, e["name"]))

    busy = {d: union_length(per_dev.get(d, [])) / 1e6 for d in devices}
    idle: dict = defaultdict(float)
    for d in devices:
        holes = gaps(per_dev.get(d, []), lo, hi)
        names = innermost(host, [(a + b) / 2 for a, b in holes])
        for (a, b), name in zip(holes, names):
            idle[name or f"{window_name} (no host event)"] += (
                (b - a) / 1e6 / len(devices))
    return Summary(
        window_s=(hi - lo) / 1e6, busy_s=busy,
        op_s={k: v / 1e6 for k, v in op_us.items()},
        h2d_bytes=h2d_bytes,
        h2d_s=sum(union_length(ivs) for ivs in h2d.values()) / 1e6,
        idle_by_host=dict(idle),
        intervals={d: named.get(d, []) for d in devices},
    )
