"""The card time a pass costs: the length of the union of every
kernel, copy and memset interval on the cell's cards inside the window
(from the profiler's trace of the whole window), summed over the
cards, over the passes the window completed, in ms."""


def read(rec):
    t = rec.trace
    if t is None or not rec.traced_passes:
        return None
    busy = sum(t.busy_s.values())
    if not busy:
        return None
    return busy / rec.traced_passes * 1e3
