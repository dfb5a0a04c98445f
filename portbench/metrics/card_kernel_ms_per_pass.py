"""The card's own work a pass: the length of the union of every kernel
and memset interval on the cell's cards inside the window (from the
profiler's trace of the whole window), without the copies, summed over
the cards, over the passes the window completed, in ms.  The window
and the pass count are those of ``card_ms_per_pass``."""
from yardstick.trace import union_length


def read(rec):
    t = rec.trace
    if t is None or not rec.traced_passes:
        return None
    busy = sum(union_length((start, end) for start, end, cat, _ in ivs
                            if cat != "gpu_memcpy")
               for ivs in t.intervals.values())
    if not busy:
        return None
    return busy / rec.traced_passes * 1e3
