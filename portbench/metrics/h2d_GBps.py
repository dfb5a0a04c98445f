"""Host-to-device copies: their bytes over their time on the link, from
the profiler's trace of the traced passes.  A card's copy time is the
union of its copies' intervals (copies on side streams overlap, so more
overlap reads as a faster link, not a slower one), summed over the
cards."""


def read(rec):
    t = rec.trace
    if t is None or not t.h2d_bytes or not t.h2d_s:
        return None
    return t.h2d_bytes / t.h2d_s / 1e9
