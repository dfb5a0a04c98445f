"""The 90th percentile of a pass's wall time over every pass of the
window (host clock).  A per-layer reading: where the card idles most of
the window, the host alone sets this tail."""
from yardstick.stats import percentile



def read(rec):
    if not rec.spans:
        return None
    return percentile([b - a for a, b in rec.spans], 90)
