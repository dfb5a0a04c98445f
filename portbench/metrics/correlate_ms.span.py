"""The correlation UDFs' own work a pass, on the host's clock and not
synchronised: the program's span totals (``feed_stats["spans"]``)
``libertem.correlate`` (a block's cast, FFT, product and inverse) plus
``libertem.refine`` (the windows, argmax, centre of mass and result
writes), over the window's passes."""

PARTS = ("libertem.correlate", "libertem.refine")


def read(rec):
    if not rec.feeds:
        return None
    total = 0.0
    for feed in rec.feeds:
        spans = feed.get("spans")
        if not spans or not all(p in spans for p in PARTS):
            return None
        total += sum(spans[p][1] for p in PARTS)
    return total / len(rec.feeds) * 1e3
