"""The fold of the workers' states and the wrap of the results, a pass,
not synchronised: the program's span totals (``feed_stats["spans"]``,
host clock) ``libertem.fold`` plus ``libertem.wrap`` over the window's
passes."""

PARTS = ("libertem.fold", "libertem.wrap")


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
