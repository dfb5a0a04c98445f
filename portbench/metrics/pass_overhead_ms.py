"""The consumer's time a pass outside the feed, the engine and the
results: the program's span totals (``feed_stats["spans"]``, host
clock) ``libertem.run`` less ``libertem.feed_wait``, ``libertem.step``,
``libertem.host_step``, ``libertem.fold`` and ``libertem.wrap``, over
the window's passes (preparation, the feeds' set-up, the hooks, the
close, the loop's own Python)."""

RUN = "libertem.run"
PARTS = ("libertem.feed_wait", "libertem.step", "libertem.host_step",
         "libertem.fold", "libertem.wrap")


def read(rec):
    if not rec.feeds:
        return None
    total = 0.0
    for feed in rec.feeds:
        spans = feed.get("spans")
        if not spans or RUN not in spans:
            return None
        total += spans[RUN][1] - sum(
            spans[p][1] for p in PARTS if p in spans)
    return total / len(rec.feeds) * 1e3
