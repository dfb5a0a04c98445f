"""The share of the cards' idle time in the traced window that falls
while the consumer is in the correlation UDFs' own spans: the idle time
named ``libertem.correlate`` or ``libertem.refine`` over all idle time
(``idle_by_host``, each gap named by the consumer's innermost host
event at its middle, as ``idle_feed_wait_share`` reads it; a gap under
one of the spans' torch operations is named by that operation)."""

SPANS = ("libertem.correlate", "libertem.refine")


def read(rec):
    t = rec.trace
    if t is None or not any(s in t.idle_by_host for s in SPANS):
        return None
    idle = sum(t.idle_by_host.values())
    if not idle:
        return None
    return 100.0 * sum(t.idle_by_host.get(s, 0.0) for s in SPANS) / idle
