"""The share of the cards' idle time in the traced window that falls
while the consumer (the thread that launches the steps) waits for the
next super-step's blocks: the idle time under the program's span
``libertem.feed_wait`` over all idle time (``idle_by_host``, each gap
named by the consumer's innermost host event at its middle)."""

SPAN = "libertem.feed_wait"


def read(rec):
    t = rec.trace
    if t is None or SPAN not in t.idle_by_host:
        return None
    idle = sum(t.idle_by_host.values())
    if not idle:
        return None
    return 100.0 * t.idle_by_host[SPAN] / idle
