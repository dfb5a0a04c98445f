"""The share of a pass the consumer (the thread that launches the
steps) waited for the next super-step's blocks: ``feed_stats``
``wait_s`` over the pass's wall time, over the window's passes."""


def read(rec):
    wall = sum(b - a for a, b in rec.spans)
    if not rec.feeds or not wall:
        return None
    return 100.0 * sum(f["wait_s"] for f in rec.feeds) / wall
