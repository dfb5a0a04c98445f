"""A reader thread's rate: the bytes each worker's feed moved to the
card over the seconds its reader spent filling pinned slots
(``feed_stats["workers"]``: ``h2d_bytes`` over ``read_s``), over every
worker and every pass of the window."""


def read(rec):
    workers = [w for f in rec.feeds for w in f.get("workers", [])]
    nbytes = sum(w["h2d_bytes"] for w in workers)
    seconds = sum(w["read_s"] for w in workers)
    if not nbytes or not seconds:
        return None
    return nbytes / seconds / 1e9
