"""Scan throughput on the host's clock: the raw dataset bytes of every
pass completed in the window over the time from the first pass's start
to the last pass's end, in GB/s (10**9 bytes).  A per-layer reading:
where the host's readers pace the passes, the host's memory sets it,
and it drifts with that."""
from yardstick.stats import rate



def read(rec):
    if not rec.spans:
        return None
    return rate(rec.pass_bytes, rec.spans) / 1e9
