"""The share of the traced window in which no kernel, copy or memset
ran on a card (the union of their intervals, not their sum), averaged
over the cell's cards."""


def read(rec):
    t = rec.trace
    if t is None or not t.window_s:
        return None
    busy = sum(t.busy_s.values()) / len(t.busy_s)
    return 100.0 * (1.0 - busy / t.window_s)
