"""The correlation's share of its roofline over the traced passes: the
least time the result's work needs, over the card's own time a pass
(the union of every kernel and memset interval on the cell's cards
inside the window, summed over the cards, over the passes: the time
``card_kernel_ms_per_pass`` reads).

The least time counts bytes only (``correlation_bytes``): each frame
read once at its item size, and each window's centre, refined centre
and peak value written once (float32), at the card's HBM rate.  It
counts the result's work whatever computes it (a full-frame FFT, an
rfft, a correlation computed only in the windows, a hand kernel), so
no implementation can read above 100%."""
from yardstick.roofline import HBM_BYTES_PER_S
from yardstick.trace import union_length


def correlation_bytes(frames: int, pixels: int, itemsize: int,
                      n_peaks: int) -> int:
    """Bytes of one correlation pass over ``frames`` frames of
    ``pixels`` pixels: the frames read once, and per frame and peak the
    centre (2 float32), the refined centre (2) and the peak value (1)
    written once."""
    return frames * pixels * itemsize + frames * n_peaks * 5 * 4


def read(rec):
    t = rec.trace
    config = rec.cell.config
    if t is None or not rec.traced_passes or "specimen" not in config:
        return None
    busy = sum(union_length((start, end) for start, end, cat, _ in ivs
                            if cat != "gpu_memcpy")
               for ivs in t.intervals.values())
    if not busy:
        return None
    pixels = 1
    for s in config["sig"]:
        pixels *= int(s)
    n_peaks = (2 * int(config["specimen"]["orders"]) + 1) ** 2
    bound = correlation_bytes(rec.frames, pixels, rec.kernel_itemsize,
                              n_peaks) / HBM_BYTES_PER_S
    return 100.0 * bound / (busy / rec.traced_passes)
