"""The fused-moments kernel's share of its roofline over the traced
passes: the least time their work needs
(``yardstick.roofline.fused_moments_bound_s``: the frames, the
configuration's mask count ``M``, the kernel's input item size and the
calls the program counted, ``fused_moments.launches``) over the device
time of the kernels that compute the product and the moments, matched
by name here."""
from yardstick.roofline import fused_moments_bound_s

# the partials and the combine launch of every call
KERNELS = r"moments_partials|moments_combine"


def read(rec):
    t = rec.trace
    if t is None or not rec.traced_launches:
        return None
    seconds = t.matching_s(KERNELS)
    if not seconds:
        return None
    config = rec.cell.config
    pixels = 1
    for s in config["sig"]:
        pixels *= int(s)
    bound, _ = fused_moments_bound_s(
        rec.frames * rec.traced_passes, pixels, int(config["M"]),
        rec.kernel_itemsize, rec.traced_launches)
    return 100.0 * bound / seconds
