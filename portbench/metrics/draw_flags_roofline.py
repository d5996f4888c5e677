"""``draw_flags_kernel``'s share of its roofline: the mean bound of a card
window (roofline.draw_flags_bound) over the mean duration of a
``draw_flags_kernel`` launch in the trace."""

from portbench import roofline


def read(window):
    t = window.trace
    seen = t["kernels"].get("draw_flags_kernel") if t else None
    if not seen:
        return None
    bound, count = roofline.draw_flags_bound(window.sims)
    if not count:
        return None
    return 100.0 * (bound / count) / (sum(seen) / len(seen))
