"""The share of the traced window in which the card ran nothing: 100 x (1
- the union of its kernels, copies and sets / the window), from the
``torch.profiler`` trace. Where the profiler dropped launches (run.py
prints how many it saw against the port's counters) it is an upper
bound."""


def read(window):
    t = window.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
