"""Host time in the controller's round loop (the run summary's
``wall_seconds``: events, barrier and draw flush with the rest of the
loop) per simulated second, over the window's simulations. The data
directory's writes, construction and teardown are outside it."""


def read(window):
    done = [s.summary for s in window.sims if s.summary]
    sim_s = sum(s["sim_seconds"] for s in done)
    if not sim_s:
        return None
    return 1e3 * sum(s["wall_seconds"] for s in done) / sim_s
