"""Host time in the round loop's event execution (the C engine's per-host
loop: ``phase_wall.events``) per simulated second, over the window's
simulations."""


def read(window):
    done = [s.summary for s in window.sims if s.summary]
    sim_s = sum(s["sim_seconds"] for s in done)
    if not sim_s:
        return None
    return 1e3 * sum(s["phase_wall"]["events"] for s in done) / sim_s
