"""The simulator's rate in the traced run: simulated seconds of the
window's whole simulations that ran to their end over the window's wall,
from its start to the end of its last simulation. The profiler's cost is
in it. The untraced rate spreads too widely from run to run to hold an
end-to-end bound (PERF.md, section 2), so it is read here."""


def read(window):
    done = [s.summary for s in window.sims
            if s.summary and not s.error and not s.summary.get("partial")]
    sim_s = sum(s["sim_seconds"] for s in done)
    if not sim_s or window.wall_s <= 0:
        return None
    return sim_s / window.wall_s
