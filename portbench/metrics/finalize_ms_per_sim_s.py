"""Host time in ``Controller.run()`` outside its round loop, per simulated
second: the harness's span around ``run()`` less the loop's
``wall_seconds``, which is mostly ``Controller._finalize`` writing every
host's log into the data directory (``Host.flush_logs``)."""


def read(window):
    done = [s for s in window.sims if s.summary and "run" in s.phases]
    sim_s = sum(s.summary["sim_seconds"] for s in done)
    if not sim_s:
        return None
    return 1e3 * sum(s.phases["run"] - s.summary["wall_seconds"]
                     for s in done) / sim_s
