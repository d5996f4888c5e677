"""The comparison that decides ``correct``.

The window's first simulations (``recorded``: run.py checks four) are
judged three ways, once the window has closed:

- every loss decision they made, against the plain reference
  (``reference/draws.py``) worked out anew from the inputs the program
  was handed, and their delivered and dropped counts against the
  reference's draws on the units they sent;
- the guarantee that the config states: for a seed, the hosts/ tree
  and the counts are byte-identical under every policy and device. Each
  is run again at its seed on the witness path (run.WITNESS: the
  user's default command on the host, ``device: cpu``) and compared;
- what its clients finished, read from their logs against the config
  (``outcome.py``), where the simulations ran to the config's stop time.

The numbers:

- ``failed_sims``: simulations (the warm-up's too) that raised, ended
  partial or reported process errors;
- ``unanswered_windows``: card windows whose flags never came back;
- ``draw_flag_mismatches``: units whose loss flag, on the card or on the
  host, differs from the reference's;
- ``dropped_count_gap``: the simulation's ``units_dropped`` against the
  reference's drops over every unit it decided;
- ``delivered_count_gap``: its ``units_sent`` against the units it
  emitted, less those blackholed and the reference's drops;
- ``hosts_tree_mismatches``: simulations whose hosts/ tree or counts
  differ from the witness's;
- ``outcome_shortfall``: completions that the config asks of its
  clients and their logs do not show.

Each number is exact: its limit is 0 (PERF.md gives the readings).
"""

from __future__ import annotations

import numpy as np

from portbench.reference import draws as ref

LIMITS = {
    "failed_sims": 0,
    "unanswered_windows": 0,
    "draw_flag_mismatches": 0,
    "dropped_count_gap": 0,
    "delivered_count_gap": 0,
    "hosts_tree_mismatches": 0,
    "outcome_shortfall": 0,
}


def sim_failed(sim, cut: bool = False) -> bool:
    """Raised, ended partial, or (unless ``cut`` short of the config's
    stop time, where processes are still running) reported process
    errors."""
    s = sim.summary
    return (sim.error is not None or s is None or bool(s.get("partial"))
            or (not cut and bool(s.get("process_errors"))))


def judge(sims, cut: bool = False) -> dict:
    """name -> (reading, limit) over the simulations of one window."""
    out = dict.fromkeys(LIMITS, 0)
    for sim in sims:
        if sim_failed(sim, cut):
            out["failed_sims"] += 1
            continue
        if not sim.recorded:
            continue
        out["unanswered_windows"] += sim.card_windows - sum(
            d[5] for d in sim.draws)
        ref_drops = 0
        if sim.draws:
            lo, hi, npk, th, got = (np.concatenate([d[i] for d in sim.draws])
                                    for i in range(5))
            want = ref.loss_flags(sim.seed, lo, hi, npk, th, sim.width)
            ref_drops = int(want.sum())
            out["draw_flag_mismatches"] += int((got != want).sum())
        s = sim.summary
        out["dropped_count_gap"] += abs(s["units_dropped"] - ref_drops)
        emitted = s["counters"].get("units_emitted", 0)
        out["delivered_count_gap"] += abs(
            s["units_sent"] - (emitted - s["units_blackholed"] - ref_drops))
        out["hosts_tree_mismatches"] += int(
            sim.tree is None or sim.tree != sim.witness_tree)
        if not cut:
            out["outcome_shortfall"] += (1 if sim.shortfall is None
                                         else sim.shortfall)
    return {k: (v, LIMITS[k]) for k, v in out.items()}


def passed(readings: dict) -> bool:
    return all(v <= limit for v, limit in readings.values())
