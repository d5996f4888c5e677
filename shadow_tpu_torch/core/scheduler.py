"""Scheduler policies: how hosts execute within a round.

The port of shadow_tpu/core/scheduler.py, reduced to the ``tpu_batch``
and ``tpu_mesh`` policies: hosts run serially on the main thread, in
host-id order, while the per-round network data plane runs on the card.
Under tpu_batch, event execution overlaps device work through dispatch
asynchrony, not Python threads: the columnar plane dispatches ONE fused
launch per multi-round window (two in-flight windows, deferred readbacks
at causal deadlines — network/devroute.py), so the card computes window N
while this thread runs the events and barriers of window N+1. Under
tpu_mesh, each causal window's exchange runs when its deadline comes due,
and the thread waits for it (as the reference does).

The thread policies (``thread_per_core``, ``thread_per_host``) run the
per-unit plane (network/engine.py), which is not ported yet; config load
refuses them (config/schema.py).

Correctness note: within a round, a host's events touch only that host's
state; cross-host effects flow exclusively through the engine at the round
barrier, so any execution order of hosts within a round gives identical
results.
"""

from __future__ import annotations

from typing import Sequence

from shadow_tpu_torch.core.time import SimTime


def _run_hosts(hosts, round_end: SimTime) -> int:
    """Run one round for a set of hosts. The inline heap peek matters: at
    10k+ hosts most queues are empty most rounds, and a Python call into
    run_events per (host, round) costs more than the whole round's real
    work. A cancelled head with an earlier timestamp makes the peek
    conservatively true — run_events then discards it correctly."""
    n = 0
    for h in hosts:
        heap = h.equeue._heap
        if (heap and heap[0][0] < round_end) or h._inbox is not None:
            n += h.run_events(round_end)
    return n


class SerialScheduler:
    """Hosts executed in host-id order on the calling thread."""

    name = "serial"

    def __init__(self, hosts: Sequence) -> None:
        self.hosts = hosts

    def run_round(self, round_end: SimTime, active: Sequence = None) -> int:
        return _run_hosts(self.hosts if active is None else active, round_end)

    def shutdown(self) -> None:
        pass


def make_scheduler(policy: str, hosts: Sequence, parallelism: int):
    if policy in ("tpu_batch", "tpu_mesh"):
        return SerialScheduler(hosts)
    raise ValueError(f"scheduler policy {policy!r} is not ported to "
                     f"shadow_tpu_torch yet")
