"""Scheduler policies: how hosts execute within a round.

The port of shadow_tpu/core/scheduler.py, with the reference's policies
behind one interface:

- ``thread_per_core``: a fixed pool of worker threads; hosts are sharded
  across them each round (the reference's CPU baseline policy). It runs
  the per-unit plane (network/engine.py) with every loss draw on the host.
- ``thread_per_host``: one persistent thread per host, parked between
  rounds (a cache-locality policy for small host counts), on the same
  per-unit plane.
- ``tpu_batch`` and ``tpu_mesh``: hosts run serially on the main thread,
  in host-id order, while the per-round network data plane runs on the
  card. Under tpu_batch, event execution overlaps device work through
  dispatch asynchrony, not Python threads: the columnar plane dispatches
  ONE fused launch per multi-round window (two in-flight windows,
  deferred readbacks at causal deadlines — network/devroute.py), so the
  card computes window N while this thread runs the events and barriers
  of window N+1. Under tpu_mesh, each causal window's exchange runs when
  its deadline comes due, and the thread waits for it (as the reference
  does).

Correctness note: within a round, a host's events touch only that host's
state; cross-host effects flow exclusively through the engine at the round
barrier. So any assignment of hosts to threads, and any execution order of
hosts within a round, gives identical results — tests/test_torch_policies.py
holds every policy to the reference.

CPython's GIL means the thread policies add no real CPU parallelism for
pure-Python workloads; they exist for structural parity with the
reference, whose baseline they are.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
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


class ThreadPerCoreScheduler:
    """Fixed worker pool; hosts chunked across it each round."""

    name = "thread_per_core"

    def __init__(self, hosts: Sequence, nthreads: int) -> None:
        self.hosts = hosts
        self.nthreads = max(1, nthreads)
        self.pool = ThreadPoolExecutor(
            max_workers=self.nthreads, thread_name_prefix="shadow-worker"
        )
        # static host -> shard assignment (reference: fixed sharding keeps
        # determinism trivially; work stealing is unnecessary because the
        # engine barrier dominates imbalance at realistic host counts)
        self.shards = [list(hosts[i :: self.nthreads]) for i in range(self.nthreads)]

    def _run_shard(self, shard, round_end: SimTime) -> int:
        return _run_hosts(shard, round_end)

    def run_round(self, round_end: SimTime, active: Sequence = None) -> int:
        if active is not None:
            # shard only the hosts that can have work this round; a single
            # populated shard runs inline (no pool round trip)
            shards = [[] for _ in range(self.nthreads)]
            for h in active:
                shards[h.id % self.nthreads].append(h)
            shards = [s for s in shards if s]
            if not shards:
                return 0
            if len(shards) == 1:
                return _run_hosts(shards[0], round_end)
        else:
            shards = [s for s in self.shards if s]
        futs = [self.pool.submit(self._run_shard, s, round_end) for s in shards]
        return sum(f.result() for f in futs)

    def shutdown(self) -> None:
        self.pool.shutdown(wait=False)


class ThreadPerHostScheduler:
    """One persistent parked thread per host, woken each round."""

    name = "thread_per_host"

    def __init__(self, hosts: Sequence) -> None:
        self.hosts = hosts
        self._round_end: SimTime = 0
        self._go = [threading.Event() for _ in hosts]
        self._done = [threading.Event() for _ in hosts]
        self._stop = False
        self._counts = [0] * len(hosts)
        self._errors: list = [None] * len(hosts)
        self._index = {h.id: i for i, h in enumerate(hosts)}
        self._threads = [
            threading.Thread(
                target=self._loop, args=(i,), name=f"shadow-host-{h.name}", daemon=True
            )
            for i, h in enumerate(hosts)
        ]
        for t in self._threads:
            t.start()

    def _loop(self, i: int) -> None:
        while True:
            self._go[i].wait()
            self._go[i].clear()
            if self._stop:
                return
            try:
                self._counts[i] = _run_hosts((self.hosts[i],), self._round_end)
            except BaseException as exc:  # propagate instead of hanging
                self._errors[i] = exc
            self._done[i].set()

    def run_round(self, round_end: SimTime, active: Sequence = None) -> int:
        idx = (list(range(len(self.hosts))) if active is None
               else [self._index[h.id] for h in active])
        self._round_end = round_end
        for i in idx:
            self._errors[i] = None
            self._counts[i] = 0
            self._go[i].set()
        total = 0
        for i in idx:
            self._done[i].wait()
            self._done[i].clear()
            if self._errors[i] is not None:
                raise self._errors[i]
            total += self._counts[i]
        return total

    def shutdown(self) -> None:
        self._stop = True
        for ev in self._go:
            ev.set()


def make_scheduler(policy: str, hosts: Sequence, parallelism: int):
    if policy == "thread_per_core":
        import os

        n = parallelism if parallelism > 0 else (os.cpu_count() or 1)
        return ThreadPerCoreScheduler(hosts, n)
    if policy == "thread_per_host":
        if len(hosts) > 2048:
            raise ValueError(
                f"thread_per_host with {len(hosts)} hosts would create too many "
                "OS threads; use thread_per_core or tpu_batch"
            )
        return ThreadPerHostScheduler(hosts)
    if policy in ("tpu_batch", "tpu_mesh"):
        # host events run serially on the main thread; the data plane is
        # on the device. Event execution overlaps device work through
        # dispatch asynchrony, not Python threads: the columnar plane
        # dispatches ONE fused program per multi-round window (two
        # in-flight windows, deferred readbacks at causal deadlines —
        # network/devroute.py), so the device computes window N while
        # this thread runs the events and barriers of window N+1.
        return SerialScheduler(hosts)
    raise ValueError(f"unknown scheduler policy {policy!r}")
