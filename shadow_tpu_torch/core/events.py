"""Per-host event queues.

Mirrors the reference's ``src/main/core/work`` event machinery (SURVEY.md §2
"Event queue / events"): an event is (time, task) on a specific host; each
host owns a priority queue; determinism comes from a total order on
(time, host_id, sequence-number-of-insertion).

Events never move between hosts: cross-host interactions (packets) are always
scheduled onto the destination host's queue at a time >= one round ahead, the
conservative-PDES invariant (SURVEY.md §2 "Parallelism strategies" item 4).
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

from shadow_tpu_torch.core.time import SimTime, T_NEVER


#: heap ordering bands for same-time ties: network events (arrivals, loss
#: notifications) execute before application events at the same instant.
#: Network events carry an explicit ``key`` assigned at the emission barrier
#: in canonical batch order, which makes the total event order independent
#: of WHEN the engine physically inserts them — the deferred device-readback
#: path (shadow_tpu/network/engine.py) inserts arrivals rounds later than
#: the inline numpy path, yet both yield the same execution order.
BAND_NET = 0
BAND_APP = 1
#: fault-subsystem band (faults.py): host lifecycle transitions
#: (process respawn after a reboot) execute before any network arrival at
#: the same instant, so a rebooted host's listeners exist before the first
#: same-tick SYN — identically under every scheduler policy.
BAND_FAULT = -1


class EventQueue:
    """Min-heap of (time, band, key, seq, task) for one host.

    ``seq`` is a per-queue monotonically increasing insertion counter; it
    breaks ties deterministically (FIFO among same-time events) and makes the
    heap ordering total without comparing task callables. ``band``/``key``
    impose a canonical order on same-time ties that is stable across
    scheduler policies and data-plane backends (see BAND_NET above).
    """

    __slots__ = ("_heap", "_seq", "_live", "_cancelled", "on_first")

    def __init__(self) -> None:
        self._heap: list[tuple[SimTime, int, int, int, Callable[[], None]]] = []
        self._seq = 0
        self._live: set[int] = set()  # seqs pushed and not yet popped
        self._cancelled: set[int] = set()
        #: fired on the empty->nonempty transition; the controller uses it
        #: to maintain the active-host set (per-round work is then O(active
        #: hosts), not O(all hosts) — the difference at 10k+ mostly-idle
        #: hosts)
        self.on_first = None

    def push(self, time: SimTime, task: Callable[[], None],
             band: int = BAND_APP, key: int = -1) -> int:
        """Schedule ``task`` at ``time``; returns a handle usable with cancel()."""
        seq = self._seq
        self._seq += 1
        was_empty = not self._heap
        heapq.heappush(self._heap, (time, band, key if key >= 0 else seq, seq, task))
        self._live.add(seq)
        if was_empty and self.on_first is not None:
            self.on_first()
        return seq

    def cancel(self, handle: int) -> None:
        """Lazily cancel a scheduled event (e.g. a disarmed timer). A no-op
        if the event already ran — cancelling a fired timer is the normal
        disarm pattern and must not corrupt the queue."""
        if handle in self._live:
            self._cancelled.add(handle)

    def clear_band(self, band: int) -> int:
        """Lazily cancel every pending event in ``band`` (host crash: app
        timers die with the host, while BAND_NET arrivals stay queued and
        are discarded at delivery — keeping event counts identical to the
        columnar plane, whose resolved arrivals live outside the heap).
        Returns the number of events cancelled."""
        n = 0
        for entry in self._heap:
            seq = entry[3]
            if (entry[1] == band and seq in self._live
                    and seq not in self._cancelled):
                self._cancelled.add(seq)
                n += 1
        return n

    def next_time(self) -> SimTime:
        """Time of the earliest pending event, or T_NEVER if empty."""
        self._drop_cancelled_head()
        return self._heap[0][0] if self._heap else T_NEVER

    def head(self):
        """The earliest pending entry (time, band, key, seq, task), or
        None — the columnar plane's inbox-merge peek."""
        self._drop_cancelled_head()
        return self._heap[0] if self._heap else None

    def pop_until(self, end: SimTime) -> Optional[tuple[SimTime, Callable[[], None]]]:
        """Pop the earliest event with time < end, else None."""
        self._drop_cancelled_head()
        if self._heap and self._heap[0][0] < end:
            time, _band, _key, seq, task = heapq.heappop(self._heap)
            self._live.discard(seq)
            return time, task
        return None

    def _drop_cancelled_head(self) -> None:
        while self._heap and self._heap[0][3] in self._cancelled:
            seq = heapq.heappop(self._heap)[3]
            self._cancelled.discard(seq)
            self._live.discard(seq)

    def live_times(self, exclude_band: Optional[int] = None) -> list:
        """Sorted (time, band) of every pending non-cancelled event,
        optionally excluding one band — determinism-sentinel fodder
        (shadow_tpu/checkpoint.py): the multiset of pending timers is
        plane-independent once BAND_NET is excluded (the per-unit plane
        queues in-flight arrivals in the heap; the columnar plane holds
        them in its pending store)."""
        out = [(e[0], e[1]) for e in self._heap
               if e[3] not in self._cancelled and e[1] != exclude_band]
        out.sort()
        return out

    def live_count(self, exclude_band: Optional[int] = None) -> int:
        """Count of pending non-cancelled events outside ``exclude_band``
        — live_times without materializing the sorted list (the telemetry
        sampler calls this once per host per sample)."""
        cancelled = self._cancelled
        n = 0
        for e in self._heap:
            if e[1] != exclude_band and e[3] not in cancelled:
                n += 1
        return n

    def __len__(self) -> int:
        return len(self._heap) - len(self._cancelled)
