"""One span recorder for the port's host phases.

A ``Spans`` belongs to one ``Controller`` and is shared with its data
plane. Every boundary takes one clock read, ``now`` (``time.time_ns``,
the clock ``torch.profiler`` stamps its device events with, so a span and
a kernel of one trace line up), and from the same reads it keeps:

- ``totals``: wall seconds a phase key, always. It is the data plane's
  ``phase_wall`` and the run summary's, so a phase's total is the sum of
  its records;
- with recording on (``Spans(record=True)``), one record a span in flat
  int64 arrays: the name (an index into ``NAMES``), the parent record's
  index (-1 at a root), start and end ns, and the card window the span
  served (-1 where none). ``take()`` hands them over and starts afresh.
  They are never written to disk.

With recording off a boundary that only records costs the test of ``on``:
no clock read, and no record storage exists. Spans nest: ``open``
pushes a record that the next ``close`` ends, ``add`` appends a finished
leaf under the record open at the time.

The tree on the path of ``tpu_batch`` under the C engine (the names a
record holds; a phase key in brackets where a name's durations are the
total of one):

    construct
    run
      loop
        round.start
          draw.flush [draw_flush]
          ingress_deferred [ingress_deferred]
          extract [extract]
        events [events]
        round.end
          transport_tick [transport_tick]
          barrier [barrier]
          window.tick
        gc, idle.skip, telemetry [telemetry], checkpoint [checkpoint],
        heartbeat, draw.flush (flush_all)
      finalize
        finalize.reap, finalize.fold, finalize.flush_logs, finalize.log

The draw spans sit under whichever phase called them (draw.flush,
window.tick, idle.skip): draw.build and spec.build [window_build],
draw.launch and spec.launch [window_dispatch], draw.wait and
draw.copy_out [window_readback], spec.install [spec_install], draw.host
and draw.store.
"""

from __future__ import annotations

import time as _walltime  # detlint: ok(wallclock): span and phase_wall clock, never simulation state
from array import array

import numpy as np

now = _walltime.time_ns

NAMES = (
    "construct", "run", "loop", "round.start", "round.end", "events",
    "extract", "ingress_deferred", "transport_tick", "barrier",
    "window.tick", "gc", "idle.skip", "telemetry", "checkpoint",
    "heartbeat", "finalize", "finalize.reap", "finalize.fold",
    "finalize.flush_logs", "finalize.log", "draw.flush", "draw.build",
    "draw.launch", "draw.wait", "draw.copy_out", "draw.host", "draw.store",
    "spec.build", "spec.launch", "spec.install",
)
(CONSTRUCT, RUN, LOOP, ROUND_START, ROUND_END, EVENTS, EXTRACT,
 INGRESS_DEFERRED, TRANSPORT_TICK, BARRIER, WINDOW_TICK, GC, IDLE_SKIP,
 TELEMETRY, CHECKPOINT, HEARTBEAT, FINALIZE, FINALIZE_REAP, FINALIZE_FOLD,
 FINALIZE_FLUSH_LOGS, FINALIZE_LOG, DRAW_FLUSH, DRAW_BUILD, DRAW_LAUNCH,
 DRAW_WAIT, DRAW_COPY_OUT, DRAW_HOST, DRAW_STORE, SPEC_BUILD, SPEC_LAUNCH,
 SPEC_INSTALL) = range(len(NAMES))

#: phase_wall key -> the span names whose durations it totals
PHASE_NAMES = {
    "events": ("events",), "barrier": ("barrier",),
    "draw_flush": ("draw.flush",), "extract": ("extract",),
    "ingress_deferred": ("ingress_deferred",),
    "window_build": ("draw.build", "spec.build"),
    "window_dispatch": ("draw.launch", "spec.launch"),
    "window_readback": ("draw.wait", "draw.copy_out"),
    "transport_tick": ("transport_tick",), "spec_install": ("spec.install",),
    "telemetry": ("telemetry",), "checkpoint": ("checkpoint",),
}

_COLUMNS = ("name", "parent", "start", "end", "window")


class Spans:
    """``totals`` always; records while ``on`` (module doc)."""

    __slots__ = ("totals", "on", "name", "parent", "start", "end",
                 "window", "_open")

    def __init__(self, record: bool = False) -> None:
        self.totals: dict = {}
        self.on = bool(record)
        self._reset()

    def _reset(self) -> None:
        for col in _COLUMNS:
            setattr(self, col, array("q") if self.on else None)
        self._open = []

    def open(self, name: int, t: int = None) -> int:
        """Start a record of ``name`` at ``t`` (now by default) under the
        open one; it stays open, the parent of what follows, until
        ``close``. Returns ``t``."""
        if t is None:
            t = now()
        op = self._open
        i = len(self.start)
        self._append(name, op[-1] if op else -1, t, 0, -1)
        op.append(i)
        return t

    def close(self, t: int = None) -> int:
        """End the innermost open record at ``t`` (now by default).
        Returns ``t``."""
        if t is None:
            t = now()
        self.end[self._open.pop()] = t
        return t

    def add(self, name: int, t0: int, t1: int, window: int = -1) -> None:
        """A finished span from ``t0`` to ``t1`` under the open record."""
        op = self._open
        self._append(name, op[-1] if op else -1, t0, t1, window)

    def _append(self, name, parent, t0, t1, window) -> None:
        self.name.append(name)
        self.parent.append(parent)
        self.start.append(t0)
        self.end.append(t1)
        self.window.append(window)

    def take(self) -> dict:
        """The records since the last take, as int64 numpy arrays under
        ``name``, ``parent``, ``start``, ``end`` and ``window``, with
        ``names`` (NAMES); None with recording off. Records still open
        end at 0."""
        if not self.on:
            return None
        out = {col: np.frombuffer(getattr(self, col), dtype=np.int64).copy()
               for col in _COLUMNS}
        out["names"] = NAMES
        self._reset()
        return out

    def nbytes(self) -> int:
        """Bytes the records held now take (0 with recording off)."""
        return sum(getattr(self, c).itemsize * len(getattr(self, c))
                   for c in _COLUMNS) if self.on else 0

    def __getstate__(self):
        # a checkpoint carries the totals; records are this process's
        return {"totals": self.totals}

    def __setstate__(self, state) -> None:
        self.totals = state["totals"]
        self.on = False
        self._reset()


# -- reading records ------------------------------------------------------

def durations(rec: dict) -> np.ndarray:
    return rec["end"] - rec["start"]


def self_ns(rec: dict) -> np.ndarray:
    """Each record's self time: its duration less its children's (which
    never overlap one another)."""
    dur = durations(rec)
    out = dur.copy()
    kids = rec["parent"] >= 0
    np.subtract.at(out, rec["parent"][kids], dur[kids])
    return out


def total_s(rec: dict, *names: str) -> float:
    """Seconds of every record named one of ``names``."""
    ids = [NAMES.index(n) for n in names]
    return float(durations(rec)[np.isin(rec["name"], ids)].sum()) / 1e9


def by_name(rec: dict, values: np.ndarray, where=None) -> dict:
    """``values`` (one a record) summed by name, over ``where``."""
    sel = np.ones(len(values), bool) if where is None else where
    sums = np.bincount(rec["name"][sel], weights=values[sel],
                       minlength=len(NAMES))
    return {NAMES[i]: float(v) for i, v in enumerate(sums) if v}


def innermost(rec: dict) -> tuple:
    """The records' time as segments (start ns, end ns, record index) in
    time order, each segment of time given to the innermost record open
    through it; time under no record has no segment."""
    start, end = rec["start"], rec["end"]
    order = np.lexsort((-end, start))
    seg_s, seg_e, seg_r = [], [], []
    stack = []
    cursor = 0

    def emit(a, b, r):
        if b > a:
            seg_s.append(a)
            seg_e.append(b)
            seg_r.append(r)

    for i in order.tolist():
        s = int(start[i])
        while stack and int(end[stack[-1]]) <= s:
            j = stack.pop()
            emit(cursor, int(end[j]), j)
            cursor = int(end[j])
        if stack:
            emit(cursor, s, stack[-1])
        cursor = s
        stack.append(i)
    while stack:
        j = stack.pop()
        emit(cursor, int(end[j]), j)
        cursor = max(cursor, int(end[j]))
    return (np.asarray(seg_s, np.int64), np.asarray(seg_e, np.int64),
            np.asarray(seg_r, np.int64))


def overlap_by_record(segments: tuple, gaps) -> dict:
    """Nanoseconds of the intervals ``gaps`` ((start, end) pairs, sorted
    and disjoint) that each record's innermost segments cover: record
    index -> ns."""
    seg_s, seg_e, seg_r = segments
    out: dict = {}
    k = 0
    n = len(seg_s)
    for a, b in gaps:
        while k < n and seg_e[k] <= a:
            k += 1
        j = k
        while j < n and seg_s[j] < b:
            cover = min(b, int(seg_e[j])) - max(a, int(seg_s[j]))
            if cover > 0:
                r = int(seg_r[j])
                out[r] = out.get(r, 0) + cover
            j += 1
    return out
