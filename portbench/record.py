"""What the timed path decides, recorded where the program decides it.

The simulator decides a unit's loss in one of two places, each a
boundary of the program's draw plane:

- ``DeviceDrawPlane.dispatch`` (``ops/propagate.py``): one causal
  window's units on the card (``draw_flags``); the flags come back
  through the handle's ``read()``;
- ``loss_flags`` as the columnar plane calls it (``network/colplane.py``):
  a window that stays on the host (below the floor, or both in-flight
  slots busy).

A ``Recorder`` wraps these two callables for its lifetime. For every
simulation it counts the windows each resolves, and for a simulation
that is ``recorded`` it writes each decision's inputs and answer to a
file of its own, so that what the harness keeps for the reference adds
nothing to the process's memory while the window runs. Once the window
has closed, ``load`` reads them back. The wrappers change no argument
and no answer.

With ``control_rounds`` set, the answers are replaced where they are
produced by the reference's draw at that many rounds: the control, which
the comparison has to fail.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench.reference import draws as ref

#: a record: [units, 1 for a card window] int64, then the units'
#: [uid_lo, uid_hi, npkts, thresh] as (4, units) int64, then a flag byte
#: a unit
HEADER = 16
BUFFER = 1 << 20


@dataclass
class SimRecord:
    """One simulation: its seed and draw width, what it decided, and its
    summary (or the error it raised)."""

    seed: int
    width: int
    #: whether its decisions are kept for the reference
    recorded: bool = True
    #: windows the draw plane sent to the card
    card_windows: int = 0
    #: windows resolved on the host (``colplane.loss_flags`` calls)
    host_windows: int = 0
    #: after ``Recorder.load``: (uid_lo, uid_hi, npkts, thresh, flags,
    #: on the card) of every decision it kept
    draws: list = field(default_factory=list)
    summary: dict = None
    error: str = None
    wall_s: float = 0.0
    #: the harness's spans of it: name -> seconds
    phases: dict = field(default_factory=dict)
    #: where its decisions are written while the window runs
    file: Path = None
    #: (sha256 of its hosts/ tree, its counts), and the same of the
    #: witness: the same seed run again on run.WITNESS
    tree: tuple = None
    witness_tree: tuple = None
    #: completions its clients' logs lack against the config (outcome.py)
    shortfall: int = None


class _Answer:
    """Stands between a card window's handle and its reader: writes the
    window's inputs and the flags the reader got."""

    __slots__ = ("_handle", "_rec", "_sim", "_cols", "flags")

    def __init__(self, handle, rec, sim, cols) -> None:
        self._handle = handle
        self._rec = rec
        self._sim = sim
        self._cols = cols
        self.flags = None

    def read(self) -> np.ndarray:
        if self.flags is None:
            flags = self._handle.read()
            if self._rec.control_rounds is not None:
                flags = self._rec._control(self._sim, *self._cols)
            self.flags = flags
            if self._sim.recorded:
                self._rec._write(self._sim, self._cols, flags, True)
            self._handle = self._cols = None
        return self.flags


class Recorder:
    """Install with ``with Recorder(spill_dir) as rec:``;
    ``rec.begin(seed, width, recorded)`` before each simulation directs
    its decisions to a new SimRecord and ``rec.end()`` after it closes
    its file."""

    def __init__(self, spill_dir: Path, control_rounds: int = None) -> None:
        self.spill_dir = Path(spill_dir)
        self.control_rounds = control_rounds
        self.sim = None
        self._out = None
        self._undo = []

    def begin(self, seed: int, width: int,
              recorded: bool = True) -> SimRecord:
        self.end()
        self.sim = SimRecord(int(seed), int(width), recorded)
        if recorded:
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            self.sim.file = self.spill_dir / f"draws-{seed}.bin"
            self._out = open(self.sim.file, "wb", buffering=BUFFER)
        return self.sim

    def end(self) -> None:
        if self._out is not None:
            self._out.close()
            self._out = None

    def _write(self, sim, cols, flags, card: bool) -> None:
        if sim is not self.sim or self._out is None:
            return
        block = np.stack([np.asarray(c, dtype=np.int64) for c in cols])
        n = block.shape[1]
        self._out.write(np.array([n, int(card)], np.int64).tobytes())
        self._out.write(block.tobytes())
        self._out.write(np.asarray(flags, dtype=np.uint8).tobytes())

    @staticmethod
    def load(sim: SimRecord) -> None:
        """Read ``sim``'s decisions back into ``sim.draws``."""
        if sim.file is None or not sim.file.is_file():
            return
        data = sim.file.read_bytes()
        at = 0
        while at < len(data):
            n, card = (int(v) for v in np.frombuffer(data, np.int64, 2, at))
            at += HEADER
            block = np.frombuffer(data, np.int64, 4 * n, at).reshape(4, n)
            at += 32 * n
            flags = np.frombuffer(data, np.uint8, n, at).astype(bool)
            at += n
            sim.draws.append((*block, flags, bool(card)))

    def __enter__(self) -> "Recorder":
        from shadow_tpu_torch.network import colplane
        from shadow_tpu_torch.ops import propagate

        rec = self
        plane_cls = propagate.DeviceDrawPlane
        dispatch = plane_cls.dispatch

        def recorded_dispatch(plane, uid_lo, uid_hi, npkts, thresh,
                              seed=None):
            handle = dispatch(plane, uid_lo, uid_hi, npkts, thresh, seed)
            rec.sim.card_windows += 1
            return _Answer(handle, rec, rec.sim,
                           (uid_lo, uid_hi, npkts, thresh))

        host_flags = colplane.loss_flags

        def recorded_loss_flags(seed, uid_lo, uid_hi, npkts, thresh):
            flags = host_flags(seed, uid_lo, uid_hi, npkts, thresh)
            sim = rec.sim
            cols = (uid_lo, uid_hi, npkts, thresh)
            if rec.control_rounds is not None:
                flags = rec._control(sim, *cols)
            sim.host_windows += 1
            if sim.recorded:
                rec._write(sim, cols, flags, False)
            return flags

        self._undo = [(plane_cls, "dispatch", dispatch),
                      (colplane, "loss_flags", host_flags)]
        plane_cls.dispatch = recorded_dispatch
        colplane.loss_flags = recorded_loss_flags
        return self

    def __exit__(self, *exc) -> None:
        self.end()
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)
        self._undo = []

    def _control(self, sim, uid_lo, uid_hi, npkts, thresh) -> np.ndarray:
        return ref.loss_flags(sim.seed, uid_lo, uid_hi, npkts, thresh,
                              sim.width, self.control_rounds)
