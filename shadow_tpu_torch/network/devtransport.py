"""Device-resident columnar transport: endpoint ticks as a batched tensor
program.

The port of shadow_tpu/network/devtransport.py. The per-endpoint hot path
(cumulative-ack application and the congestion-control window arithmetic
behind it) is scalar Python on the columnar plane: a 100k-endpoint round
costs 100k scalar callbacks. This module makes the tick columnar: whole
cohorts of endpoints advance per round through ONE batched integer kernel
(ops/transport_kernels.py), with the scalar twin serving every odd path.

How byte identity is preserved:

- **Deferral, not reordering.** A host whose round inbox looks
  ack-dominated has its ENTIRE round deferred: ``Host.run_events`` hands
  the inbox to ``DeviceTransport.intercept`` untouched, and the whole round
  replays at the barrier (``flush_round``) through the exact inbox<->timer
  heap merge of ``run_events``: same (time, band, key) order, same clock
  updates, same token charges, same event counts. Host rounds are
  independent within a round (the conservative-PDES invariant), so WHEN
  within the round a host's events execute cannot be observed; the
  replayed emissions join the same barrier they always joined.
- **Guess, verify, fall back.** At flush, clean-looking cumulative acks
  are gathered into struct-of-arrays columns and advanced by one batched
  kernel; at replay, each row re-verifies its gathered input snapshot
  against the live endpoint (state ESTABLISHED, snd_una/cwnd/ssthresh/
  cubic epoch unchanged, scoreboards empty, not in recovery, clock as
  predicted). Any mismatch takes the scalar twin for that row. A wrong
  guess costs kernel cycles, never correctness.
- **Emission-bearing side effects stay scalar, in order.** rtx pruning,
  RTO cancel/rearm, on_drain callbacks and the post-ack pump run per row
  during replay with the host clock at that row's dispatch time.

Engagement is wall-clock policy only, behind
``experimental.device_transport`` (default off), with the devroute
break-even economics: an EMA of batched cost per ack against a periodically
probed scalar cost per ack, engage/release hysteresis at 0.8x/1.25x. So on
a box where the scalar twin wins, the feature is a measured no-op. Cohorts
of at least ``_DEVICE_FLOOR`` rows go to the device (the CUDA kernel on a
card, its plain PyTorch version under ``--device cpu``); smaller cohorts
take the numpy host version, as in the reference.

Unlike the reference, whose attach quietly falls back to numpy when the
device path is unusable, a failed kernel build or warm-up launch is an
error: it is re-raised on the simulation thread at the next flush (or at
close), never served from the host version instead.

Under the C engine (``experimental.native_colcore``, the default), which
owns the host loop, this module stands down, as in the reference: the
Python columnar plane alone runs it. Not ported yet: packet capture and
fault injection, whose hooks in the reference's intercept and replay are
left out here because their config keys are refused at load.
"""

from __future__ import annotations

import time as _walltime  # detlint: ok(wallclock): engagement economics + phase_wall
from typing import Optional

import numpy as np

from shadow_tpu_torch.network import unit as U
from shadow_tpu_torch.network.transport import ESTABLISHED, StreamEndpoint
from shadow_tpu_torch.ops import transport_kernels as TK

# store-row field indices (colplane.py row layout)
_R_T, _R_KEY, _R_TGT, _R_KIND = 0, 1, 2, 3
_R_PEER, _R_APORT, _R_BPORT, _R_NBYTES, _R_SEQ = 4, 5, 6, 7, 8
_R_FRAG, _R_NFRAGS, _R_SIZE, _R_PAYLOAD = 9, 10, 11, 12

#: minimum clean-looking ack rows in a host round to defer it (smaller
#: rounds cannot amortize even the gather loop)
_MIN_STAGE = 2
#: minimum cohort size to route the kernel to the device; below it the
#: numpy host version wins on fixed dispatch cost
_DEVICE_FLOOR = 4096
#: EMA weight + engage/release hysteresis (devroute's constants, applied
#: to the transport tick)
_EMA_ALPHA = 0.25
_ENGAGE = 0.8
_RELEASE = 1.25

#: the canonical per-endpoint column set (struct-of-arrays, int64): what
#: export_columns snapshots and what the determinism gates compare.
#: sacked_n / rtx_done_n are the bounded-scoreboard lengths.
COLUMNS = (
    "state", "cwnd", "ssthresh", "snd_nxt", "snd_una", "adv_wnd",
    "buffered", "bytes_acked", "rto_backoff", "retries", "dup_acks",
    "loss_events", "cc_id", "in_recovery", "recover", "sack_high",
    "w_max", "epoch_start", "sacked_n", "rtx_done_n",
    "rcv_nxt", "ooo_bytes", "bytes_received", "last_wnd",
)
#: endpoint identity columns (snapshot/adopt join keys)
KEY_COLUMNS = ("hid", "local_port", "remote_host", "remote_port")
#: the columns adopt_columns may write back: pure window/CC arithmetic
#: state, never sequence/buffer state, whose invariants are owned by the
#: scalar machinery (rtx ring consistency etc.)
ADOPT_COLUMNS = ("cwnd", "ssthresh", "w_max", "epoch_start",
                 "rto_backoff", "retries", "dup_acks")


def export_columns(hosts) -> dict:
    """Snapshot every stream endpoint's transport state as SoA int64
    columns, hosts in id order, connections in sorted-key order."""
    eps = []
    for h in hosts:
        conns = h._conns
        for key in sorted(conns):
            ep = conns[key]
            if isinstance(ep, StreamEndpoint):
                eps.append((h.id, key, ep))
    n = len(eps)
    out = {name: np.empty(n, dtype=np.int64)
           for name in KEY_COLUMNS + COLUMNS}
    for i, (hid, key, ep) in enumerate(eps):
        s, r = ep.sender, ep.receiver
        row = (hid, key[0], key[1], key[2],
               ep.state, s.cwnd, s.ssthresh, s.snd_nxt, s.snd_una,
               s.adv_wnd, s.buffered, s.bytes_acked, s.rto_backoff,
               s.retries, s.dup_acks, s.loss_events, s.cc.cc_id,
               1 if s.in_recovery else 0, s.recover, s.sack_high,
               s.w_max, s.epoch_start, len(s.sacked), len(s.rtx_done),
               r.rcv_nxt, r.ooo_bytes, r.bytes_received, r.last_wnd)
        for name, v in zip(KEY_COLUMNS + COLUMNS, row):
            out[name][i] = v
    return out


def adopt_columns(hosts, cols: dict) -> int:
    """Write the ADOPT_COLUMNS subset of a column snapshot back into the
    endpoints. Joins on the identity columns; raises if any row no longer
    matches a live endpoint BEFORE writing anything (refusal is atomic: a
    half-adopted cohort would be a state no snapshot ever described).
    Returns the endpoint count written."""
    by_hid: dict = {h.id: h for h in hosts}
    n = len(cols["hid"]) if "hid" in cols else 0
    for name in KEY_COLUMNS + ADOPT_COLUMNS:  # atomicity needs lengths
        if name not in cols or len(cols[name]) != n:
            raise ValueError(f"adopt_columns: column {name!r} missing or "
                             f"not length {n}")
    eps = []
    for i in range(n):
        h = by_hid.get(int(cols["hid"][i]))
        ep = h._conns.get((int(cols["local_port"][i]),
                           int(cols["remote_host"][i]),
                           int(cols["remote_port"][i]))) if h else None
        if not isinstance(ep, StreamEndpoint):
            raise ValueError(
                f"adopt_columns: row {i} names no live Python endpoint")
        eps.append(ep)
    for i, ep in enumerate(eps):
        s = ep.sender
        s.cwnd = int(cols["cwnd"][i])
        s.ssthresh = int(cols["ssthresh"][i])
        s.w_max = int(cols["w_max"][i])
        s.epoch_start = int(cols["epoch_start"][i])
        s.rto_backoff = int(cols["rto_backoff"][i])
        s.retries = int(cols["retries"][i])
        s.dup_acks = int(cols["dup_acks"][i])
    return n


class _Ent:
    """One gathered kernel entry: the input snapshot (for replay-time
    verification) plus the kernel outputs (filled after dispatch)."""

    __slots__ = ("ep", "s", "key", "cum", "wnd", "now", "cc_id",
                 "snd_una", "cwnd", "ssthresh", "w_max", "epoch_start",
                 "o_cwnd", "o_wmax", "o_eps")

    def __init__(self, ep, key, cum, wnd, now):
        self.ep = ep
        s = ep.sender
        self.s = s
        self.key = key
        self.cum = cum
        self.wnd = wnd
        self.now = now
        self.cc_id = s.cc.cc_id
        self.snd_una = s.snd_una
        self.cwnd = s.cwnd
        self.ssthresh = s.ssthresh
        self.w_max = s.w_max
        self.epoch_start = s.epoch_start


class DeviceTransport:
    """The columnar transport engine for one ColumnarPlane (attached when
    ``experimental.device_transport`` is on; see the module docstring)."""

    def __init__(self, plane, device: str = "cuda") -> None:
        self.plane = plane
        self.device = device
        self.staged: list = []  # (host, rows, end, n) deferred this round
        self.executed = 0  # replayed event count, drained per round
        # telemetry / economics (wall-clock policy, never sim state)
        self.cohorts = 0  # columnar flushes served
        self.acks_batched = 0  # rows advanced by the kernel
        self.misguesses = 0  # gathered rows that failed replay verify
        self.scalar_probes = 0  # probe flushes run on the scalar twin
        self.device_cohorts = 0  # cohorts served by the device kernel
        self.rounds_deferred = 0
        self._flushes = 0
        self._eligible = 0
        self._engaged = True
        self._batch_ema = 0.0
        self._scalar_ema = 0.0
        self._warm = False  # first columnar flush is attach noise
        self._devk = None  # DeviceAckKernel, published by the bg attach
        # slots of the cohorts the numpy host version serves (plain memory)
        self._host_slots = TK.AckSlots("cpu")
        self._bg = None
        self._bg_error = None  # a failed attach, re-raised on the sim thread

    # -- background device attach (the devroute discipline) -----------------
    def start_device_attach(self) -> None:
        import threading

        self._bg = threading.Thread(target=self._bg_attach, daemon=True)
        self._bg.start()

    def _bg_attach(self) -> None:
        try:
            self._devk = TK.DeviceAckKernel.attach(self.device)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            self._bg_error = exc

    def raise_attach_error(self) -> None:
        """Re-raise a failed background attach on the calling thread."""
        exc = self._bg_error
        if exc is not None:
            self._bg_error = None
            raise RuntimeError(
                f"device transport attach failed: {exc}") from exc

    def close(self) -> None:
        """Join the attach thread and raise the error it hit, if any."""
        t = self._bg
        if t is not None and t.is_alive():
            t.join()
        self.raise_attach_error()

    # -- staging (called from Host.run_events) ------------------------------
    def intercept(self, host, rows, end) -> bool:
        """Decide whether to defer this host's round to the barrier.
        Deferral is always result-identical (the whole round replays in
        canonical order); the scan is a pure profitability guess."""
        if not self._engaged:
            # released by the economics: skip even the profitability
            # scan, re-probing the columnar path on a coarse cadence so
            # a changed traffic shape can re-engage
            self._eligible += 1
            if self._eligible & 127:
                return False
        n = 0
        for r in rows:
            if r[_R_KIND] == U.ACK and r[_R_PAYLOAD] is None:
                n += 1
        if n < _MIN_STAGE:
            return False
        self.staged.append((host, rows, end, n))
        self.rounds_deferred += 1
        return True

    def take_executed(self) -> int:
        n, self.executed = self.executed, 0
        return n

    # -- the barrier flush ---------------------------------------------------
    def flush_round(self, round_end) -> None:
        if self._bg_error is not None:
            self.raise_attach_error()
        staged = self.staged
        if not staged:
            return
        self.staged = []
        self._flushes += 1
        t0 = _walltime.perf_counter()
        probe = (self._flushes & 15) == 0 and self._warm
        # both EMAs divide the whole-flush wall by the SAME denominator:
        # the clean-looking ack rows the intercept scan already counted
        # (carried in the staged tuple), so the break-even comparison is
        # apples to apples even when gather rejects part of the population
        nacks = sum(s[3] for s in staged)
        if probe:
            # scalar probe: the same deferred replay, every row through
            # the scalar twin, timed: the live denominator of the
            # break-even comparison (bit-identical by construction)
            self.scalar_probes += 1
            for host, rows, end, _n in staged:
                self.executed += self._replay(host, rows, end, None)
            dt = _walltime.perf_counter() - t0
            if nacks:
                self._scalar_ema = _ema(self._scalar_ema, dt / nacks)
        else:
            fast_maps, ents, slot = self._gather(staged)
            n = len(ents)
            if n:
                outs = self._kernel(slot, n)
                for ent, cw, wm, ep in zip(ents, outs[2][:n].tolist(),
                                           outs[3][:n].tolist(),
                                           outs[4][:n].tolist()):
                    ent.o_cwnd = cw
                    ent.o_wmax = wm
                    ent.o_eps = ep
                slot.home.give(slot)
                self.cohorts += 1
                self.acks_batched += n
            for (host, rows, end, _n), fm in zip(staged, fast_maps):
                self.executed += self._replay(host, rows, end,
                                              fm or None)
            dt = _walltime.perf_counter() - t0
            if not self._warm:
                self._warm = True  # kernel warmup flush: not signal
            elif nacks:
                self._batch_ema = _ema(self._batch_ema, dt / nacks)
        self._decide()
        self.plane.phase_wall["transport_tick"] += (
            _walltime.perf_counter() - t0)

    def _decide(self) -> None:
        """Engage/release with the devroute hysteresis bands: both paths
        are bit-identical, so this is pure wall-clock routing policy."""
        b, s = self._batch_ema, self._scalar_ema
        if b <= 0.0 or s <= 0.0:
            return
        if self._engaged and b > _RELEASE * s:
            self._engaged = False
        elif not self._engaged and b < _ENGAGE * s:
            self._engaged = True

    # -- gather: rows -> columns --------------------------------------------
    def _gather(self, staged):
        """Classify each deferred host's ack rows and write the cohort's
        inputs straight into the columns of a slot (``_take_slot``).
        Classification is a guess (replay verifies it row by row); the
        gathered inputs are the live pre-round state, since deferred hosts
        ran nothing yet. Returns (a map of row index -> entry for each
        host, the entries in cohort order, the slot or None)."""
        fast_maps = []
        ents = []
        for host, rows, _end, _n in staged:
            fm = {}
            conns = host._conns
            seen = {}
            now0 = host._now
            for i, r in enumerate(rows):
                if r[_R_KIND] != U.ACK or r[_R_PAYLOAD] is not None:
                    continue
                ep = conns.get((r[_R_BPORT], r[_R_PEER], r[_R_APORT]))
                if type(ep) is not StreamEndpoint or ep in seen:
                    continue
                s = ep.sender
                cum = r[_R_NBYTES]
                if not self._stageable(ep, s, cum):
                    continue
                seen[ep] = None
                t = r[_R_T]
                ent = _Ent(ep, (r[_R_BPORT], r[_R_PEER], r[_R_APORT]),
                           cum, r[_R_SEQ], t if t > now0 else now0)
                fm[i] = ent
                ents.append(ent)
            fast_maps.append(fm)
        if not ents:
            return fast_maps, ents, None
        slot = self._take_slot(len(ents))
        (cc_id, cwnd, ssthresh, w_max, eps, snd_una, bytes_acked, cum,
         now) = slot.inp
        for j, e in enumerate(ents):
            cc_id[j] = e.cc_id
            cwnd[j] = e.cwnd
            ssthresh[j] = e.ssthresh
            w_max[j] = e.w_max
            eps[j] = e.epoch_start
            snd_una[j] = e.snd_una
            bytes_acked[j] = e.s.bytes_acked
            cum[j] = e.cum
            now[j] = e.now
        return fast_maps, ents, slot

    @staticmethod
    def _stageable(ep, s, cum) -> bool:
        """The clean-advance GUESS (replay verifies it row by row; the
        wrong-kernel-guess test forces this to lie and asserts results are
        still byte-identical)."""
        return (ep.state == ESTABLISHED and not s.in_recovery
                and not s.sacked and not s.rtx_done and cum > s.snd_una)

    def _take_slot(self, n: int):
        """A slot for a cohort of ``n`` rows: the device kernel's
        (page-locked on a card) at or above the device floor once it is
        attached, else one in plain memory for the numpy host version."""
        devk = self._devk
        if devk is not None and n >= _DEVICE_FLOOR:
            return devk.slots.take(n)
        return self._host_slots.take(n)

    def _kernel(self, slot, n: int):
        """ONE batched dispatch for the whole cohort in ``slot``: the
        device kernel if the slot is the device's, else the numpy host
        version on views of its rows; bit-identical integer programs either
        way. Returns the five output rows (at least ``n`` columns each),
        valid until the slot is given back."""
        if slot.home is self._host_slots:
            return TK.ack_advance(*slot.inp[:, :n])
        self.device_cohorts += 1
        return self._devk.advance(slot, n)

    # -- replay: the deferred round, in canonical order ----------------------
    def _replay(self, host, rows, end, fast: Optional[dict]) -> int:
        """Execute the deferred round exactly as Host.run_events would
        have: the inbox<->timer-heap merge in (time, band, key) order, each
        row either kernel-applied (verified) or dispatched through the
        scalar twin."""
        eq = host.equeue
        heap = eq._heap
        head = eq.head
        pop = eq.pop_until
        n = 0
        pos, ln = 0, len(rows)
        dispatch = host.dispatch_row
        # fast path (run_events' twin): no heap events at all; straight
        # row drain, re-checking only the emptiness bit per row
        while pos < ln and not heap:
            ent = fast.get(pos) if fast is not None else None
            if ent is not None:
                self._fast_row(host, rows[pos], ent)
            else:
                dispatch(rows[pos])
            pos += 1
            n += 1
        while True:
            h0 = head()
            hv = h0 is not None and h0[0] < end
            if pos < ln:
                row = rows[pos]
                ti = row[0]
                if (not hv or ti < h0[0]
                        or (ti == h0[0]
                            and (0, row[1]) < (h0[1], h0[2]))):
                    ent = fast.get(pos) if fast is not None else None
                    if ent is not None:
                        self._fast_row(host, row, ent)
                    else:
                        dispatch(row)
                    pos += 1
                    n += 1
                    continue
            if hv:
                host._now, task = pop(end)
                task()
                n += 1
                continue
            break
        host._n_events += n
        return n

    def _fast_row(self, host, row, ent) -> None:
        """dispatch_row's clock/NIC accounting, then the verified kernel
        writeback, or the scalar twin when verification fails (the
        wrong-guess path: cycles, never correctness)."""
        t = row[_R_T]
        if t > host._now:
            host._now = t
        eng = self.plane
        if t >= eng.bootstrap_end:
            tokens = eng.tokens_down
            if tokens[host.id] >= row[_R_SIZE]:
                tokens[host.id] -= row[_R_SIZE]
            else:
                host.ingress_deferred_rows.append(row)
                eng._deferred.add(host)
                return
        ep, s = ent.ep, ent.s
        if (host._conns.get(ent.key) is not ep
                or ep.state != ESTABLISHED
                or ent.cum <= s.snd_una
                or s.snd_una != ent.snd_una or s.cwnd != ent.cwnd
                or s.ssthresh != ent.ssthresh or s.w_max != ent.w_max
                or s.epoch_start != ent.epoch_start
                or s.in_recovery or s.sacked or s.rtx_done
                or (ent.cc_id == TK.CC_CUBIC and ent.now != host._now)):
            self.misguesses += 1
            host._deliver_row(t, row[_R_KIND], row[_R_PEER],
                              row[_R_APORT], row[_R_BPORT],
                              row[_R_NBYTES], row[_R_SEQ], row[_R_FRAG],
                              row[_R_NFRAGS], row[_R_PAYLOAD])
            return
        host._n_delivered += 1
        # handle_fields(ACK) for the verified clean advance, kernel results
        # written back in the scalar twin's exact order
        if ep._idle_timer is not None:
            ep._rearm_idle()
        cum = ent.cum
        s.adv_wnd = ent.wnd
        s.dup_acks = 0
        s.snd_una = cum
        s.bytes_acked += cum - ent.snd_una
        rtx = s.rtx
        while rtx and rtx[0][0] + rtx[0][1] <= cum:
            rtx.popleft()
        s.rto_backoff = 1
        s.retries = 0
        s._cancel_rto()
        if s.snd_nxt > cum:
            s._arm_rto()
        s.cwnd = ent.o_cwnd
        s.w_max = ent.o_wmax
        s.epoch_start = ent.o_eps
        drained = ep.on_drain
        if drained is not None and s.buffered < s.send_buffer:
            drained(s.send_buffer - s.buffered)
        s.pump()

    # -- telemetry -----------------------------------------------------------
    def summary(self) -> dict:
        """Wall-clock routing telemetry (volatile, never sim state)."""
        return {
            "cohorts": self.cohorts,
            "acks_batched": self.acks_batched,
            "misguesses": self.misguesses,
            "rounds_deferred": self.rounds_deferred,
            "scalar_probes": self.scalar_probes,
            "device_cohorts": self.device_cohorts,
            "engaged": self._engaged,
            "batch_per_ack_us": round(self._batch_ema * 1e6, 3),
            "scalar_per_ack_us": round(self._scalar_ema * 1e6, 3),
        }


def _ema(cur: float, sample: float) -> float:
    return sample if cur == 0.0 else cur + _EMA_ALPHA * (sample - cur)
