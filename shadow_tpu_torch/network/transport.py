"""Transports for plugin workloads: reliable streams (TCP-like) and datagrams.

A copy of shadow_tpu/network/transport.py.

Re-designs the reference's userspace TCP + UDP socket layer (SURVEY.md §1
layer 9, §2 "TCP stack") as a *fluid* model suited to batched per-round
simulation, with a real stream protocol and self-contained loss recovery
(dup-ack fast retransmit; the engine-notification loss model is retired
per COMPONENTS.md #13):

- **Cumulative acks + sequence accounting.** Every DATA unit carries its
  byte offset; the receiver tracks ``rcv_nxt``, buffers out-of-order
  chunks (bounded by ``experimental.socket_recv_buffer``), discards
  duplicates, and acks cumulatively with its advertised window. A lost ACK
  is repaired by any later ACK — no cross-host bookkeeping.
- **Retransmission machinery with SACK.** Two layers, like TCP's
  fast-retransmit vs RTO: the receiver acks out-of-order data immediately
  and attaches SACK blocks (its merged received-unit ranges, up to 4,
  RFC 2018-shaped — encoded in the ACK's payload field, wire size
  unchanged); the sender keeps a scoreboard of SACKed segments, counts
  consecutive duplicate acks, and the 3rd enters recovery: multiplicative
  decrease + retransmission of EVERY un-SACKed hole below the highest
  SACKed byte in one burst — a multi-unit loss burst repairs in one RTT
  instead of the pre-PR-9 one-retransmit-per-RTT crawl. While in recovery,
  each partial ack or newly arrived SACK block retransmits newly exposed
  holes (each hole at most once per recovery episode); recovery ends when
  the cumulative ack reaches the recovery point. An RTO timer (2x path
  RTT, exponential backoff, RTO_MAX_NS ceiling) independently guarantees
  progress for every pattern duplicate acks do not cover (lost ACKs, lost
  retransmits, tail loss); an RTO discards the scoreboard (renege safety,
  RFC 2018 §8) and falls back to go-back-N from the oldest hole. Control
  units use pure timers: SYN and FIN retransmit
  on RTO with bounded retries; SYNACK loss is repaired by SYN retransmit +
  the server's duplicate-SYN re-ack; FINACK loss by FIN retransmit + the
  TIME_WAIT re-ack below.
- **Flow control.** Senders respect ``min(cwnd, peer advertised window)``;
  the handshake exchanges initial windows; ``send()`` accepts at most
  ``experimental.socket_send_buffer`` un-segmented bytes and returns the
  accepted count (POSIX write semantics), with ``on_drain`` callbacks as
  buffer space frees.
- **Orderly close with half-close.** FIN only after all of the closer's
  data is acked; a receiver still mid-stream defers its FINACK until its
  own outbound data drains (the FIN sender keeps receiving in FIN_SENT,
  like TCP's FIN_WAIT half-close). The FINACK side lingers in TIME_WAIT
  (2x RTO) to re-ack duplicate FINs, then the endpoint is dropped — no
  stranded connections (tests assert ``_conns`` empties; exhausted retries
  force-drop like TCP's orphan timeout).

Congestion control is pluggable behind the ``CongestionControl`` seam
(selected per host via ``experimental.congestion_control`` or the
per-host ``congestion_control`` key): ``newreno`` is the extracted
default (standard slow-start + AIMD, RFC 5681 shaped, in integer bytes —
bit-identical to the pre-seam behavior), ``cubic`` a CUBIC-shaped
variant (RFC 8312's time-based cubic window in pure integer arithmetic,
beta 0.7, C = 0.4 — every operation is int64-safe and
floor-division-free on negatives so the C twin computes the exact same
windows). Datagram sockets fragment payloads into units and reassemble
at the receiver; losing any fragment loses the datagram (IP semantics).

Telemetry contract (telemetry/): the sampler aggregates, per
host connection, ``sender.{snd_nxt, snd_una, cwnd, ssthresh, loss_events,
retries, rto_backoff, buffered}`` and models read
``sender.loss_events`` / ``receiver.bytes_received`` at flow close. Every
field in that set is exposed IDENTICALLY by the C endpoint twin
(csrc/colcore.c ``CEp`` getters) — extending the sampled set means adding
the matching C getter, or the telemetry streams stop being byte-identical
across the Python/C twins (tests/test_torch_telemetry.py).
"""

from __future__ import annotations

from bisect import bisect_left, insort
from collections import deque
from typing import Callable, Optional

from shadow_tpu_torch.core.time import NS_PER_MS, SimTime
from shadow_tpu_torch.network.fluid import HEADER
from shadow_tpu_torch.network import unit as U
from shadow_tpu_torch.network.unit import Unit

MSS = 1460  # cwnd growth quantum (classic ethernet MSS)
INIT_CWND = 10 * MSS  # RFC 6928
MIN_CWND = 2 * MSS
RTO_MIN_NS = 200 * NS_PER_MS
#: RTO ceiling (TCP's conventional 60 s): a connection CREATED while its
#: path is cut (faults.py blackholes it with INF latency) derives its
#: timeout from the effective matrix, and an uncapped 2x-INF RTO both
#: stalls retries forever and overflows the C twin's int64 timer math.
#: Physical latencies are ms-scale, so the cap only binds on cut paths.
RTO_MAX_NS = 60_000 * NS_PER_MS
SYN_RETRIES = 5
FIN_RETRIES = 5
DATA_RETRIES = 8  # consecutive data RTOs before the connection resets

#: SACK blocks per ack (TCP fits 3-4 in the options space; we keep 4)
SACK_MAX_BLOCKS = 4


def _icbrt(x: int) -> int:
    """Floor integer cube root (binary search; operands stay < 2**60 so
    the C twin computes the identical result in int64)."""
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if mid * mid * mid <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _sb_has(sb: list, seq: int) -> bool:
    """Sorted-scoreboard membership (bisect; the lists are tiny — entries
    are a subset of the rtx seqs under loss)."""
    i = bisect_left(sb, seq)
    return i < len(sb) and sb[i] == seq


class CongestionControl:
    """The pluggable congestion-control seam: pure window arithmetic over
    the sender's integer state (cwnd/ssthresh plus the cubic epoch fields
    w_max/epoch_start, which live ON the sender so checkpoint export and
    the determinism fingerprint stay uniform across algorithms).

    Contract: every hook mutates only ``s.cwnd``/``s.ssthresh``/
    ``s.w_max``/``s.epoch_start``, in integer arithmetic with no negative
    floor divisions — the C endpoint twin (native/colcore ``cc_*``
    functions, dispatched on the same ``cc_id``) must reproduce every
    result bit-exactly in int64, so any new algorithm needs BOTH halves
    or the cross-plane byte-identity gates fail."""

    name = "?"
    cc_id = -1

    def on_ack(self, s: "StreamSender", newly: int) -> None:
        """``newly`` bytes newly acknowledged (called for every
        cumulative advance, including during recovery — ack-clocked
        growth, like the pre-seam behavior)."""
        raise NotImplementedError

    def on_loss(self, s: "StreamSender") -> None:
        """Entering fast-retransmit recovery (3rd duplicate ack)."""
        raise NotImplementedError

    def on_rto(self, s: "StreamSender") -> None:
        """Retransmission timeout: collapse to slow start."""
        raise NotImplementedError


class NewReno(CongestionControl):
    """RFC 5681-shaped slow start + AIMD — the extracted default,
    bit-identical to the pre-seam inline arithmetic."""

    name = "newreno"
    cc_id = 0

    def on_ack(self, s, newly):
        if s.cwnd < s.ssthresh:
            s.cwnd += min(newly, s.cwnd)  # slow start (doubles/RTT)
        else:
            s.cwnd += max(1, MSS * newly // s.cwnd)  # AIMD

    def on_loss(self, s):
        s.ssthresh = max(s.inflight // 2, MIN_CWND)
        s.cwnd = max(s.cwnd // 2, MIN_CWND)

    def on_rto(self, s):
        s.ssthresh = max(s.inflight // 2, MIN_CWND)
        s.cwnd = MIN_CWND


class CubicLike(CongestionControl):
    """CUBIC-shaped variant (RFC 8312 reduced to integer arithmetic):
    beta = 0.7 multiplicative decrease, and congestion avoidance grows
    toward the cubic function W(t) = C*(t-K)^3 + w_max with C = 0.4 and
    t measured from the last decrease (``s.epoch_start``). All division
    operands are clamped non-negative and below 2**63 so the C twin's
    truncating int64 division equals Python's floor division."""

    name = "cubic"
    cc_id = 1

    def on_ack(self, s, newly):
        if s.cwnd < s.ssthresh:
            s.cwnd += min(newly, s.cwnd)  # slow start, shared shape
            return
        now = s.ep.host._now
        if s.epoch_start == 0:  # first CA ack with no recorded epoch
            s.epoch_start = now
            s.w_max = s.cwnd
        t_ms = (now - s.epoch_start) // NS_PER_MS
        # K = cbrt(w_max * beta_decrement / C) seconds, in ms; operands
        # clamped so (…)*1e9 stays under 2**63 in the C twin
        wmax_c = min(s.w_max, 1 << 32)
        k_ms = _icbrt((wmax_c * 3 // (4 * MSS)) * 1_000_000_000)
        d = t_ms - k_ms
        if d > 200_000:
            d = 200_000
        elif d < -200_000:
            d = -200_000
        a = -d if d < 0 else d
        # C*(t-K)^3 with C = 0.4*MSS bytes/s^3: cube in ms^3, scaled by
        # 4*MSS/10 over 1e9 — split into two non-negative divisions
        delta = (a * a * a // 1_000_000) * (4 * MSS) // 10_000
        target = s.w_max - delta if d < 0 else s.w_max + delta
        if target < MIN_CWND:
            target = MIN_CWND
        elif target > 1 << 45:
            target = 1 << 45
        nn = min(newly, 1 << 20)
        if s.cwnd < target:
            dd = min(target - s.cwnd, 1 << 40)
            inc = dd * nn // s.cwnd
            s.cwnd = min(s.cwnd + (inc if inc > 1 else 1), target)
        else:
            # at/above the cubic target: slow reno-friendly creep
            inc = MSS * nn // (100 * s.cwnd)
            s.cwnd += inc if inc > 1 else 1

    def on_loss(self, s):
        s.w_max = s.cwnd
        s.epoch_start = s.ep.host._now
        nc = s.cwnd * 7 // 10
        s.ssthresh = s.cwnd = nc if nc > MIN_CWND else MIN_CWND

    def on_rto(self, s):
        s.w_max = s.cwnd
        s.epoch_start = s.ep.host._now
        half = s.inflight // 2
        s.ssthresh = half if half > MIN_CWND else MIN_CWND
        s.cwnd = MIN_CWND


#: config name -> class (config/schema.py validates against these keys)
CONGESTION_CONTROLS = {"newreno": NewReno, "cubic": CubicLike}


class StreamSender:
    """The sending half of one endpoint: segmentation, windows, retransmit."""

    def __init__(self, endpoint: "StreamEndpoint", send_buffer: int,
                 cc: Optional[CongestionControl] = None):
        self.ep = endpoint
        self.chunk = endpoint.host.unit_chunk  # fluid quantum payload size
        self.cc = cc if cc is not None else NewReno()
        self.cwnd = INIT_CWND
        self.ssthresh = 1 << 62
        self.send_buffer = send_buffer
        self.snd_nxt = 0  # next byte offset to segment
        self.snd_una = 0  # oldest unacknowledged byte
        self.adv_wnd = INIT_CWND  # peer's advertised window (from handshake)
        self.sendbuf: deque[tuple[int, Optional[bytes]]] = deque()
        self.buffered = 0  # bytes in sendbuf (not yet segmented)
        self.rtx: deque[tuple[int, int, Optional[bytes]]] = deque()  # (seq, n, payload)
        self.rto_timer: Optional[int] = None
        self.rto_backoff = 1
        self.retries = 0
        self.loss_events = 0
        self.bytes_acked = 0
        self.dup_acks = 0  # consecutive duplicate acks (RFC 5681 counting)
        #: SACK scoreboard: seqs of rtx entries the peer reported holding
        #: (pruned as the cumulative ack passes them), the highest SACKed
        #: byte seen since the last RTO (holes live strictly below it),
        #: and the per-recovery-episode list of already-retransmitted seqs
        #: — "all holes per RTT" means each hole at most once per episode.
        #: Both are SORTED lists, not sets: membership stays cheap
        #: at scoreboard scale (entries ⊆ rtx seqs, a handful under real
        #: loss), iteration order is canonical by construction — the
        #: determinism fingerprint reads them without a sort
        self.sacked: list[int] = []
        self.sack_high = 0
        self.rtx_done: list[int] = []
        self.in_recovery = False
        self.recover = 0  # recovery point: snd_nxt when recovery began
        #: cubic epoch state (CongestionControl contract: on the sender)
        self.w_max = 0
        self.epoch_start = 0

    # -- app side ----------------------------------------------------------
    def queue(self, nbytes: int, payload: Optional[bytes]) -> int:
        room = self.send_buffer - self.buffered
        accept = min(nbytes, max(room, 0))
        if accept <= 0:
            return 0
        self.sendbuf.append((accept, payload[:accept] if payload is not None else None))
        self.buffered += accept
        self.pump()
        return accept

    @property
    def inflight(self) -> int:
        return self.snd_nxt - self.snd_una

    def pump(self) -> None:
        ep = self.ep
        if ep.state not in (ESTABLISHED, CLOSING):
            return  # not yet connected (or closing past data); connect re-pumps
        window = min(self.cwnd, max(self.adv_wnd, MSS))
        while self.buffered > 0 and self.inflight < window:
            usable = window - self.inflight
            # silly-window avoidance (Nagle-shaped): emit only full-size
            # chunks or the final tail of the app buffer; sub-chunk window
            # remainders wait for more acks — except when idle, where
            # sending something is what restarts the ack clock
            if usable < self.chunk and usable < self.buffered and self.inflight > 0:
                break
            budget = min(usable, self.chunk)
            nbytes, payload = self.sendbuf[0]
            if nbytes <= budget:
                self.sendbuf.popleft()
                chunk_p = payload
            else:
                chunk_p = payload[:budget] if payload is not None else None
                rest_p = payload[budget:] if payload is not None else None
                self.sendbuf[0] = (nbytes - budget, rest_p)
                nbytes = budget
            self.buffered -= nbytes
            seq = self.snd_nxt
            self.snd_nxt += nbytes
            self.rtx.append((seq, nbytes, chunk_p))
            self._emit_data(seq, nbytes, chunk_p)
        if self.inflight > 0:
            self._arm_rto()
        elif self.buffered == 0:
            self.ep._on_sender_drained()

    def _emit_data(self, seq: int, nbytes: int, payload: Optional[bytes]) -> None:
        # recovery comes entirely from duplicate acks like real TCP — the
        # sender gets no simulator-side loss information
        self.ep.emit(U.DATA, nbytes=nbytes, payload=payload, seq=seq)

    # -- loss recovery (SACK) ----------------------------------------------
    def _apply_sack(self, payload: bytes) -> None:
        """Fold an arriving ack's SACK blocks (pairs of big-endian u64
        byte offsets) into the scoreboard: mark every rtx segment fully
        covered by a block, and track the highest SACKed byte."""
        sacked = self.sacked
        for off in range(0, len(payload) - 15, 16):
            a = int.from_bytes(payload[off:off + 8], "big")
            b = int.from_bytes(payload[off + 8:off + 16], "big")
            if b > self.sack_high:
                self.sack_high = b
            for seq, n, _p in self.rtx:
                if seq >= b:
                    break  # rtx is seq-ascending
                if seq >= a and seq + n <= b and not _sb_has(sacked, seq):
                    insort(sacked, seq)

    def _retransmit_holes(self, force_head: bool = False) -> int:
        """Retransmit every un-SACKed, not-yet-retransmitted segment
        below the highest SACKed byte — ALL holes in one burst, so a
        multi-unit loss repairs in one RTT. ``force_head`` additionally
        retransmits the oldest segment even without SACK cover (the
        no-SACK-info entry fallback and the NewReno partial-ack rule).
        Returns the number of segments emitted."""
        hi = self.sack_high
        sacked, done = self.sacked, self.rtx_done
        emitted = 0
        for i, (seq, n, p) in enumerate(self.rtx):
            if seq >= hi and not (force_head and i == 0):
                break  # rtx is seq-ascending: nothing past hi is a hole
            if _sb_has(sacked, seq) or _sb_has(done, seq):
                continue
            insort(done, seq)
            self._emit_data(seq, n, p)
            emitted += 1
        return emitted

    def _enter_recovery(self) -> None:
        """The fast-retransmit response (3rd consecutive duplicate ack):
        multiplicative decrease + retransmit of every known hole + RTO
        reset."""
        self.loss_events += 1
        host = self.ep.host
        if host.faults_active:
            host.counters.add("stream_fast_retransmits", 1)
        self.in_recovery = True
        self.recover = self.snd_nxt
        self.rtx_done.clear()
        self.cc.on_loss(self)
        emitted = self._retransmit_holes(force_head=True)
        if emitted > 1 and host.faults_active:
            host.counters.add("stream_sack_retransmits", emitted - 1)
        self._arm_rto(reset=True)

    def _exit_recovery(self) -> None:
        self.in_recovery = False
        self.rtx_done.clear()

    def _arm_rto(self, reset: bool = False) -> None:
        if reset and self.rto_timer is not None:
            self.ep.host.cancel(self.rto_timer)
            self.rto_timer = None
        if self.rto_timer is None:
            self.rto_timer = self.ep.host.schedule_in(
                self.ep.rto_ns * self.rto_backoff, self._on_rto)

    def _cancel_rto(self) -> None:
        if self.rto_timer is not None:
            self.ep.host.cancel(self.rto_timer)
            self.rto_timer = None

    def _on_rto(self) -> None:
        self.rto_timer = None
        if self.inflight == 0 or self.ep.state in (CLOSED, TIME_WAIT):
            return
        if self.adv_wnd > 0:
            # zero-window retransmits are persist probes, not losses: TCP
            # probes a closed peer window indefinitely instead of counting
            # toward the retry limit (the backoff below still applies)
            self.retries += 1
        if self.retries > DATA_RETRIES:
            # terminal ETIMEDOUT: an established connection whose peer is
            # unreachable (crashed host, unhealed partition) dies here,
            # like TCP's retransmission timeout — the application sees
            # connection death instead of a silent stall (faults.py)
            host = self.ep.host
            if host.faults_active:
                host.counters.add("stream_timeouts", 1)
            self.ep._reset(
                "connection timed out (ETIMEDOUT): data retransmission "
                "retries exhausted")
            return
        if self.ep.host.faults_active:
            self.ep.host.counters.add("stream_rto_retransmits", 1)
        # classic RTO response: collapse to slow start, back off, resend the
        # oldest unacked chunk (its ACK, cumulative, repairs everything
        # else). The SACK scoreboard is discarded (RFC 2018 §8 renege
        # safety): after a timeout the receiver's reported state is stale.
        self.sacked.clear()
        self.rtx_done.clear()
        self.sack_high = 0
        self.in_recovery = False
        self.cc.on_rto(self)
        self.rto_backoff = min(self.rto_backoff * 2, 64)
        seq, nbytes, payload = self.rtx[0]
        self._emit_data(seq, nbytes, payload)
        self._arm_rto()

    # -- ack processing ----------------------------------------------------
    def on_ack(self, cum_ack: int, wnd: int,
               sack: Optional[bytes] = None) -> None:
        prev_wnd = self.adv_wnd
        self.adv_wnd = wnd
        if sack is not None:
            self._apply_sack(sack)
        if cum_ack > self.snd_una:
            self.dup_acks = 0
            newly = cum_ack - self.snd_una
            self.snd_una = cum_ack
            self.bytes_acked += newly
            while self.rtx and self.rtx[0][0] + self.rtx[0][1] <= cum_ack:
                self.rtx.popleft()
            if self.sacked:
                del self.sacked[:bisect_left(self.sacked, cum_ack)]
            if self.rtx_done:
                del self.rtx_done[:bisect_left(self.rtx_done, cum_ack)]
            self.rto_backoff = 1
            self.retries = 0
            self._cancel_rto()
            if self.inflight > 0:
                self._arm_rto()
            if self.in_recovery:
                if self.snd_una >= self.recover:
                    self._exit_recovery()
                else:
                    # partial ack: the oldest hole arrived but the burst
                    # is not repaired — retransmit the NEW oldest segment
                    # (NewReno partial-ack rule) plus any holes the
                    # scoreboard newly exposes, each at most once
                    n = self._retransmit_holes(force_head=True)
                    if n and self.ep.host.faults_active:
                        self.ep.host.counters.add(
                            "stream_sack_retransmits", n)
            self.cc.on_ack(self, newly)
            drained = self.ep.on_drain
            if drained is not None and self.buffered < self.send_buffer:
                drained(self.send_buffer - self.buffered)
        elif (cum_ack == self.snd_una
              and wnd == prev_wnd and self.inflight > 0 and self.rtx):
            # duplicate ack (RFC 5681: same cum, same window, data
            # outstanding); the 3rd CONSECUTIVE one enters recovery and
            # retransmits EVERY hole the scoreboard knows about
            self.dup_acks += 1
            if self.dup_acks == 3 and not self.in_recovery:
                self._enter_recovery()
            elif self.in_recovery and sack is not None:
                # later dup acks can expose new holes (higher sack_high)
                n = self._retransmit_holes()
                if n and self.ep.host.faults_active:
                    self.ep.host.counters.add("stream_sack_retransmits", n)
        else:
            self.dup_acks = 0  # anything else breaks the consecutive run
        self.pump()  # pump() fires _on_sender_drained when fully drained


class StreamReceiver:
    """Receiving half: in-order delivery, OOO buffering, cumulative acks."""

    def __init__(self, endpoint: "StreamEndpoint", recv_buffer: int):
        self.ep = endpoint
        self.recv_buffer = recv_buffer
        self.rcv_nxt = 0
        self.ooo: dict[int, tuple[int, Optional[bytes]]] = {}  # seq -> (n, p)
        self.ooo_bytes = 0
        self.bytes_received = 0
        #: optional delegate reporting delivered-but-unread application
        #: bytes (the managed-process bridge wires this to the guest's
        #: rxbuf); plugin apps consume synchronously, so it stays None
        self.app_unread: Optional[Callable[[], int]] = None
        #: the window the peer last heard (via flush_ack / handshake);
        #: drives read-triggered window-update acks
        self.last_wnd = recv_buffer

    def window(self) -> int:
        unread = self.app_unread() if self.app_unread is not None else 0
        return max(self.recv_buffer - self.ooo_bytes - unread, 0)

    def on_data(self, seq: int, n: int, payload: Optional[bytes],
                now: SimTime) -> None:
        if seq + n <= self.rcv_nxt:
            self._dup_ack()  # duplicate (retransmit after lost ACK): re-ack
            return
        if seq > self.rcv_nxt:
            if seq not in self.ooo and n <= self.window():
                self.ooo[seq] = (n, payload)
                self.ooo_bytes += n
            self._dup_ack()  # duplicate ack: rcv_nxt unchanged
            return
        if n > self.window():
            # beyond-window in-order data (a sender probing a closed
            # window): refuse it like TCP drops out-of-window segments —
            # rcv_nxt stays, a COALESCED ack re-advertises the window,
            # and the sender's RTO retries until the app reads. Not a
            # dup ack: counting probe refusals toward fast retransmit
            # would halve cwnd during a stall where nothing was lost.
            self._ack()
            return
        self._deliver(n, payload, now)
        while self.rcv_nxt in self.ooo:
            n2, p2 = self.ooo.pop(self.rcv_nxt)
            self.ooo_bytes -= n2
            self._deliver(n2, p2, now)
        self._ack()

    def on_app_read(self) -> None:
        """The app consumed buffered bytes: if the peer last saw a
        materially closed window, queue a window-update ack (flushed,
        coalesced, at the round barrier)."""
        if (self.last_wnd < (self.recv_buffer >> 2)
                and self.window() > self.last_wnd
                and self.ep.state not in (CLOSED, TIME_WAIT)):
            self._ack()

    def _deliver(self, nbytes: int, payload, now: SimTime) -> None:
        self.rcv_nxt += nbytes
        self.bytes_received += nbytes
        if self.ep.on_data is not None:
            self.ep.on_data(nbytes, payload, now)

    def sack_payload(self) -> Optional[bytes]:
        """The receiver's SACK report: its buffered out-of-order segments
        merged into contiguous [start, end) byte ranges, the lowest
        SACK_MAX_BLOCKS of them, each encoded as two big-endian u64s in
        the ACK's payload field (wire size unchanged — SACK option bytes
        are noise at fluid-quantum granularity). None when nothing is
        buffered, which is every ack of a loss-free connection. The C
        receiver twin (colcore cr_sack_payload) emits identical bytes."""
        ooo = self.ooo
        if not ooo:
            return None
        out = bytearray()
        nblocks = 0
        cs = ce = -1
        for s in sorted(ooo):
            n = ooo[s][0]
            if cs < 0:
                cs, ce = s, s + n
            elif s == ce:
                ce = s + n
            else:
                out += cs.to_bytes(8, "big") + ce.to_bytes(8, "big")
                nblocks += 1
                if nblocks == SACK_MAX_BLOCKS:
                    return bytes(out)
                cs, ce = s, s + n
        out += cs.to_bytes(8, "big") + ce.to_bytes(8, "big")
        return bytes(out)

    def _ack(self) -> None:
        # round-barrier ack coalescing (the fluid analog of delayed acks):
        # every in-round delivery marks the endpoint; the engine flushes ONE
        # cumulative ACK per connection at the barrier. Halves unit volume
        # on bulk transfers with identical reliability (acks are cumulative
        # and the sender's RTO floor far exceeds a round width).
        self.ep.host.mark_ack(self.ep)

    def _dup_ack(self) -> None:
        """Out-of-order / duplicate data: real TCP acks IMMEDIATELY
        (RFC 5681 §4.2 — dup acks must not be delayed, they drive the
        sender's fast-retransmit counter). Two deliberate choices keep
        the counter sound in the fluid model: the dup ack re-advertises
        ``last_wnd`` (the window the peer last heard) rather than the
        recomputed one — buffering the OOO segment shrinks window() by n
        every time, which would make consecutive dup acks all differ and
        defeat the sender's same-window test — and it supersedes any
        coalesced ack queued this round (a same-cum barrier ack would
        inflate the count)."""
        ep = self.ep
        if ep.state in (CLOSED, TIME_WAIT):
            return
        ep.host._ack_eps.pop(ep, None)
        ep.emit(U.ACK, payload=self.sack_payload(), acked=self.rcv_nxt,
                wnd=self.last_wnd)

    def flush_ack(self) -> None:
        self.last_wnd = self.window()
        self.ep.emit(U.ACK, payload=self.sack_payload(),
                     acked=self.rcv_nxt, wnd=self.last_wnd)


# endpoint states
CLOSED, SYN_SENT, ESTABLISHED, CLOSING, FIN_SENT, TIME_WAIT = range(6)


class StreamEndpoint:
    """One host's view of a stream connection (half of the four-tuple).

    Host-local by construction: the only cross-host interaction is emitting
    units into the owning host's egress queue; all recovery is driven by
    this host's own timers and arriving units.
    """

    def __init__(self, host, local_port: int, remote_host: int, remote_port: int,
                 initiator: bool, send_buffer: int = 131072,
                 recv_buffer: int = 174760,
                 cc: Optional[str] = None):
        self.host = host
        self.local_port = local_port
        self.remote_host = remote_host
        self.remote_port = remote_port
        self.initiator = initiator
        self.state = CLOSED
        cc_cls = CONGESTION_CONTROLS[cc] if cc else NewReno
        self.sender = StreamSender(self, send_buffer, cc=cc_cls())
        self.receiver = StreamReceiver(self, recv_buffer)
        self.syn_tries = 0
        self.fin_tries = 0
        self._ctl_timer: Optional[int] = None  # SYN/FIN retransmit timer
        #: optional idle timeout (the app-level keepalive analog): a pure
        #: RECEIVER has no outstanding data, so the RTO ladder can never
        #: detect a dead peer (real TCP has the same blind spot without
        #: keepalive). When armed, the timer rearms on every arrival and
        #: its expiry surfaces ETIMEDOUT. Opt-in per endpoint
        #: (set_idle_timeout); models wire it to an environment knob.
        self.idle_timeout_ns: Optional[SimTime] = None
        self._idle_timer: Optional[int] = None
        self.peer_fin = False  # peer closed while we still had data to send
        # deterministic per-path timeout: 2x RTT, floored and capped
        rtt = (host.engine.latency_between(host.id, remote_host)
               + host.engine.latency_between(remote_host, host.id))
        self.rto_ns: SimTime = min(max(2 * rtt, RTO_MIN_NS), RTO_MAX_NS)
        # app callbacks
        self.on_connected: Optional[Callable[[SimTime], None]] = None
        self.on_data: Optional[Callable[[int, Optional[bytes], SimTime], None]] = None
        self.on_drain: Optional[Callable[[int], None]] = None
        self.on_close: Optional[Callable[[SimTime], None]] = None
        self.on_error: Optional[Callable[[str], None]] = None

    # -- API used by ProcessAPI ------------------------------------------
    def send(self, nbytes: int = 0, payload: Optional[bytes] = None) -> int:
        """Queue bytes for transmission; returns the count accepted (may be
        short when the send buffer is full — see on_drain)."""
        if payload is not None:
            nbytes = len(payload)
        if nbytes <= 0 or self.state in (CLOSING, FIN_SENT, TIME_WAIT):
            return 0
        accepted = self.sender.queue(nbytes, payload)
        self.host.counters.add("stream_bytes_queued", accepted)
        return accepted

    def close(self) -> None:
        if self.state in (CLOSED, CLOSING, FIN_SENT, TIME_WAIT):
            return
        self.state = CLOSING
        self.sender.pump()  # fires _on_sender_drained when nothing remains

    def connect(self) -> None:
        self.state = SYN_SENT
        self._send_syn()

    def set_idle_timeout(self, timeout_ns: SimTime) -> None:
        """Arm (or disarm with None/0) the idle timeout; see the field
        docstring. The C endpoint carries the exact twin
        (colcore CEp_set_idle_timeout — same rearm-per-arrival seq
        consumption, same expiry semantics), so fault configs behave
        identically with the C engine on."""
        self._cancel_idle()
        self.idle_timeout_ns = timeout_ns if timeout_ns else None
        if self.idle_timeout_ns is not None:
            self._idle_timer = self.host.schedule_in(
                self.idle_timeout_ns, self._idle_expired)

    def _cancel_idle(self) -> None:
        if self._idle_timer is not None:
            self.host.cancel(self._idle_timer)
            self._idle_timer = None

    def _rearm_idle(self) -> None:
        if self.idle_timeout_ns is not None:
            self._cancel_idle()
            self._idle_timer = self.host.schedule_in(
                self.idle_timeout_ns, self._idle_expired)

    def _idle_expired(self) -> None:
        self._idle_timer = None
        if self.state in (CLOSED, TIME_WAIT):
            return
        if self.host.faults_active:
            self.host.counters.add("stream_timeouts", 1)
        self._reset("connection timed out (ETIMEDOUT): idle timeout — no "
                    "traffic from peer")

    # -- internals --------------------------------------------------------
    def _send_syn(self) -> None:
        self.syn_tries += 1
        if self.syn_tries > SYN_RETRIES:
            self._reset("connection timed out (ETIMEDOUT): SYN retries "
                        "exhausted")
            return
        self.emit(U.SYN, wnd=self.receiver.window())
        self._ctl_timer = self.host.schedule_in(
            self.rto_ns * min(1 << (self.syn_tries - 1), 64), self._syn_timeout)

    def _syn_timeout(self) -> None:
        if self.state == SYN_SENT:
            self._send_syn()

    def _on_sender_drained(self) -> None:
        """All outbound data sent and acked: finish whichever close is
        pending — the peer's (answer their deferred FIN) or our own."""
        if self.peer_fin and self.state in (ESTABLISHED, CLOSING):
            self.emit(U.FINACK)
            self._enter_time_wait(self.host.now)
        elif self.state == CLOSING:
            self.state = FIN_SENT
            self._send_fin()

    def _send_fin(self) -> None:
        self.fin_tries += 1
        if self.fin_tries > FIN_RETRIES:
            self._drop()  # orphan timeout: give up like TCP would
            return
        self.emit(U.FIN)
        self._ctl_timer = self.host.schedule_in(
            self.rto_ns * min(1 << (self.fin_tries - 1), 64), self._fin_timeout)

    def _fin_timeout(self) -> None:
        if self.state == FIN_SENT:
            self._send_fin()

    def _cancel_ctl(self) -> None:
        if self._ctl_timer is not None:
            self.host.cancel(self._ctl_timer)
            self._ctl_timer = None

    def _reset(self, reason: str) -> None:
        self.host.counters.add("stream_resets", 1)
        err = self.on_error
        self._drop()
        if err is not None:
            err(reason)

    def _drop(self) -> None:
        self._cancel_ctl()
        self.sender._cancel_rto()
        self._cancel_idle()
        self.state = CLOSED
        self.host.drop_endpoint(self)

    def _enter_time_wait(self, now: SimTime) -> None:
        """FINACK sent: linger to re-ack a retransmitted FIN, then vanish."""
        if self.state == TIME_WAIT:
            return
        was_open = self.state in (ESTABLISHED, CLOSING, FIN_SENT)
        self.state = TIME_WAIT
        self._cancel_ctl()
        self.sender._cancel_rto()
        self._cancel_idle()
        self.host.schedule_in(2 * self.rto_ns, self._drop)
        if was_open and self.on_close is not None:
            self.on_close(now)

    def emit(self, kind: int, nbytes: int = 0, payload: Optional[bytes] = None,
             seq: int = 0, acked: int = 0, wnd: int = 0) -> None:
        # control units overload the fields: nbytes carries the cumulative
        # ack, seq carries the advertised window
        self.host.emit_msg(
            kind, self.remote_host, nbytes + HEADER,
            nbytes if kind == U.DATA else acked, payload,
            seq if kind == U.DATA else wnd,
            self.local_port, self.remote_port)

    # -- unit arrivals (dispatched by the host) ---------------------------
    def handle(self, unit: Unit, now: SimTime) -> None:
        self.handle_fields(unit.kind, unit.nbytes, unit.payload, unit.seq,
                           now)

    def handle_fields(self, k: int, nbytes: int, payload: Optional[bytes],
                      seq: int, now: SimTime) -> None:
        """Field-level arrival dispatch shared by the per-unit plane
        (via handle) and the columnar plane's inbox loop. Control units:
        nbytes = cumulative ack, seq = advertised window."""
        if self._idle_timer is not None:
            self._rearm_idle()  # any arrival proves the peer is alive
        if k == U.SYN:
            # (server side) duplicate SYN: the SYNACK was lost — re-ack
            if self.state == ESTABLISHED:
                self.sender.adv_wnd = seq
                self.emit(U.SYNACK, wnd=self.receiver.window())
            return
        if k == U.SYNACK:
            if self.state == SYN_SENT:
                self.state = ESTABLISHED
                self.sender.adv_wnd = seq
                self._cancel_ctl()
                if self.on_connected is not None:
                    self.on_connected(now)
                self.sender.pump()
            return
        if k == U.DATA:
            if self.state in (CLOSED, TIME_WAIT):
                return
            self.host.counters.add("stream_bytes_received", nbytes)
            self.receiver.on_data(seq, nbytes, payload, now)
            return
        if k == U.ACK:
            if self.state in (CLOSED, TIME_WAIT):
                return
            self.sender.on_ack(nbytes, seq, payload)
            return
        if k == U.FIN:
            # the peer's data all precedes its FIN (it fins only once fully
            # acked) — but OUR outbound direction may still be mid-stream
            if self.state == SYN_SENT:
                # peer accepted then closed before our SYNACK arrived view
                self.emit(U.FINACK)
                self._reset("connection closed by peer")
                return
            if (self.state in (ESTABLISHED, CLOSING)
                    and (self.sender.buffered > 0 or self.sender.inflight > 0)):
                # half-close: keep transmitting; FINACK when drained
                # (the peer keeps receiving in FIN_SENT). Its FIN will
                # retransmit until then — each repeat lands here again.
                self.peer_fin = True
                return
            self.emit(U.FINACK)
            if self.state != CLOSED:
                # covers simultaneous close too (FIN while FIN_SENT:
                # treat the peer's FIN as confirmation)
                self._enter_time_wait(now)
            return
        if k == U.FINACK:
            if self.state == FIN_SENT:
                self._cancel_ctl()
                self._drop()
                if self.on_close is not None:
                    self.on_close(now)
            return

    def fingerprint(self) -> tuple:
        """Observable protocol state for the determinism sentinel
        (checkpoint.py): the full connection state machine —
        identical across data planes and scheduler policies at a round
        boundary, and the first place a divergence in traffic shows up."""
        s, r = self.sender, self.receiver
        return (self.state, self.initiator, self.syn_tries, self.fin_tries,
                self.peer_fin, s.snd_nxt, s.snd_una, s.cwnd, s.ssthresh,
                s.adv_wnd, s.buffered, s.retries, s.rto_backoff, s.dup_acks,
                s.loss_events, s.bytes_acked, r.rcv_nxt, r.ooo_bytes,
                r.bytes_received, r.last_wnd,
                # SACK scoreboard + congestion-control seam state
                # (same order/types in the C twin's CEp_fingerprint)
                s.cc.cc_id, s.w_max, s.epoch_start,
                1 if s.in_recovery else 0, s.recover, s.sack_high,
                # sorted lists: canonical by construction
                tuple(s.sacked), tuple(s.rtx_done))


class DatagramSocket:
    """UDP-like socket with fragmentation/reassembly."""

    def __init__(self, host, local_port: int):
        self.host = host
        self.local_port = local_port
        self.on_datagram: Optional[
            Callable[[int, Optional[bytes], tuple, SimTime], None]
        ] = None
        self._next_dgram = 0
        self._partial: dict[tuple, list] = {}  # (src, sport, dgram) -> frags

    def sendto(self, dst_host: int, dst_port: int, nbytes: int = 0,
               payload: Optional[bytes] = None) -> None:
        # nbytes may exceed len(payload): wire size is nbytes, with the real
        # payload bytes riding along (lets workloads model fixed-size
        # messages without materializing padding)
        if payload is not None:
            nbytes = max(nbytes, len(payload))
        dgram = self._next_dgram
        self._next_dgram += 1
        host = self.host
        chunk = host.unit_chunk
        nfrags = max(1, -(-nbytes // chunk))
        host._n_dgrams += 1
        port = self.local_port
        if nfrags == 1:  # the overwhelmingly common case: one row, go
            cp = host.colplane
            if cp is not None and host.pcap is None:
                c = cp._c
                if c is not None:
                    # C engine: packed egress row
                    c.emit_row(host.id, U.DGRAM, dst_host, nbytes + HEADER,
                               host._now, port, dst_port, nbytes, dgram,
                               0, 1, payload)
                    return
                # columnar fast path: inline the emit_msg tuple append
                # (this call is the hottest emission site at gossip scale)
                eg = host.egress_rows
                if not eg:
                    cp.emitters.append(host)
                eg.append((U.DGRAM, dst_host, nbytes + HEADER, host._now,
                           port, dst_port, nbytes, dgram, 0, 1, payload))
                host._n_emitted += 1
                return
            host.emit_msg(U.DGRAM, dst_host, nbytes + HEADER, nbytes,
                          payload, dgram, port, dst_port)
            return
        emit = host.emit_msg
        for i in range(nfrags):
            lo = i * chunk
            hi = min(nbytes, lo + chunk)
            emit(U.DGRAM, dst_host, (hi - lo) + HEADER, hi - lo,
                 payload[lo:hi] if payload is not None else None,
                 dgram, port, dst_port, frag_idx=i, nfrags=nfrags)

    def handle(self, unit: Unit, now: SimTime) -> None:
        self.handle_fields(unit.nbytes, unit.payload,
                           (unit.src, unit.src_port), unit.seq,
                           unit.frag_idx, unit.nfrags, now)

    def handle_fields(self, nbytes: int, payload: Optional[bytes],
                      src_addr: tuple, dgram: int, frag_idx: int,
                      nfrags: int, now: SimTime) -> None:
        if nfrags == 1:
            self._deliver(nbytes, payload, src_addr, now)
            return
        key = (src_addr[0], src_addr[1], dgram)
        frags = self._partial.setdefault(key, [None] * nfrags)
        frags[frag_idx] = (nbytes, payload)
        if all(f is not None for f in frags):
            del self._partial[key]
            total = sum(n for n, _ in frags)
            whole = (
                b"".join(p for _, p in frags)
                if all(p is not None for _, p in frags)
                else None
            )
            self._deliver(total, whole, src_addr, now)
        elif len(self._partial) > 4096:  # bound memory: drop oldest partial
            self._partial.pop(next(iter(self._partial)))

    def _deliver(self, nbytes, payload, src_addr, now) -> None:
        self.host._n_dgrams_recv += 1
        if self.on_datagram is not None:
            self.on_datagram(nbytes, payload, src_addr, now)
