"""Simulated hosts.

A Host mirrors the reference's ``Host`` (SURVEY.md §2 "Host"): a simulated
machine with its own clock view, RNG stream, NIC token-bucket state (held in
the engine's arrays, indexed by host id), socket namespace, event queue, and
processes. All Host state is host-local: cross-host interaction happens
only through the network engine at round boundaries.

A copy of shadow_tpu/host/host.py for the columnar plane, with its C
engine hooks (the engine's stream endpoints and packed emission, when
network/colplane.py attached it). The per-unit plane's Unit path, packet
capture, the telemetry collector (flow records are dropped, as the
reference drops them with telemetry off), the fault lifecycle
(crash/reboot) and checkpoint pickling are not ported yet (their config
keys are refused at load).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional

from shadow_tpu_torch.core.events import BAND_APP, BAND_NET, EventQueue
from shadow_tpu_torch.core.rng import host_rng
from shadow_tpu_torch.core.time import SimTime
from shadow_tpu_torch.network import unit as U
from shadow_tpu_torch.network.fluid import HEADER, MTU
from shadow_tpu_torch.network.transport import (
    CONGESTION_CONTROLS, DatagramSocket, StreamEndpoint, ESTABLISHED)
from shadow_tpu_torch.utils.counters import Counters

EPHEMERAL_BASE = 49152
LOG_LEVELS = ("error", "warning", "info", "debug", "trace")


class Host:
    def __init__(self, host_id: int, name: str, ip: str, node_id: int,
                 seed: int, controller, cc: Optional[str] = None) -> None:
        self.id = host_id
        self.name = name
        self.ip = ip
        self.node_id = node_id
        self.controller = controller
        self.engine = None  # set by controller after engine construction
        # fluid quantum (experimental.unit_mtus): max stream payload bytes
        # per unit on this host's connections
        self.unit_chunk = (
            controller.cfg.experimental.unit_mtus * MTU - HEADER)
        #: congestion control for this host's stream endpoints
        #: (experimental.congestion_control, overridable per host via
        #: hosts.<name>.congestion_control); cc_id is the C twin's
        #: dispatch integer, read at core bind (colcore.c init_core)
        self.cc_name = cc or controller.cfg.experimental.congestion_control
        self.cc_id = CONGESTION_CONTROLS[self.cc_name].cc_id
        self.rng = host_rng(seed, host_id)
        self.equeue = EventQueue()
        self.counters = Counters()
        self._now: SimTime = 0
        self._uid_counter = 0
        #: columnar-plane state (set when the engine is a ColumnarPlane):
        #: egress rows are plain tuples; resolved arrival rows for the
        #: current round land in _inbox (see network/colplane.py)
        self.colplane = None
        #: columnar transport engine (network/devtransport.py) when
        #: experimental.device_transport is on: ack-dominated rounds defer
        #: to the barrier and advance as one batched kernel (bit-identical)
        self.devt = None
        #: the telemetry collector; always None here (the telemetry:
        #: section is refused at load), so models skip flow bookkeeping
        self.telemetry = None
        self.egress_rows: list[tuple] = []
        self._inbox = None
        self.ingress_deferred_rows: list[tuple] = []
        # hot-path counters kept as plain ints (Counter.__getitem__ per
        # unit measurably drags at 1M+ units); folded in fold_counters()
        self._n_emitted = 0
        self._n_delivered = 0
        self._n_dgrams = 0
        self._n_dgrams_recv = 0
        self._n_events = 0
        #: fault-injection state the C engine reads and folds into (faults.py
        #: is not ported: a host is never down, and without the plane's
        #: faults_active the engine counts nothing torn down or blackholed)
        self.down = False
        self._n_teardown = 0
        self._n_blackholed = 0
        #: packet capture (utils/pcap.py is not ported): always None, so
        #: every host takes the C engine's dispatch when it is attached
        self.pcap = None
        self.processes: list = []
        # sockets
        self._listeners: dict[int, Callable] = {}  # port -> on_accept
        self._udp: dict[int, DatagramSocket] = {}
        self._conns: dict[tuple[int, int, int], StreamEndpoint] = {}
        self._next_ephemeral = EPHEMERAL_BASE
        self._log_lines: list[str] = []
        #: running hash over the log lines (determinism sentinel): updated
        #: per append so a digest sample costs O(new bytes), not a re-hash
        #: of the whole history every sampled round
        self._log_sha = hashlib.sha256()
        self._ack_eps: dict = {}  # endpoints owing a coalesced barrier ack
        self.log_level = "info"  # per-host override (hosts.<name>.log_level)

    # -- time & events ----------------------------------------------------
    @property
    def now(self) -> SimTime:
        return self._now

    def schedule(self, time: SimTime, fn: Callable[[], None],
                 band: int = BAND_APP, key: int = -1) -> int:
        return self.equeue.push(time, fn, band=band, key=key)

    def schedule_in(self, delay: SimTime, fn: Callable[[], None]) -> int:
        return self.equeue.push(self._now + delay, fn)

    def cancel(self, handle: int) -> None:
        self.equeue.cancel(handle)

    def fold_counters(self) -> None:
        """Fold the int-attribute hot counters into the Counter object
        (called once at finalize, before the controller merges)."""
        if self._n_emitted:
            self.counters.add("units_emitted", self._n_emitted)
        if self._n_delivered:
            self.counters.add("units_delivered", self._n_delivered)
        if self._n_dgrams:
            self.counters.add("dgrams_sent", self._n_dgrams)
        if self._n_dgrams_recv:
            self.counters.add("dgrams_received", self._n_dgrams_recv)
        if self._n_events:
            self.counters.add("events", self._n_events)
        self._n_emitted = self._n_delivered = self._n_dgrams = 0
        self._n_dgrams_recv = 0
        self._n_events = 0

    def run_events(self, end: SimTime) -> int:
        """Execute all pending events with time < end (one round's worth).
        Resolved network rows (the inbox) merge with the heap in canonical
        (time, band, key) order."""
        n = 0
        rows = self._inbox
        if rows is None:
            while (ev := self.equeue.pop_until(end)) is not None:
                self._now, task = ev
                task()
                n += 1
            self._n_events += n
            return n
        self._inbox = None
        devt = self.devt
        if devt is not None and devt.intercept(self, rows, end):
            # device transport: the whole round (inbox AND due timers)
            # defers to the barrier, where cohorts of clean acks across
            # hosts advance as ONE batched kernel and everything replays
            # through this method's exact merge; the event count reports
            # through DeviceTransport.take_executed
            return 0
        eq = self.equeue
        heap = eq._heap
        dispatch = self.dispatch_row
        pos = 0
        ln = len(rows)
        # fast path: no heap events at all (common for workload hosts with
        # no pending timers) — straight row drain, re-checking only the
        # cheap emptiness bit in case a dispatch scheduled something
        while pos < ln and not heap:
            dispatch(rows[pos])
            pos += 1
            n += 1
        if heap:
            head = eq.head
            pop = eq.pop_until
            # the inbox<->heap merge with a CACHED head: while heap[0]
            # is still the validated head object (our local ref keeps it
            # alive, so identity is sound), its (t, band, key) is a
            # lower bound on the live head — a later cancel only moves
            # the live head LATER — so a row that beats it dispatches
            # without re-running head()'s cancelled-head scan. Anything
            # else re-validates. One identity check + tuple compare per
            # hot row instead of a method call.
            h0 = None
            while True:
                if h0 is not None and pos < ln and heap and heap[0] is h0:
                    row = rows[pos]
                    ti = row[0]
                    if (ti < h0[0]
                            or (ti == h0[0]
                                and (0, row[1]) < (h0[1], h0[2]))):
                        dispatch(row)
                        pos += 1
                        n += 1
                        continue
                h0 = head()
                hv = h0 is not None and h0[0] < end
                if pos < ln:
                    row = rows[pos]
                    ti = row[0]
                    # inbox rows are BAND_NET (0): they win same-time ties
                    # unless a heap net event carries a smaller key
                    if (not hv or ti < h0[0]
                            or (ti == h0[0]
                                and (0, row[1]) < (h0[1], h0[2]))):
                        dispatch(row)
                        pos += 1
                        n += 1
                        continue
                if hv:
                    self._now, task = pop(end)
                    task()
                    n += 1
                    continue
                break
        self._n_events += n
        return n

    def dispatch_row(self, row) -> None:
        """Columnar-plane arrival dispatch: the field-level twin of the
        per-unit plane's arrival event (engine.ingress_arrival + deliver).
        Charges the ingress token bucket at event time, in event order —
        exactly like the per-unit plane — parking the whole row into the
        deferred backlog when tokens run short."""
        (t, _key, _tgt, kind, peer, aport, bport, nbytes, seq, frag,
         nfrags, size, payload) = row
        if t > self._now:
            self._now = t
        eng = self.engine
        if t >= eng.bootstrap_end:
            tokens = eng.tokens_down
            if tokens[self.id] >= size:
                tokens[self.id] -= size
            else:
                self.ingress_deferred_rows.append(row)
                eng._deferred.add(self)
                return
        self._deliver_row(t, kind, peer, aport, bport, nbytes, seq, frag,
                          nfrags, payload)

    def _deliver_row(self, t: SimTime, kind: int, peer: int, aport: int,
                     bport: int, nbytes: int, seq: int, frag: int,
                     nfrags: int, payload) -> None:
        """The row cleared the ingress bucket: dispatch to a socket."""
        if t > self._now:
            self._now = t
        self._n_delivered += 1
        if kind == U.DGRAM:
            sock = self._udp.get(bport)
            if sock is None:
                self.counters.add("units_unroutable", 1)
                return
            sock.handle_fields(nbytes, payload, (peer, aport), seq, frag,
                               nfrags, t)
            return
        key = (bport, peer, aport)
        ep = self._conns.get(key)
        if ep is None:
            if kind == U.SYN:
                on_accept = self._listeners.get(bport)
                if on_accept is None:
                    self.counters.add("units_unroutable", 1)
                    return
                ep = self._make_endpoint(bport, peer, aport,
                                         initiator=False)
                ep.state = ESTABLISHED
                ep.sender.adv_wnd = seq  # client window rides the SYN
                self._conns[key] = ep
                ep.emit(U.SYNACK, wnd=ep.receiver.window())
                on_accept(ep, t)
                return
            self.counters.add("units_unroutable", 1)
            return
        ep.handle_fields(kind, nbytes, payload, seq, t)

    def record_flow(self, kind: str, peer, t_open: SimTime,
                    ttfb: Optional[SimTime], nbytes: int, status: str,
                    retx: int = 0, x: Optional[int] = None) -> None:
        """One application-flow lifecycle record, called at flow close
        from model code. The telemetry collector that keeps these records
        is not ported (``telemetry`` is always None), so the record is
        dropped, exactly as the reference drops it with telemetry off."""

    def mark_ack(self, ep) -> None:
        """Queue a coalesced barrier ack for this endpoint (transport's
        _ack); the columnar plane tracks owing hosts in a list instead of
        scanning all hosts at the barrier."""
        aeps = self._ack_eps
        if not aeps and self.colplane is not None:
            self.colplane.ack_hosts.append(self)
        aeps[ep] = None

    # -- units ------------------------------------------------------------
    def emit_msg(self, kind: int, dst: int, size: int, nbytes: int,
                 payload, seq: int, sport: int, dport: int,
                 frag_idx: int = 0, nfrags: int = 1) -> None:
        """Field-level emission API shared by the transport and datagram
        layers: one tuple append, no Unit object, no uid mint (uids are
        assigned vectorized at the barrier in the same per-host emission
        order)."""
        c = getattr(self.colplane, "_c", None)
        if c is not None:
            # C engine: packed egress row, no tuple (the C side also
            # tracks the emitters list and the emitted counter)
            c.emit_row(self.id, kind, dst, size, self._now, sport, dport,
                       nbytes, seq, frag_idx, nfrags, payload)
            return
        eg = self.egress_rows
        if not eg:
            self.colplane.emitters.append(self)
        eg.append((kind, dst, size, self._now, sport, dport, nbytes,
                   seq, frag_idx, nfrags, payload))
        self._n_emitted += 1

    # -- determinism sentinel (shadow_tpu/checkpoint.py) ------------------
    def state_fingerprint(self) -> dict:
        """Plane-independent observable state for the per-round state
        digest. Everything listed is identical across the per-unit and
        columnar planes (and every scheduler policy) at a round boundary;
        BAND_NET heap entries are deliberately excluded — the planes
        represent in-flight arrivals differently (host heap vs pending
        store), and their effects surface through the counters and
        endpoint machines below."""
        conns = []
        for key in sorted(self._conns):
            ep = self._conns[key]
            fp = getattr(ep, "fingerprint", None)
            conns.append((list(key),
                          fp() if fp is not None else type(ep).__name__))
        return {
            "now": self._now,
            "uid": self._uid_counter,
            "down": self.down,
            "emitted": self._n_emitted,
            "delivered": self._n_delivered,
            "dgrams": self._n_dgrams,
            "dgrams_recv": self._n_dgrams_recv,
            "events": self._n_events,
            "teardown": self._n_teardown,
            "blackholed": self._n_blackholed,
            "counters": dict(self.counters.c),
            "rng": self.rng.bit_generator.state,
            "timers": self.equeue.live_times(exclude_band=BAND_NET),
            "conns": conns,
            "listeners": sorted(self._listeners),
            "udp": sorted(self._udp),
            "ephemeral": self._next_ephemeral,
            "log_lines": len(self._log_lines),
            "log_sha": (self._log_sha.hexdigest()
                        if self._log_lines else ""),
        }

    # -- sockets ----------------------------------------------------------
    def ephemeral_port(self) -> int:
        p = self._next_ephemeral
        self._next_ephemeral += 1
        return p

    def listen(self, port: int, on_accept: Callable) -> None:
        if port in self._listeners:
            raise ValueError(f"{self.name}: port {port} already listening")
        self._listeners[port] = on_accept

    def unlisten(self, port: int) -> None:
        self._listeners.pop(port, None)

    def _make_endpoint(self, local_port: int, remote_host: int,
                       remote_port: int, initiator: bool) -> StreamEndpoint:
        exp = self.controller.cfg.experimental
        core = getattr(self.colplane, "_c", None)
        if core is not None:
            # C stream endpoint (native/colcore): the exact protocol twin
            # of StreamEndpoint, bit-identical under the colcore suites
            return core.make_endpoint(
                self.id, local_port, remote_host, remote_port,
                initiator, exp.socket_send_buffer, exp.socket_recv_buffer,
                self.cc_id)
        return StreamEndpoint(
            self, local_port, remote_host, remote_port, initiator=initiator,
            send_buffer=exp.socket_send_buffer,
            recv_buffer=exp.socket_recv_buffer,
            cc=self.cc_name,
        )

    def connect(self, remote_host: int, remote_port: int) -> StreamEndpoint:
        ep = self._make_endpoint(self.ephemeral_port(), remote_host,
                                 remote_port, initiator=True)
        self._conns[(ep.local_port, remote_host, remote_port)] = ep
        return ep  # caller sets callbacks, then calls ep.connect()

    def udp_socket(self, port: Optional[int] = None) -> DatagramSocket:
        if port is None:
            port = self.ephemeral_port()
        if port in self._udp:
            raise ValueError(f"{self.name}: UDP port {port} already bound")
        sock = DatagramSocket(self, port)
        self._udp[port] = sock
        return sock

    def find_endpoint(self, local_port: int, remote_host: int,
                      remote_port: int) -> Optional[StreamEndpoint]:
        return self._conns.get((local_port, remote_host, remote_port))

    def drop_endpoint(self, ep: StreamEndpoint) -> None:
        self._conns.pop((ep.local_port, ep.remote_host, ep.remote_port), None)

    # -- logging ----------------------------------------------------------
    def log(self, msg: str, level: str = "info") -> None:
        if LOG_LEVELS.index(level) <= LOG_LEVELS.index(self.log_level):
            self._log_lines.append(msg)
            self._log_sha.update(msg.encode() + b"\n")

    def flush_logs(self, data_dir) -> None:
        if not self._log_lines:
            return
        d = data_dir / "hosts" / self.name
        d.mkdir(parents=True, exist_ok=True)
        with open(d / f"{self.name}.log", "w") as f:
            f.write("\n".join(self._log_lines) + "\n")
