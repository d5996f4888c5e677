"""The network engine: per-round batched data plane orchestration.

The port of shadow_tpu/network/engine.py: the per-unit plane that the
thread policies (``thread_per_core``, ``thread_per_host``) run, as the
reference's CPU baseline. Under those policies the backend is ``numpy``:
every loss draw runs fluid.loss_flags on the host and no kernel launches.
The device branch of ``end_of_round`` (draw batches dispatched to
ops/propagate.py's DeviceDrawPlane, read at their causal deadlines) is
kept as the reference wrote it; no config reaches it, because the
controller maps the thread policies to the numpy backend. The
multi-process shard hooks (``bind_shard``, ``take_xout``,
``ingest_remote``) serve parallel/shards.py's workers.

This replaces the reference's per-packet Router/Relay push model (SURVEY.md
§3.4) with a batched design: hosts emit units into host-local egress lists
during a round; at the round barrier the engine assembles one flat batch and
resolves EVERY unit in closed form — departure time from the fluid token
buckets (shadow_tpu/network/fluid.py::TokenBuckets, O(1)/unit), arrival time
from the APSP latency gather, and loss from counter-based draws. There is no
retry queue: a unit that must wait for tokens gets its exact future departure
time immediately, so backlog costs nothing per round.

Loss draws are the one heavy computation (20-round threefry × MAX_PKTS per
unit). They route either to the numpy twin (fluid.loss_flags) or to the
device kernel (ops/propagate.py) — bit-identical by construction — based on
batch size vs a calibrated floor. Device batches are read back
*asynchronously with a causal deadline*: the flags are not needed until the
earliest time any unit of the batch can arrive, which is
computable host-side; until then the readback streams in the background and
subsequent rounds proceed. Event ordering is canonicalized with per-unit
keys assigned at the emission barrier (core/events.py BAND_NET), so the
inline and deferred paths produce byte-identical simulations.

Ingress (down-link) token buckets are enforced at arrival time: an arrival
that finds insufficient ingress tokens parks the unit in the host's deferred
queue, which the engine re-drains after each round's refill.

Units whose route is unreachable (APSP latency == INF) are "blackholed":
counted, then silently discarded — matching IP semantics for no-route.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from functools import partial

import numpy as np

from shadow_tpu_torch.core.events import BAND_NET
from shadow_tpu_torch.core.time import SimTime, T_NEVER
from shadow_tpu_torch.network.fluid import (
    NetParams,
    TokenBuckets,
    clamped_refill,
    loss_flags,
)
from shadow_tpu_torch.network.devroute import DeviceRoutedPlane
from shadow_tpu_torch.network.graph import INF_I64, NetworkGraph
from shadow_tpu_torch.network.unit import Unit
from shadow_tpu_torch.utils import spans as _sp


@dataclass
class _Outstanding:
    """One dispatched draw batch awaiting its causal deadline."""

    units: list  # list[Unit], batch order
    arrival: np.ndarray  # (N,) int64 — depart + latency
    keys: np.ndarray  # (N,) int64 canonical event keys
    round_end: SimTime  # barrier that emitted the batch
    deadline: SimTime  # earliest event time any unit can produce
    handle: object  # DrawHandle


class NetworkEngine(DeviceRoutedPlane):
    def __init__(self, graph: NetworkGraph, params: NetParams, hosts,
                 round_ns: SimTime, backend: str = "numpy",
                 tpu_options=None, bootstrap_end: SimTime = 0,
                 device: str = "cuda", spans: _sp.Spans = None) -> None:
        self.graph = graph
        self.params = params
        self.hosts = hosts
        self.round_ns = round_ns
        self.backend = backend
        self.buckets = TokenBuckets(params)
        #: before this sim time, bandwidth limits are suspended (reference:
        #: general.bootstrap_end_time — lets large deployments bootstrap
        #: without token-bucket congestion; loss still applies)
        self.bootstrap_end = bootstrap_end
        self.tokens_down = params.cap_down.copy()
        self._last_refill: SimTime = 0
        self._ev_key = 0  # canonical per-unit event key counter
        self.outstanding: deque[_Outstanding] = deque()
        self.units_sent = 0
        self.units_dropped = 0
        self.units_blackholed = 0
        self.bytes_sent = 0
        #: targeted fault injection (tests, experiments): units for which
        #: this predicate returns True are force-dropped in the network —
        #: silently; recovery must come from the endpoints' own machinery
        #: (dup acks, RTO timers — SURVEY.md §5.3).
        self.fault_filter = None
        #: a faults: config section exists (shadow_tpu/faults.py): hosts
        #: may crash, links may cut; enables per-host blackhole accounting
        self.faults_active = False
        #: the controller's span recorder (utils/spans.py), or one of
        #: this plane's own when it is built alone; its totals are the
        #: phase_wall (per-phase timing lives in colplane)
        self.spans = spans if spans is not None else _sp.Spans()
        self.phase_wall = self.spans.totals
        #: multi-process sharding (parallel/shards.py): when bound, rows
        #: resolved here whose destination lives on another shard divert
        #: into xout[dst_shard] (13-field store rows) instead of the local
        #: heaps; bind_shard/take_xout/ingest_remote are the whole surface
        self.shard_id = 0
        self.shard_n = 1
        self.xout = None  # list[list[row]] per destination shard

        self._deferred: set = set()  # hosts with ingress backlog
        #: dynamic runahead (reference: experimental.use_dynamic_runahead):
        #: the smallest latency any resolved unit has actually used. Rounds
        #: may widen to this instead of the graph-wide minimum; a new flow
        #: over a shorter edge gets its first arrivals clamped to one
        #: barrier (the documented fidelity trade), then shrinks the window
        self.min_used_latency: SimTime = T_NEVER
        self.qdisc = str(getattr(tpu_options, "interface_qdisc", "fifo")
                         or "fifo")
        # device attach/calibration + adaptive routing floor (shared with
        # the columnar plane: network/devroute.py)
        self._init_device_routing(backend, tpu_options, params, device)

    def pending_head(self) -> SimTime:
        """Resolved-but-undelivered arrivals: always T_NEVER here — this
        plane pushes arrivals straight into host heaps (the columnar
        plane's store is where this is a real quantity)."""
        return T_NEVER

    # round hooks ----------------------------------------------------------
    def start_of_round(self, round_start: SimTime, round_end: SimTime) -> None:
        """Flush due draw results, refill the ingress buckets for the elapsed
        window, and re-drain any ingress-deferred units."""
        self.flush_due(round_end)
        dt = round_start - self._last_refill
        self._last_refill = round_start
        if dt > 0:
            p = self.params
            add_down = clamped_refill(p.rate_down, p.cap_down, dt)
            self.tokens_down += np.minimum(add_down, p.cap_down - self.tokens_down)
        if self._deferred:
            drain, self._deferred = self._deferred, set()
            for host in sorted(drain, key=lambda h: h.id):
                backlog, host.ingress_deferred = host.ingress_deferred, []
                for u in backlog:
                    self.ingress_arrival(u, round_start)

    def ingress_arrival(self, u: Unit, now: SimTime) -> None:
        """Down-link token bucket at the destination (runs on the dst host's
        thread via its arrival event, or single-threaded from round start)."""
        h = self.hosts[u.dst]
        if h.down:
            # crashed host (faults.py): dead NIC — no charge, no delivery
            h._n_teardown += 1
            return
        if now < self.bootstrap_end:
            self.hosts[u.dst].deliver(u, now)
            return
        if self.tokens_down[u.dst] >= u.size:
            self.tokens_down[u.dst] -= u.size
            self.hosts[u.dst].deliver(u, now)
        else:
            h = self.hosts[u.dst]
            h.ingress_deferred.append(u)
            self._deferred.add(h)

    def end_of_round(self, round_start: SimTime, round_end: SimTime) -> None:
        """The round barrier: resolve all units emitted this round."""
        units: list[Unit] = []
        for h in self.hosts:  # host-id order == src-sorted FIFO, no sort
            if h._ack_eps:
                # flush coalesced acks (transport.StreamReceiver._ack);
                # snapshot + clear in place — the dict's identity is
                # load-bearing for the C engine's cached reference
                eps = list(h._ack_eps)
                h._ack_eps.clear()
                for ep in eps:
                    if ep.state != 0:  # not CLOSED
                        ep.receiver.flush_ack()
            if h.egress:
                if self.qdisc == "round_robin" and len(h.egress) > 1:
                    h.egress = _round_robin(h.egress)
                units.extend(h.egress)
                h.egress = []
        n = len(units)
        if n == 0:
            return

        src = np.fromiter((u.src for u in units), dtype=np.int32, count=n)
        size = np.fromiter((u.size for u in units), dtype=np.int32, count=n)
        t_emit = np.fromiter((u.t_emit for u in units), dtype=np.int64, count=n)
        if round_start < self.bootstrap_end:
            depart = t_emit.copy()  # bootstrap: unlimited bandwidth
        else:
            depart = self.buckets.depart_times(src, size, t_emit, round_start)

        dst = np.fromiter((u.dst for u in units), dtype=np.int32, count=n)
        sn = self.params.host_node[src]
        dn = self.params.host_node[dst]
        lat = self.graph.latency_ns[sn, dn]

        reach = lat < INF_I64
        n_bh = n - int(reach.sum())
        if n_bh:
            self.units_blackholed += n_bh
            if self.faults_active:
                # per-host accounting (fault experiments): which sources
                # lost traffic to cut links / no-route
                for s in src[~reach].tolist():
                    self.hosts[s]._n_blackholed += 1
            units = [u for u, ok in zip(units, reach) if ok]
            if not units:
                return
            src, dst, sn, dn = src[reach], dst[reach], sn[reach], dn[reach]
            depart, lat = depart[reach], lat[reach]
            n = len(units)

        arrival = depart + lat
        if n:
            ml = int(lat.min())
            if ml < self.min_used_latency:
                self.min_used_latency = ml
        thresh = self.params.drop_thresh[sn, dn]
        # canonical event keys are the unit uids ((src << 32) | per-src
        # seq): a pure function of unit identity, so same-time arrival
        # ordering at a destination is independent of WHERE the unit was
        # resolved — the property that makes multi-process sharding
        # (parallel/shards.py) byte-identical at any shard count. _ev_key
        # stays a resolved-units counter (the determinism sentinel hashes
        # it; per-shard counts sum to the single-process value).
        keys = np.fromiter((u.uid for u in units), dtype=np.int64, count=n)
        self._ev_key += n

        forced = None
        if self.fault_filter is not None:
            forced = np.fromiter((self.fault_filter(u) for u in units),
                                 dtype=bool, count=n)
            if not forced.any():
                forced = None

        use_device = (
            self.device is not None
            and n >= self.device_floor
            and bool((thresh > 0).any())
        )
        if not use_device:
            self._floor_cooldown_tick()
            self.host_windows["below_floor"] += 1
            flags = loss_flags(self.params.seed, *_uid_arrays(units, n), thresh)
            if forced is not None:
                flags = flags | forced
            self._schedule_batch(units, arrival, flags, keys, round_end)
            return
        for i in range(0, n, self.max_batch):
            j = min(n, i + self.max_batch)
            lo, hi, npk = _uid_arrays(units[i:j], j - i)
            handle = self.device.dispatch(lo, hi, npk, thresh[i:j])
            if forced is not None:
                handle = _ForcedHandle(handle, forced[i:j])
            deadline = max(round_end, int(arrival[i:j].min()))
            self.outstanding.append(_Outstanding(
                units[i:j], arrival[i:j], keys[i:j],
                round_end, deadline, handle,
            ))

    # result consumption ----------------------------------------------------
    def flush_due(self, limit: SimTime) -> None:
        """Materialize every in-flight batch whose deadline precedes
        ``limit`` (the end of the round about to run). Batches flush in
        emission order; canonical keys make the order immaterial anyway."""
        if not self.outstanding:
            return
        due = [b for b in self.outstanding if b.deadline < limit]
        if not due:
            return
        self.outstanding = deque(b for b in self.outstanding if b.deadline >= limit)
        for b in due:
            t0 = _sp.now()
            flags = b.handle.read()
            self._record_dev_read((_sp.now() - t0) / 1e9,
                                  len(b.units))
            self._schedule_batch(b.units, b.arrival,
                                 flags, b.keys, b.round_end)
        self._floor_settle()

    def flush_all(self) -> None:
        self.flush_due(T_NEVER + 1)

    def _schedule_batch(self, units, arrival, dropped, keys,
                        round_end: SimTime) -> None:
        # bulk numpy->Python conversions (tolist is C-speed; per-element
        # int() boxing dominated this loop at 10k-host scale). The clamps
        # keep causality when experimental.runahead widens the round
        # beyond the graph's min latency.
        t_arrs = np.maximum(arrival, round_end).tolist()
        key_l = keys.tolist()
        drop_l = dropped.tolist()
        hosts = self.hosts
        ingress = self.ingress_arrival
        sent = 0
        nbytes = 0
        dropped_ct = 0
        sh_n, sh_id, xout = self.shard_n, self.shard_id, self.xout
        for i, u in enumerate(units):
            if drop_l[i]:
                dropped_ct += 1
            else:
                sent += 1
                nbytes += u.size
                t_arr = t_arrs[i]
                if sh_n > 1 and u.dst % sh_n != sh_id:
                    # cross-shard arrival: the sender resolved everything
                    # (departure, loss, arrival time, canonical key); the
                    # owning shard charges ingress + delivers in event
                    # order — the 13-field columnar store row is the wire
                    # format (parallel/shards.py packs/ships it)
                    xout[u.dst % sh_n].append(
                        (t_arr, key_l[i], u.dst, u.kind, u.src, u.src_port,
                         u.dst_port, u.nbytes, u.seq, u.frag_idx, u.nfrags,
                         u.size, u.payload))
                    continue
                hosts[u.dst].equeue.push(
                    t_arr, partial(ingress, u, t_arr),
                    band=BAND_NET, key=key_l[i])
        self.units_sent += sent
        self.units_dropped += dropped_ct
        self.bytes_sent += nbytes

    # -- multi-process sharding (parallel/shards.py) ------------------------
    def bind_shard(self, shard_id: int, shard_n: int) -> None:
        """Install the shard filter: this engine resolves only its owned
        hosts' emissions and diverts rows for other shards into xout."""
        self.shard_id = shard_id
        self.shard_n = shard_n
        self.xout = [[] for _ in range(shard_n)]

    def take_xout(self) -> list:
        """Drain the per-shard cross-shard row buffers, each sorted by the
        unique (t, key) prefix (the receiving shard's merge order)."""
        out, self.xout = self.xout, [[] for _ in range(self.shard_n)]
        for rows in out:
            rows.sort(key=lambda r: (r[0], r[1]))
        return out

    def ingest_remote(self, rows: list) -> None:
        """Arrival rows shipped from another shard (sorted by (t, key)):
        rebuild the per-unit plane's arrival events. The uid IS the key
        (canonical-key scheme), so the reconstructed Unit draws nothing
        and orders exactly as the local plane would have ordered it."""
        hosts = self.hosts
        ingress = self.ingress_arrival
        for (t, key, tgt, kind, peer, aport, bport, nbytes, seq, frag,
             nfrags, size, payload) in rows:
            u = Unit(uid=key, src=peer, dst=tgt, size=size, t_emit=0,
                     kind=kind, src_port=aport, dst_port=bport,
                     nbytes=nbytes, payload=payload, seq=seq,
                     frag_idx=frag, nfrags=nfrags)
            hosts[tgt].equeue.push(t, partial(ingress, u, t),
                                   band=BAND_NET, key=key)


def _round_robin(egress):
    """interface_qdisc: round_robin — fair interleave across this host's
    flows (src_port). Emission-time causality is primary (a unit emitted
    later can never charge the link bucket before an earlier one — the
    fluid serialization is FIFO in t_emit); fairness applies where it
    actually binds: among units emitted at the same instant, flows take
    turns (per-flow rank breaks the tie) instead of one flow's burst
    monopolizing the link. O(n log n), deterministic."""
    rank: dict = {}
    order: dict = {}
    keyed = []
    for i, u in enumerate(egress):
        f = u.src_port
        r = rank.get(f, 0)
        rank[f] = r + 1
        keyed.append((u.t_emit, r, order.setdefault(f, len(order)), i, u))
    keyed.sort(key=lambda t: t[:4])
    return [t[4] for t in keyed]


class _ForcedHandle:
    """Wraps a DrawHandle, OR-ing in fault-injected drops at read time."""

    __slots__ = ("_inner", "_forced")

    def __init__(self, inner, forced):
        self._inner = inner
        self._forced = forced

    def read(self):
        return self._inner.read() | self._forced


def _uid_arrays(units, n):
    uid = np.fromiter((u.uid for u in units), dtype=np.uint64, count=n)
    lo = (uid & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (uid >> np.uint64(32)).astype(np.uint32)
    npk = np.fromiter((u.npkts for u in units), dtype=np.uint32, count=n)
    return lo, hi, npk
