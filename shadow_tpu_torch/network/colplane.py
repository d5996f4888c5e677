"""The columnar data plane: array-native unit flow for the tpu policies.

The port of shadow_tpu/network/colplane.py's Python plane. Same simulation
semantics as the reference (bit-identical results), traffic represented as
batch-level data end-to-end:

- **Emission** appends one plain tuple per unit to the host's egress-row
  list — no Unit objects, no uid mint, no closure (host/host.py emit_msg).
- **The barrier** resolves the whole round's units at once: departures
  (closed-form buckets), latency gather, and uid/key assignment run as
  numpy vector ops for large batches and as an exact scalar twin for small
  ones.
- **Loss draws are coalesced across rounds.** Arrival times are known
  without the flags, so each batch carries a causal deadline (earliest
  possible arrival). Host-routed batches accumulate until one's deadline
  passes, then ALL accumulated batches resolve in ONE threefry call; a
  window that clears the device floor dispatches as ONE CUDA launch and
  reads back asynchronously (network/devroute.py, ops/propagate.py).
- **The mesh plane (tpu_mesh) rides the same machinery**: departures are
  closed form host-side, so a barrier's units only need draws and the
  arrival exchange, which a whole causal window batches into one sharded
  program (parallel/mesh.py::mesh_exchange). Windows below
  ``experimental.tpu_mesh_floor`` units take the numpy twin instead
  (identical flags: pure functions of unit identity).
- **Resolved rows live in a sorted pending store**: each flushed batch
  becomes a (time, key)-sorted row list; every round the engine extracts
  the due prefixes (bisect), buckets them per destination host, and each
  host's event loop merges its inbox with its timer heap by (time, band,
  key) — the canonical order (core/events.py BAND_NET) — charging the
  ingress token bucket per row at dispatch time, in event order.

- **The C engine** (``experimental.native_colcore``, on by default under
  the fifo qdisc; csrc/colcore.c, built by shadow_tpu_torch/native): the
  same structures with C hot loops — the host event loop, extraction, the
  barrier, stream endpoints, inline loss draws — bit-identical to the
  Python paths of this file, which run when it is off. Under it, big live
  barriers hand off to the device window machinery
  (``_dispatch_device_batch``) or the mesh collective
  (``_queue_mesh_batch``), and auto-mode ``tpu_batch`` speculates the
  prefix-min draws of future uids on the device (``min_draw``), which the
  engine consults instead of drawing inline.
- **The device transport** (``experimental.device_transport``,
  network/devtransport.py): ack-dominated host rounds defer to the
  barrier, where their clean cumulative acks advance as one batched
  kernel (ops/transport_kernels.py) before the rounds replay in canonical
  order (``end_of_round``; wall in ``phase_wall.transport_tick``). It
  stands down when the C engine is attached, as in the reference.

Multi-process sharding (parallel/shards.py): ``bind_shard`` diverts the
rows resolved for hosts another shard owns into per-shard buffers
(``take_xout``, or the C engine's packed wire blocks,
``take_xout_packed``), and ``ingest_remote`` takes rows shipped from a
peer into the pending store.

Store row layout (tuples; each host's pending list is kept sorted by the
unique (t, key) prefix):
    (t, key, tgt, kind, peer, aport, bport, nbytes, seq, frag, nfrags,
     size, payload)
tgt/peer = dst/src of the unit.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import deque

import numpy as np

from shadow_tpu_torch.core.time import SimTime, T_NEVER
from shadow_tpu_torch.network.fluid import (
    HARD_MAX_PKTS,
    MTU,
    NetParams,
    TokenBuckets,
    clamped_refill,
    loss_flags,
)
from shadow_tpu_torch.network.devroute import WINDOW_SLOTS, DeviceRoutedPlane
from shadow_tpu_torch.network.graph import INF_I64, NetworkGraph
from shadow_tpu_torch.utils import spans as _sp

# egress row field indices (tuples appended by Host.emit_msg)
E_KIND, E_DST, E_SIZE, E_TEMIT, E_SPORT, E_DPORT = 0, 1, 2, 3, 4, 5
E_NBYTES, E_SEQ, E_FRAG, E_NFRAGS, E_PAYLOAD = 6, 7, 8, 9, 10

#: barriers at or below this many units take the exact scalar twin of the
#: vector math (numpy's ~µs fixed cost per op dominates tiny batches)
SMALL_BARRIER = 48


class StoreBatch:
    """One resolved batch: store-row tuples pre-sorted by (t, key),
    consumed as a moving prefix by per-round extraction. (With the C
    engine attached the store holds its packed CBatch instead; the engine
    fetches this class by module path for the batches it hands back.)"""

    __slots__ = ("rows", "pos")

    def __init__(self, rows: list) -> None:
        self.rows = rows
        self.pos = 0

    def head_time(self) -> SimTime:
        return self.rows[self.pos][0] if self.pos < len(self.rows) else T_NEVER


class _Outstanding:
    """One barrier's units awaiting loss flags. ``handle`` is a device
    window slice, or None for a lazily-coalesced numpy batch. ``rows`` are
    the egress row tuples (post blackhole filter), ``src`` the per-row
    source host ids."""

    __slots__ = ("rows", "src", "arrival", "keys", "uid_lo", "uid_hi",
                 "npk", "thresh", "forced", "round_end", "deadline",
                 "handle")

    def __init__(self, rows, src, arrival, keys, uid_lo, uid_hi, npk,
                 thresh, forced, round_end, deadline, handle):
        self.rows = rows
        self.src = src  # list[int]
        self.arrival = arrival  # list[int]
        self.keys = keys  # list[int]
        self.uid_lo = uid_lo  # np.uint32 array
        self.uid_hi = uid_hi
        self.npk = npk
        self.thresh = thresh
        self.forced = forced  # list[bool] | None: fault_filter's drops
        self.round_end = round_end
        self.deadline = deadline
        self.handle = handle


class ColumnarPlane(DeviceRoutedPlane):
    """The columnar engine: the network plane of the tpu policies."""

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
        self.bootstrap_end = bootstrap_end
        self.tokens_down = params.cap_down.copy()
        self._last_refill: SimTime = 0
        self._ev_key = 0
        self.outstanding: deque[_Outstanding] = deque()
        self.pending: deque[StoreBatch] = deque()
        self.units_sent = 0
        self.units_dropped = 0
        self.units_blackholed = 0
        self.bytes_sent = 0
        self.fault_filter = None
        #: a faults: config section exists (faults.py): hosts may crash,
        #: links may cut; enables per-host blackhole accounting (the C
        #: engine reads it at bind)
        self.faults_active = False
        #: multi-process sharding (parallel/shards.py): resolved rows for
        #: hosts owned by another shard divert into xout[dst_shard]
        #: (13-field store rows) instead of the local pending store
        self.shard_id = 0
        self.shard_n = 1
        self.xout = None
        self.emitters: list = []  # hosts with egress rows this round
        self.ack_hosts: list = []  # hosts owing coalesced barrier acks
        self._deferred: set = set()  # hosts with ingress backlog
        #: controller hook: called with a host id when extraction flags it
        #: runnable (keeps the active-host set correct)
        self.activate = None
        self.min_used_latency: SimTime = T_NEVER
        self.qdisc = str(getattr(tpu_options, "interface_qdisc", "fifo")
                         or "fifo")
        #: minimum due-window unit count for the mesh collective; smaller
        #: windows resolve on the numpy twin (identical flags)
        _mf = getattr(tpu_options, "tpu_mesh_floor", None)
        self.mesh_floor = 2048 if _mf is None else int(_mf)
        #: the controller's span recorder (utils/spans.py), or one of
        #: this plane's own when it is built alone
        self.spans = spans if spans is not None else _sp.Spans()
        #: per-phase wall-clock breakdown (the recorder's totals), which
        #: the run summary reports. window_* phases attribute the fused
        #: multi-round device windows: host-side array build vs async
        #: dispatch vs realized readback stalls (a pipelined window shows
        #: build+dispatch but ~zero readback); spec_install is the
        #: speculative waves' hand-off to the C engine.
        self.phase_wall = self.spans.totals
        self.phase_wall.update(dict.fromkeys((
            "barrier", "draw_flush", "extract", "ingress_deferred",
            "window_build", "window_dispatch", "window_readback",
            "transport_tick", "spec_install"), 0.0))
        for h in hosts:
            h.colplane = self
        self._init_device_routing(backend, tpu_options, params, device)
        #: C engine (csrc/colcore.c): same structures, C hot loops;
        #: bit-identical to this file's Python paths, which run when it is
        #: not attached
        self._c = None
        self.attach_colcore(tpu_options)
        #: device-resident columnar transport (network/devtransport.py),
        #: set by attach_devtransport
        self.devt = None

    def attach_colcore(self, tpu_options):
        """Build (at first use) and attach the C engine over the current
        structures when the policy is tpu_batch or tpu_mesh, the qdisc is
        fifo and experimental.native_colcore is on. Returns the core or
        None. A failed build raises (shadow_tpu_torch/native): it never
        falls back to the Python plane. Resolved batches already in the
        store convert to the engine's packed CBatch shells in place (the
        deque's identity is load-bearing — the core caches it)."""
        self._c = None
        if not (self.backend in ("tpu", "mesh") and self.qdisc == "fifo"
                and getattr(tpu_options, "native_colcore", True)):
            return None
        from shadow_tpu_torch.native import colcore

        _colcore = colcore()
        for i, b in enumerate(self.pending):
            if isinstance(b, StoreBatch):
                cb = _colcore.shell("CBatch")
                cb._restore_state((b.pos, list(b.rows)))
                self.pending[i] = cb
        self._c = _colcore.Core(self)
        if self.shard_n > 1:
            # the packed send path: the engine drains the diverted rows
            # as wire blocks (take_xout_packed)
            self._c.bind_shard(self.shard_id, self.shard_n, None)
        return self._c

    def attach_devtransport(self, tpu_options, device: str = "cuda"):
        """Attach the columnar transport engine when
        experimental.device_transport is on and the C engine is not (the
        controller calls this once the plane is built, and again after a
        checkpoint restore; colcore already owns the scalar fast path).
        Every path is bit-identical, so the key is wall-clock policy only
        and a resume may flip it. Returns the engine or None."""
        for h in self.hosts:
            h.devt = None
        self.devt = None
        if not getattr(tpu_options, "device_transport", False):
            return None
        if self._c is not None:
            return None  # colcore IS the fast scalar twin (module doc)
        from shadow_tpu_torch.network.devtransport import DeviceTransport

        self.devt = DeviceTransport(self, device)
        self.devt.start_device_attach()
        for h in self.hosts:
            h.devt = self.devt
        return self.devt

    # state queries (controller) -------------------------------------------
    def pending_head(self) -> SimTime:
        """Earliest resolved-but-undelivered row time in the store."""
        return min((b.head_time() for b in self.pending), default=T_NEVER)

    # round hooks ----------------------------------------------------------
    def start_of_round(self, round_start: SimTime, round_end: SimTime) -> None:
        self.flush_due(round_end)
        dt = round_start - self._last_refill
        self._last_refill = round_start
        if dt > 0:
            if self._c is not None:
                self._c.refill_ingress(dt)
            else:
                p = self.params
                add_down = clamped_refill(p.rate_down, p.cap_down, dt)
                self.tokens_down += np.minimum(
                    add_down, p.cap_down - self.tokens_down)
        sp = self.spans
        if self._deferred:
            t0 = _sp.now()
            self._drain_deferred(round_start)
            t1 = _sp.now()
            self.phase_wall["ingress_deferred"] += (t1 - t0) / 1e9
            if sp.on:
                sp.add(_sp.INGRESS_DEFERRED, t0, t1)
        if self.pending:
            t0 = _sp.now()
            if self._c is not None:
                self._c.extract(round_end)
            else:
                self._extract(round_end)
            t1 = _sp.now()
            self.phase_wall["extract"] += (t1 - t0) / 1e9
            if sp.on:
                sp.add(_sp.EXTRACT, t0, t1)

    def _extract(self, round_end: SimTime) -> None:
        """Hand every store row with t < round_end to its destination
        host's inbox, preserving (t, key) order within each host."""
        slices = []
        for b in self.pending:
            rows, pos = b.rows, b.pos
            if pos >= len(rows) or rows[pos][0] >= round_end:
                continue
            hi = bisect_left(rows, round_end, lo=pos, key=_row_t)
            slices.append(rows[pos:hi])
            b.pos = hi
        while self.pending and self.pending[0].pos >= len(self.pending[0].rows):
            self.pending.popleft()
        if not slices:
            return
        # bucket rows per destination host; each host only needs ITS rows
        # in (t, key) order, so instead of a global k-way merge, dump the
        # (sorted) slices per host and let TimSort merge the k runs — its
        # adaptive path makes this nearly O(rows) on pre-sorted input
        buckets: dict = {}
        for sl in slices:
            for row in sl:
                tg = row[2]
                b = buckets.get(tg)
                if b is None:
                    buckets[tg] = [row]
                else:
                    b.append(row)
        multi = len(slices) > 1
        hosts = self.hosts
        activate = self.activate
        for hid, rows in buckets.items():
            if multi and len(rows) > 1:
                rows.sort(key=_row_tk)
            hosts[hid]._inbox = rows
            activate(hid)

    def _drain_deferred(self, round_start: SimTime) -> None:
        """Retry ingress-deferred rows against the refilled buckets, in
        host-id order, delivering inline at round_start — mirroring the
        per-unit plane's direct deliver() calls before any host event."""
        # copy + clear in place: the set's object identity is load-bearing
        # when the C engine is attached (it caches the set)
        drain = list(self._deferred)
        self._deferred.clear()
        tokens = self.tokens_down
        boot = round_start < self.bootstrap_end
        for host in sorted(drain, key=lambda h: h.id):
            backlog, host.ingress_deferred_rows = (
                host.ingress_deferred_rows, [])
            toks = int(tokens[host.id])
            for row in backlog:
                if boot or toks >= row[11]:
                    if not boot:
                        toks -= row[11]
                    host._deliver_row(round_start, row[3], row[4], row[5],
                                      row[6], row[7], row[8], row[9],
                                      row[10], row[12])
                else:
                    host.ingress_deferred_rows.append(row)
                    self._deferred.add(host)
            tokens[host.id] = toks

    def end_of_round(self, round_start: SimTime, round_end: SimTime) -> None:
        """The round barrier: resolve all rows emitted this round, then
        advance the fused device-window state machine. Windows open and
        close ONLY at round boundaries."""
        if self.devt is not None:
            # deferred host rounds replay (and their ack cohorts advance
            # as one batched kernel) BEFORE the barrier collects emitters,
            # so replayed emissions join this round's barrier exactly as
            # live-dispatched ones would have
            self.devt.flush_round(round_end)
        self._barrier_round(round_start, round_end)
        sp = self.spans
        if sp.on:
            sp.open(_sp.WINDOW_TICK)
        self._window_tick(round_end)
        if sp.on:
            sp.close()

    def _barrier_round(self, round_start: SimTime,
                       round_end: SimTime) -> None:
        t0 = _sp.now()
        acks = self.ack_hosts
        if acks:
            self.ack_hosts = []
            if len(acks) > 1:
                acks.sort(key=lambda h: h.id)
            if self._c is not None:
                # the whole coalesced-ack flush loop runs in C (the
                # _ack_eps dicts are identity-stable — cleared in place,
                # never rebound — so the C engine caches them)
                self._c.flush_acks(acks)
            else:
                for h in acks:
                    # snapshot + clear IN PLACE: the dict's identity is
                    # load-bearing when the C engine is attached
                    eps = list(h._ack_eps)
                    h._ack_eps.clear()
                    for ep in eps:
                        if ep.state != 0:  # not CLOSED
                            ep.receiver.flush_ack()
        if self._c is not None and self.fault_filter is None:
            # C barrier protocol: tuple = big live batch for the device
            # dispatch machinery; True = kept rows stored inline (tick the
            # floor cooldown, like the vector twin's non-device branch);
            # None = nothing survived (no tick — the twin never ticks on
            # empty rounds)
            r = self._c.barrier(round_start, round_end)
            if isinstance(r, tuple):
                if len(r) == 10:  # mesh hand-off (src/dst arrays appended)
                    self._queue_mesh_batch(r, round_end)
                else:
                    self._dispatch_device_batch(r, round_end)
            elif r and self.device is not None:
                self._floor_cooldown_tick()
            t1 = _sp.now()
            self.phase_wall["barrier"] += (t1 - t0) / 1e9
            if self.spans.on:
                self.spans.add(_sp.BARRIER, t0, t1)
            return
        if self._c is not None:
            # fault_filter rounds run the Python barrier below: flush the
            # packed C egress buffers into host.egress_rows first
            self._c.materialize_egress()
        emitters = self.emitters
        if not emitters:
            return
        self.emitters = []
        if len(emitters) > 1:
            emitters.sort(key=lambda h: h.id)
        rows: list = []
        segs: list = []  # (host_id, count, uid_base) per emitter, in order
        rr = self.qdisc == "round_robin"
        uids_l = None
        for h in emitters:
            # copy + clear in place: the egress list's object identity is
            # load-bearing when the C engine is attached (it caches it)
            hr = h.egress_rows[:]
            h.egress_rows.clear()
            k = len(hr)
            base = (h.id << 32) | h._uid_counter
            if rr and k > 1:
                # uids follow EMISSION order (the per-unit plane mints
                # them before the qdisc reorders), so carry each row's
                # original index through the reorder
                if uids_l is None:
                    uids_l = []
                    for _hid0, k0, base0 in segs:
                        uids_l.extend(range(base0, base0 + k0))
                hr, orig = _round_robin_rows(hr)
                rows.extend(hr)
                uids_l.extend(base + i for i in orig)
            else:
                rows.extend(hr)
                if uids_l is not None:
                    uids_l.extend(range(base, base + k))
            segs.append((h.id, k, base))
            h._uid_counter += k
        n = len(rows)
        if n == 0:
            return
        if (n <= SMALL_BARRIER and self.mesh_plane is None
                and self.fault_filter is None):
            self._barrier_scalar(rows, segs, round_start, round_end, uids_l)
        else:
            self._barrier_vector(rows, segs, round_start, round_end, uids_l)
        t1 = _sp.now()
        self.phase_wall["barrier"] += (t1 - t0) / 1e9
        if self.spans.on:
            self.spans.add(_sp.BARRIER, t0, t1)

    def _mesh_materialize(self) -> None:
        """Resolve EVERY lazily-accumulated mesh barrier in one fused
        collective dispatch: the accumulated window's units run through
        draws + the arrival exchange as one sharded program
        (parallel/mesh.py::mesh_exchange); each barrier's handle then reads
        its own units out of the shared exchange tables. Draws are pure
        functions of unit identity, so batch order is immaterial — the
        lazy-numpy coalescing discipline, one program instead of one per
        barrier."""
        pend = [b for b in self.outstanding
                if isinstance(b.handle, _MeshLazy)]
        if not pend:
            return
        total = sum(len(b.handle.uid) for b in pend)
        if total < self.mesh_floor:
            # small window: the collective's fixed cost loses to the numpy
            # twin — convert to lazily-coalesced numpy batches (flags
            # identical either way: pure functions of identity)
            for b in pend:
                h = b.handle
                u = h.uid.astype(np.uint64)
                b.uid_lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                b.uid_hi = (u >> np.uint64(32)).astype(np.uint32)
                b.npk = h.npk.astype(np.uint32)
                b.thresh = h.th.astype(np.uint32)
                b.handle = None
            return

        def cat(field):
            return np.concatenate([getattr(b.handle, field) for b in pend])

        parts = self.mesh_plane.exchange_rounds(
            cat("src"), cat("dst"), cat("arrival"), cat("uid"),
            cat("npk"), cat("th"))
        from shadow_tpu_torch.parallel.mesh import F_FLAGS, F_UID

        tab = np.concatenate(parts) if len(parts) > 1 else parts[0]
        tab = tab[tab[:, F_FLAGS] >= 2]  # valid rows only
        tab = tab[np.argsort(tab[:, F_UID])]  # sorted ONCE, shared
        for b in pend:
            b.handle = _MeshHandle(tab, b.handle.uid)

    # -- scalar barrier (exact twin of the vector math, for tiny rounds) ---
    def _barrier_scalar(self, rows, segs, round_start: SimTime,
                        round_end: SimTime, uids_l=None) -> None:
        p = self.params
        graph_lat = self.graph.latency_ns
        thresh_t = p.drop_thresh
        host_node = p.host_node
        boot = round_start < self.bootstrap_end
        src_all: list = []
        for hid, k, _base in segs:
            src_all.extend([hid] * k)
        if uids_l is not None:
            uids = uids_l
        else:
            uids = []
            for _hid, k, base in segs:
                uids.extend(range(base, base + k))
        if boot:
            depart = [r[E_TEMIT] for r in rows]
        else:
            depart = self.buckets.depart_times_scalar(
                src_all, [r[E_SIZE] for r in rows],
                [r[E_TEMIT] for r in rows], round_start)
        keep_rows: list = []
        src_l: list = []
        arrival_l: list = []
        keys_l: list = []
        uid_keep: list = []
        thresh_l: list = []
        npk_l: list = []
        any_live = False
        mul = self.min_used_latency
        bh = 0
        for i, r in enumerate(rows):
            src = src_all[i]
            sn = host_node[src]
            dn = host_node[r[E_DST]]
            lat = int(graph_lat[sn, dn])
            if lat >= INF_I64:
                bh += 1
                if self.faults_active:
                    self.hosts[src]._n_blackholed += 1
                continue
            if lat < mul:
                mul = lat
            arrival_l.append(depart[i] + lat)
            # the canonical event key IS the uid (placement-independent;
            # see engine.py _schedule_batch) — _ev_key stays a resolved-
            # units counter for the determinism sentinel
            keys_l.append(uids[i])
            uid_keep.append(uids[i])
            th = int(thresh_t[sn, dn])
            thresh_l.append(th)
            if th:
                any_live = True
            q = -(-r[E_SIZE] // MTU)
            npk_l.append(q if 1 <= q <= HARD_MAX_PKTS
                         else (1 if q < 1 else HARD_MAX_PKTS))
            keep_rows.append(r)
            src_l.append(src)
        self._ev_key += len(keys_l)
        self.units_blackholed += bh
        self.min_used_latency = mul
        if not keep_rows:
            return
        if not any_live:
            self._store_resolved(keep_rows, src_l, arrival_l, keys_l,
                                 None, round_end)
            return
        ul = np.array(uid_keep, dtype=np.uint64)
        self.outstanding.append(_Outstanding(
            keep_rows, src_l, arrival_l, keys_l,
            (ul & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (ul >> np.uint64(32)).astype(np.uint32),
            np.array(npk_l, dtype=np.uint32),
            np.array(thresh_l, dtype=np.uint32),
            None, round_end,
            max(round_end, min(arrival_l)), None))

    # -- vector barrier -----------------------------------------------------
    @staticmethod
    def _batch_columns(rows, segs, uids_l=None) -> tuple:
        """A barrier's units as columns (src, dst, size, t_emit, uid), in
        emission order: per source host (``segs``), its rows FIFO."""
        n = len(rows)
        size = np.fromiter((r[E_SIZE] for r in rows), dtype=np.int64,
                           count=n)
        t_emit = np.fromiter((r[E_TEMIT] for r in rows), dtype=np.int64,
                             count=n)
        dst = np.fromiter((r[E_DST] for r in rows), dtype=np.int32, count=n)
        counts = np.array([s[1] for s in segs], dtype=np.int64)
        src = np.repeat(np.array([s[0] for s in segs], dtype=np.int32),
                        counts)
        if uids_l is not None:  # round_robin carried emission-order uids
            uid = np.array(uids_l, dtype=np.uint64)
        else:
            # per-segment uid ranges without per-segment arange: base minus
            # the segment's start offset, repeated, plus the global position
            starts = np.cumsum(counts) - counts
            bases = np.array([s[2] for s in segs], dtype=np.int64)
            uid = (np.repeat(bases - starts, counts)
                   + np.arange(n, dtype=np.int64)).astype(np.uint64)
        return src, dst, size, t_emit, uid

    def _barrier_vector(self, rows, segs, round_start: SimTime,
                        round_end: SimTime, uids_l=None) -> None:
        src, dst, size, t_emit, uid = self._batch_columns(rows, segs, uids_l)
        n = len(rows)
        use_mesh = (self.mesh_plane is not None
                    and round_start >= self.bootstrap_end)
        if round_start < self.bootstrap_end:
            depart = t_emit.copy()  # bootstrap: unlimited bandwidth
        else:
            # host-side closed-form departures for every backend (one
            # implementation: fluid.TokenBuckets) — computing them where
            # the emissions originate is what lets the mesh plane defer its
            # collective to the causal deadline
            depart = self.buckets.depart_times(src, size, t_emit,
                                               round_start)

        p = self.params
        sn = p.host_node[src]
        dn = p.host_node[dst]
        lat = self.graph.latency_ns[sn, dn]

        reach = lat < INF_I64
        n_bh = n - int(reach.sum())
        keep_rows = rows
        if n_bh:
            self.units_blackholed += n_bh
            if self.faults_active:
                for s in src[~reach].tolist():
                    self.hosts[s]._n_blackholed += 1
            keep = np.flatnonzero(reach)
            kl = keep.tolist()
            keep_rows = [rows[i] for i in kl]
            src, dst, sn, dn = src[keep], dst[keep], sn[keep], dn[keep]
            lat = lat[keep]
            depart = depart[keep]
            size, t_emit, uid = size[keep], t_emit[keep], uid[keep]
            n = len(kl)
            if n == 0:
                return  # buckets already charged for the full batch

        ml = int(lat.min())
        if ml < self.min_used_latency:
            self.min_used_latency = ml
        thresh = p.drop_thresh[sn, dn]
        # canonical keys = uids (placement-independent; engine.py twin)
        keys_l = uid.astype(np.int64).tolist()
        self._ev_key += n

        src_l = src.tolist()
        forced = None
        if self.fault_filter is not None:
            forced = [bool(self.fault_filter(_RowView(r, s, int(u))))
                      for r, s, u in zip(keep_rows, src_l, uid)]
            if not any(forced):
                forced = None

        arrival = depart + lat
        arrival_l = arrival.tolist()

        live = bool((thresh > 0).any())
        if use_mesh:
            if not live and forced is None:
                # nothing can drop: straight to the store (the collective
                # would only confirm all-false flags)
                self._store_resolved(keep_rows, src_l, arrival_l, keys_l,
                                     None, round_end)
                return
            # LAZY collective batch: arrivals are known host-side, draws
            # are pure functions of unit identity, so the whole causal
            # window (every barrier until the earliest arrival comes due)
            # resolves in ONE sharded draws+exchange program at flush
            # (_mesh_materialize) — fused across rounds, not per barrier
            npk = np.minimum(np.maximum(1, -(-size // MTU)),
                             HARD_MAX_PKTS).astype(np.int64)
            deadline = max(round_end, int(arrival.min()))
            self.outstanding.append(_Outstanding(
                keep_rows, src_l, arrival_l, keys_l, None, None, None,
                None, forced, round_end, deadline,
                _MeshLazy(src.astype(np.int64), dst.astype(np.int64),
                          arrival, uid.astype(np.int64), npk,
                          thresh.astype(np.int64))))
            return
        if not live and forced is None:
            # nothing can drop: skip draws entirely, straight to the store
            self._store_resolved(keep_rows, src_l, arrival_l, keys_l, None,
                                 round_end)
            return
        uid_lo = (uid & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        uid_hi = (uid >> np.uint64(32)).astype(np.uint32)
        npk = np.minimum(np.maximum(1, -(-size // MTU)),
                         HARD_MAX_PKTS).astype(np.uint32)
        # lazy batch: flags are a pure function of unit identity, so defer
        # to the causal deadline and coalesce across rounds — into ONE
        # numpy call or ONE fused device window, whichever the window
        # state machine (_window_tick / flush_due) routes this window to
        deadline = max(round_end, int(arrival.min()))
        self.outstanding.append(_Outstanding(
            keep_rows, src_l, arrival_l, keys_l, uid_lo, uid_hi, npk,
            thresh, forced, round_end, deadline, None))

    def _queue_mesh_batch(self, r, round_end: SimTime) -> None:
        """C-barrier mesh hand-off: append the lazy collective batch
        exactly as the Python vector path does."""
        (keep_rows, src_l, arrival, keys_l, uid_lo, uid_hi, npk, thresh,
         src_a, dst_a) = r
        uid64 = (uid_lo.astype(np.int64)
                 | (uid_hi.astype(np.int64) << np.int64(32)))
        deadline = max(round_end, int(arrival.min()))
        self.outstanding.append(_Outstanding(
            keep_rows, src_l, arrival.tolist(), keys_l, None, None, None,
            None, None, round_end, deadline,
            _MeshLazy(src_a.astype(np.int64), dst_a.astype(np.int64),
                      arrival, uid64, npk.astype(np.int64),
                      thresh.astype(np.int64))))

    def _dispatch_device_batch(self, r, round_end: SimTime) -> None:
        """A C barrier handed back a big live batch: it joins the open
        device window as a lazy batch (the window state machine owns all
        device dispatch — one fused launch per window, two-slot async
        pipeline)."""
        keep_rows, src_l, arrival, keys_l, uid_lo, uid_hi, npk, thresh = r
        deadline = max(round_end, int(arrival.min()))
        self.outstanding.append(_Outstanding(
            keep_rows, src_l, arrival.tolist(), keys_l, uid_lo, uid_hi,
            npk, thresh, None, round_end, deadline, None))

    # -- fused multi-round device windows -----------------------------------
    def _window_tick(self, round_end: SimTime) -> None:
        """Advance the window state machine at this round boundary.

        experimental.device_window_rounds = K:
          K >= 1  close the deferred window every K barriers and dispatch
                  it when it clears the floor (K=1 reproduces the legacy
                  per-round dispatch cadence, through the same machinery);
          auto    dispatch as soon as the open window clears the live
                  break-even estimate (hysteresis in devroute) — smaller
                  windows fall through to the host twin at flush time.

        Routing is pure wall-clock policy: every path yields bit-identical
        flags, only the dispatch count moves."""
        dev = self.device
        if dev is None:
            if self._bg_error is not None:
                self.raise_attach_error()
            return
        if (self._c is not None and not self._spec_checked
                and self.window_rounds == 0):
            # speculation is an auto-mode feature: a fixed K asks for the
            # deterministic deferred-window discipline only
            self._spec_enable()
        if self._spec_on:
            self._spec_tick()
        if not self.outstanding:  # the common C-plane round: all inline
            self._win_open_rounds = 0
            return
        lazy = [b for b in self.outstanding if b.handle is None]
        if not lazy:
            self._win_open_rounds = 0
            return
        self._win_open_rounds += 1
        units = sum(len(b.keys) for b in lazy)
        k = self.window_rounds
        if k > 0:
            if self._win_open_rounds >= k:
                self._note_window_units(units)
                if (units >= self.device_floor
                        and self._win_inflight < WINDOW_SLOTS):
                    self._dispatch_window(lazy, units)
                else:
                    # below floor (or both slots busy): the window stays
                    # lazy and resolves on the host twin at flush
                    self._floor_cooldown_tick()
                    self._win_open_rounds = 0
        elif (self._win_inflight < WINDOW_SLOTS
              and not self._probe_clamped
              and units >= self.window_gate_units(self._win_engaged)):
            self._dispatch_window(lazy, units)

    def _dispatch_window(self, lazy, units: int) -> None:
        """ONE fused device dispatch for the whole window: every lazy
        batch's draw arrays concatenate into one program (chunked only at
        tpu_max_batch); each batch keeps a slice view of the shared handle
        and reads it — for free, once the shared readback landed — at its
        own causal deadline. Readback is deferred exactly as before; only
        the dispatch count changes (one per window, not one per barrier)."""
        t0 = _sp.now()
        mb = self.max_batch
        groups: list = []
        cur: list = []
        cur_n = 0
        for b in lazy:
            n = len(b.keys)
            if cur and cur_n + n > mb:
                groups.append((cur, cur_n))
                cur, cur_n = [], 0
            cur.append(b)
            cur_n += n
        groups.append((cur, cur_n))
        t1 = _sp.now()
        win = self.dev_windows  # this window's id (spans)
        for batches, n_g in groups:
            self._win_inflight += 1
            if len(batches) == 1 and n_g > mb:
                # one oversized batch: chunk it like the retired per-batch
                # loop did, behind a concatenating handle
                b = batches[0]
                handles = [
                    self.device.dispatch(b.uid_lo[i:i + mb],
                                         b.uid_hi[i:i + mb],
                                         b.npk[i:i + mb],
                                         b.thresh[i:i + mb])
                    for i in range(0, n_g, mb)]
                b.handle = _ConcatHandle(self, handles, win)
                continue
            if len(batches) == 1:
                b = batches[0]
                lo, hi, npk, th = b.uid_lo, b.uid_hi, b.npk, b.thresh
            else:
                lo = np.concatenate([b.uid_lo for b in batches])
                hi = np.concatenate([b.uid_hi for b in batches])
                npk = np.concatenate([b.npk for b in batches])
                th = np.concatenate([b.thresh for b in batches])
            wh = _WindowHandle(self, self.device.dispatch(lo, hi, npk, th),
                               win)
            off = 0
            for b in batches:
                n = len(b.keys)
                b.handle = _WindowSlice(wh, off, n)
                off += n
        self._win_open_rounds = 0
        t2 = _sp.now()
        self.phase_wall["window_build"] += (t1 - t0) / 1e9
        self.phase_wall["window_dispatch"] += (t2 - t1) / 1e9
        sp = self.spans
        if sp.on:
            sp.add(_sp.DRAW_BUILD, t0, t1, win)
            sp.add(_sp.DRAW_LAUNCH, t1, t2, win)
        self._note_window_units(units)
        self._record_window(units, (t2 - t0) / 1e9)

    def _window_done(self) -> None:
        """A dispatched window's last deferred readback was consumed: its
        pipeline slot frees for the next window."""
        if self._win_inflight > 0:
            self._win_inflight -= 1

    def _stall_sample(self, dt: float) -> None:
        """A window readback stalled for dt seconds: fold it into the
        break-even EMA (a stalling window costs host wall exactly like
        dispatch does)."""
        if dt > 2e-5:
            self._win_cost_ema += 0.25 * dt

    def _read_card(self, dh, window: int) -> tuple:
        """Read one card result ``dh`` of window ``window``: (its value,
        the seconds the read took), billed to window_readback. Recording,
        the wait for the card (draw.wait) and the copy out (draw.copy_out)
        are spans of their own, and a wait that found the kernel still
        running counts in ``waits_blocked``."""
        self.waits += 1
        sp = self.spans
        t0 = _sp.now()
        if sp.on and hasattr(dh, "wait"):
            if not dh.is_ready():
                self.waits_blocked += 1
            dh.wait()
            tw = _sp.now()
            value = dh.read()
            t1 = _sp.now()
            sp.add(_sp.DRAW_WAIT, t0, tw, window)
            sp.add(_sp.DRAW_COPY_OUT, tw, t1, window)
        else:
            value = dh.read()
            t1 = _sp.now()
            if sp.on:
                sp.add(_sp.DRAW_WAIT, t0, t1, window)
        dt = (t1 - t0) / 1e9
        self.phase_wall["window_readback"] += dt
        return value, dt

    # -- speculative forward windows (C plane) -------------------------------
    def _spec_enable(self) -> None:
        """One-time switch: speculation runs under the C engine (its class
        tracker and consult table) unless a fault filter forces the
        Python barrier."""
        self._spec_checked = True
        self._spec_on = self.fault_filter is None

    def _spec_tick(self) -> None:
        """Drive the speculative pipeline once per round: install every
        speculative wave whose device readback has landed (is_ready —
        never a stall), then, on a coarse cadence so single-host demand
        coalesces into fused waves, pull per-host demand from the C class
        tracker and dispatch it as one launch. A wave speculates the
        PREFIX-MIN threefry draw for a contiguous range of FUTURE uids
        under each host's recent npkts classes — threshold-independent
        (dropped == min_draw < thresh), so one row serves every
        destination. The C consult verifies uid range + npkts exactly; a
        wrong guess costs device cycles, never correctness."""
        pend = self._spec_pending
        if pend:
            keep = []
            for wave in pend:
                if wave[0].is_ready():
                    self._install_spec(wave)
                else:
                    keep.append(wave)
            self._spec_pending = keep
        self._spec_round += 1
        if (self._spec_round & 15
                or len(self._spec_pending) >= WINDOW_SLOTS):
            return  # demand keeps queueing C-side between drains
        if (self._spec_round & 255 == 0 and self.dev_windows >= 4
                and self._spec_round >= 1024):
            # live economics: fold the C consult counters and compare
            # realized spend — wave build + dispatch wall plus a
            # compute-contention share for the speculated rows — against
            # realized savings (verified hits x the inline C draw cost,
            # ~0.22us for a full-quantum unit, the reference's host
            # estimate). A losing speculation stops demanding new waves;
            # installed windows keep serving their remaining hits.
            hits, draws = self._c.spec_stats()
            self.spec_hits += hits
            self.spec_draws += draws
            spend = self._spec_spend + 2.5e-8 * self._spec_units
            if spend > self.spec_hits * 2.2e-7:
                self._spec_on = False
                self._spec_clamped = True
                return
        # demand coalescing: a wave's fixed dispatch cost wants a sizable
        # host cohort; the coarse age cadence (every 256 rounds) flushes
        # stragglers so every demanding host gets a window within ~one
        # round-trip of simulated time
        min_hosts = 1 if self._spec_round & 255 == 0 else 160
        d = self._c.spec_demand(min_hosts)
        if d is not None:
            self._dispatch_spec(d)

    #: classes cheaper than this many packet draws are not worth a wave
    #: row (the inline threefry twin beats the speculation overhead);
    #: must match SPEC_MIN_NPK in csrc/colcore.c
    SPEC_MIN_NPK = 4

    def _dispatch_spec(self, d) -> None:
        """Build and dispatch one speculative wave: for each demanded host
        a contiguous future-uid range min-drawn under up to two npkts
        classes, packed with vectorized range arithmetic. Waves chunk at
        the ONE pinned shape (DeviceDrawPlane.SPEC_BUCKET), whole hosts
        per chunk (a host's classes must install together)."""
        hosts, u0, n, npk_a, npk_b = d
        n64 = n.astype(np.int64)
        rows = (n64 * ((npk_a >= self.SPEC_MIN_NPK).astype(np.int64)
                       + (npk_b >= self.SPEC_MIN_NPK).astype(np.int64)))
        bucket = self.device.SPEC_BUCKET
        lo_idx = 0
        idx = np.flatnonzero(rows > 0)
        while lo_idx < idx.size:
            acc, take = 0, []
            while lo_idx < idx.size and \
                    acc + int(rows[idx[lo_idx]]) <= bucket:
                acc += int(rows[idx[lo_idx]])
                take.append(idx[lo_idx])
                lo_idx += 1
            if not take:  # single host larger than the bucket: skip it
                lo_idx += 1
                continue
            g = np.asarray(take)
            self._dispatch_spec_group(
                hosts[g], u0[g], n[g], npk_a[g], npk_b[g])

    def _dispatch_spec_group(self, hosts, u0, n, npk_a, npk_b) -> None:
        t0 = _sp.now()
        n64 = n.astype(np.int64)
        parts_lo: list = []
        parts_hi: list = []
        parts_npk: list = []
        off_a = np.full(len(hosts), -1, dtype=np.int64)
        off_b = np.full(len(hosts), -1, dtype=np.int64)
        off = 0
        for npk_c, offs in ((npk_a, off_a), (npk_b, off_b)):
            use = np.flatnonzero(npk_c >= self.SPEC_MIN_NPK)
            if use.size == 0:
                continue
            ns = n64[use]
            total = int(ns.sum())
            starts = np.cumsum(ns) - ns
            uid = (np.repeat(u0[use], ns)
                   + (np.arange(total, dtype=np.int64)
                      - np.repeat(starts, ns)).astype(np.uint64))
            parts_lo.append((uid & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            parts_hi.append((uid >> np.uint64(32)).astype(np.uint32))
            parts_npk.append(
                np.repeat(npk_c[use].astype(np.uint32), ns))
            offs[use] = off + starts
            off += total
        if off == 0:
            return
        t1 = _sp.now()
        win = self.dev_windows  # this wave's id (spans)
        dh = self.device.dispatch_min(
            np.concatenate(parts_lo), np.concatenate(parts_hi),
            np.concatenate(parts_npk),
            min_bucket=self.device.SPEC_BUCKET)
        self._spec_pending.append(
            (dh, (hosts, u0, n, npk_a, npk_b), off_a, off_b, win))
        self.dev_windows += 1
        self.dev_window_units += off
        self._spec_units += off
        t2 = _sp.now()
        self.phase_wall["window_build"] += (t1 - t0) / 1e9
        self.phase_wall["window_dispatch"] += (t2 - t1) / 1e9
        sp = self.spans
        if sp.on:
            sp.add(_sp.SPEC_BUILD, t0, t1, win)
            sp.add(_sp.SPEC_LAUNCH, t1, t2, win)
        # the economics clamp compares speculation's OWN spend against its
        # hits; deferred-window walls must not be billed to it
        self._spec_spend += (t2 - t0) / 1e9

    def _install_spec(self, wave) -> None:
        """A speculative wave's min-draws landed: hand them to the C
        consult table in one call (per-host slices by unit offset)."""
        t0 = _sp.now()
        dh, d, off_a, off_b, win = wave
        mins = dh.read()
        hosts, u0, n, npk_a, npk_b = d
        self._c.spec_install(hosts, u0, n, npk_a, npk_b, off_a, off_b,
                             np.ascontiguousarray(mins))
        t1 = _sp.now()
        dt = (t1 - t0) / 1e9
        self.phase_wall["spec_install"] += dt
        if self.spans.on:
            self.spans.add(_sp.SPEC_INSTALL, t0, t1, win)
        self._spec_spend += dt

    # result consumption ----------------------------------------------------
    def flush_due(self, limit: SimTime) -> None:
        """Resolve in-flight batches: every batch whose deadline precedes
        ``limit`` MUST resolve now; while at it, ALL accumulated lazy
        numpy batches resolve in the same single draw call (their flags
        are pure functions of unit identity, so early resolution is
        result-identical — it only coalesces work). Device handles are
        read only when due (an early read would stall on the transfer)."""
        if not self.outstanding:
            return
        if not any(b.deadline < limit for b in self.outstanding):
            return
        sp = self.spans
        t0 = _sp.now()
        if sp.on:
            sp.open(_sp.DRAW_FLUSH, t0)
        # why a window resolves on the host twin, if one does (counted in
        # host_windows): its units under the gate (or no device plane)
        host_reason = "below_floor"
        if self.mesh_plane is not None:
            self._mesh_materialize()
        if self.device is not None:
            # a deadline closes the open window here (even a fixed-K
            # window — causality outranks K): route the WHOLE accumulated
            # window (due and not-yet-due batches — early resolution is
            # result-identical) through ONE fused device dispatch when it
            # clears the gate, with hysteresis in auto mode so a window
            # size hovering at break-even does not flap; smaller windows
            # fall through to the coalesced host twin
            lazy_all = [b for b in self.outstanding if b.handle is None]
            if lazy_all:
                units = sum(len(b.keys) for b in lazy_all)
                self._note_window_units(units)
                # both pipeline slots busy -> the host twin resolves this
                # window (the documented two-slot bound: never queue
                # unbounded device memory behind unread handles)
                slot_free = self._win_inflight < WINDOW_SLOTS
                if self.window_rounds > 0:
                    gate = units >= self.device_floor
                else:
                    gate = (not self._probe_clamped
                            and units >= self.window_gate_units(
                                self._win_engaged))
                engage = slot_free and gate
                self._win_engaged = engage
                if engage:
                    self._dispatch_window(lazy_all, units)
                else:
                    self._floor_cooldown_tick()
                    if gate:
                        # both slots busy: a window that is itself due, or
                        # one still open that this flush takes early
                        host_reason = (
                            "slots_busy" if any(b.deadline < limit
                                                for b in lazy_all)
                            else "flushed_open")
        take = [b for b in self.outstanding
                if b.handle is None or b.deadline < limit]
        self.outstanding = deque(
            b for b in self.outstanding
            if not (b.handle is None or b.deadline < limit))
        lazy = [b for b in take if b.handle is None]
        if lazy:
            self._win_open_rounds = 0  # flush truncated the open window
        it = None
        if lazy:
            self.host_windows[host_reason] += 1
            if sp.on:
                sp.open(_sp.DRAW_HOST)
            if len(lazy) == 1:
                b = lazy[0]
                lz = [loss_flags(self.params.seed, b.uid_lo, b.uid_hi,
                                 b.npk, b.thresh)]
            else:
                lo = np.concatenate([b.uid_lo for b in lazy])
                hi = np.concatenate([b.uid_hi for b in lazy])
                npk = np.concatenate([b.npk for b in lazy])
                th = np.concatenate([b.thresh for b in lazy])
                flat = loss_flags(self.params.seed, lo, hi, npk, th)
                lz = np.split(
                    flat, np.cumsum([len(b.keys) for b in lazy])[:-1])
            it = iter(lz)
            if sp.on:
                sp.close()
        for b in take:
            if b.handle is None:
                flags = next(it)
                flags_l = flags.tolist() if flags.any() else None
            elif isinstance(b.handle, _MeshHandle):
                arrival_a, mflags = b.handle.read()
                b.arrival = arrival_a.tolist()
                flags_l = mflags.tolist() if mflags.any() else None
            else:
                r0 = _sp.now()
                flags = b.handle.read()
                self._record_dev_read((_sp.now() - r0) / 1e9, len(b.keys))
                flags_l = flags.tolist() if flags.any() else None
            if b.forced is not None:
                # the fault filter's forced drops join every route's flags
                if flags_l is None:
                    flags_l = b.forced
                else:
                    flags_l = [a or f for a, f in zip(flags_l, b.forced)]
            if sp.on:
                sp.open(_sp.DRAW_STORE)
            self._store_resolved(b.rows, b.src, b.arrival, b.keys, flags_l,
                                 b.round_end)
            if sp.on:
                sp.close()
        self._floor_settle()
        t1 = _sp.now()
        self.phase_wall["draw_flush"] += (t1 - t0) / 1e9
        if sp.on:
            sp.close(t1)

    def flush_all(self) -> None:
        self.flush_due(T_NEVER + 1)
        if (self._spec_on or self._spec_clamped) and self._c is not None:
            # drain the C consult counters (hits served from speculative
            # windows vs inline draws) into the run telemetry — also
            # after an economics clamp, since installed windows keep
            # serving hits; in-flight speculative waves are dropped (a
            # cache of a pure function, never simulation state)
            hits, draws = self._c.spec_stats()
            self.spec_hits += hits
            self.spec_draws += draws
            self._spec_pending = []
        if self._c is not None:
            self._c.fold_counters()
        if self.mesh_plane is not None:
            # the collective's per-window wall attribution in the run
            # summary (mesh_* keys in phase_wall)
            for k, v in self.mesh_plane.phase.items():
                self.phase_wall[f"mesh_{k}"] = (
                    round(v, 4) if isinstance(v, float) else v)

    def _store_resolved(self, rows, src_l, arrival, keys, flags,
                        round_end: SimTime) -> None:
        """Flags known (None = all survive): build one sorted StoreBatch
        of arrival rows for the surviving units (the C engine's packed
        batch when it is attached)."""
        if self._c is not None:
            self._c.store_resolved(rows, src_l, arrival, keys, flags,
                                   round_end)
            return
        out: list = []
        nbytes_total = 0
        sent = 0
        dropped = 0
        sh_n, sh_id, xout = self.shard_n, self.shard_id, self.xout
        for i, r in enumerate(rows):
            if flags is not None and flags[i]:
                dropped += 1
                continue
            sent += 1
            nbytes_total += r[E_SIZE]
            t = arrival[i]
            if t < round_end:
                t = round_end
            row = (t, keys[i], r[E_DST], r[E_KIND], src_l[i],
                   r[E_SPORT], r[E_DPORT], r[E_NBYTES], r[E_SEQ],
                   r[E_FRAG], r[E_NFRAGS], r[E_SIZE], r[E_PAYLOAD])
            if sh_n > 1 and r[E_DST] % sh_n != sh_id:
                xout[r[E_DST] % sh_n].append(row)
            else:
                out.append(row)
        self.units_sent += sent
        self.units_dropped += dropped
        self.bytes_sent += nbytes_total
        if out:
            out.sort(key=_row_tk)
            self.pending.append(StoreBatch(out))

    # -- multi-process sharding (parallel/shards.py) ------------------------
    def bind_shard(self, shard_id: int, shard_n: int) -> None:
        """Install the shard filter on this plane (and the C engine when
        attached): resolved rows for non-owned destinations divert into
        xout[dst_shard] (or the engine's packed buffers) instead of the
        local pending store."""
        self.shard_id = shard_id
        self.shard_n = shard_n
        self.xout = [[] for _ in range(shard_n)]
        if self._c is not None:
            self._c.bind_shard(shard_id, shard_n, None)

    def take_xout(self) -> list:
        """Drain the per-shard cross-shard buffers, each sorted by the
        unique (t, key) prefix. (With the C engine bound, rows live in
        its packed buffers instead — take_xout_packed is the drain; these
        Python lists stay empty.)"""
        out, self.xout = self.xout, [[] for _ in range(self.shard_n)]
        for rows in out:
            rows.sort(key=_row_tk)
        return out

    def take_xout_packed(self, max_bytes: int):
        """The C engine's send-side packer (parallel/shards.py): drain the
        diverted cross-shard rows as ready-to-ship wire-format byte
        blocks — (t, key)-sorted, chunked at ``max_bytes`` — without ever
        materializing per-row Python tuples. None on the Python plane,
        whose callers use take_xout() + pack_rows."""
        if self._c is None:
            return None
        return self._c.take_xout_packed(int(max_bytes))

    def ingest_remote(self, rows: list) -> None:
        """Arrival rows shipped from another shard (already (t, key)
        sorted): they join the pending store as one more resolved batch —
        extraction merges them with local batches per destination host in
        canonical order, exactly like any other overlapping StoreBatch."""
        if not rows:
            return
        if self._c is not None:
            from shadow_tpu_torch.native import colcore

            cb = colcore().shell("CBatch")
            cb._restore_state((0, rows))
            self.pending.append(cb)
        else:
            self.pending.append(StoreBatch(rows))


class _WindowHandle:
    """One fused window dispatch shared by its batches: the device result
    is read once (the only point that can stall — attributed to
    window_readback) and every batch slices it for free at its own causal
    deadline. Frees its pipeline slot when the last slice is consumed."""

    __slots__ = ("plane", "flags", "_dh", "_left", "window")

    def __init__(self, plane, dh, window: int = -1) -> None:
        self.plane = plane
        self.flags = None
        self._dh = dh
        self._left = 0
        self.window = window  # the window's id (spans)

    def read_full(self) -> np.ndarray:
        if self.flags is None:
            self.flags, dt = self.plane._read_card(self._dh, self.window)
            self.plane._stall_sample(dt)
        return self.flags

    def slice_consumed(self) -> None:
        self._left -= 1
        if self._left == 0:
            self.plane._window_done()


class _WindowSlice:
    """One batch's view over its window's shared flags."""

    __slots__ = ("wh", "off", "n")

    def __init__(self, wh: _WindowHandle, off: int, n: int) -> None:
        self.wh = wh
        self.off = off
        self.n = n
        wh._left += 1

    def read(self) -> np.ndarray:
        flags = self.wh.read_full()[self.off:self.off + self.n]
        self.wh.slice_consumed()
        return flags


class _ConcatHandle:
    """An oversized single batch dispatched as several chunks (legacy
    tpu_max_batch split), read back as one flag array."""

    __slots__ = ("plane", "handles", "window")

    def __init__(self, plane, handles, window: int = -1) -> None:
        self.plane = plane
        self.handles = handles
        self.window = window  # the window's id (spans)

    def read(self) -> np.ndarray:
        plane = self.plane
        t0 = _sp.now()
        flags = np.concatenate([plane._read_card(h, self.window)[0]
                                for h in self.handles])
        plane._stall_sample((_sp.now() - t0) / 1e9)
        plane._window_done()
        return flags


class _MeshLazy:
    """A barrier's units awaiting the fused collective (draws + arrival
    exchange): post-blackhole arrays, arrivals already resolved host-side.
    Converted to a _MeshHandle over the window's shared exchange tables by
    _mesh_materialize."""

    __slots__ = ("src", "dst", "arrival", "uid", "npk", "th")

    def __init__(self, src, dst, arrival, uid, npk, th):
        self.src = src
        self.dst = dst
        self.arrival = arrival
        self.uid = uid
        self.npk = npk
        self.th = th


class _MeshHandle:
    """A barrier's view over the window's uid-sorted exchange table (built
    once in _mesh_materialize, shared across the window's barriers)."""

    __slots__ = ("tab", "uids")

    def __init__(self, tab, uids):
        self.tab = tab  # (rows, 4) int64, valid rows only, uid-ascending
        self.uids = uids  # (n,) int64, batch order (post blackhole filter)

    def read(self):
        """(arrival times, drop flags) of the batch's units, in batch
        order. Raises when the table lacks one of them."""
        from shadow_tpu_torch.parallel.mesh import F_FLAGS, F_TARR, F_UID

        tab = self.tab
        idx = np.searchsorted(tab[:, F_UID], self.uids)
        if (idx >= len(tab)).any() or (tab[idx, F_UID] != self.uids).any():
            raise RuntimeError(
                "mesh exchange table is missing units — collective "
                "routing bug (capacity truncation?)")
        return tab[idx, F_TARR], (tab[idx, F_FLAGS] & 1).astype(bool)


def _row_t(row):
    return row[0]


def _row_tk(row):
    return row[0], row[1]


def _round_robin_rows(rows):
    """interface_qdisc: round_robin over egress ROW tuples — same fairness
    rule as the per-unit plane's _round_robin (emission-time causality
    primary; same-instant ties interleave flows by per-flow rank).
    Returns (reordered rows, their original emission indices) so uid
    assignment can follow emission order like the per-unit plane."""
    rank: dict = {}
    order: dict = {}
    keyed = []
    for i, r in enumerate(rows):
        f = r[E_SPORT]
        rk = rank.get(f, 0)
        rank[f] = rk + 1
        keyed.append((r[E_TEMIT], rk, order.setdefault(f, len(order)), i, r))
    keyed.sort(key=lambda t: t[:4])
    return [t[4] for t in keyed], [t[3] for t in keyed]


class _RowView:
    """Unit-shaped view over one egress row: what ``fault_filter`` sees on
    the columnar plane, the surface of the per-unit plane's ``Unit``."""

    __slots__ = ("_r", "src", "uid")

    def __init__(self, row, src, uid):
        self._r = row
        self.src = src
        self.uid = uid

    @property
    def kind(self):
        return self._r[E_KIND]

    @property
    def t_emit(self):
        return self._r[E_TEMIT]

    @property
    def frag_idx(self):
        return self._r[E_FRAG]

    @property
    def nfrags(self):
        return self._r[E_NFRAGS]

    @property
    def dst(self):
        return self._r[E_DST]

    @property
    def size(self):
        return self._r[E_SIZE]

    @property
    def src_port(self):
        return self._r[E_SPORT]

    @property
    def dst_port(self):
        return self._r[E_DPORT]

    @property
    def nbytes(self):
        return self._r[E_NBYTES]

    @property
    def seq(self):
        return self._r[E_SEQ]

    @property
    def payload(self):
        return self._r[E_PAYLOAD]
