"""Multi-process host partitioning with conservative cross-shard windows.

The port of shadow_tpu/parallel/shards.py, with the reference's live
plane: the parent owns the endpoint, live commands ride shard 0's round
marker so every worker applies them at the same boundary, and the parent
writes commands.jsonl from shard 0's lines; replayed logs apply on every
worker alike; pause and resume are refused by name. The
workers launch no kernel, by the reference's own design: each sets
``tpu_device_floor = -1`` (and the device transport off — both wall-clock
policy, result-identical), builds its controller with the invocation's
device without initialising CUDA, and the numpy/C twins carry every
draw. The shared-memory segments are named ``stpt_*`` (the reference's
are ``stpu_*``), so a port run and a reference run on one machine cannot
collide.

This is the scale-out plane: the host set is
partitioned across N worker processes by static id-modulo placement
(``hid % N`` — the same discipline ``thread_per_core`` uses for threads),
each worker running its own scheduler + engine (Python columnar, per-unit,
or C colcore) over its owned subset, coordinated by a parent process that
runs the SAME conservative min-latency lookahead loop the single-process
controller runs — extended across processes, which is exactly Shadow's
worker-thread barrier (Jansen & Hopper, NDSS'12) lifted to Chandy–Misra
conservative lookahead between OS processes (PAPERS.md).

The causal window is one round (round width <= min path latency), so every
cross-shard effect of round R lands at round >= R+1: a worker resolves its
own hosts' emissions completely at its barrier (closed-form departures,
threefry loss draws, arrival times, canonical keys — all pure functions of
sender-local state and unit identity), diverts rows whose destination host
lives on another shard into per-shard egress buffers, and ships them over
pickle-free shared-memory ring buffers at the round edge, followed by an
EDGE MARKER carrying that shard's reduction inputs. Workers synchronize
PEER-TO-PEER: each waits for all peers' markers of the same round and
computes the identical global decision (skip-ahead target, dynamic round
width, early end, graceful stop) the single-process loop computes from
local state — the parent process never gates a round (a pipe wake-up
costs ~0.7 ms on a loaded box; it was the dominant scale-out overhead),
it only consumes asynchronous streams: digest/telemetry partials to
merge, heartbeat stats, checkpoint notices, stop forwarding. The
receiving shard merges shipped rows into its pending store at its next
round top, in canonical (t, key) order — with the C engine attached they
parse straight into a packed CBatch (no per-row Python tuples).

Why byte-identity at ANY shard count is structural, not incidental:

- **Loss draws** are counter-based threefry keyed on (seed, uid, packet):
  placement-independent by construction.
- **Canonical event keys ARE uids** ((src << 32) | per-src seq): two
  same-instant arrivals at one destination order identically no matter
  which process resolved them (the PR that added this plane changed the
  key scheme in all three planes from a global dense counter — a
  placement-DEPENDENT quantity — to the uid).
- **Egress buckets** are per-source (owned by the emitting shard);
  **ingress buckets** are charged at the destination in canonical event
  order (owned by the delivering shard).
- **The round grid** is decided identically on every worker from the
  same marker reductions (executed counts, next-event minima including
  in-flight cross-shard arrivals, fault wake-ups) — the same decisions
  the single-process loop makes from local state.
- **Fault timelines** are pure functions of (config, seed) and broadcast:
  every shard applies every matrix rewrite; host lifecycle transitions
  mutate only owned hosts.

Output streams merge canonically: host log trees are disjoint by
ownership; sentinel digests and telemetry samples are assembled by the
parent from per-shard partials into byte-exact single-process records;
flow records merge by (round, host id) at run end. ``sim_shards: 1`` is
the unchanged single-process controller; tests/test_torch_shards.py gates
byte-identity of trees, flows, metrics, and digest streams at 1/2/4
shards with the C engine on and off, against the reference.

Checkpoints: each worker snapshots its shard at the same round boundary;
the parent writes a ``.shards.json`` manifest beside them. The shard
count rides the checkpoint header — same-count resume is byte-identical,
a mismatched count refuses by name (re-run from scratch at the new count
reproduces the same simulation anyway, by the identity above).
"""

from __future__ import annotations

import json
import marshal
import os
import pickle
import struct
import time as _walltime  # detlint: ok(wallclock): ring polling + straggler wall telemetry
from pathlib import Path

import numpy as np

from shadow_tpu_torch.core.controller import (SUMMARY_ONLY_PHASES, Controller,
                                              _GC_EVERY_ROUNDS)
from shadow_tpu_torch.core.time import (NS_PER_SEC, NS_PER_US, T_NEVER,
                                        format_time)
from shadow_tpu_torch.host.process import PluginProcess
from shadow_tpu_torch.supervise import (STALL_CEILING_S, ChaosInjector,
                                        ProgressPage, progress_name,
                                        stall_deadline_s)
from shadow_tpu_torch.utils.counters import Counters
from shadow_tpu_torch.utils.logging import SimLogger

#: shared-memory ring capacity per directed shard pair (bytes); a round
#: edge whose packed rows exceed the free space blocks the writer (which
#: keeps draining its own inbound rings, so the pair always makes
#: progress). Override: SHADOW_TPU_RING_BYTES.
DEFAULT_RING_BYTES = 4 << 20

_NUM_FIELDS = 12  # numeric fields of a 13-field store row (payload apart)

MANIFEST_SUFFIX = ".shards.json"
MANIFEST_FORMAT = "shadow_tpu_torch-shard-manifest"


def validate_config_shardable(cfg) -> None:
    """Build-time policy for sim_shards > 1 — named refusals only."""
    import platform

    if platform.machine() not in ("x86_64", "AMD64", "i686", "i386"):
        # the ShmRing SPSC protocol relies on x86-TSO store ordering
        # (data stores before the tail store, no explicit fence — see
        # ShmRing); a weakly-ordered CPU could observe a tail before the
        # block bytes and silently corrupt the exchange. Refuse by name
        # until the ring carries real barriers.
        raise ValueError(
            f"sim_shards > 1 requires an x86-TSO host (the shared-memory "
            f"ring protocol orders its stores by program order, not "
            f"fences); this machine is {platform.machine()!r}")
    if cfg.experimental.scheduler_policy == "tpu_mesh":
        raise ValueError(
            "sim_shards > 1 is unsupported with scheduler_policy tpu_mesh "
            "(the mesh collective plane is single-process); use tpu_batch "
            "— the shard workers run the same columnar/C engine")
    for hopts in cfg.hosts:
        if hopts.pcap_enabled:
            raise ValueError(
                f"sim_shards > 1 is unsupported with pcap capture: host "
                f"{hopts.name!r} has pcap_enabled; disable one of the two")
        for popts in hopts.processes:
            if not PluginProcess.is_plugin_path(popts.path):
                raise ValueError(
                    f"sim_shards > 1 is unsupported with managed native "
                    f"processes: host {hopts.name!r} runs {popts.path!r}; "
                    f"use pyapp: workloads or sim_shards: 1")


# -- row packing (the shared-memory wire format) ------------------------------
#
# One block per (sender, receiver, round edge): little-endian
#   [n_rows u64][numeric cols (n, 12) int64][payload lens (n,) int64][blobs]
# Payloads are marshal-encoded (bytes / str / tuples / ints / None — the
# model payload vocabulary); a negative length marks the rare pickle
# fallback. No per-row pickling on the hot path.

def pack_rows(rows: list) -> bytes:
    n = len(rows)
    if n == 0:
        return struct.pack("<q", 0)
    arr = np.empty((n, _NUM_FIELDS), dtype=np.int64)
    lens = np.empty(n, dtype=np.int64)
    blobs = []
    for i, r in enumerate(rows):
        arr[i] = r[:_NUM_FIELDS]
        p = r[_NUM_FIELDS]
        if p is None:
            lens[i] = 0
        else:
            try:
                b = marshal.dumps(p)
                lens[i] = len(b)
            except ValueError:
                b = pickle.dumps(p, protocol=4)
                lens[i] = -len(b)
            blobs.append(b)
    return b"".join([struct.pack("<q", n), arr.tobytes(), lens.tobytes()]
                    + blobs)


def unpack_rows(buf: bytes) -> list:
    (n,) = struct.unpack_from("<q", buf, 0)
    if n == 0:
        return []
    off = 8
    arr = np.frombuffer(buf, dtype=np.int64, count=n * _NUM_FIELDS,
                        offset=off).reshape(n, _NUM_FIELDS)
    off += n * _NUM_FIELDS * 8
    lens = np.frombuffer(buf, dtype=np.int64, count=n, offset=off)
    off += n * 8
    nums = arr.tolist()  # C-speed conversion to Python ints
    lens_l = lens.tolist()
    rows = []
    for i in range(n):
        ln = lens_l[i]
        if ln == 0:
            p = None
        elif ln > 0:
            p = marshal.loads(buf[off:off + ln])
            off += ln
        else:
            p = pickle.loads(buf[off:off - ln])
            off += -ln
        rows.append((*nums[i], p))
    return rows


# -- shared-memory rings ------------------------------------------------------

class RingCreateError(RuntimeError):
    """A shard pair's shared-memory ring could not be made: the run stops
    by name, it never falls back to a slower exchange."""


def check_shm_room(n_shards: int, ring_bytes: int) -> None:
    """Raise RingCreateError unless /dev/shm has room for the run's
    rings (one per directed shard pair) and its progress page. Segments
    on tmpfs are sparse: an oversized ring is created without complaint
    and faults (SIGBUS) at its first write past the free space, so the
    room is checked before any ring exists."""
    need = n_shards * (n_shards - 1) * (ring_bytes + ShmRing.HDR) \
        + 64 * n_shards
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return  # no such mount to measure: creation itself reports
    free = st.f_bavail * st.f_frsize
    if free < need:
        raise RingCreateError(
            f"/dev/shm has {free} bytes free, the {n_shards}-shard run's "
            f"rings need {need} ({n_shards * (n_shards - 1)} rings of "
            f"{ring_bytes} bytes) — free space there or lower "
            f"SHADOW_TPU_RING_BYTES")

class ShmRing:
    """One directed shard-pair SPSC ring over a SharedMemory segment.

    Layout: [head u64][tail u64][data (cap bytes)]; blocks are
    [len u64][bytes], with a len = -1 pad marker skipping to the buffer
    end when a block would straddle the wrap point. ``head`` is owned by
    the single reader, ``tail`` by the single writer (absolute, ever-
    increasing offsets; position = offset % cap), so the two sides never
    write the same word — the writer may append round R's blocks WHILE
    the reader drains round R-1's (workers run rounds concurrently; the
    parent barrier only guarantees the previous edge's blocks are
    complete). The reader snapshots ``tail`` once: blocks appended after
    the snapshot are simply picked up at the next round start — they
    carry arrivals at least one full round ahead, so early ingestion is
    result-identical. Data stores precede the tail store in program
    order (x86-TSO keeps them ordered; the one-word header fields are
    naturally aligned). write() returns False when the ring is full —
    the worker's blocking wrapper (_write_block) drains its own inbound
    rings and retries, which is what guarantees pairwise progress.
    """

    HDR = 16

    def __init__(self, name: str, size: int = 0, create: bool = False):
        from multiprocessing import shared_memory

        if create:
            try:
                self.shm = shared_memory.SharedMemory(
                    name=name, create=True, size=size + self.HDR)
            except OSError as exc:
                raise RingCreateError(
                    f"cannot create the {size}-byte shared-memory ring "
                    f"{name!r}: {exc} — free space in /dev/shm or lower "
                    f"SHADOW_TPU_RING_BYTES") from exc
        else:
            # attach WITHOUT resource_tracker registration: the creator
            # (parent) owns the segment's lifetime; a tracked attach
            # fights the shared tracker process over unregistration at
            # exit (cpython#82300 family)
            from multiprocessing import resource_tracker

            orig = resource_tracker.register
            resource_tracker.register = lambda *a, **k: None
            try:
                self.shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = orig
        self.buf = self.shm.buf
        self.cap = len(self.buf) - self.HDR
        if create:
            struct.pack_into("<qq", self.buf, 0, 0, 0)

    def _pos(self, off: int) -> int:
        return self.HDR + off % self.cap

    def write(self, data: bytes) -> bool:
        (head,) = struct.unpack_from("<q", self.buf, 0)
        (tail,) = struct.unpack_from("<q", self.buf, 8)
        need = 8 + len(data)
        free = self.cap - (tail - head)
        pos = tail % self.cap
        if pos + need > self.cap:
            # pad to the wrap point so the block stays contiguous
            pad = self.cap - pos
            if need + pad > free:
                return False
            if pad >= 8:
                struct.pack_into("<q", self.buf, self.HDR + pos, -1)
            tail += pad
            struct.pack_into("<q", self.buf, 8, tail)
            pos = 0
            free -= pad
        if need > free:
            return False
        struct.pack_into("<q", self.buf, self.HDR + pos, len(data))
        self.buf[self.HDR + pos + 8:self.HDR + pos + need] = data
        struct.pack_into("<q", self.buf, 8, tail + need)
        return True

    def read_all(self) -> list:
        (head,) = struct.unpack_from("<q", self.buf, 0)
        (tail,) = struct.unpack_from("<q", self.buf, 8)  # snapshot once
        out = []
        while head < tail:
            pos = head % self.cap
            if pos + 8 > self.cap:
                head += self.cap - pos
                continue
            (ln,) = struct.unpack_from("<q", self.buf, self.HDR + pos)
            if ln < 0:  # pad marker: skip to the wrap point
                head += self.cap - pos
                continue
            start = self.HDR + pos + 8
            out.append(bytes(self.buf[start:start + ln]))
            head += 8 + ln
        struct.pack_into("<q", self.buf, 0, head)
        return out

    def close(self) -> None:
        self.buf = None
        self.shm.close()

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


def _ring_name(tag: str, src: int, dst: int) -> str:
    # "stpt_": the port's segments, apart from the reference's "stpu_"
    return f"stpt_{tag}_{src}_{dst}"


# -- the shard worker ---------------------------------------------------------

class ShardController(Controller):
    """One worker's controller: full topology, owned-subset execution."""

    def __init__(self, cfg, shard_id: int, n_shards: int,
                 device: str = "cuda") -> None:
        self.shard_id = shard_id
        self.n_shards = n_shards
        super().__init__(cfg, mirror_log=False, device=device)
        self.engine.bind_shard(shard_id, n_shards)
        if self.telemetry is not None:
            self.telemetry.shard = (shard_id, n_shards)
        if self.faults is not None and self.telemetry is not None \
                and shard_id != 0:
            # fault application is identical on every shard; only shard
            # 0's collector annotates the timeline (the parent writes it)
            self.faults.on_apply = None

    def _log_name(self) -> str:
        return f"shadow.shard{self.shard_id}.log"


class _PeerDied(RuntimeError):
    pass


class _ShardWorker:
    """The worker side: a FREE-RUNNING conservative round loop.

    Workers synchronize peer-to-peer through the rings, not through the
    parent: each round edge ships the cross-shard rows plus a MARKER
    block carrying this shard's reduction inputs (executed count,
    immediate-work flag, next-event minimum, shipped-row minimum, fault
    wake-up, min-used-latency, stop request). Every worker waits for all
    peers' markers of the same round and computes the IDENTICAL global
    decision the single-process loop computes locally — next `now`,
    skip-ahead target, dynamic round width, early end, graceful stop.
    The parent never gates a round (a pipe wake-up costs ~0.7 ms on
    this class of box — it was the dominant sharding overhead); it only
    consumes asynchronous streams (digest/telemetry partials, heartbeat
    stats, checkpoint notices) and forwards stop requests.

    Waiting is drain-and-yield polling on the rings: while waiting (or
    blocked on a full outbound ring) a worker keeps draining its inbound
    rings — which is what guarantees the peer's blocked writes always
    make progress (no write-write deadlock). Workers can be at most one
    round apart (the marker barrier), so early-arriving next-round rows
    are bounded and result-identical to ingest (arrival times are
    clamped past their emitting round's end)."""

    def __init__(self, ctl, conn, shard_id: int, n_shards: int,
                 ring_tag: str, ring_bytes: int) -> None:
        self.ctl = ctl
        self.conn = conn
        self.k = shard_id
        self.n = n_shards
        self.rings_out = {}
        self.rings_in = {}
        for j in range(n_shards):
            if j == shard_id:
                continue
            self.rings_out[j] = ShmRing(_ring_name(ring_tag, shard_id, j))
            self.rings_in[j] = ShmRing(_ring_name(ring_tag, j, shard_id))
        self._exchange_wall = 0.0
        self._sync_wall = 0.0
        self._next_gc = _GC_EVERY_ROUNDS
        #: liveness (supervise.py): this shard's slot on the
        #: shared progress page — stamped at every round top, inside the
        #: marker wait, and inside blocked ring writes, so only a shard
        #: that is truly frozen ever goes stale (a shard merely blocked
        #: on a wedged peer keeps stamping and the right one gets named)
        self._prog = ProgressPage(progress_name(ring_tag), n_shards)
        #: observed round-wall EMA, the base of the stall deadline
        self._round_ema = 0.0
        self._t_round_top = None
        #: chaos harness (supervise.py): env-armed, this shard's events
        self._chaos = ChaosInjector.from_env(ctl.data_dir, shard=shard_id)
        #: packed ingest (C engine attached): ring bytes parse straight
        #: into a CBatch — no tuple materialization per row
        self._packed_ingest = None
        if getattr(ctl.engine, "_c", None) is not None:
            from shadow_tpu_torch.native import colcore

            self._packed_ingest = colcore().cbatch_from_packed
        #: packed SEND (C engine): the engine hands back ready wire
        #: blocks — BRow -> ring bytes in C, no 13-field tuples before the
        #: wire. None (the Python plane) falls back to take_xout() +
        #: pack_rows.
        self._take_packed = getattr(ctl.engine, "take_xout_packed", None)
        self._max_block = (min(r.cap for r in self.rings_out.values())
                           // 2 - 64) if self.rings_out else 1 << 20
        #: markers received but not yet consumed: round -> {shard: dict}
        self._markers: dict = {}
        #: row blocks received but not yet ingested: (round, rows). A
        #: block from the peer's round-r edge is ingested only once WE
        #: have completed round r (the consistent-cut rule): a fast peer
        #: may ship round r+1 rows while we sit at the r+1 boundary, and
        #: a checkpoint there must not capture rows the restored peer
        #: will re-emit (double delivery on resume).
        self._pending_rows: list = []
        self._stop_req = False  # parent asked for a graceful stop
        #: live operations plane (live.py): commands arrive on the parent
        #: pipe (shard 0 only), ride shard 0's NEXT round marker so every
        #: worker holds the identical list, and apply at the following
        #: round boundary — the same round everywhere
        self._pending_cmds: list = []  # from the parent pipe (shard 0)
        self._marker_cmds: list = []   # from shard 0's marker, due next top
        self._cmd_stop = False         # a live `stop` command ended the run

    # -- lifecycle ---------------------------------------------------------
    def serve(self, resume_at=None) -> None:
        import gc as _gc
        import signal as _signal

        # the parent owns signal policy: a terminal Ctrl-C reaches the
        # whole process group, and a worker dying mid-protocol would turn
        # a graceful stop into a hang
        try:
            _signal.signal(_signal.SIGINT, _signal.SIG_IGN)
        except (ValueError, OSError):
            pass
        ctl = self.ctl
        tel = ctl.telemetry
        if tel is not None and resume_at is None:
            tel.start_fresh(ctl)
        if resume_at is not None and ctl._replay_cmds:
            # commands at boundaries <= resume_at were applied BEFORE the
            # checkpoint snapshot (boundary order: commands, then
            # checkpoint) — their effects are in the restored state
            while (ctl._replay_idx < len(ctl._replay_cmds)
                   and ctl._replay_cmds[ctl._replay_idx]["t"] <= resume_at):
                ctl._replay_idx += 1
        gc_was_enabled = _gc.isenabled()
        _gc.disable()
        self.conn.send(("ready", {
            "round_ns": ctl.round_ns,
            "n_hosts": len(ctl.hosts),
            "rounds": ctl.rounds,
            "events": ctl.events,
            "mul": ctl.engine.min_used_latency,
            "tel_partials": (tel.drain_partials()
                            if tel is not None else []),
        }))
        try:
            op, m = self.conn.recv()
            if op != "run":
                raise RuntimeError(f"expected run command, got {op!r}")
            self._free_run(m)
            while True:
                msg = self.conn.recv()
                if msg[0] == "finalize":
                    break
                if msg[0] != "stop":  # a stop racing our normal finish
                    raise RuntimeError(
                        f"expected finalize, got {msg[0]!r}")
            self.conn.send(("final", self._finalize(msg[1])))
        finally:
            if gc_was_enabled:
                _gc.enable()
            for r in self.rings_out.values():
                r.close()
            for r in self.rings_in.values():
                r.close()
            self._prog.close()

    # -- the free-running round loop ---------------------------------------
    def _free_run(self, m: dict) -> None:
        import gc as _gc

        ctl = self.ctl
        eng = ctl.engine
        cfg = ctl.cfg
        stop = cfg.general.stop_time
        now = m["now"]
        mul = m["mul0"]  # globally-reduced min_used_latency (resume)
        base_w = ctl.round_ns
        w = base_w
        dyn = cfg.experimental.use_dynamic_runahead
        dig = ctl.digest_every
        ck_every = ctl.ckpt_every
        next_ckpt = ((now // ck_every) + 1) * ck_every if ck_every \
            else T_NEVER
        hb = cfg.general.heartbeat_interval or 0
        next_hb = ((now // hb) + 1) * hb if hb else T_NEVER
        tel = ctl.telemetry
        faults = ctl.faults
        interrupted = False
        from shadow_tpu_torch import checkpoint as _ckpt

        while now < stop:
            # liveness: stamp the progress word FIRST (round + wall),
            # then update the round-wall EMA the stall deadline derives
            # from — chaos fires after the stamp so a wedge freezes an
            # honest last-progress record for the peers to name
            t_top = _walltime.monotonic()
            if self._t_round_top is not None:
                dt = t_top - self._t_round_top
                self._round_ema = (dt if self._round_ema == 0.0
                                   else 0.85 * self._round_ema + 0.15 * dt)
            self._t_round_top = t_top
            self._prog.stamp(self.k, ctl.rounds)
            if self._chaos is not None:
                self._chaos.maybe_fire(ctl.rounds, ctl)
            # ingest rows shipped at edges we have barrier-passed (the
            # markers for round `ctl.rounds` were consumed last
            # iteration, and rows precede markers in ring FIFO order,
            # so every edge <= ctl.rounds is fully drained or stashed)
            self._drain_rings()
            self._ingest_ready(ctl.rounds)
            if self._marker_cmds or ctl._replay_idx < len(ctl._replay_cmds):
                # round-boundary command application (live.py contract):
                # marker-delivered live commands and due replay-log
                # entries — identical inputs on every worker, so the
                # fault timeline mutates identically everywhere
                faults = self._apply_boundary_cmds(now, faults)
                if self._cmd_stop:
                    interrupted = True
                    break
            if (ck_every and now >= next_ckpt) or ctl._ckpt_now:
                ctl._ckpt_now = False
                self._checkpoint(now)
                if ck_every:
                    next_ckpt = ((now // ck_every) + 1) * ck_every
            if faults is not None:
                faults.apply_due(now)
            if dyn:
                # the globally-reduced minimum, exactly the value the
                # single-process loop reads from its own engine
                w = max(base_w, min(mul, 10 * base_w))
            round_end = min(now + w, stop)
            eng.start_of_round(now, round_end)
            t_ev = _walltime.perf_counter()
            if ctl._c_core is not None:
                executed = ctl._c_core.run_round(round_end)
            else:
                hosts = ctl.hosts
                active = [hosts[i] for i in sorted(ctl._active)]
                executed = ctl.scheduler.run_round(round_end, active)
                for h in active:
                    if not h.equeue._heap:
                        ctl._active.discard(h.id)
            ctl.spans.totals["events"] += _walltime.perf_counter() - t_ev
            eng.end_of_round(now, round_end)
            devt = getattr(eng, "devt", None)
            if devt is not None:
                # columnar-transport replays ran inside end_of_round:
                # fold them into this shard's executed count BEFORE the
                # marker reduction, exactly like Controller._round_loop
                executed += devt.take_executed()
            ctl.rounds += 1
            ctl.events += executed

            # the round edge: resolve EVERY outstanding draw batch
            # (early resolution is result-identical — flags are pure
            # functions of unit identity — and a cross-shard row must be
            # on the wire before its arrival round starts anywhere),
            # ship the diverted rows, then publish this round's marker
            t1 = _walltime.perf_counter()
            eng.flush_due(T_NEVER + 1)
            xmin = T_NEVER
            packed = (self._take_packed(self._max_block)
                      if self._take_packed is not None else None)
            if packed is not None:
                # C send-side packer: blocks are already (t, key)-sorted
                # wire bytes chunked to fit the ring; the first numeric
                # column of row 0 (offset 8) is the block's min t
                for j, blocks in enumerate(packed):
                    if j == self.k:
                        continue
                    for data in blocks:
                        (bt,) = struct.unpack_from("<q", data, 8)
                        if bt < xmin:
                            xmin = bt
                        self._write_packed(j, data)
            else:
                xout = eng.take_xout()
                for j, rows in enumerate(xout):
                    if j == self.k or not rows:
                        continue
                    if rows[0][0] < xmin:
                        xmin = rows[0][0]  # (t, key)-sorted: [0] is min t
                    self._write_rows(j, rows)
            # the next-event minimum is only consumed by the global
            # skip-ahead reduction, which requires EVERY shard to have
            # executed zero events — so a shard that executed anything
            # can ship a placeholder and skip the active-set scan (the
            # single-process loop likewise only scans on quiet rounds;
            # scanning every round cost ~13 ms/round at 100k hosts)
            if executed == 0:
                if ctl._c_core is not None:
                    nq = ctl._c_core.next_time()
                else:
                    nq = min((ctl.hosts[i].equeue.next_time()
                              for i in ctl._active), default=T_NEVER)
                nq = min(nq, eng.pending_head())
            else:
                nq = T_NEVER
            self._poll_parent()
            stats = {
                "executed": executed,
                "imm": bool(eng.has_immediate_work()),
                "next": nq,
                "xmin": xmin,
                "fnext": (faults.next_time() if faults is not None
                          else T_NEVER),
                "mul": eng.min_used_latency,
                "stop": self._stop_req,
            }
            if self.k == 0 and self._pending_cmds:
                # live commands ride shard 0's marker: every worker reads
                # the SAME list at the same round and applies it at the
                # next boundary (the parent only ever feeds shard 0)
                stats["cmds"] = self._pending_cmds
                self._pending_cmds = []
            for j in self.rings_out:
                self._write_block(j, b"M" + marshal.dumps(
                    (ctl.rounds, self.k, stats)))
            self._exchange_wall += _walltime.perf_counter() - t1

            # asynchronous streams to the parent (never round-gating)
            if dig and ctl.rounds % dig == 0:
                self.conn.send(("dig", ctl.rounds, round_end,
                                _ckpt.shard_digest_partial(ctl, round_end)))
            if tel is not None and (tel.dirty
                                    or round_end >= tel.next_sample):
                t_tel = _walltime.perf_counter()
                tel.on_round_end(ctl, round_end)
                ctl.spans.totals["telemetry"] += (
                    _walltime.perf_counter() - t_tel)
                parts = tel.drain_partials()
                if parts:
                    self.conn.send(("tel", ctl.rounds, parts))
            if hb and round_end >= next_hb:
                note = getattr(eng, "heartbeat_note", None)
                self.conn.send(("hb", ctl.rounds, round_end, {
                    "events": ctl.events,
                    "units_sent": eng.units_sent,
                    "units_dropped": eng.units_dropped,
                    **({"dev": note()} if note is not None else {}),
                    "phase_wall": {
                        pk: round(pv, 4)
                        for pk, pv in ctl.spans.totals.items()
                        if pk not in SUMMARY_ONLY_PHASES}}))
                # grid-snap (not +=): skip-ahead can jump several
                # heartbeat periods; the next beat lands on the grid so
                # every shard fires on the same sim-time cadence
                next_hb = ((round_end // hb) + 1) * hb
            if ctl.rounds >= self._next_gc:
                self._next_gc = ctl.rounds + _GC_EVERY_ROUNDS
                _gc.collect()

            # the cross-shard barrier + the global reduction: identical
            # inputs on every worker -> identical decisions
            t2 = _walltime.perf_counter()
            peers = self._wait_markers(ctl.rounds)
            self._sync_wall += _walltime.perf_counter() - t2
            s0 = stats if self.k == 0 else peers[0]
            cmds = s0.get("cmds")
            if cmds:
                # due at the NEXT loop top — after `now` advances, so the
                # command's recorded t is the boundary it applies at
                self._marker_cmds.extend(cmds)
            allm = list(peers.values())
            allm.append(stats)
            for pm2 in allm:
                if pm2["mul"] < mul:
                    mul = pm2["mul"]
            if (sum(pm2["executed"] for pm2 in allm) == 0
                    and not any(pm2["imm"] for pm2 in allm)):
                nt = min(min(pm2["next"] for pm2 in allm),
                         min(pm2["xmin"] for pm2 in allm),
                         min(pm2["fnext"] for pm2 in allm))
                if nt >= T_NEVER:
                    if self.k == 0:
                        self.conn.send(("early_end", round_end))
                    now = stop
                    break
                now = max(round_end, nt)
            else:
                now = round_end
            # graceful stop AFTER advancing now: the single-process loop
            # sees the signal at the next iteration top, with `now`
            # already at the post-round boundary — the state the final
            # checkpoint must correspond to
            if any(pm2["stop"] for pm2 in allm):
                interrupted = True
                break

        interrupted = interrupted and now < stop
        if interrupted and ck_every:
            # the graceful-stop final checkpoint, like the single-process
            # loop's post-loop snapshot (the stop reduction happened at
            # round ctl.rounds on every worker, so no later edge exists)
            self._drain_rings()
            self._ingest_ready(ctl.rounds)
            self._checkpoint(now)
        self.conn.send(("done", {
            "now": now, "rounds": ctl.rounds, "events": ctl.events,
            "interrupted": interrupted,
            **({"stop_reason": "live_stop"} if self._cmd_stop else {})}))

    def _apply_boundary_cmds(self, now: int, faults):
        """Apply round-boundary commands exactly like the single-process
        Controller._live_boundary: due replay-log entries first, then
        live commands that arrived through shard 0's round marker (the
        identical list on every worker, so every shard applies them at
        the same boundary with the same seq). Only shard 0 ships the
        canonical commands.jsonl lines to the parent — the single
        writer."""
        ctl = self.ctl
        lines: list = []
        replay = ctl._replay_cmds
        while ctl._replay_idx < len(replay) \
                and replay[ctl._replay_idx]["t"] <= now:
            rec = replay[ctl._replay_idx]
            ctl._replay_idx += 1
            if rec.get("wall_only"):
                continue  # pause/resume never touched sim state
            faults = ctl._apply_cmd(rec["cmd"], now, rec["seq"], lines,
                                    faults, replayed=True)
        for norm in self._marker_cmds:
            ctl._live_seq += 1
            faults = ctl._apply_cmd(norm, now, ctl._live_seq, lines,
                                    faults, replayed=False)
        self._marker_cmds = []
        if ctl._interrupt == "live_stop":
            self._cmd_stop = True
            ctl._interrupt = None  # the parent owns the summary's signal
        if lines and self.k == 0:
            self.conn.send(("cmdlog", lines))
        return faults

    def _poll_parent(self) -> None:
        """Drain the parent pipe without blocking: a stop request, a live
        command (shard 0: it rides the next marker), or the parent's abort
        after another worker failed."""
        while self.conn.poll(0):
            pm = self.conn.recv()
            if pm[0] == "stop":
                self._stop_req = True
            elif pm[0] == "cmd":
                self._pending_cmds.append(pm[1])
            elif pm[0] == "abort":
                raise _PeerDied("parent aborted the run")

    # -- ring plumbing -----------------------------------------------------
    def _drain_rings(self) -> None:
        """Drain every inbound ring: stash row blocks (by emitting
        round) and marker blocks (by round). Ingestion happens at round
        tops via _ingest_ready — the consistent-cut rule above."""
        for ring in self.rings_in.values():
            for blob in ring.read_all():
                if blob[0:1] == b"R":
                    (rnd,) = struct.unpack_from("<q", blob, 1)
                    self._pending_rows.append((rnd, blob[9:]))
                else:
                    rnd, src, stats = marshal.loads(blob[1:])
                    self._markers.setdefault(rnd, {})[src] = stats

    def _ingest_ready(self, limit_round: int) -> None:
        """Ingest every stashed row block whose emitting round we have
        completed ourselves (<= limit_round): those are exactly the rows
        the single-process twin would hold resolved at this boundary.
        The marker barrier bounds peers to one round ahead, so the
        stash never grows past one round of traffic."""
        if not self._pending_rows:
            return
        eng = self.ctl.engine
        fast = self._packed_ingest
        keep = []
        for rnd, blob in self._pending_rows:
            if rnd > limit_round:
                keep.append((rnd, blob))
            elif fast is not None and getattr(eng, "_c", None) is not None:
                # packed C path: wire bytes -> CBatch, no row tuples
                eng.pending.append(fast(blob))
            else:
                eng.ingest_remote(unpack_rows(blob))
        self._pending_rows = keep

    def _write_block(self, j: int, data: bytes) -> None:
        """Blocking ring write: while the peer's ring is full, keep
        draining our own inbound rings (the peer may itself be blocked
        writing to us — draining is what guarantees global progress).
        Stamping while blocked keeps this shard's liveness word fresh,
        so a shard stuck behind a WEDGED peer is never misnamed as the
        failure itself."""
        import os as _os

        ring = self.rings_out[j]
        spins = 0
        while not ring.write(data):
            self._drain_rings()
            spins += 1
            if spins & 1023 == 0:
                self._prog.stamp(self.k, self.ctl.rounds)
            _os.sched_yield()

    def _write_rows(self, j: int, rows: list) -> None:
        """Ship rows to shard j tagged with the emitting round, chunked
        so every block fits the ring (chunks of a (t, key)-sorted list
        stay sorted; each becomes its own pending batch)."""
        data = pack_rows(rows)
        if 9 + len(data) > self.rings_out[j].cap // 2 and len(rows) > 1:
            mid = len(rows) // 2
            self._write_rows(j, rows[:mid])
            self._write_rows(j, rows[mid:])
            return
        if 9 + len(data) + 8 > self.rings_out[j].cap:
            # a SINGLE row bigger than the ring can never ship: fail by
            # name instead of spinning in _write_block forever (the peer
            # would only see a 3600 s barrier timeout)
            raise _PeerDied(
                f"shard {self.k}: one cross-shard row packs to "
                f"{len(data)} bytes, larger than the "
                f"{self.rings_out[j].cap}-byte ring — raise "
                f"SHADOW_TPU_RING_BYTES")
        self._write_block(
            j, b"R" + struct.pack("<q", self.ctl.rounds) + data)

    def _write_packed(self, j: int, data: bytes) -> None:
        """Ship one C-packed wire block (sorted + chunked at the packer)
        tagged with the emitting round."""
        if 9 + len(data) + 8 > self.rings_out[j].cap:
            # the packer chunks at half the ring, so only a SINGLE row
            # bigger than the ring lands here: fail by name (the
            # _write_rows discipline)
            raise _PeerDied(
                f"shard {self.k}: one packed cross-shard block is "
                f"{len(data)} bytes, larger than the "
                f"{self.rings_out[j].cap}-byte ring — raise "
                f"SHADOW_TPU_RING_BYTES")
        self._write_block(
            j, b"R" + struct.pack("<q", self.ctl.rounds) + data)

    def _wait_markers(self, rnd: int) -> dict:
        """Spin (drain + sched_yield) until every peer's marker for
        ``rnd`` arrived. Checks the parent pipe for aborts on a coarse
        cadence. The wait is DEADLINED (supervise.stall_deadline_s over
        the observed round-wall EMA): on expiry the missing peers'
        progress stamps decide — a peer whose stamp is stale past the
        deadline is dead or wedged and gets NAMED (shard id, last round,
        stamp age); peers still stamping are merely slow and the wait
        extends, up to the absolute ceiling."""
        import os as _os

        want = self.n - 1
        deadline_s = stall_deadline_s(self._round_ema)
        t_wait0 = _walltime.monotonic()
        deadline = t_wait0 + deadline_s
        spins = 0
        while True:
            got = self._markers.get(rnd)
            if got is not None and len(got) == want:
                return self._markers.pop(rnd)
            self._drain_rings()
            spins += 1
            if spins & 1023 == 0:
                self._prog.stamp(self.k, rnd)  # waiting IS liveness
                self._poll_parent()
                now_w = _walltime.monotonic()
                if now_w > deadline:
                    stale = self._stale_peers(rnd, deadline_s)
                    if stale:
                        raise _PeerDied(
                            f"shard {self.k}: no round-{rnd} marker "
                            f"after {now_w - t_wait0:.1f}s (deadline "
                            f"{deadline_s:.1f}s) — " + "; ".join(stale))
                    if now_w - t_wait0 > STALL_CEILING_S:
                        raise _PeerDied(
                            f"shard {self.k}: no round-{rnd} marker "
                            f"within {STALL_CEILING_S:.0f}s despite live "
                            f"peer stamps — marker livelock")
                    # every missing peer stamped recently: slow, not
                    # dead — extend one deadline and keep waiting
                    deadline = now_w + deadline_s
            _os.sched_yield()

    def _stale_peers(self, rnd: int, deadline_s: float) -> list:
        """Name the peers whose round-``rnd`` marker is missing AND whose
        progress stamp is stale past the deadline."""
        got = self._markers.get(rnd) or {}
        out = []
        for j in self.rings_in:
            if j in got:
                continue
            age = self._prog.age_s(j)
            if age > deadline_s:
                r_j, _ns = self._prog.read(j)
                out.append(
                    f"shard {j} last stamped round {r_j} "
                    f"{'never' if age == float('inf') else f'{age:.1f}s ago'}"
                    f" (dead or wedged)")
        return out

    def _checkpoint(self, now: int) -> None:
        from shadow_tpu_torch import checkpoint as _ckpt

        ctl = self.ctl
        # ring-resident cross-shard arrivals are part of this shard's
        # state at the boundary: _drain_rings ran just before, so the
        # pending store is complete (the single-process twin has them in
        # its store already)
        if ctl.telemetry is not None:
            ctl.telemetry.sync(ctl)
        t0 = _walltime.perf_counter()
        self._prog.stamp(self.k, ctl.rounds)  # a long save is not a stall
        path = _ckpt.save_checkpoint(ctl, now)
        self._prog.stamp(self.k, ctl.rounds)
        pw = ctl.spans.totals
        pw["checkpoint"] = pw.get("checkpoint", 0.0) + (
            _walltime.perf_counter() - t0)
        self.conn.send(("ckpt_done", ctl.rounds, now, str(path)))

    def _finalize(self, end_time: int) -> dict:
        ctl = self.ctl
        eng = ctl.engine
        eng.flush_all()
        telp = []
        tel_state = None
        if ctl.telemetry is not None:
            ctl.telemetry.finalize(ctl)
            telp = ctl.telemetry.drain_partials()
            tel_state = ctl.telemetry.export_merge_state()
        errors = []
        for p in ctl.processes:
            err = p.check_final_state()
            if err is not None:
                errors.append((p.host.id, err))
                ctl.log.error(err)
        for p in ctl.processes:
            reap = getattr(p, "reap", None)
            if reap is not None:
                reap()
        for h in ctl.hosts:
            if not ctl.owns(h.id):
                continue
            h.fold_counters()
            ctl.counters.merge(h.counters)
        close = getattr(eng, "close", None)
        if close is not None:
            close()
        ctl.data_dir.mkdir(parents=True, exist_ok=True)
        for h in ctl.hosts:
            if ctl.owns(h.id):
                h.flush_logs(ctl.data_dir)
        ctl.log.info(ctl.counters.summary())
        ctl.log.flush()
        import resource

        pw = ctl.spans.totals
        phase = {
            **{k: round(v, 4) for k, v in pw.items()
               if k not in SUMMARY_ONLY_PHASES},
            "exchange": round(self._exchange_wall, 4),
            "sync": round(self._sync_wall, 4),
            **({"telemetry": round(pw["telemetry"], 4)}
               if ctl.telemetry is not None else {}),
            **({"checkpoint": round(pw["checkpoint"], 4)}
               if pw.get("checkpoint") else {}),
        }
        return {
            "events": ctl.events,
            "rounds": ctl.rounds,
            "units_sent": eng.units_sent,
            "units_dropped": eng.units_dropped,
            "units_blackholed": eng.units_blackholed,
            "bytes_sent": eng.bytes_sent,
            "counters": dict(ctl.counters.c),
            "process_errors": errors,
            "phase_wall": phase,
            "max_rss_mb": round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                1),
            "fault_transitions_applied": (ctl.faults.applied
                                          if ctl.faults is not None
                                          else None),
            "tel": telp,
            "tel_state": tel_state,
            "native_colcore": ctl._c_core is not None,
            "launches": _kernel_launches(),
        }


def _kernel_launches() -> dict:
    """This process's kernel launches by kernel, from the launch counters
    of the kernel modules it imported (a module never imported launched
    nothing): a worker's must all be 0."""
    import sys

    out = {}
    for mod in ("shadow_tpu_torch.ops.propagate",
                "shadow_tpu_torch.ops.transport_kernels",
                "shadow_tpu_torch.parallel.mesh",
                "shadow_tpu_torch.ops.apsp"):
        m = sys.modules.get(mod)
        out.update(getattr(m, "LAUNCHES", {}))
    return out


def _worker_main(conn, cfg, shard_id: int, n_shards: int, ring_tag: str,
                 ring_bytes: int, resume_path, device: str = "cuda") -> None:
    """Worker process entry (multiprocessing spawn target)."""
    try:
        # the device draw plane stays off in workers: draw routing is
        # pure wall-clock policy (bit-identical either way), and N
        # workers each attaching the one card would serialize on it
        # anyway. The numpy/C twins carry the draws; the device transport
        # (the same kind of policy) stays off for the same reason, so a
        # worker launches no kernel and never initialises CUDA.
        cfg.experimental.tpu_device_floor = -1
        cfg.experimental.device_transport = False
        if resume_path is not None:
            from shadow_tpu_torch import checkpoint as _ckpt

            ctl, resume_at = _ckpt.load_checkpoint(
                resume_path, cfg, mirror_log=False, device=device)
            if not isinstance(ctl, ShardController):
                raise _ckpt.CheckpointError(
                    f"{resume_path}: not a shard checkpoint")
            if ctl.telemetry is not None:
                ctl.telemetry.shard = (shard_id, n_shards)
        else:
            ctl = ShardController(cfg, shard_id, n_shards, device=device)
            resume_at = None
        worker = _ShardWorker(ctl, conn, shard_id, n_shards, ring_tag,
                              ring_bytes)
        worker.serve(resume_at)
    except BaseException as exc:
        import traceback

        try:
            conn.send(("error", str(exc), traceback.format_exc()))
        except Exception:
            pass
        raise


# -- the parent coordinator ---------------------------------------------------

class _ShardError(RuntimeError):
    pass


class ShardedRun:
    """Parent process: spawns N workers, drives the global round loop
    (the exact decision twin of Controller._round_loop), merges output
    streams, and assembles the run summary."""

    #: process-wide spawn counter: uniquifies ring/page tags across the
    #: restart attempts a supervisor makes inside one wall second
    _spawn_seq = 0

    def __init__(self, cfg, mirror_log: bool = True,
                 resume_from=None, device: str = "cuda") -> None:
        from shadow_tpu_torch.ops import devcfg

        validate_config_shardable(cfg)
        devcfg.require_device(device)  # the workers' device; no CUDA here
        self.device = device
        self.cfg = cfg
        self.n = int(cfg.general.sim_shards)
        self.data_dir = Path(cfg.general.data_directory)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.log = SimLogger(cfg.general.log_level,
                             self.data_dir / "shadow.log",
                             mirror_stderr=mirror_log)
        from shadow_tpu_torch.network.graph import load_graph

        self.graph = load_graph(cfg.network["graph"])
        w = self.graph.min_latency_ns
        if cfg.experimental.runahead is not None:
            w = cfg.experimental.runahead
        self.round_ns = max(int(w), NS_PER_US)
        self.rounds = 0
        self.events = 0
        self._interrupt = None
        self._partial = False
        self.resume_at = None
        self._resume_paths = None
        if resume_from is not None:
            self._prepare_resume(resume_from)
        self.ckpt_dir = (Path(cfg.general.checkpoint_dir)
                         if cfg.general.checkpoint_dir
                         else self.data_dir / "checkpoints")
        self._metrics_fh = None
        # live operations plane (live.py): the PARENT owns the socket —
        # workers never bind. Commands are forwarded to shard 0 and ride
        # its round marker so every worker applies them at the same
        # boundary; shard 0 ships the canonical commands.jsonl lines back
        # and the parent is the single writer.
        self.live = None
        if cfg.general.live_endpoint:
            from shadow_tpu_torch import live as _live

            self.live = _live.LiveServer(
                _live.resolve_endpoint(cfg.general.live_endpoint,
                                       self.data_dir),
                log=self.log, refuse=self._refuse_cmd)

    @staticmethod
    def _refuse_cmd(norm):
        if norm["cmd"] in ("pause", "resume"):
            # free-running workers synchronize peer to peer; the parent
            # cannot wall-block them at a shared boundary without a
            # round-gating channel the design deliberately lacks
            return (f"{norm['cmd']!r} is single-process only: sharded "
                    f"workers free-run and cannot wall-block at a "
                    f"shared round boundary")
        return None

    # -- resume ------------------------------------------------------------
    def _prepare_resume(self, resume_from) -> None:
        from shadow_tpu_torch import checkpoint as _ckpt

        p = Path(resume_from)
        if p.name.endswith(MANIFEST_SUFFIX):
            try:
                doc = json.loads(p.read_text())
            except (OSError, ValueError) as exc:
                raise _ckpt.CheckpointError(
                    f"{p}: unreadable shard manifest ({exc})") from exc
            if doc.get("format") != MANIFEST_FORMAT:
                raise _ckpt.CheckpointError(
                    f"{p}: not a shard-checkpoint manifest")
            files = [p.parent / f for f in doc["files"]]
            n = int(doc["sim_shards"])
        else:
            header = _ckpt.read_header(p)
            n = int(header.get("sim_shards", 1))
            shard = header.get("shard")
            if n == 1 or shard is None:
                raise _ckpt.CheckpointError(
                    f"{p}: single-process checkpoint (sim_shards=1) but "
                    f"this invocation has sim_shards={self.n} — the host "
                    f"partition is part of the snapshot's identity; "
                    f"resume with sim_shards=1 or re-run from scratch")
            stem = p.name.replace(f".shard{shard}.ckpt", "")
            files = [p.parent / f"{stem}.shard{k}.ckpt" for k in range(n)]
        if n != self.n:
            raise _ckpt.CheckpointError(
                f"{resume_from}: checkpoint written with sim_shards={n} "
                f"but this invocation has sim_shards={self.n} — resume "
                f"with general.sim_shards={n} (results are byte-identical "
                f"at any shard count, so a from-scratch run at the new "
                f"count reproduces the same simulation)")
        for f in files:
            if not f.is_file():
                raise _ckpt.CheckpointError(
                    f"shard checkpoint set incomplete: {f} missing")
        header = _ckpt.read_header(files[0])
        self.resume_at = int(header["sim_time_ns"])
        self.rounds = int(header["rounds"])
        self._resume_paths = [str(f) for f in files]

    # -- worker management -------------------------------------------------
    def _spawn(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        ring_bytes = int(os.environ.get("SHADOW_TPU_RING_BYTES",
                                        DEFAULT_RING_BYTES))
        check_shm_room(self.n, ring_bytes)
        # the spawn sequence keeps tags unique across supervised restart
        # attempts inside one parent second (ring + page names collide
        # otherwise if a prior attempt's unlink was lost)
        seq = ShardedRun._spawn_seq
        ShardedRun._spawn_seq += 1
        self._ring_tag = (f"{os.getpid():x}"
                          f"{int(_walltime.time()) & 0xFFFF:x}{seq:x}")
        # liveness board (supervise.py): created before the
        # workers so their attach in _ShardWorker.__init__ always finds it
        self._prog = ProgressPage(progress_name(self._ring_tag), self.n,
                                  create=True)
        self._rings = []
        for i in range(self.n):
            for j in range(self.n):
                if i != j:
                    self._rings.append(ShmRing(
                        _ring_name(self._ring_tag, i, j), ring_bytes,
                        create=True))
        self._conns = []
        self._procs = []
        for k in range(self.n):
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(child_conn, self.cfg, k, self.n, self._ring_tag,
                      ring_bytes,
                      (self._resume_paths[k] if self._resume_paths
                       else None), self.device),
                name=f"shadow-shard-{k}", daemon=True)
            p.start()
            child_conn.close()
            self._conns.append(parent_conn)
            self._procs.append(p)

    def _recv(self, k: int):
        """Receive one protocol message from worker k, surfacing worker
        errors (and worker death) as named failures."""
        conn = self._conns[k]
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                raise _ShardError(
                    f"shard worker {k} died (exit code "
                    f"{self._procs[k].exitcode})")
            if msg[0] == "error":
                raise _ShardError(
                    f"shard worker {k} failed: {msg[1]}\n{msg[2]}")
            return msg

    def _broadcast(self, msg) -> None:
        for conn in self._conns:
            conn.send(msg)

    def _teardown(self) -> None:
        if getattr(self, "live", None) is not None:
            self.live.close()  # idempotent; covers the error paths
        for p in getattr(self, "_procs", []):
            if p.is_alive():
                p.terminate()
        for p in getattr(self, "_procs", []):
            p.join(timeout=5)
        for r in getattr(self, "_rings", []):
            r.close()
            r.unlink()
        if getattr(self, "_prog", None) is not None:
            self._prog.close()
            self._prog.unlink()
            self._prog = None

    # -- stream assembly ---------------------------------------------------
    def _metrics_append(self, lines: list) -> None:
        from shadow_tpu_torch.telemetry.collector import METRICS_FILE

        if self._metrics_fh is None:
            d = (Path(self.cfg.telemetry.metrics_dir)
                 if self.cfg.telemetry.metrics_dir else self.data_dir)
            d.mkdir(parents=True, exist_ok=True)
            self._metrics_fh = open(d / METRICS_FILE, "a")
        self._metrics_fh.write("\n".join(lines) + "\n")
        if self.live is not None:
            # tee the merged stream to live followers (the wall-clock
            # plane: record ordering equals file ordering)
            self.live.publish_stream(METRICS_FILE, lines)

    def _handle_tel_partials(self, parts_by_shard: list,
                             rounds: int) -> None:
        """Write one round's metrics records in single-process order:
        shard 0's meta/fault lines first, then the assembled sample."""
        from shadow_tpu_torch.telemetry.collector import format_sample_line

        lines = []
        samples = []  # (shard, partial)
        for k, parts in enumerate(parts_by_shard):
            for p in parts or ():
                if p["kind"] in ("meta", "fault"):
                    lines.append(p["line"])
                else:
                    samples.append((k, p))
        if samples:
            H = self._n_hosts
            # column names come from the shipped partial itself (the
            # host_columns contract), so a new sampler column cannot be
            # silently dropped at the merge
            names = sorted(samples[0][1]["cols"])
            cols = {nm: [0] * H for nm in names}
            bucket = [0] * H
            tokens = [0] * H
            g = {"units_sent": 0, "units_dropped": 0,
                 "units_blackholed": 0, "bytes_sent": 0, "events": 0}
            t = samples[0][1]["t"]
            for _k, p in samples:
                ids = p["ids"]
                for nm in names:
                    col = cols[nm]
                    vals = p["cols"][nm]
                    for i, hid in enumerate(ids):
                        col[hid] = vals[i]
                pg = p["g"]
                for i, hid in enumerate(ids):
                    bucket[hid] = pg["bucket_up"][i]
                    tokens[hid] = pg["tokens_down"][i]
                for key in g:
                    g[key] += pg[key]
            g["bucket_up"] = bucket
            g["tokens_down"] = tokens
            lines.append(format_sample_line(g, cols, rounds, t))
        if lines:
            self._metrics_append(lines)

    def _merge_flows(self) -> None:
        """K-way merge of the per-shard flow streams into the canonical
        flows.jsonl, ordered by (round, host id) — the single-process
        flush order (records of one host stay in their shard-local
        order, which is event-execution order)."""
        from shadow_tpu_torch.telemetry.collector import FLOWS_FILE

        d = (Path(self.cfg.telemetry.metrics_dir)
             if self.cfg.telemetry.metrics_dir else self.data_dir)
        recs = []
        for k in range(self.n):
            f = d / f"flows.shard{k}.jsonl"
            if not f.is_file():
                continue
            with open(f) as fh:
                for i, line in enumerate(fh):
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    rec = json.loads(line)
                    recs.append((rec["round"], rec["hid"], i, line))
        recs.sort(key=lambda r: (r[0], r[1], r[2]))
        with open(d / FLOWS_FILE, "w") as out:
            for _r, _h, _i, line in recs:
                out.write(line + "\n")

    def _emit_digest(self, parts: list, round_end, rounds: int) -> None:
        from shadow_tpu_torch import checkpoint as _ckpt

        g, hosts = _ckpt.merge_shard_digests(parts, round_end,
                                             rounds, self._n_hosts)
        rec = {"round": rounds, "t": round_end, "digest": g,
               "hosts": hosts}
        with open(self.data_dir / _ckpt.DIGEST_FILE, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        # shard-tagged sidecar streams (tools/bisect_divergence.py
        # --shard K): one sentinel stream per shard over its OWNED hosts
        # plus a digest of its slice of the global observables — when a
        # cross-shard run ever diverges, the bisection names the first
        # divergent round AND shard, not just the merged record
        for k, p in enumerate(parts):
            pg = _ckpt._digest({
                "counters": [p["events"], p["units_sent"],
                             p["units_dropped"], p["units_blackholed"],
                             p["bytes_sent"], p["ev_key"],
                             p["last_refill"]],
                "tokens_down": p["tokens_down"],
                "bucket_avail": p["bucket_avail"],
                "faults": p["faults"],
                "hosts": p["hosts"],
            })
            srec = {"round": rounds, "t": round_end, "shard": k,
                    "digest": pg, "hosts": p["hosts"]}
            with open(self.data_dir
                      / f"state_digests.shard{k}.jsonl", "a") as f:
                f.write(json.dumps(srec, sort_keys=True) + "\n")

    # -- signals -----------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        import signal as _signal

        if self._interrupt is not None:
            raise KeyboardInterrupt
        self._interrupt = _signal.Signals(signum).name

    # -- the run -----------------------------------------------------------
    def run(self) -> dict:
        self._spawn()
        try:
            return self._run_inner()
        except _ShardError:
            # one worker failed: tell the others to stop spinning at
            # their marker barrier (best effort — teardown terminates
            # whatever does not listen)
            for conn in self._conns:
                try:
                    conn.send(("abort",))
                except (OSError, ValueError):
                    pass
            raise
        finally:
            if self._metrics_fh is not None:
                self._metrics_fh.close()
            self._teardown()

    def _run_inner(self) -> dict:
        import signal as _signal
        import threading as _threading
        from shadow_tpu_torch import checkpoint as _ckpt

        cfg = self.cfg
        stop = cfg.general.stop_time
        w = self.round_ns
        now = self.resume_at if self.resume_at is not None else 0
        dig = cfg.general.state_digest_every
        if dig and self.resume_at is None:
            (self.data_dir / _ckpt.DIGEST_FILE).unlink(missing_ok=True)
            for p in sorted(self.data_dir.glob("state_digests.shard*.jsonl")):
                p.unlink()
        if (self.live is not None or cfg.general.replay_commands) \
                and self.resume_at is None:
            # fresh run: commands.jsonl is an output artifact (replay
            # reads from wherever general.replay_commands points)
            from shadow_tpu_torch import live as _live

            _live.command_log_path(self.data_dir).unlink(missing_ok=True)
        tel = cfg.telemetry
        if tel is not None and self.resume_at is None:
            # fresh run: truncate stale streams BEFORE the ready
            # partials land (shard 0 ships the meta record in its ready)
            from shadow_tpu_torch.telemetry.collector import (FLOWS_FILE,
                                                              METRICS_FILE)

            d = (Path(tel.metrics_dir) if tel.metrics_dir
                 else self.data_dir)
            if d.is_dir():
                (d / METRICS_FILE).unlink(missing_ok=True)
                (d / FLOWS_FILE).unlink(missing_ok=True)
        readies = [self._recv(k)[1] for k in range(self.n)]
        # the run clock starts when every worker is built and ready: the
        # parallel worker builds are warm-up (the single-process summary
        # likewise excludes Controller construction from wall_seconds)
        t0 = _walltime.perf_counter()
        #: supervision MTTR anchor (supervise.run_supervised): the wall
        #: instant this attempt reached ready, monotonic clock
        self.t_first_ready = _walltime.monotonic()
        self._n_hosts = readies[0]["n_hosts"]
        self.events = sum(r["events"] for r in readies)
        mul = min(r["mul"] for r in readies)
        startup_tel = [r["tel_partials"] for r in readies]
        if any(startup_tel):
            self._handle_tel_partials(startup_tel, self.rounds)
        self.log.info(
            f"simulation {'resuming' if self.resume_at is not None else 'starting'}: "
            f"{self._n_hosts} hosts over {self.n} shard processes "
            f"(id-modulo placement), round width {format_time(w)}, "
            f"policy {cfg.experimental.scheduler_policy}, "
            f"stop {format_time(stop)}")
        self._partial = False
        self._interrupt = None
        installed = {}
        if _threading.current_thread() is _threading.main_thread():
            for s in (_signal.SIGINT, _signal.SIGTERM):
                try:
                    installed[s] = _signal.signal(s, self._on_signal)
                except (ValueError, OSError):
                    pass
        # release the free-running workers: they synchronize peer-to-peer
        # through the rings (edge markers carry the reduction inputs) and
        # compute the global round decisions themselves; this loop only
        # consumes their asynchronous streams
        self._broadcast(("run", {"now": now, "mul0": mul}))
        from multiprocessing.connection import wait as _mpwait

        done = [None] * self.n
        digbuf: dict = {}   # round -> (t, {shard: partial})
        ckptbuf: dict = {}  # round -> (now, {shard: path})
        hbbuf: dict = {}    # round -> (t, {shard: stats})
        telbuf: dict = {}   # round -> {shard: parts}
        self._last_seen = [self.rounds] * self.n
        stop_sent = [False] * self.n
        # full-ring-stall backstop: peers name a SINGLE dead/wedged shard
        # themselves (the _wait_markers deadline); only a stall of EVERY
        # worker at once leaves no survivor to raise — the parent detects
        # that from a frozen progress-page snapshot. The floor is larger
        # than the worker-side one: simultaneous long checkpoints are the
        # legitimate all-quiet case.
        prog_snap = self._prog.snapshot()
        prog_wall = _walltime.monotonic()
        prog_ema = 0.0
        parent_floor = float(os.environ.get(
            "SHADOW_TPU_PARENT_STALL_FLOOR_S", "120"))
        try:
            while any(d is None for d in done):
                snap = self._prog.snapshot()
                now_w = _walltime.monotonic()
                if snap != prog_snap:
                    dt = now_w - prog_wall
                    prog_ema = (dt if prog_ema == 0.0
                                else 0.85 * prog_ema + 0.15 * dt)
                    prog_snap, prog_wall = snap, now_w
                elif (now_w - prog_wall
                      > max(stall_deadline_s(prog_ema), parent_floor)):
                    raise _ShardError(
                        f"full-ring stall: no shard has stamped progress "
                        f"for {now_w - prog_wall:.1f}s (rounds "
                        f"{[r for r, _s in snap]}) — every worker is "
                        f"wedged or the box is livelocked")
                if self._interrupt is not None:
                    for k in range(self.n):
                        if done[k] is None and not stop_sent[k]:
                            self._conns[k].send(("stop",))
                            stop_sent[k] = True
                if self.live is not None and done[0] is None \
                        and not stop_sent[0]:
                    for norm in self.live.poll_commands():
                        self._conns[0].send(("cmd", norm))
                ready = _mpwait(self._conns, timeout=0.25)
                for conn in ready:
                    k = self._conns.index(conn)
                    if done[k] is not None:
                        continue
                    msg = self._recv(k)
                    op = msg[0]
                    if op == "dig":
                        _r, t, part = msg[1], msg[2], msg[3]
                        slot = digbuf.setdefault(_r, (t, {}))
                        slot[1][k] = part
                        self._note_round(k, _r)
                        if len(slot[1]) == self.n:
                            digbuf.pop(_r)
                            self._emit_digest(
                                [slot[1][i] for i in range(self.n)],
                                t, _r)
                    elif op == "tel":
                        _r, parts = msg[1], msg[2]
                        telbuf.setdefault(_r, {})[k] = parts
                        self._note_round(k, _r)
                    elif op == "hb":
                        _r, t, stats = msg[1], msg[2], msg[3]
                        slot = hbbuf.setdefault(_r, (t, {}))
                        slot[1][k] = stats
                        self._note_round(k, _r)
                        if len(slot[1]) == self.n:
                            hbbuf.pop(_r)
                            self._heartbeat(_r, t, slot[1], t0)
                    elif op == "ckpt_done":
                        _r, t, path = msg[1], msg[2], msg[3]
                        slot = ckptbuf.setdefault(_r, (t, {}))
                        slot[1][k] = path
                        self._note_round(k, _r)
                        if len(slot[1]) == self.n:
                            ckptbuf.pop(_r)
                            self._write_manifest(
                                [slot[1][i] for i in range(self.n)],
                                t, _r)
                    elif op == "cmdlog":
                        # shard 0 applied round-boundary commands: the
                        # parent is the single commands.jsonl writer and
                        # the live broadcaster
                        from shadow_tpu_torch import live as _live

                        _live.append_command_lines(self.data_dir, msg[1])
                        if self.live is not None:
                            for ln in msg[1]:
                                self.live.publish(
                                    {"type": "command", **json.loads(ln)})
                    elif op == "early_end":
                        self.log.info(
                            f"no further events at "
                            f"{format_time(msg[1])}; ending early")
                    elif op == "done":
                        done[k] = msg[1]
                        self._last_seen[k] = 1 << 62
                    else:
                        raise _ShardError(
                            f"unexpected worker message {op!r}")
                self._flush_tel(telbuf)
        finally:
            for s, old in installed.items():
                _signal.signal(s, old)
        self._flush_tel(telbuf, force=True)
        # every worker computed the same global decisions: verify
        for d in done[1:]:
            if (d["now"], d["rounds"]) != (done[0]["now"],
                                           done[0]["rounds"]):
                raise _ShardError(
                    f"shard decision divergence: {done[0]} vs {d}")
        now = done[0]["now"]
        self.rounds = done[0]["rounds"]
        self.events = sum(d["events"] for d in done)
        self._partial = done[0]["interrupted"]
        if self._partial and self._interrupt is None:
            # a live `stop` command ended the run inside the workers;
            # surface it as the summary's interrupt_signal
            self._interrupt = done[0].get("stop_reason")
        if self._partial:
            self.log.warning(
                f"{self._interrupt or 'stop'} received: stopped "
                f"gracefully at round boundary {format_time(now)} "
                f"({self.rounds} rounds); summary is partial")
        end_time = min(now, stop)
        self._broadcast(("finalize", end_time))
        finals = [self._recv(k)[1] for k in range(self.n)]
        wall = _walltime.perf_counter() - t0
        result = self._summary(finals, end_time, wall)
        if self.live is not None:
            self.live.publish({"type": "end",
                               "exit_reason": result["exit_reason"],
                               "rounds": self.rounds, "t": end_time})
            self.live.close()
        return result

    def _note_round(self, k: int, rnd: int) -> None:
        if rnd > self._last_seen[k]:
            self._last_seen[k] = rnd

    def _flush_tel(self, telbuf: dict, force: bool = False) -> None:
        """Write buffered telemetry rounds in order. A round is ready
        when its sample is complete (all N partials — samples fire on
        the same round grid everywhere) or when every worker's stream
        has demonstrably passed it (fault-line-only rounds); later
        rounds never flush past a pending earlier one."""
        if not telbuf:
            return
        floor = min(self._last_seen)
        for rnd in sorted(telbuf):
            parts = telbuf[rnd]
            n_samples = sum(1 for ps in parts.values()
                            for p in ps if p["kind"] == "sample")
            if not (force or rnd <= floor or n_samples == self.n):
                break
            telbuf.pop(rnd)
            self._handle_tel_partials(
                [parts.get(i) for i in range(self.n)], rnd)

    def _heartbeat(self, rnd: int, t, stats: dict, t0: float) -> None:
        wall = _walltime.perf_counter() - t0
        rate = (t / NS_PER_SEC) / wall if wall else 0.0
        ev = sum(s["events"] for s in stats.values())
        sent = sum(s["units_sent"] for s in stats.values())
        drop = sum(s["units_dropped"] for s in stats.values())
        if self.live is not None:
            # merged heartbeat (the single-process record's shape) plus one
            # shard_status per worker with its wall-phase and device-note
            # detail — followers see per-shard skew live
            self.live.publish({
                "type": "hb", "t": t, "round": rnd,
                "events": ev, "units_sent": sent, "units_dropped": drop,
                "shards": self.n,
                "wall": {"seconds": round(wall, 3),
                         "rate": round(rate, 3)},
            })
            for k in sorted(stats):
                s = stats[k]
                self.live.publish({
                    "type": "shard_status", "shard": k, "t": t,
                    "round": rnd, "events": s["events"],
                    "units_sent": s["units_sent"],
                    "units_dropped": s["units_dropped"],
                    **({"dev": s["dev"]} if "dev" in s else {}),
                    **({"phase_wall": s["phase_wall"]}
                       if "phase_wall" in s else {}),
                })
        self.log.info(
            f"heartbeat: sim {format_time(t)} wall {wall:.1f}s "
            f"({rate:.2f} sim-sec/wall-sec) rounds {rnd} events {ev} "
            f"units sent {sent} dropped {drop} shards {self.n}")
        if self.cfg.general.progress:
            self._progress(t, self.cfg.general.stop_time, t0)

    def _write_manifest(self, paths: list, now, rnd: int) -> None:
        paths = [Path(p) for p in paths]
        manifest = paths[0].parent / (
            paths[0].name.replace(".shard0.ckpt", "") + MANIFEST_SUFFIX)
        manifest.write_text(json.dumps({
            "format": MANIFEST_FORMAT,
            "sim_shards": self.n,
            "sim_time_ns": now,
            "rounds": rnd,
            "files": [p.name for p in paths],
        }, sort_keys=True, indent=1))
        self.log.info(
            f"checkpoint written: {manifest} ({self.n} shard files, "
            f"sim {format_time(now)}, round {rnd})")

    def _progress(self, sim_now, stop, t0) -> None:
        import sys as _sys

        wall = _walltime.perf_counter() - t0
        pct = 100 * sim_now // stop
        rate = (sim_now / NS_PER_SEC) / wall if wall > 0 else 0.0
        eta = (stop - sim_now) / NS_PER_SEC / rate if rate > 0 else 0.0
        print(f"\r[{pct:3d}%] sim {format_time(sim_now)} / "
              f"{format_time(stop)}  {rate:.2f} sim-s/s  eta {eta:.0f}s   ",
              end="", file=_sys.stderr, flush=True)

    # -- summary -----------------------------------------------------------
    def _summary(self, finals: list, end_time, wall: float) -> dict:
        import resource

        counters = Counters()
        for f in finals:
            c = Counters()
            c.c.update(f["counters"])
            counters.merge(c)
        errors = []
        for f in finals:
            errors.extend(f["process_errors"])
        errors.sort(key=lambda e: e[0])
        error_strs = [e[1] for e in errors]
        sim_sec = end_time / NS_PER_SEC
        rate = sim_sec / wall if wall > 0 else float("inf")
        units_sent = sum(f["units_sent"] for f in finals)
        units_dropped = sum(f["units_dropped"] for f in finals)
        self.log.info(
            f"simulation finished: sim {format_time(end_time)} in "
            f"{wall:.2f}s wall ({rate:.2f} sim-sec/wall-sec), "
            f"{self.rounds} rounds, {self.events} events, "
            f"{units_sent} units delivered, {units_dropped} dropped, "
            f"{self.n} shard processes")
        self.log.info(counters.summary())
        self.log.flush()
        phase: dict = {}
        for f in finals:
            for k2, v in f["phase_wall"].items():
                phase[k2] = round(phase.get(k2, 0.0) + v, 4)
        tel_summary = None
        if finals[0]["tel_state"] is not None:
            tel_summary = _merge_tel_summaries(
                [f["tel_state"] for f in finals])
            self._merge_flows()
        out = {
            "sim_seconds": sim_sec,
            "wall_seconds": wall,
            "sim_sec_per_wall_sec": rate,
            "exit_reason": "interrupted" if self._partial else "completed",
            "partial": self._partial,
            **({"interrupt_signal": self._interrupt}
               if self._partial else {}),
            "max_rss_mb": round(max(
                [f["max_rss_mb"] for f in finals]
                + [resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 1024]), 1),
            "rounds": self.rounds,
            "events": self.events,
            "units_sent": units_sent,
            "units_dropped": units_dropped,
            "units_blackholed": sum(f["units_blackholed"] for f in finals),
            "bytes_sent": sum(f["bytes_sent"] for f in finals),
            "counters": counters.as_dict(),
            "process_errors": error_strs,
            "phase_wall": phase,
            # the workers launch no kernel (tpu_device_floor -1)
            "device_windows_dispatched": 0,
            "native_colcore": finals[0]["native_colcore"],
            **({"fault_transitions_applied":
                finals[0]["fault_transitions_applied"]}
               if finals[0]["fault_transitions_applied"] is not None
               else {}),
            **({"telemetry": tel_summary} if tel_summary is not None
               else {}),
            # volatile scale-out detail (VOLATILE_SUMMARY_KEYS): per-shard
            # walls for the bench straggler advisory
            "sim_shards": self.n,
            "shards": {
                "n": self.n,
                "per_shard": [
                    {"events": f["events"],
                     "max_rss_mb": f["max_rss_mb"],
                     "phase_wall": f["phase_wall"],
                     "launches": f["launches"]}
                    for f in finals],
            },
        }
        return out


def _merge_tel_summaries(states: list) -> dict:
    """Fold per-shard telemetry reduction states into the exact summary
    the single-process collector would produce (log-bucket histograms are
    mergeable by construction; counts are disjoint sums)."""
    from shadow_tpu_torch.telemetry.histogram import LogHistogram

    hist: dict = {}
    counts: dict = {}
    for st in states:
        for kind, hs in st["hist"].items():
            h = LogHistogram.from_state(hs)
            if kind in hist:
                hist[kind].merge(h)
            else:
                hist[kind] = h
        for kind, c in st["flow_counts"].items():
            tgt = counts.setdefault(kind, {"ok": 0, "failed": 0})
            tgt["ok"] += c["ok"]
            tgt["failed"] += c["failed"]
            if c.get("x_n"):
                tgt["x_sum"] = tgt.get("x_sum", 0) + c["x_sum"]
                tgt["x_n"] = tgt.get("x_n", 0) + c["x_n"]
    flows = {}
    for kind in sorted(counts):
        c = counts[kind]
        row = {"count": c["ok"] + c["failed"], "ok": c["ok"],
               "failed": c["failed"]}
        if c.get("x_n"):
            row["x_mean"] = c["x_sum"] // c["x_n"]
        h = hist.get(kind)
        if h is not None and h.total:
            row.update(h.quantiles_ns_to_ms())
        flows[kind] = row
    return {"samples": states[0]["samples"],
            "flows_recorded": sum(st["flows_written"] for st in states),
            "flows": flows}


def run_sharded(cfg, mirror_log: bool = True, resume_from=None,
                device: str = "cuda") -> dict:
    """Entry point (cli.py): run ``cfg`` partitioned across
    ``cfg.general.sim_shards`` worker processes, each building its
    controller on ``device``. Returns the merged run summary — the same
    shape Controller.run() produces."""
    return ShardedRun(cfg, mirror_log=mirror_log, resume_from=resume_from,
                      device=device).run()
