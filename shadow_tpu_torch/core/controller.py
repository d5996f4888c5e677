"""The Controller: owns and drives one simulation.

The port of shadow_tpu/core/controller.py. Reference analog:
``Controller::run()`` -> ``Manager::run()`` -> round loop (SURVEY.md §3.1).
Responsibilities: load the topology, compute the conservative lookahead
(round width = min edge latency, overridable with
``experimental.runahead``), build hosts and their processes, drive the
round loop, and produce the output tree + end-of-run summary.

Round-loop structure (the conservative PDES core):

    while now < stop:
        engine.start_of_round(now, end)   # flush due draws, ingress refills
        scheduler.run_round(round_end)    # per-host events
        engine.end_of_round(now, end)     # the barrier: batched data plane
        now = round_end (or skip ahead through provably idle time)

Skip-ahead: when a round executed zero events and the engine holds no
deferred ingress, the controller jumps the clock to the next scheduled
event (or the earliest event an in-flight draw batch can produce) — idle
sim time costs nothing (the closed-form token buckets account elapsed time
exactly, so results are identical to grinding through empty rounds).

The plane follows the policy, as in the reference: the thread policies
run the per-unit plane (network/engine.py, backend numpy: the reference's
CPU baseline, with no device work), tpu_batch and tpu_mesh the columnar
plane (network/colplane.py). With the C engine attached to the columnar
plane (``experimental.native_colcore``, the default) the engine's
``run_round`` replaces the scheduler's per-host loop and keeps the
active-host set itself.

``device`` ("cuda" or "cpu") is where the data-plane kernels run (the
loss draws under tpu_batch, the mesh programs under tpu_mesh); it is
checked under every policy. Fault injection (faults.py), telemetry
(telemetry/) and packet capture (utils/pcap.py) run on every plane and
policy, as in the reference; so do checkpoints (checkpoint.py: a snapshot
at a round boundary, ``run(resume_at=...)`` to continue it, byte-identical
to the uninterrupted run), the supervisor's in-process chaos hook
(supervise.py), the shard-worker subclass (parallel/shards.py) and the
live operations plane (live.py: an endpoint streaming heartbeats and
records, runtime commands applied at round boundaries and logged to
commands.jsonl, their replay, and the time-travel ``jump``'s stop hook).
Any process path that is not ``pyapp:`` is a real executable run as a
managed process under the preload shim (native/managed.py), with its
observation journal armed for re-execution checkpoints and its stalls
escalated to the supervisor.
"""

from __future__ import annotations

from functools import partial

from pathlib import Path

import numpy as np

from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.scheduler import make_scheduler
from shadow_tpu_torch.core.time import NS_PER_SEC, NS_PER_US, SimTime, T_NEVER, format_time
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.host.process import PluginProcess
from shadow_tpu_torch.network.colplane import ColumnarPlane
from shadow_tpu_torch.network.engine import NetworkEngine
from shadow_tpu_torch.network.fluid import MTU, NetParams
from shadow_tpu_torch.network.graph import load_graph
from shadow_tpu_torch.utils.counters import Counters
from shadow_tpu_torch.utils import spans as _sp
from shadow_tpu_torch.utils.logging import SimLogger
from shadow_tpu_torch.utils.units import parse_bandwidth

DEFAULT_BANDWIDTH = parse_bandwidth("1 Gbit")
#: rounds between explicit gc.collect() calls while auto-GC is suspended
_GC_EVERY_ROUNDS = 5000

#: run-summary keys that are wall-clock / routing telemetry rather than
#: simulation state — strip these when diffing summaries for determinism
#: (WHICH windows the device served legitimately varies run to run while
#: output trees stay bit-identical). The reference's list, plus
#: "native_colcore" (whether the C engine ran): which host engine ran is
#: as immaterial to results.
VOLATILE_SUMMARY_KEYS = ("wall_seconds", "sim_sec_per_wall_sec",
                         "phase_wall", "max_rss_mb", "device",
                         "device_windows_dispatched", "sim_shards",
                         "shards", "device_transport",
                         "device_transport_engaged", "supervisor",
                         "native_colcore")
#: phases the summary's phase_wall reports and the heartbeat's leaves out
SUMMARY_ONLY_PHASES = ("telemetry", "checkpoint")


class Controller:
    #: multi-process sharding (parallel/shards.py): the shard worker
    #: subclass overrides these INSTANCE attrs before calling __init__;
    #: the base controller owns every host. owns() gates which hosts get
    #: processes, scheduler slots, fault lifecycle transitions, telemetry
    #: columns, and digest fingerprints.
    shard_id = 0
    n_shards = 1
    #: supervision (supervise.py): ``_supervised`` is set by
    #: run_supervised (an in-process chaos kill then raises instead of
    #: taking the supervisor down, and a managed guest's watchdog stall
    #: escalates as GuestStallError via ``_stall_escalate`` at the next
    #: boundary instead of the unsupervised host_down conversion);
    #: ``_chaos`` is the env-armed fault injector (wall-clock plane,
    #: rebuilt by every run())
    _supervised = False
    _stall_escalate = None
    _chaos = None
    #: live operations plane (live.py). ``live`` (the endpoint server)
    #: and ``on_stop_round`` (the time-travel inspector hook) are
    #: runtime-only and nulled by __getstate__; the replay cursor is
    #: rebuilt by _init_live from the resuming invocation's config.
    live = None
    stop_after_round = None
    on_stop_round = None
    _ckpt_now = False
    _live_paused = False
    _live_seq = 0
    _replay_cmds = ()
    _replay_idx = 0

    def owns(self, hid: int) -> bool:
        return self.n_shards == 1 or hid % self.n_shards == self.shard_id

    def _sched_hosts(self) -> list:
        """The hosts this controller's scheduler executes: all of them,
        or the owned subset on a shard worker (a scheduler policy's
        host->thread placement cannot change results, so neither can the
        shard partition — same argument, one level up)."""
        if self.n_shards == 1:
            return self.hosts
        return [h for h in self.hosts if self.owns(h.id)]

    def _log_name(self) -> str:
        return "shadow.log"

    def __init__(self, cfg: ConfigOptions, mirror_log: bool = True,
                 device: str = "cuda", record_spans: bool = False) -> None:
        """``record_spans`` keeps a record of every span of the host's
        phases (utils/spans.py) until ``spans.take()``; off, only the
        phase totals (``phase_wall``) are kept."""
        from shadow_tpu_torch.ops import devcfg

        t_construct = _sp.now() if record_spans else 0
        devcfg.require_device(device)  # "cuda" without a card: fail now
        self.cfg = cfg
        #: the host phases' timer, shared with the data plane, whose
        #: phase_wall is its totals dict (events first, as the summary
        #: lists them)
        self.spans = _sp.Spans(record_spans)
        self.spans.totals["events"] = 0.0
        if cfg.general.checkpoint_every:
            # fail at build, not at the first checkpoint boundary 40
            # minutes in (checkpoint.py owns the policy)
            from shadow_tpu_torch.checkpoint import \
                validate_config_checkpointable

            validate_config_checkpointable(cfg)
        self.device = device
        self.data_dir = Path(cfg.general.data_directory)
        self.log = SimLogger(cfg.general.log_level,
                             self.data_dir / self._log_name(),
                             mirror_stderr=mirror_log)
        self.graph = load_graph(cfg.network["graph"])

        # conservative lookahead: round width <= min latency keeps every
        # cross-host arrival at least one round in the future (SURVEY.md §2
        # parallelism item 4). An explicit runahead overrides (arrivals then
        # clamp to the next round boundary — coarser, faster, still causal).
        w = self.graph.min_latency_ns
        if cfg.experimental.runahead is not None:
            w = cfg.experimental.runahead
        self.round_ns: SimTime = max(int(w), NS_PER_US)

        self.hosts: list[Host] = []
        self._by_name: dict[str, int] = {}
        self._by_ip: dict[str, int] = {}
        rate_up = np.zeros(len(cfg.hosts), dtype=np.int64)
        rate_down = np.zeros(len(cfg.hosts), dtype=np.int64)
        host_node = np.zeros(len(cfg.hosts), dtype=np.int32)
        for hid, hopts in enumerate(cfg.hosts):
            node_gml_id = hopts.network_node_id
            if node_gml_id not in self.graph.node_id_map:
                raise ValueError(
                    f"host {hopts.name!r}: network_node_id {node_gml_id} not in graph"
                )
            node = self.graph.node_id_map[node_gml_id]
            defaults = self.graph.node_defaults[node]
            up = hopts.bandwidth_up or defaults.bandwidth_up
            down = hopts.bandwidth_down or defaults.bandwidth_down
            if up is None or down is None:
                self.log.warning(
                    f"host {hopts.name!r}: no bandwidth configured on host or "
                    f"graph node; defaulting to 1 Gbit"
                )
                up = up or DEFAULT_BANDWIDTH
                down = down or DEFAULT_BANDWIDTH
            ip = hopts.ip_addr or _default_ip(hid)
            host = Host(hid, hopts.name, ip, node, cfg.general.seed, self,
                        cc=hopts.congestion_control)
            host.log_level = hopts.log_level or cfg.general.log_level
            if hopts.pcap_enabled:
                from shadow_tpu_torch.utils.pcap import PcapWriter

                d = self.data_dir / "hosts" / hopts.name
                d.mkdir(parents=True, exist_ok=True)
                host.pcap = PcapWriter(d / f"{hopts.name}.pcap",
                                       hopts.pcap_capture_size)
            self.hosts.append(host)
            self._by_name[hopts.name] = hid
            self._by_ip[ip] = hid
            rate_up[hid] = up
            rate_down[hid] = down
            host_node[hid] = node

        params = NetParams.build(
            host_node=host_node,
            rate_up=rate_up,
            rate_down=rate_down,
            latency_ns=self.graph.latency_ns,
            reliability=self.graph.reliability,
            seed=cfg.general.seed,
            round_ns=self.round_ns,
            max_unit=cfg.experimental.unit_mtus * MTU,
        )
        policy = cfg.experimental.scheduler_policy
        backend = {"tpu_batch": "tpu", "tpu_mesh": "mesh"}.get(policy,
                                                               "numpy")
        # active-host tracking: per-round work is O(hosts with pending
        # events), not O(all hosts). A host (re)activates on its queue's
        # empty->nonempty edge.
        self._active: set = set()  # host IDS (ints sort at C speed)
        if backend in ("tpu", "mesh"):
            # the tpu policies run the array-native columnar plane
            # (network/colplane.py): tpu_batch with its loss draws on the
            # device, tpu_mesh with each causal window's draws and arrival
            # exchange as one sharded program (parallel/mesh.py)
            self.engine = ColumnarPlane(
                self.graph, params, self.hosts, self.round_ns,
                backend=backend, tpu_options=cfg.experimental,
                bootstrap_end=cfg.general.bootstrap_end_time,
                device=device, spans=self.spans,
            )
            self.engine.activate = self._active.add
        else:
            # the thread policies keep the per-unit plane, the
            # reference-architecture baseline (results are bit-identical
            # across planes: tests/test_torch_policies.py)
            self.engine = NetworkEngine(
                self.graph, params, self.hosts, self.round_ns,
                backend=backend, tpu_options=cfg.experimental,
                bootstrap_end=cfg.general.bootstrap_end_time,
                device=device, spans=self.spans,
            )
        for h in self.hosts:
            h.engine = self.engine
            h.equeue.on_first = partial(self._active.add, h.id)
        # C engine (csrc/colcore.c, columnar plane only): owns the
        # per-round host loop and maintains the active set directly;
        # activations route through it so its sorted active-set snapshot
        # merges new members incrementally instead of re-snapshotting
        # every round
        self._c_core = getattr(self.engine, "_c", None)
        if self._c_core is not None:
            self._c_core.bind_active(self._active)
            act = self._c_core.activate
            self.engine.activate = act
            for h in self.hosts:
                h.equeue.on_first = partial(act, h.id)
        # experimental.device_transport (network/devtransport.py):
        # wall-clock policy only, every path is bit-identical; it stands
        # down when the C engine is attached, and the per-unit plane has
        # no columnar transport (a no-op there, as in the reference)
        attach_dt = getattr(self.engine, "attach_devtransport", None)
        if attach_dt is not None:
            attach_dt(cfg.experimental, device)
        self.scheduler = make_scheduler(policy, self._sched_hosts(),
                                        cfg.general.parallelism)

        # processes: pyapp: plugins run in-process; any other path is a real
        # executable run under the native preload shim (SURVEY.md §7 phase 4)
        # (sharded workers build processes only for their OWNED hosts — a
        # non-owned host is pure topology here, its simulation lives on
        # the owning shard)
        self.processes: list = []
        for host, hopts in zip(self.hosts, cfg.hosts):
            if not self.owns(host.id):
                continue
            for i, popts in enumerate(hopts.processes):
                if PluginProcess.is_plugin_path(popts.path):
                    proc = PluginProcess(host, popts, i)
                else:
                    from shadow_tpu_torch.native.managed import (
                        ManagedProcess, _shim_lib)

                    # fail fast at build time, not inside a scheduler
                    # event; _shim_lib builds the shim at first use and
                    # raises with the compiler's output
                    if not Path(popts.path).is_file():
                        raise ValueError(
                            f"host {hopts.name!r}: managed executable "
                            f"{popts.path!r} does not exist")
                    if not _shim_lib().exists():
                        raise ValueError(
                            f"native shim {_shim_lib()} missing "
                            f"(SHADOW_SHIM_LIB names no file)")
                    proc = ManagedProcess(host, popts, i)
                host.processes.append(proc)
                self.processes.append(proc)
                host.schedule(popts.start_time, proc.spawn)
                if popts.shutdown_time is not None:
                    host.schedule(popts.shutdown_time, proc.shutdown)

        #: fault injection (faults.py) runs on every plane, the C engine
        #: included: the injector rewrites the effective latency/loss/rate
        #: matrices and bucket arrays in place, and the C engine holds raw
        #: pointers into those arrays, so a transition is visible to all
        #: planes at the next barrier. Crash/reboot drive the C engine's
        #: teardown hooks (Core.host_crash/host_boot) through Host.
        self.faults = None
        faults_cfg = cfg.faults
        if faults_cfg is not None and (faults_cfg.events or faults_cfg.churn):
            from shadow_tpu_torch.faults import FaultInjector

            self.engine.faults_active = True
            for h in self.hosts:
                h.faults_active = True
            if self._c_core is not None:
                # the C engine read the plane's flag at bind, before this:
                # enable its per-host blackhole/teardown accounting and the
                # faults-gated stream recovery counters
                self._c_core.set_faults_active(True)
            self.faults = FaultInjector(self)
            self.log.info(
                f"fault timeline: {len(self.faults.actions)} transitions "
                f"({len(faults_cfg.events)} configured events, "
                f"{len(faults_cfg.churn)} churn groups)")

        #: deterministic simulation telemetry (telemetry/): a telemetry:
        #: section builds the collector; hosts carry a direct reference so
        #: flow records cost one attribute check when off. The samplers read
        #: only plane-independent observables, so the streams are the same
        #: on every plane and with the C engine on or off.
        self.telemetry = None
        if cfg.telemetry is not None:
            from shadow_tpu_torch.telemetry import TelemetryCollector

            self.telemetry = TelemetryCollector(cfg.telemetry)
            self.spans.totals["telemetry"] = 0.0
            for h in self.hosts:
                h.telemetry = self.telemetry
            if self.faults is not None:
                self.faults.on_apply = self.telemetry.record_fault

        self.counters = Counters()
        self.rounds = 0
        self.events = 0
        self.wall_seconds = 0.0
        # checkpoint/restore + determinism sentinel (checkpoint.py)
        self.ckpt_every: SimTime = cfg.general.checkpoint_every or 0
        self.ckpt_dir = (Path(cfg.general.checkpoint_dir)
                         if cfg.general.checkpoint_dir
                         else self.data_dir / "checkpoints")
        self.digest_every = cfg.general.state_digest_every
        #: managed re-execution snapshots (checkpoint format version 2):
        #: arm the per-guest observation journal whenever this run could
        #: write a snapshot (grid cadence, or live checkpoint_now via the
        #: endpoint) so every snapshot carries verifiable guest cursors.
        #: The journal is a pure side-plane recorder — it never feeds sim
        #: state — so SHADOW_TPU_GUEST_JOURNAL=1/0 may force it on or off
        #: without touching results.
        self._reexec_verify = None
        self.guest_journal_dir = None
        self._has_managed = any(
            not PluginProcess.is_plugin_path(p.path)
            for h in cfg.hosts for p in h.processes)
        if self._has_managed:
            import os as _os

            jr = _os.environ.get("SHADOW_TPU_GUEST_JOURNAL")  # detlint: ok(envread): side-plane artifact toggle
            if jr != "0" and (jr == "1" or self.ckpt_every
                              or cfg.general.live_endpoint):
                self.guest_journal_dir = self.data_dir / "guest_oplogs"
        #: set by the SIGINT/SIGTERM handler: the round loop finishes the
        #: current round, writes a final checkpoint (when enabled), and
        #: finalizes a valid partial summary instead of dying mid-round
        self._interrupt = None
        self._partial = False
        self._init_live()
        for w in cfg.warnings:
            self.log.warning(w)
        if record_spans:
            self.spans.add(_sp.CONSTRUCT, t_construct, _sp.now())

    def _init_live(self) -> None:
        """Build the live operations plane (live.py): load the replay
        command log and bind the endpoint. Both config keys are volatile —
        the plane is pure wall-clock; commands touch sim state only through
        the recorded commands.jsonl. Shard workers never bind: the parent
        owns the socket and feeds commands through the shard-0 marker path
        so all workers apply them at the same round."""
        from shadow_tpu_torch import live as _live

        gen = self.cfg.general
        self._replay_cmds = ()
        self._replay_idx = 0
        if gen.replay_commands:
            self._replay_cmds = tuple(
                _live.load_command_log(gen.replay_commands))
            self.log.info(
                f"replaying {len(self._replay_cmds)} recorded command(s) "
                f"from {gen.replay_commands}")
        self.live = None
        if gen.live_endpoint and self.n_shards == 1:
            self.live = _live.LiveServer(
                _live.resolve_endpoint(gen.live_endpoint, self.data_dir),
                log=self.log)

    def _close_live(self) -> None:
        if self.live is not None:
            self.live.close()  # idempotent and bounded

    # -- checkpoint/restore (checkpoint.py) -------------------------------
    def __getstate__(self):
        """Snapshot-time state: everything except runtime plumbing. The
        scheduler (worker threads), the C engine, the chaos injector and
        the live plane (its server, the inspector hook, the replay cursor:
        rebuilt by _init_live from the resuming invocation's volatile
        keys) are rebuilt on restore; all are result-transparent."""
        d = self.__dict__.copy()
        d["scheduler"] = None
        d["_c_core"] = None
        d.pop("_chaos", None)
        d["live"] = None
        d["on_stop_round"] = None
        d["_live_paused"] = False
        d["_replay_cmds"] = ()
        d["_replay_idx"] = 0
        return d

    def _reattach_runtime(self, mirror_log: bool = True,
                          device: str = "cuda") -> None:
        """Rebuild the runtime-only pieces after a checkpoint restore:
        output location, logger mirroring, scheduler threads, the device
        data plane on the resume invocation's ``device`` (the draw plane
        and its slots, the mesh plane, the device transport), and the C
        engine (honoring the invocation's ``experimental.native_colcore``
        — a volatile config key). Everything simulation-semantic came back
        through the pickle; checkpoint-restored C objects (endpoints,
        gossip states, relays) are bound to the fresh engine via
        ``checkpoint.finish_colcore_adopt``. The fault injector and the
        rebuilt engine share the restored arrays (the pickle memo keeps
        one object per array), so the injector's in-place rewrites reach
        the C engine's pointers as before."""
        from shadow_tpu_torch import checkpoint as _ckpt
        from shadow_tpu_torch.ops import devcfg
        from shadow_tpu_torch.utils.logging import LEVELS

        devcfg.require_device(device)  # "cuda" without a card: fail now
        self.device = device
        cfg = self.cfg
        self.data_dir = Path(cfg.general.data_directory)
        self.log.path = self.data_dir / self._log_name()
        self.log.mirror = mirror_log
        # log_level is a volatile config key: honor the resume invocation's
        # value on the main log and on hosts without a per-host override
        self.log.level = LEVELS[cfg.general.log_level]
        for h, hopts in zip(self.hosts, cfg.hosts):
            h.log_level = hopts.log_level or cfg.general.log_level
        self.ckpt_every = cfg.general.checkpoint_every or 0
        self.ckpt_dir = (Path(cfg.general.checkpoint_dir)
                         if cfg.general.checkpoint_dir
                         else self.data_dir / "checkpoints")
        self.digest_every = cfg.general.state_digest_every
        self._init_live()
        self.scheduler = make_scheduler(
            cfg.experimental.scheduler_policy, self._sched_hosts(),
            cfg.general.parallelism)
        self.engine.reattach_device(cfg.experimental, device)
        # C engine: rebuild over the restored structures and REWIRE the
        # activation hooks — the pickled hooks may reference the dead
        # engine's placeholder (checkpoint._DeadCoreHandle)
        self._c_core = None
        attach = getattr(self.engine, "attach_colcore", None)
        core = attach(cfg.experimental) if attach is not None else None
        if core is not None:
            self._c_core = core
            core.bind_active(self._active)
            act = core.activate
            self.engine.activate = act
            for h in self.hosts:
                h.equeue.on_first = partial(act, h.id)
            if self.faults is not None:
                core.set_faults_active(True)
        else:
            if isinstance(self.engine, ColumnarPlane):
                self.engine.activate = self._active.add
            for h in self.hosts:
                h.equeue.on_first = partial(self._active.add, h.id)
        attach_dt = getattr(self.engine, "attach_devtransport", None)
        if attach_dt is not None:
            # after attach_colcore: the transport engine yields to an
            # attached C engine (experimental.device_transport is volatile
            # wall-clock policy, like native_colcore)
            attach_dt(cfg.experimental, device)
        _ckpt.finish_colcore_adopt(self)

    # -- managed re-execution restore (checkpoint format version 2) -------
    def guest_journal_cursors(self) -> dict:
        """Per-guest observation-journal cursors for a re-execution
        snapshot: ``{"host/proc": {"n": entries, "sha": running-hash}}``.
        Empty when journaling is off (no managed guests, or neither a
        checkpoint cadence nor a live endpoint armed the journal)."""
        out = {}
        for p in self.processes:
            j = getattr(p, "_journal", None)
            if j is not None:
                out[f"{p.host.name}/{p.name}"] = j.cursor()
        return out

    def note_guest_pid(self, proc) -> None:
        """Side-plane registry of live guest OS pids
        (``<data_dir>/guest_pids.jsonl``, one record per spawn/exec/fork).
        Never part of the determinism surface — fleet's ``--resume`` reads
        a dead run's registry to reap stale guests before re-running the
        seed (the pid is verified against the record's clock-page path in
        /proc/<pid>/environ first, so pid reuse cannot kill a stranger)."""
        import json as _json

        pid = proc.proc.pid if proc.proc is not None else proc.real_pid
        if pid is None:
            return
        # fork children borrow the parent's clock page; their environ
        # still carries the parent's SHADOW_TIME_SHM, so identity checks
        # use the nearest ancestor's page path
        shm, p = proc._time_path, proc
        while shm is None and getattr(p, "parent_proc", None) is not None:
            p = p.parent_proc
            shm = p._time_path
        rec = {"pid": int(pid), "host": proc.host.name, "proc": proc.name,
               "shm": str(shm) if shm else None}
        self.data_dir.mkdir(parents=True, exist_ok=True)
        with open(self.data_dir / "guest_pids.jsonl", "a") as f:
            f.write(_json.dumps(rec, sort_keys=True) + "\n")

    def _verify_reexec(self, now: SimTime) -> None:
        """The deterministic re-execution of a restored managed run has
        reached the snapshot boundary: verify the recomputed state digest
        and every guest's journal cursor against the checkpoint record.
        Any mismatch means the prefix did NOT reproduce the checkpointed
        run — fail by name instead of continuing a silently different
        simulation."""
        info, self._reexec_verify = self._reexec_verify, None
        from shadow_tpu_torch.checkpoint import CheckpointError, state_digest

        if now != info["t"] or self.rounds != info["rounds"]:
            raise CheckpointError(
                f"re-execution diverged from {info['path']}: expected "
                f"round {info['rounds']} at sim {info['t']} ns, but the "
                f"round grid reached sim {now} ns at round {self.rounds} "
                f"— this environment does not reproduce the checkpointed "
                f"run")
        g, _hosts = state_digest(self, now)
        if g != info["digest"]:
            raise CheckpointError(
                f"re-execution diverged from {info['path']}: state digest "
                f"at round {self.rounds} is {g[:16]}, checkpoint recorded "
                f"{info['digest'][:16]} — bisect with "
                f"tools/bisect_divergence.py against the original "
                f"state_digests.jsonl")
        want = info.get("cursors") or {}
        cur = self.guest_journal_cursors()
        if want and cur != want:
            bad = sorted(k for k in set(want) | set(cur)
                         if want.get(k) != cur.get(k))
            raise CheckpointError(
                f"re-execution diverged from {info['path']}: guest "
                f"journal cursor mismatch for {bad} — the re-executed "
                f"guests did not observe the recorded syscall stream")
        self.log.info(
            f"re-execution reached the snapshot boundary (round "
            f"{self.rounds}, sim {format_time(now)}): state digest and "
            f"{len(want)} guest journal cursor(s) verified; continuing")

    def _on_signal(self, signum, frame) -> None:
        """SIGINT/SIGTERM: request a graceful stop at the next round
        boundary. A second signal aborts immediately (the operator means
        it)."""
        import signal as _signal

        if self._interrupt is not None:
            raise KeyboardInterrupt
        self._interrupt = _signal.Signals(signum).name

    # -- naming -----------------------------------------------------------
    def resolve(self, name_or_ip) -> int:
        if isinstance(name_or_ip, int):
            return name_or_ip
        hid = self._by_name.get(name_or_ip)
        if hid is None:
            hid = self._by_ip.get(name_or_ip)
        if hid is None:
            raise KeyError(f"unknown host {name_or_ip!r}")
        return hid

    # -- main loop --------------------------------------------------------
    def run(self, resume_at: SimTime = None) -> dict:
        """Drive the simulation to stop_time and return the run summary.
        ``resume_at`` (set by checkpoint.load_checkpoint) re-enters the
        round loop at a saved round boundary; all loop-carried state
        (engine, queues, fault cursor, active set, counters) came back
        through the snapshot, so the continuation is byte-identical to the
        uninterrupted run."""
        sp = self.spans
        if sp.on:
            sp.open(_sp.RUN)
        cfg = self.cfg
        stop = cfg.general.stop_time
        w = self.round_ns
        now: SimTime = resume_at if resume_at is not None else 0
        self.log.info(
            f"simulation {'resuming' if resume_at is not None else 'starting'}"
            f": {len(self.hosts)} hosts, "
            f"{self.graph.n_nodes} graph nodes, round width {format_time(w)}, "
            f"policy {cfg.experimental.scheduler_policy} on {self.device}, "
            f"stop {format_time(stop)}"
        )
        hb_interval = cfg.general.heartbeat_interval
        next_hb = ((now // hb_interval) + 1) * hb_interval \
            if hb_interval else T_NEVER
        prog_step = max(stop // 100, 1)
        next_prog = now + prog_step if cfg.general.progress else T_NEVER
        ck_every = self.ckpt_every
        dig = self.digest_every
        _ckpt = None
        if ck_every or dig or self.live is not None or self._replay_cmds:
            # the live plane needs the checkpoint module for the
            # checkpoint_now command even when grid checkpointing is off
            from shadow_tpu_torch import checkpoint as _ckpt
        if (self.live is not None or cfg.general.replay_commands) \
                and resume_at is None:
            # fresh run: a stale command log would concatenate with this
            # run's records and break replay (resumes keep appending — the
            # continuation of one log, as the digests do)
            from shadow_tpu_torch import live as _live

            _live.command_log_path(self.data_dir).unlink(missing_ok=True)
        if resume_at is not None and self._replay_cmds:
            # commands at or before the snapshot boundary are already in
            # the restored state (the command hook runs before the
            # checkpoint write at a shared boundary): skip them without
            # re-applying or re-logging
            while (self._replay_idx < len(self._replay_cmds)
                   and self._replay_cmds[self._replay_idx]["t"] <= resume_at):
                self._replay_idx += 1
        if dig and resume_at is None:
            # fresh run: a stale sentinel stream from a previous run into
            # this data_directory would concatenate and confuse
            # tools/bisect_divergence.py (resumes keep appending — the
            # continuation of one stream)
            (self.data_dir / _ckpt.DIGEST_FILE).unlink(missing_ok=True)
        if resume_at is None and self._has_managed:
            # fresh-run discipline for the managed side planes: stale
            # guest journals or a dead run's pid registry must not
            # concatenate with this run's records (a re-execution restore
            # is a fresh run here — its artifacts regenerate 0..end, which
            # is exactly what makes them comparable to the originals)
            (self.data_dir / "guest_pids.jsonl").unlink(missing_ok=True)
            if self.guest_journal_dir is not None:
                import shutil as _shutil

                _shutil.rmtree(self.guest_journal_dir, ignore_errors=True)
        tel = self.telemetry
        if tel is not None and resume_at is None:
            # same discipline for the telemetry streams: fresh runs
            # truncate + write the meta record; resumes keep appending
            tel.start_fresh(self)
        next_ckpt = ((now // ck_every) + 1) * ck_every if ck_every \
            else T_NEVER
        # graceful shutdown: SIGINT/SIGTERM finish the current round, write
        # a final checkpoint (when enabled), and produce a valid partial
        # summary (main thread only — signals cannot be hooked elsewhere)
        import signal as _signal
        import threading as _threading

        self._partial = False
        self._interrupt = None  # a resumed final-checkpoint carries the
        #                         old signal name; this run starts clean
        installed = {}
        if _threading.current_thread() is _threading.main_thread():
            for s in (_signal.SIGINT, _signal.SIGTERM):
                try:
                    installed[s] = _signal.signal(s, self._on_signal)
                except (ValueError, OSError):
                    pass
        # the round loop allocates millions of short-lived objects;
        # generational GC scanning them costs ~40% of wall at 10k-host
        # scale. Collect at fixed round intervals instead — reference
        # cycles from closed connections still get reclaimed.
        import gc as _gc

        gc_was_enabled = _gc.isenabled()
        _gc.disable()
        # chaos harness (supervise.py): deterministic-round fault
        # injection, armed only through the environment — one dict probe
        # per run when off, one int compare per round when on
        import os as _os

        self._chaos = None
        if _os.environ.get("SHADOW_TPU_CHAOS"):
            from shadow_tpu_torch.supervise import ChaosInjector

            self._chaos = ChaosInjector.from_env(
                self.data_dir, shard=self.shard_id, in_process=True)
        t0 = _sp.now()
        if sp.on:
            sp.open(_sp.LOOP, t0)
        try:
            now = self._round_loop(now, stop, w, next_hb, hb_interval,
                                   next_prog, prog_step, next_ckpt,
                                   ck_every, dig, _ckpt, tel, t0)
        except BaseException:
            self._close_live()  # followers see the socket close
            raise
        finally:
            for s, old in installed.items():
                _signal.signal(s, old)
            if gc_was_enabled:
                _gc.enable()
        self._partial = self._interrupt is not None and now < stop
        if self._partial:
            self.log.warning(
                f"{self._interrupt} received: stopped gracefully at round "
                f"boundary {format_time(now)} ({self.rounds} rounds); "
                f"summary is partial")
            if ck_every:
                path = _ckpt.save_checkpoint(self, now)
                self.log.info(f"final checkpoint written: {path}")
                if self.live is not None:
                    self.live.publish({"type": "checkpoint",
                                       "path": str(path), "t": now,
                                       "round": self.rounds})
        if sp.on:
            sp.open(_sp.GC)
        _gc.collect()
        if sp.on:
            sp.close()
        self.engine.flush_all()  # finalize counters for in-flight batches
        if cfg.general.progress:
            import sys as _sys

            print(file=_sys.stderr)  # end the \r status line
        t1 = _sp.now()
        self.wall_seconds = (t1 - t0) / 1e9
        if sp.on:
            sp.close(t1)
        self.scheduler.shutdown()
        try:
            result = self._finalize(min(now, stop))
        except BaseException:
            self._close_live()
            raise
        if self.live is not None:
            self.live.publish({"type": "end",
                               "exit_reason": result["exit_reason"],
                               "rounds": self.rounds, "t": min(now, stop)})
            self.live.close()
        if sp.on:
            sp.close()
        return result

    def _round_loop(self, now, stop, w, next_hb, hb_interval, next_prog,
                    prog_step, next_ckpt, ck_every, dig, _ckpt, tel,
                    t0) -> SimTime:
        """The conservative round loop (split from run() so the signal
        try/finally stays readable). Returns the final sim time."""
        import gc as _gc

        dyn = self.cfg.experimental.use_dynamic_runahead
        next_gc = _GC_EVERY_ROUNDS
        hosts = self.hosts
        # device transport: deferred host rounds replay inside
        # end_of_round; their event counts fold back into `executed`, so
        # the skip-ahead decision, the events total and the round grid
        # are the scalar twin's
        devt = getattr(self.engine, "devt", None)
        faults = self.faults
        sp = self.spans
        pw = sp.totals
        while now < stop:
            if self._chaos is not None:
                self._chaos.maybe_fire(self.rounds, self)
            if self._stall_escalate is not None:
                # a managed guest stalled past its watchdog deadline
                # under supervision: surface it at this boundary (before
                # anything is emitted for the next round) so the
                # supervisor can tear down and recover by re-execution
                from shadow_tpu_torch.supervise import GuestStallError

                msg, self._stall_escalate = self._stall_escalate, None
                raise GuestStallError(msg)
            if self.live is not None \
                    or self._replay_idx < len(self._replay_cmds):
                # live operations command plane (live.py): due replayed
                # commands, then live client commands, all quantized to
                # THIS boundary and logged — before the interrupt check (a
                # stop command IS the interrupt) and before the checkpoint
                # write (so a same-boundary snapshot already holds the
                # commands' effects)
                faults = self._live_boundary(now, faults)
            if self._interrupt is not None:
                # graceful shutdown: the signal arrived during the last
                # round; stop at this (consistent) round boundary
                break
            if self._reexec_verify is not None \
                    and now >= self._reexec_verify["t"]:
                # managed re-execution restore: the deterministic prefix
                # has reached the snapshot boundary — verify digest +
                # guest cursors HERE, exactly where the original run
                # wrote the snapshot (after the boundary's commands,
                # before fault transitions apply)
                self._verify_reexec(now)
            if now >= next_ckpt or self._ckpt_now:
                self._ckpt_now = False
                t_ck = _sp.now()
                if sp.on:
                    sp.open(_sp.CHECKPOINT, t_ck)
                if tel is not None:
                    tel.sync(self)  # streams complete at the boundary
                path = _ckpt.save_checkpoint(self, now)
                self.log.info(
                    f"checkpoint written: {path} "
                    f"(sim {format_time(now)}, round {self.rounds})")
                if self.live is not None:
                    # the checkpoint_now ack confirms receipt, not effect:
                    # this post-save record is how a live client learns
                    # the PATH, e.g. to fork it (forks.py)
                    self.live.publish({"type": "checkpoint",
                                       "path": str(path), "t": now,
                                       "round": self.rounds})
                if ck_every:
                    next_ckpt = ((now // ck_every) + 1) * ck_every
                # snapshot wall is attributed like any other phase: it is
                # plane-independent (the pickler walks the same graph fast
                # plane or slow)
                t1 = _sp.now()
                pw["checkpoint"] = pw.get("checkpoint", 0.0) + (
                    t1 - t_ck) / 1e9
                if sp.on:
                    sp.close(t1)
            if faults is not None:
                # fault transitions apply at round starts: an action at
                # time t takes effect at the first boundary >= t — the
                # same quantization the conservative barrier imposes on
                # every cross-host effect, so it is policy-independent
                faults.apply_due(now)
            if dyn:
                # widen to the smallest latency traffic has actually used
                # (never narrower than the static conservative window)
                w = max(self.round_ns,
                        min(self.engine.min_used_latency, 10 * self.round_ns))
            round_end = min(now + w, stop)
            if sp.on:
                sp.open(_sp.ROUND_START)
            self.engine.start_of_round(now, round_end)
            t_ev = _sp.now()
            if sp.on:
                sp.close(t_ev)
            if self._c_core is not None:
                # the C loop snapshots + sorts the active set, merges each
                # host's inbox/heap, and discards drained hosts itself
                executed = self._c_core.run_round(round_end)
            else:
                active = [hosts[i] for i in sorted(self._active)]
                executed = self.scheduler.run_round(round_end, active)
                for h in active:
                    if not h.equeue._heap:
                        self._active.discard(h.id)
            t1 = _sp.now()
            pw["events"] += (t1 - t_ev) / 1e9
            if sp.on:
                sp.add(_sp.EVENTS, t_ev, t1)
                sp.open(_sp.ROUND_END, t1)
            self.engine.end_of_round(now, round_end)
            if sp.on:
                sp.close()
            if devt is not None:
                executed += devt.take_executed()
            self.rounds += 1
            self.events += executed
            if dig and self.rounds % dig == 0:
                # determinism sentinel: canonical state digest at this
                # round boundary (flushes in-flight draws first — result-
                # identical, so digesting runs stay byte-identical)
                _ckpt.emit_digest(self, round_end)
            if tel is not None and (tel.dirty
                                    or round_end >= tel.next_sample):
                # telemetry: flush this round's flow closes + fault
                # annotations; take a sample when the sim-time grid says
                # so (the round grid is policy-independent, so the
                # streams are too). Idle rounds skip the call entirely.
                t_tel = _sp.now()
                if sp.on:
                    sp.open(_sp.TELEMETRY, t_tel)
                tel.on_round_end(self, round_end)
                t1 = _sp.now()
                pw["telemetry"] += (t1 - t_tel) / 1e9
                if sp.on:
                    sp.close(t1)
            if (self.stop_after_round is not None
                    and self.rounds >= self.stop_after_round):
                # time-travel inspection (live.py jump): halt AT this
                # boundary — digest and telemetry for the round are already
                # emitted — and hand the inspector the controller
                if self.on_stop_round is not None:
                    self.on_stop_round(self, round_end)
                now = round_end
                break
            if round_end >= next_hb:
                if sp.on:
                    sp.open(_sp.HEARTBEAT)
                self._heartbeat(round_end, t0)
                if sp.on:
                    sp.close()
                # grid-snap, not +=: skip-ahead can cross several
                # intervals at once
                next_hb = ((round_end // hb_interval) + 1) * hb_interval
            if round_end >= next_prog:
                self._progress(round_end, stop, t0)
                next_prog = round_end + prog_step
            if self.rounds >= next_gc:
                next_gc = self.rounds + _GC_EVERY_ROUNDS
                if sp.on:
                    sp.open(_sp.GC)
                _gc.collect()
                if sp.on:
                    sp.close()
            if executed == 0 and not self.engine.has_immediate_work():
                # provably idle: materialize any in-flight draw batch that
                # could produce an event before the next queued one, then
                # skip to the next event. Flushing here (instead of waking a
                # round at the batch deadline) keeps the round grid — and
                # hence 'rounds' and bucket rebase instants — identical to a
                # run whose flags were computed inline. The columnar
                # plane's resolved-but-undelivered store rows count as
                # queued events here (pending_head). The C core computes
                # the same min natively (it drops cancelled heads exactly
                # like next_time, so the round grid cannot move).
                def _next_queued():
                    if self._c_core is not None:
                        nq = self._c_core.next_time()
                    else:
                        nq = min((hosts[i].equeue.next_time()
                                  for i in self._active), default=T_NEVER)
                    nq = min(nq, self.engine.pending_head())
                    if faults is not None:
                        # a pending fault transition is a wake-up: skip-
                        # ahead must not jump over it (a reboot creates
                        # new events)
                        nq = min(nq, faults.next_time())
                    return nq

                if sp.on:
                    sp.open(_sp.IDLE_SKIP)
                nt = _next_queued()
                while self.engine.earliest_outstanding() < nt:
                    self.engine.flush_due(nt)
                    nt = _next_queued()
                if sp.on:
                    sp.close()
                if nt >= T_NEVER:
                    self.log.info(
                        f"no further events at {format_time(round_end)}; ending early"
                    )
                    now = stop
                    break
                now = max(round_end, nt)
            else:
                now = round_end
        return now

    def _live_boundary(self, now: SimTime, faults):
        """Drain the command plane at the round boundary ``now``: due
        replayed commands first, then live client commands. Every
        sim-visible command applies HERE with sim timestamp ``now`` and is
        appended to commands.jsonl, so an interactively driven run and its
        replay-from-log execute identical fault timelines — wall time only
        decides WHICH boundary a live command lands on, and that choice is
        recorded. Returns the (possibly just-created) fault injector."""
        from shadow_tpu_torch import live as _live

        lines: list = []
        replay = self._replay_cmds
        while self._replay_idx < len(replay) \
                and replay[self._replay_idx]["t"] <= now:
            rec = replay[self._replay_idx]
            self._replay_idx += 1
            if rec.get("wall_only"):
                continue  # pause/resume never touched sim state
            faults = self._apply_cmd(rec["cmd"], now, rec["seq"], lines,
                                     faults, replayed=True)
        srv = self.live
        if srv is not None:
            batch = srv.poll_commands()
            while batch or self._live_paused:
                if not batch:
                    # paused: wall-block at this boundary, sim state
                    # untouched (draws in flight stay in their slots, the
                    # attach thread runs on); commands arriving meanwhile
                    # still apply at THIS boundary
                    if self._interrupt is not None:
                        break
                    batch = srv.poll_commands(timeout=0.25)
                    continue
                norm = batch.pop(0)
                self._live_seq += 1
                faults = self._apply_cmd(norm, now, self._live_seq, lines,
                                         faults, replayed=False)
        if lines:
            _live.append_command_lines(self.data_dir, lines)
        return faults

    def _apply_cmd(self, norm, now: SimTime, seq: int, lines: list,
                   faults, replayed: bool):
        """Apply one normalized command at the boundary ``now``, log it,
        and publish it to live followers. A command this topology cannot
        honor is refused whole (logged as a warning, never half-applied,
        never recorded)."""
        from shadow_tpu_torch import live as _live

        kind = norm["cmd"]
        was_paused = self._live_paused
        wall_only = kind in ("pause", "resume")
        applied = True
        if kind == "pause":
            self._live_paused = True
            applied = not was_paused
        elif kind == "resume":
            self._live_paused = False
            applied = was_paused
        elif kind == "stop":
            self._live_paused = False
            self._interrupt = "live_stop"
        elif kind == "checkpoint_now":
            try:
                from shadow_tpu_torch.checkpoint import \
                    validate_config_checkpointable
                validate_config_checkpointable(self.cfg)
                self._ckpt_now = True
            except ValueError as exc:
                self.log.warning(f"live checkpoint_now refused: {exc}")
                applied = False
        else:
            try:
                faults = _live.apply_command(self, norm, now)
            except ValueError as exc:
                # resolution failure against THIS topology (unknown node
                # or host): refuse, never half-apply
                self.log.warning(f"live command {kind!r} refused: {exc}")
                applied = False
        if applied:
            lines.append(_live.format_command_record(
                norm, seq, self.rounds, now, wall_only=wall_only))
            self.log.info(
                f"live command {kind!r} applied at round {self.rounds} "
                f"(t={format_time(now)}, seq {seq}"
                f"{', replayed' if replayed else ''})")
            if self.live is not None:
                self.live.publish({"type": "command", "cmd": norm,
                                   "round": self.rounds, "seq": seq,
                                   "t": now, "replayed": replayed,
                                   "paused": self._live_paused})
        return faults

    def _progress(self, sim_now: SimTime, stop: SimTime, t0: int) -> None:
        """Terminal status line (reference: the status bar, SURVEY.md §2)."""
        import sys as _sys

        wall = (_sp.now() - t0) / 1e9
        pct = 100 * sim_now // stop
        rate = (sim_now / NS_PER_SEC) / wall if wall > 0 else 0.0
        eta = (stop - sim_now) / NS_PER_SEC / rate if rate > 0 else 0.0
        print(f"\r[{pct:3d}%] sim {format_time(sim_now)} / "
              f"{format_time(stop)}  {rate:.2f} sim-s/s  eta {eta:.0f}s   ",
              end="", file=_sys.stderr, flush=True)

    def _heartbeat(self, sim_now: SimTime, t0: int) -> None:
        wall = (_sp.now() - t0) / 1e9
        rate = (sim_now / NS_PER_SEC) / wall if wall > 0 else 0.0
        # the device-window routing decision rides the heartbeat so a
        # silently clamped/starved device is visible mid-run
        note = self.engine.heartbeat_note
        if self.live is not None:
            # sim-keyed heartbeat record: cadence and ordering are pure
            # sim time (shard-mergeable); wall cost and the device note
            # ride INSIDE the record and never feed back into the sim
            self.live.publish({
                "type": "hb", "t": sim_now, "round": self.rounds,
                "events": self.events,
                "units_sent": self.engine.units_sent,
                "units_dropped": self.engine.units_dropped,
                "shards": 1,
                "dev": note(),
                "wall": {
                    "seconds": round(wall, 3), "rate": round(rate, 3),
                    "phase": {
                        k: round(v, 4) for k, v in self.spans.totals.items()
                        if k not in SUMMARY_ONLY_PHASES},
                },
            })
        self.log.info(
            f"heartbeat: sim {format_time(sim_now)} wall {wall:.1f}s "
            f"({rate:.2f} sim-sec/wall-sec) rounds {self.rounds} "
            f"events {self.events} units sent {self.engine.units_sent} "
            f"dropped {self.engine.units_dropped}"
            + f" {note()}"
        )

    def _finalize(self, end_time: SimTime) -> dict:
        sp = self.spans
        if sp.on:
            sp.open(_sp.FINALIZE)
        if self.telemetry is not None:
            # flush the final round's flow closes (records already
            # buffered; reaping adds none) and close the stream handles
            self.telemetry.finalize(self)
        if sp.on:
            sp.open(_sp.FINALIZE_REAP)
        errors = []
        for p in self.processes:
            err = p.check_final_state()
            if err is not None:
                errors.append(err)
                self.log.error(err)
        for p in self.processes:  # reference §3.5: kill remaining managed
            reap = getattr(p, "reap", None)
            if reap is not None:
                reap()
            j = getattr(p, "_journal", None)
            if j is not None:
                # crash-killed guests that were never rebooted still hold
                # an open journal stream; flush + close it here
                j.close()
        if sp.on:
            t = sp.close()
            sp.open(_sp.FINALIZE_FOLD, t)
        for h in self.hosts:  # merge AFTER reaping so its counters land
            h.fold_counters()
            self.counters.merge(h.counters)
        self.engine.close()  # join the device-attach thread before teardown
        if sp.on:
            t = sp.close()
            sp.open(_sp.FINALIZE_LOG, t)
        devt = getattr(self.engine, "devt", None)  # the columnar plane's
        sim_sec = end_time / NS_PER_SEC
        rate = sim_sec / self.wall_seconds if self.wall_seconds > 0 else float("inf")
        self.log.info(
            f"simulation finished: sim {format_time(end_time)} in "
            f"{self.wall_seconds:.2f}s wall ({rate:.2f} sim-sec/wall-sec), "
            f"{self.rounds} rounds, {self.events} events, "
            f"{self.engine.units_sent} units delivered, "
            f"{self.engine.units_dropped} dropped"
        )
        self.log.info(self.counters.summary())
        if sp.on:
            t = sp.close()
            sp.open(_sp.FINALIZE_FLUSH_LOGS, t)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        for h in self.hosts:
            h.flush_logs(self.data_dir)
            if h.pcap is not None:
                h.pcap.close()
        if sp.on:
            t = sp.close()
            sp.open(_sp.FINALIZE_LOG, t)
        self.log.flush()
        if sp.on:
            sp.close()
        import resource

        summary = {
            "sim_seconds": sim_sec,
            "wall_seconds": self.wall_seconds,
            "sim_sec_per_wall_sec": rate,
            # graceful-shutdown contract: an interrupted run still emits a
            # VALID summary, marked partial, instead of dying mid-round
            "exit_reason": "interrupted" if self._partial else "completed",
            "partial": self._partial,
            **({"interrupt_signal": self._interrupt}
               if self._partial else {}),
            # linux ru_maxrss is KiB; the process-wide high-water mark
            "max_rss_mb": round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
            "rounds": self.rounds,
            "events": self.events,
            "units_sent": self.engine.units_sent,
            "units_dropped": self.engine.units_dropped,
            "units_blackholed": self.engine.units_blackholed,
            "bytes_sent": self.engine.bytes_sent,
            "counters": self.counters.as_dict(),
            "process_errors": errors,
            # per-phase wall breakdown: events = host event execution; the
            # engine contributes its own phases (barrier / draw_flush /
            # extract / window_* / spec_install), then telemetry while a
            # collector runs and checkpoint once one was written
            "phase_wall": {
                k: round(v, 4) for k, v in self.spans.totals.items()
                if (k != "telemetry" or self.telemetry is not None)
                and (k != "checkpoint" or v)},
            # fused device windows: zero here on a tpu_batch run means the
            # device never served a window — the host twin carried the
            # whole run. Wall-clock routing telemetry only: never
            # simulation state, so runs that differ here still produce
            # identical output trees.
            "device_windows_dispatched": self.engine.dev_windows,
            "device": self.engine.device_summary(),
            # device transport: wall-clock routing telemetry for the
            # columnar endpoint ticks; engaged = at least one cohort
            # advanced through the batched kernel
            **({} if devt is None else {
                "device_transport_engaged": devt.cohorts > 0,
                "device_transport": devt.summary(),
            }),
            # which host engine ran: the C engine (csrc/colcore.c) or the
            # Python columnar plane
            "native_colcore": self._c_core is not None,
            **({"fault_transitions_applied": self.faults.applied}
               if self.faults is not None else {}),
            # flow-latency percentiles + sample counts (telemetry/):
            # deterministic reductions of sim-time state, so not volatile
            **({"telemetry": self.telemetry.summary()}
               if self.telemetry is not None else {}),
        }
        if sp.on:
            sp.close()
        return summary


def _default_ip(host_id: int) -> str:
    # 11.0.0.0/8, sequential, skipping .0 and .255 host-octet edge cases
    n = host_id + 1
    a = 11 + (n >> 24)
    return f"{a}.{(n >> 16) & 0xFF}.{(n >> 8) & 0xFF}.{n & 0xFF}"
