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

With the C engine attached (``experimental.native_colcore``, the
default; network/colplane.py) the engine's ``run_round`` replaces the
scheduler's per-host loop and keeps the active-host set itself.

``device`` ("cuda" or "cpu") is where the data-plane kernels run (the
loss draws under tpu_batch, the mesh programs under tpu_mesh). The
reference's faults, telemetry, live plane, checkpoints, supervision,
sharding and managed processes are refused at config load
(config/schema.py::refuse_unported).
"""

from __future__ import annotations

from functools import partial

import time as _walltime  # detlint: ok(wallclock): phase_wall + heartbeat wall costs
from pathlib import Path

import numpy as np

from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.scheduler import make_scheduler
from shadow_tpu_torch.core.time import NS_PER_SEC, NS_PER_US, SimTime, T_NEVER, format_time
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.host.process import PluginProcess
from shadow_tpu_torch.network.colplane import ColumnarPlane
from shadow_tpu_torch.network.fluid import MTU, NetParams
from shadow_tpu_torch.network.graph import load_graph
from shadow_tpu_torch.utils.counters import Counters
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


class Controller:
    def __init__(self, cfg: ConfigOptions, mirror_log: bool = True,
                 device: str = "cuda") -> None:
        from shadow_tpu_torch.ops import devcfg

        devcfg.select_device(device)  # "cuda" without a card: fail now
        self.cfg = cfg
        self.device = device
        self.data_dir = Path(cfg.general.data_directory)
        self.log = SimLogger(cfg.general.log_level,
                             self.data_dir / "shadow.log",
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
        # active-host tracking: per-round work is O(hosts with pending
        # events), not O(all hosts). A host (re)activates on its queue's
        # empty->nonempty edge.
        self._active: set = set()  # host IDS (ints sort at C speed)
        # the tpu policies run the array-native columnar plane
        # (network/colplane.py): tpu_batch with its loss draws on the
        # device, tpu_mesh with each causal window's draws and arrival
        # exchange as one sharded program (parallel/mesh.py)
        backend = {"tpu_batch": "tpu", "tpu_mesh": "mesh"}[policy]
        self.engine = ColumnarPlane(
            self.graph, params, self.hosts, self.round_ns,
            backend=backend, tpu_options=cfg.experimental,
            bootstrap_end=cfg.general.bootstrap_end_time, device=device,
        )
        self.engine.activate = self._active.add
        for h in self.hosts:
            h.engine = self.engine
            h.equeue.on_first = partial(self._active.add, h.id)
        # C engine (csrc/colcore.c): owns the per-round host loop and
        # maintains the active set directly; activations route through it
        # so its sorted active-set snapshot merges new members
        # incrementally instead of re-snapshotting every round
        self._c_core = self.engine._c
        if self._c_core is not None:
            self._c_core.bind_active(self._active)
            act = self._c_core.activate
            self.engine.activate = act
            for h in self.hosts:
                h.equeue.on_first = partial(act, h.id)
        # experimental.device_transport (network/devtransport.py):
        # wall-clock policy only, every path is bit-identical; it stands
        # down when the C engine is attached
        self.engine.attach_devtransport(cfg.experimental, device)
        self.scheduler = make_scheduler(policy, self.hosts,
                                        cfg.general.parallelism)

        # processes: pyapp: plugins run in-process
        self.processes: list = []
        for host, hopts in zip(self.hosts, cfg.hosts):
            for i, popts in enumerate(hopts.processes):
                proc = PluginProcess(host, popts, i)
                host.processes.append(proc)
                self.processes.append(proc)
                host.schedule(popts.start_time, proc.spawn)
                if popts.shutdown_time is not None:
                    host.schedule(popts.shutdown_time, proc.shutdown)

        self.counters = Counters()
        self.rounds = 0
        self.events = 0
        self.wall_seconds = 0.0
        self._events_wall = 0.0  # scheduler.run_round wall (phase timing)
        #: determinism sentinel (checkpoint.py): digest every N rounds
        self.digest_every = cfg.general.state_digest_every
        #: set by the SIGINT/SIGTERM handler: the round loop finishes the
        #: current round and finalizes a valid partial summary instead of
        #: dying mid-round
        self._interrupt = None
        self._partial = False
        for w in cfg.warnings:
            self.log.warning(w)

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
    def run(self) -> dict:
        """Drive the simulation to stop_time and return the run summary."""
        cfg = self.cfg
        stop = cfg.general.stop_time
        w = self.round_ns
        now: SimTime = 0
        self.log.info(
            f"simulation starting: {len(self.hosts)} hosts, "
            f"{self.graph.n_nodes} graph nodes, round width {format_time(w)}, "
            f"policy {cfg.experimental.scheduler_policy} on {self.device}, "
            f"stop {format_time(stop)}"
        )
        hb_interval = cfg.general.heartbeat_interval
        next_hb = hb_interval if hb_interval else T_NEVER
        prog_step = max(stop // 100, 1)
        next_prog = prog_step if cfg.general.progress else T_NEVER
        dig = self.digest_every
        _ckpt = None
        if dig:
            from shadow_tpu_torch import checkpoint as _ckpt

            # a stale sentinel stream from a previous run into this
            # data_directory would concatenate and confuse
            # tools/bisect_divergence.py
            (self.data_dir / _ckpt.DIGEST_FILE).unlink(missing_ok=True)
        # graceful shutdown: SIGINT/SIGTERM finish the current round and
        # produce a valid partial summary (main thread only — signals
        # cannot be hooked elsewhere)
        import signal as _signal
        import threading as _threading

        self._partial = False
        self._interrupt = None
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
        t0 = _walltime.perf_counter()
        try:
            now = self._round_loop(now, stop, w, next_hb, hb_interval,
                                   next_prog, prog_step, dig, _ckpt, t0)
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
        _gc.collect()
        self.engine.flush_all()  # finalize counters for in-flight batches
        if cfg.general.progress:
            import sys as _sys

            print(file=_sys.stderr)  # end the \r status line
        self.wall_seconds = _walltime.perf_counter() - t0
        self.scheduler.shutdown()
        return self._finalize(min(now, stop))

    def _round_loop(self, now, stop, w, next_hb, hb_interval, next_prog,
                    prog_step, dig, _ckpt, t0) -> SimTime:
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
        devt = self.engine.devt
        while now < stop:
            if self._interrupt is not None:
                # graceful shutdown: the signal arrived during the last
                # round; stop at this (consistent) round boundary
                break
            if dyn:
                # widen to the smallest latency traffic has actually used
                # (never narrower than the static conservative window)
                w = max(self.round_ns,
                        min(self.engine.min_used_latency, 10 * self.round_ns))
            round_end = min(now + w, stop)
            self.engine.start_of_round(now, round_end)
            t_ev = _walltime.perf_counter()
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
            self._events_wall += _walltime.perf_counter() - t_ev
            self.engine.end_of_round(now, round_end)
            if devt is not None:
                executed += devt.take_executed()
            self.rounds += 1
            self.events += executed
            if dig and self.rounds % dig == 0:
                # determinism sentinel: canonical state digest at this
                # round boundary (flushes in-flight draws first — result-
                # identical, so digesting runs stay byte-identical)
                _ckpt.emit_digest(self, round_end)
            if round_end >= next_hb:
                self._heartbeat(round_end, t0)
                # grid-snap, not +=: skip-ahead can cross several
                # intervals at once
                next_hb = ((round_end // hb_interval) + 1) * hb_interval
            if round_end >= next_prog:
                self._progress(round_end, stop, t0)
                next_prog = round_end + prog_step
            if self.rounds >= next_gc:
                next_gc = self.rounds + _GC_EVERY_ROUNDS
                _gc.collect()
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
                    return min(nq, self.engine.pending_head())

                nt = _next_queued()
                while self.engine.earliest_outstanding() < nt:
                    self.engine.flush_due(nt)
                    nt = _next_queued()
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

    def _progress(self, sim_now: SimTime, stop: SimTime, t0: float) -> None:
        """Terminal status line (reference: the status bar, SURVEY.md §2)."""
        import sys as _sys

        wall = _walltime.perf_counter() - t0
        pct = 100 * sim_now // stop
        rate = (sim_now / NS_PER_SEC) / wall if wall > 0 else 0.0
        eta = (stop - sim_now) / NS_PER_SEC / rate if rate > 0 else 0.0
        print(f"\r[{pct:3d}%] sim {format_time(sim_now)} / "
              f"{format_time(stop)}  {rate:.2f} sim-s/s  eta {eta:.0f}s   ",
              end="", file=_sys.stderr, flush=True)

    def _heartbeat(self, sim_now: SimTime, t0: float) -> None:
        wall = _walltime.perf_counter() - t0
        rate = (sim_now / NS_PER_SEC) / wall if wall > 0 else 0.0
        # the device-window routing decision rides the heartbeat so a
        # silently clamped/starved device is visible mid-run
        note = self.engine.heartbeat_note
        self.log.info(
            f"heartbeat: sim {format_time(sim_now)} wall {wall:.1f}s "
            f"({rate:.2f} sim-sec/wall-sec) rounds {self.rounds} "
            f"events {self.events} units sent {self.engine.units_sent} "
            f"dropped {self.engine.units_dropped}"
            + f" {note()}"
        )

    def _finalize(self, end_time: SimTime) -> dict:
        errors = []
        for p in self.processes:
            err = p.check_final_state()
            if err is not None:
                errors.append(err)
                self.log.error(err)
        for h in self.hosts:
            h.fold_counters()
            self.counters.merge(h.counters)
        self.engine.close()  # join the device-attach thread before teardown
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
        self.data_dir.mkdir(parents=True, exist_ok=True)
        for h in self.hosts:
            h.flush_logs(self.data_dir)
        self.log.flush()
        import resource

        return {
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
            # extract / window_*)
            "phase_wall": {
                "events": round(self._events_wall, 4),
                **{k: round(v, 4)
                   for k, v in self.engine.phase_wall.items()},
            },
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
            **({} if self.engine.devt is None else {
                "device_transport_engaged": self.engine.devt.cohorts > 0,
                "device_transport": self.engine.devt.summary(),
            }),
            # which host engine ran: the C engine (csrc/colcore.c) or the
            # Python columnar plane
            "native_colcore": self._c_core is not None,
        }


def _default_ip(host_id: int) -> str:
    # 11.0.0.0/8, sequential, skipping .0 and .255 host-octet edge cases
    n = host_id + 1
    a = 11 + (n >> 24)
    return f"{a}.{(n >> 16) & 0xFF}.{(n >> 8) & 0xFF}.{n & 0xFF}"
