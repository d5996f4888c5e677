"""Shadow-compatible YAML configuration schema.

Mirrors the reference's config layer (SURVEY.md §1 layer 2, §5.6): a single
YAML file with ``general``, ``network``, ``experimental``, and ``hosts``
sections; every option overridable from the CLI. The new backend slots in as
``experimental.scheduler_policy: tpu_batch`` beside the reference's
``thread_per_core`` / ``thread_per_host`` policies (BASELINE.json north_star).

The port of shadow_tpu/config/schema.py: it reads every config the
reference reads, with the same keys, defaults and validation, and runs
every one of them.

Extensions over the reference schema (documented, all optional):
- ``hosts.<name>.quantity``: stamp out N numbered copies of a host template
  (``client`` -> ``client0..clientN-1``), for large generated benchmarks.
- process ``path`` may be ``pyapp:<module>:<Class>`` to run an in-process
  Python workload plugin instead of a real managed executable (real
  executables are the phase-4 native path, SURVEY.md §7).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from shadow_tpu_torch.core.time import SimTime, parse_time
from shadow_tpu_torch.utils.units import parse_bandwidth, parse_size

SCHEDULER_POLICIES = ("thread_per_core", "thread_per_host", "tpu_batch",
                      "tpu_mesh")
LOG_LEVELS = ("error", "warning", "info", "debug", "trace")
FAULT_KINDS = ("link_down", "link_up", "link_degrade", "host_down",
               "host_up")
#: congestion-control algorithms (network/transport.py
#: CONGESTION_CONTROLS keys, duplicated here so config validation does
#: not import the transport module)
CONGESTION_CONTROL_NAMES = ("newreno", "cubic")
#: the registered Python-twin workload models (process path
#: ``pyapp:<module>:<Class>``): every committed example and generated
#: benchmark draws from this roster. Paths into the
#: ``shadow_tpu_torch.models`` namespace are validated against it at parse
#: time (a typo'd model name fails at config load with the roster,
#: not at process spawn time mid-build); pyapp paths OUTSIDE the
#: namespace still load dynamically (user workloads stay free).
MODEL_REGISTRY = ("tgen", "gossip", "tor", "echo", "httpd", "web",
                  "dns", "abr")


@dataclass
class ProcessOptions:
    path: str
    args: list[str] = field(default_factory=list)
    environment: dict[str, str] = field(default_factory=dict)
    start_time: SimTime = 0
    shutdown_time: Optional[SimTime] = None
    shutdown_signal: str = "SIGTERM"
    expected_final_state: Any = None  # {"exited": 0} | "running" | None


@dataclass
class HostOptions:
    name: str
    network_node_id: int = 0
    ip_addr: Optional[str] = None
    bandwidth_up: Optional[int] = None  # bytes/sec; None -> graph node default
    bandwidth_down: Optional[int] = None
    log_level: Optional[str] = None
    pcap_enabled: bool = False
    pcap_capture_size: int = 65535
    #: per-host congestion-control override (None = the
    #: experimental.congestion_control default)
    congestion_control: Optional[str] = None
    processes: list[ProcessOptions] = field(default_factory=list)


@dataclass
class GeneralOptions:
    stop_time: SimTime = 0
    seed: int = 1
    parallelism: int = 0  # 0 = auto (ncores)
    bootstrap_end_time: SimTime = 0
    data_directory: str = "shadow.data"
    log_level: str = "info"
    heartbeat_interval: Optional[SimTime] = None
    progress: bool = False
    model_unblocked_syscall_latency: bool = False
    #: checkpoint/restore (shadow_tpu/checkpoint.py): snapshot the complete
    #: simulation state every this much SIM time, at a round boundary.
    #: None = off. Resumed runs are byte-identical to uninterrupted ones.
    checkpoint_every: Optional[SimTime] = None
    #: where checkpoints land; default <data_directory>/checkpoints
    checkpoint_dir: Optional[str] = None
    #: determinism sentinel: emit a canonical per-round state digest every
    #: N rounds to <data_directory>/state_digests.jsonl (0 = off). Streams
    #: are comparable across scheduler policies and data planes; diff two
    #: with tools/bisect_divergence.py.
    state_digest_every: int = 0
    #: multi-process host partitioning (shadow_tpu/parallel/shards.py):
    #: partition the host set across N worker processes (static id-modulo
    #: placement), each running its own scheduler + engine over its
    #: subset, coordinated by a parent running the conservative
    #: min-latency lookahead barrier across shards. Results are
    #: byte-identical at ANY shard count (tests/test_shards.py); 1 = the
    #: single-process controller, unchanged.
    sim_shards: int = 1
    #: live operations plane (shadow_tpu/live.py): bind an AF_UNIX live
    #: endpoint streaming heartbeats/metrics/flow snapshots and accepting
    #: runtime fault commands. "auto" = <data_directory>/live.sock.
    #: Volatile: a pure wall-clock plane with zero effect on results
    #: (commands act only via the recorded commands.jsonl).
    live_endpoint: Optional[str] = None
    #: replay a recorded commands.jsonl: each command re-applies at the
    #: same round boundary it originally hit, so an interactively driven
    #: run replays byte-identically from config + command log. Volatile.
    replay_commands: Optional[str] = None
    #: supervised self-healing (shadow_tpu/supervise.py): run under a
    #: supervisor that detects dead/wedged workers and stalled guests,
    #: auto-resumes from the newest complete checkpoint with a bounded
    #: restart budget, and writes crash_report.json when the budget is
    #: exhausted. ``{}`` / ``true`` = defaults (max_restarts 3, backoff
    #: 1.0 s); None = off. Volatile: pure wall-clock policy — a
    #: recovered run is byte-identical to an uninterrupted one.
    supervise: Optional[dict] = None


@dataclass
class ExperimentalOptions:
    scheduler_policy: str = "thread_per_core"
    runahead: Optional[SimTime] = None  # explicit round width override
    use_dynamic_runahead: bool = False
    socket_send_buffer: int = 131072
    socket_recv_buffer: int = 174760
    strace_logging_mode: str = "off"  # off | standard | deterministic
    #: reality-boundary audit for managed processes: the shim traps EVERY
    #: guest syscall (gadget-IP seccomp filter), counts the unemulated
    #: numbers it passes through natively, and the summary reports them.
    #: Diagnostic mode: adds a trap per native syscall (execve works —
    #: the worker-mediated respawn gives the new image fresh filters).
    native_audit: bool = False
    interface_qdisc: str = "fifo"
    max_unapplied_cpu_latency: SimTime = 0
    #: fluid quantum width in MTUs (1..64). Wider units mean fewer events
    #: per byte (faster at scale) at coarser loss/scheduling granularity;
    #: congestion control is byte-counted, so dynamics are size-invariant.
    unit_mtus: int = 10
    # tpu_batch knobs (ours):
    tpu_max_batch: int = 65536  # max units per device draw dispatch
    tpu_device_floor: int = 0  # min batch to engage device; 0=calibrate, -1=off
    #: fused multi-round device windows (network/devroute.py): how many
    #: rounds of loss-draw batches may fuse into ONE device dispatch.
    #: "auto" (stored as 0) sizes windows from live break-even telemetry
    #: and enables speculative forward windows under the C engine; K >= 1
    #: closes the deferred window after K rounds (K=1 = legacy per-round
    #: dispatch). Routing is pure wall-clock policy: results are
    #: bit-identical for every K (tests/test_device_windows.py).
    device_window_rounds: int = 0
    tpu_mesh_shards: int = 0  # 0 = all local devices
    #: tpu_mesh: min due-window units for the collective program; smaller
    #: windows take the bit-identical numpy twin
    tpu_mesh_floor: int = 2048
    #: C engine for the columnar plane (csrc/colcore.c, built with the C
    #: compiler at first use by shadow_tpu_torch/native). Bit-identical to
    #: the Python paths; off forces the pure-Python twin (test oracle).
    native_colcore: bool = True
    #: device-resident columnar transport (network/devtransport.py):
    #: ack-dominated host rounds defer to the barrier and whole cohorts
    #: of endpoints advance through ONE batched integer kernel
    #: (ops/transport_kernels.py) instead of per-ack scalar callbacks.
    #: Bit-identical on/off (tests/test_devtransport.py); engagement is
    #: pure wall-clock policy with break-even hysteresis, so the default
    #: stays off and a losing box measures it as a no-op. No-op with the
    #: C engine attached (colcore is the scalar fast path) and on the
    #: thread policies (per-unit plane).
    device_transport: bool = False
    #: stream loss recovery: "sack" — RFC 2018-shaped block recovery over
    #: the 3-duplicate-ack trigger (receiver reports its buffered ranges
    #: on every out-of-order ack; the sender retransmits ALL holes per
    #: RTT), the only model. The older one-retransmit-per-RTT "dupack"
    #: model and the engine-notification oracle are retired; selecting
    #: either is a config error that names the removal. The knob survives
    #: so configs stay explicit about which recovery model produced their
    #: results.
    stream_loss_recovery: str = "sack"
    #: congestion control for stream endpoints: "newreno" (RFC 5681
    #: slow start + AIMD, the extracted default) or "cubic" (integer
    #: CUBIC-shaped variant). Overridable per host via
    #: hosts.<name>.congestion_control — both run bit-identically on the
    #: Python and C endpoint twins (network/transport.py
    #: CongestionControl).
    congestion_control: str = "newreno"
    #: guest watchdog (native/managed.py): wall-clock seconds a managed
    #: process may hold its turn without making a syscall before it is
    #: killed and converted to a host_down fault (0 = off). Catches the
    #: spin-wait livelock README declares as a limitation, instead of
    #: hanging the whole simulator.
    guest_turn_timeout: float = 0.0


@dataclass
class FaultEventOptions:
    """One entry of the ``faults.events`` timeline (shadow_tpu/faults.py)."""

    time: SimTime
    kind: str  # one of FAULT_KINDS
    src_nodes: list[int] = field(default_factory=list)  # GML node ids
    dst_nodes: list[int] = field(default_factory=list)  # empty = all others
    hosts: list[str] = field(default_factory=list)  # names; trailing * globs
    latency_factor: float = 1.0  # link_degrade: multiplies path latency
    loss_add: float = 0.0  # link_degrade: added loss probability
    bandwidth_scale: float = 1.0  # link_degrade: scales attached-host NICs
    duration: Optional[SimTime] = None  # auto-heal/restore after this long


@dataclass
class ChurnOptions:
    """Seeded random up/down cycling for a set of hosts: alternating
    exponential uptime/downtime draws from the counter-based fault RNG
    (core/rng.py::fault_rng), materialized once at startup."""

    hosts: list[str]
    mean_uptime: SimTime
    mean_downtime: SimTime
    start_time: SimTime = 0


@dataclass
class FaultsOptions:
    events: list[FaultEventOptions] = field(default_factory=list)
    churn: list[ChurnOptions] = field(default_factory=list)


@dataclass
class TelemetryOptions:
    """The ``telemetry:`` section (shadow_tpu/telemetry/): sim-time
    samplers + flow records + streaming percentiles, exported as
    append-only ``metrics.jsonl`` / ``flows.jsonl``. Presence of the
    section enables collection; sampling cadence is simulated time, so
    the streams are byte-identical across scheduler policies, data
    planes, and the Python/C twins. Telemetry is result-transparent
    (never simulation state), so it is NOT part of the checkpoint config
    digest — a resume may change it like other volatile keys."""

    #: snapshot per-host/per-NIC state every this much SIM time, at the
    #: first round boundary past each grid point (the 10s default keeps
    #: telemetry within its <=5% wall budget on the tgen_1k bench row —
    #: BENCH_DETAIL telemetry_overhead; dense series want an explicit
    #: sample_every)
    sample_every: SimTime = 10_000_000_000  # 10s
    #: where metrics.jsonl/flows.jsonl land; None = data_directory
    metrics_dir: Optional[str] = None


@dataclass
class ConfigOptions:
    general: GeneralOptions = field(default_factory=GeneralOptions)
    network: dict = field(default_factory=lambda: {"graph": {"type": "1_gbit_switch"}})
    experimental: ExperimentalOptions = field(default_factory=ExperimentalOptions)
    hosts: list[HostOptions] = field(default_factory=list)
    faults: Optional[FaultsOptions] = None
    telemetry: Optional[TelemetryOptions] = None
    #: accepted-but-unimplemented options the user actually set; the
    #: controller logs each (silently ignoring a knob is a correctness trap)
    warnings: list[str] = field(default_factory=list)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"config error: {msg}")


def _parse_process(p: dict) -> ProcessOptions:
    _require(isinstance(p, dict), f"process entry must be a mapping, got {p!r}")
    _require("path" in p, f"process entry missing 'path': {p!r}")
    args = p.get("args", [])
    if isinstance(args, str):
        args = args.split()
    env = p.get("environment", {}) or {}
    _require(isinstance(env, dict), "process environment must be a mapping")
    opts = ProcessOptions(
        path=str(p["path"]),
        args=[str(a) for a in args],
        environment={str(k): str(v) for k, v in env.items()},
        start_time=parse_time(p.get("start_time", 0)),
        shutdown_time=(parse_time(p["shutdown_time"]) if p.get("shutdown_time") is not None else None),
        shutdown_signal=str(p.get("shutdown_signal", "SIGTERM")),
        expected_final_state=p.get("expected_final_state"),
    )
    _require(opts.start_time >= 0, f"process start_time must be >= 0: {p!r}")
    _require(
        opts.shutdown_time is None or opts.shutdown_time > opts.start_time,
        f"process shutdown_time must be after start_time: {p!r}",
    )
    if opts.path.startswith("pyapp:shadow_tpu_torch.models."):
        parts = opts.path.split(":")
        _require(len(parts) == 3,
                 f"bad pyapp path {opts.path!r} (want pyapp:module:Class)")
        mod = parts[1]
        _require(mod.removeprefix("shadow_tpu_torch.models.") in MODEL_REGISTRY,
                 f"unknown workload model {mod!r} "
                 f"(registered: {sorted(MODEL_REGISTRY)})")
    return opts


def _parse_host(name: str, h: dict) -> HostOptions:
    _require(isinstance(h, dict), f"host {name!r} must be a mapping")
    opts = HostOptions(name=name)
    opts.network_node_id = int(h.get("network_node_id", 0))
    opts.ip_addr = h.get("ip_addr")
    if h.get("bandwidth_up") is not None:
        opts.bandwidth_up = parse_bandwidth(h["bandwidth_up"])
        _require(opts.bandwidth_up > 0, f"host {name!r} bandwidth_up must be > 0")
    if h.get("bandwidth_down") is not None:
        opts.bandwidth_down = parse_bandwidth(h["bandwidth_down"])
        _require(opts.bandwidth_down > 0, f"host {name!r} bandwidth_down must be > 0")
    if h.get("log_level") is not None:
        opts.log_level = str(h["log_level"]).lower()
        _require(opts.log_level in LOG_LEVELS, f"bad log_level {opts.log_level!r}")
    opts.pcap_enabled = bool(h.get("pcap_enabled", False))
    opts.pcap_capture_size = parse_size(h.get("pcap_capture_size", 65535))
    if h.get("congestion_control") is not None:
        opts.congestion_control = str(h["congestion_control"])
        _require(opts.congestion_control in CONGESTION_CONTROL_NAMES,
                 f"host {name!r} congestion_control must be one of "
                 f"{CONGESTION_CONTROL_NAMES}, got "
                 f"{opts.congestion_control!r}")
    procs = h.get("processes", [])
    _require(isinstance(procs, list), f"host {name!r} processes must be a list")
    opts.processes = [_parse_process(p) for p in procs]
    return opts


def _parse_fault_event(e: dict) -> FaultEventOptions:
    _require(isinstance(e, dict), f"faults.events entry must be a mapping: {e!r}")
    _require("time" in e and "kind" in e,
             f"faults.events entry needs 'time' and 'kind': {e!r}")
    kind = str(e["kind"])
    _require(kind in FAULT_KINDS,
             f"faults.events kind must be one of {FAULT_KINDS}, got {kind!r}")
    ev = FaultEventOptions(time=parse_time(e["time"]), kind=kind)
    _require(ev.time >= 0, f"faults.events time must be >= 0: {e!r}")
    ev.src_nodes = [int(n) for n in (e.get("src_nodes") or [])]
    ev.dst_nodes = [int(n) for n in (e.get("dst_nodes") or [])]
    ev.hosts = [str(h) for h in (e.get("hosts") or [])]
    if kind in ("link_down", "link_up", "link_degrade"):
        _require(len(ev.src_nodes) > 0,
                 f"faults {kind} needs src_nodes: {e!r}")
        _require(not ev.hosts, f"faults {kind} takes nodes, not hosts: {e!r}")
    else:
        _require(len(ev.hosts) > 0, f"faults {kind} needs hosts: {e!r}")
        _require(not ev.src_nodes and not ev.dst_nodes,
                 f"faults {kind} takes hosts, not nodes: {e!r}")
    if kind == "link_degrade":
        ev.latency_factor = float(e.get("latency_factor", 1.0))
        ev.loss_add = float(e.get("loss_add", 0.0))
        ev.bandwidth_scale = float(e.get("bandwidth_scale", 1.0))
        _require(1.0 <= ev.latency_factor <= 1e6,
                 f"latency_factor must be in [1, 1e6]: {e!r}")
        _require(0.0 <= ev.loss_add <= 1.0,
                 f"loss_add must be in [0, 1]: {e!r}")
        _require(0.0 < ev.bandwidth_scale <= 1.0,
                 f"bandwidth_scale must be in (0, 1]: {e!r}")
        _require(ev.latency_factor != 1.0 or ev.loss_add != 0.0
                 or ev.bandwidth_scale != 1.0,
                 f"link_degrade with no effect: {e!r}")
    else:
        for k in ("latency_factor", "loss_add", "bandwidth_scale"):
            _require(k not in e, f"faults {kind} does not take {k}: {e!r}")
    if e.get("duration") is not None:
        _require(kind in ("link_down", "link_degrade", "host_down"),
                 f"faults {kind} does not take a duration: {e!r}")
        ev.duration = parse_time(e["duration"])
        _require(ev.duration > 0, f"faults duration must be > 0: {e!r}")
    return ev


def _parse_churn(c: dict) -> ChurnOptions:
    _require(isinstance(c, dict), f"faults.churn entry must be a mapping: {c!r}")
    for k in ("hosts", "mean_uptime", "mean_downtime"):
        _require(k in c, f"faults.churn entry needs {k!r}: {c!r}")
    opts = ChurnOptions(
        hosts=[str(h) for h in (c["hosts"] or [])],
        mean_uptime=parse_time(c["mean_uptime"]),
        mean_downtime=parse_time(c["mean_downtime"]),
        start_time=parse_time(c.get("start_time", 0)),
    )
    _require(len(opts.hosts) > 0, f"faults.churn needs hosts: {c!r}")
    _require(opts.mean_uptime > 0 and opts.mean_downtime > 0,
             f"faults.churn means must be > 0: {c!r}")
    _require(opts.start_time >= 0, f"faults.churn start_time must be >= 0: {c!r}")
    return opts


def _parse_faults(doc: dict) -> FaultsOptions:
    _require(isinstance(doc, dict), "faults must be a mapping")
    for k in doc:
        _require(k in ("events", "churn"),
                 f"unknown faults key {k!r} (want events/churn)")
    f = FaultsOptions()
    events = doc.get("events") or []
    _require(isinstance(events, list), "faults.events must be a list")
    f.events = [_parse_fault_event(e) for e in events]
    churn = doc.get("churn") or []
    _require(isinstance(churn, list), "faults.churn must be a list")
    f.churn = [_parse_churn(c) for c in churn]
    _require(f.events or f.churn, "faults section is present but empty")
    return f


def _parse_telemetry(doc) -> TelemetryOptions:
    """``telemetry:`` — a bare key (None) enables with defaults, which is
    what the CLI's --sample-every/--metrics-dir overrides rely on."""
    t = TelemetryOptions()
    if doc is None:
        return t
    _require(isinstance(doc, dict), "telemetry must be a mapping")
    for k in doc:
        _require(k in ("sample_every", "metrics_dir"),
                 f"unknown telemetry key {k!r} (want sample_every/"
                 f"metrics_dir)")
    if doc.get("sample_every") is not None:
        t.sample_every = parse_time(doc["sample_every"])
        _require(t.sample_every > 0, "telemetry.sample_every must be > 0")
    if doc.get("metrics_dir") is not None:
        t.metrics_dir = str(doc["metrics_dir"])
    return t


def parse_config(doc: dict, overrides: Optional[dict] = None) -> ConfigOptions:
    """Parse a loaded YAML document (plus dotted-key CLI overrides) into
    validated ConfigOptions.

    ``overrides`` maps dotted paths to raw values, e.g.
    ``{"general.stop_time": "30s", "experimental.scheduler_policy": "tpu_batch"}``.
    """
    doc = copy.deepcopy(doc) if doc else {}
    _require(isinstance(doc, dict), "top-level config must be a mapping")
    for key, val in (overrides or {}).items():
        parts = key.split(".")
        cur = doc
        for p in parts[:-1]:
            nxt = cur.setdefault(p, {})
            if nxt is None:
                # a bare section key (`telemetry:` / `faults:` with no
                # body) parses as None; a dotted override into it means
                # "that section, with this key set"
                nxt = cur[p] = {}
            cur = nxt
            _require(isinstance(cur, dict), f"cannot override {key!r}")
        cur[parts[-1]] = val

    cfg = ConfigOptions()

    gen = doc.get("general", {}) or {}
    _require("stop_time" in gen, "general.stop_time is required")
    g = cfg.general
    g.stop_time = parse_time(gen["stop_time"])
    _require(g.stop_time > 0, "general.stop_time must be > 0")
    g.seed = int(gen.get("seed", 1))
    _require(0 <= g.seed < (1 << 63), "general.seed must be in [0, 2**63)")
    g.parallelism = int(gen.get("parallelism", 0))
    _require(g.parallelism >= 0, "general.parallelism must be >= 0")
    g.bootstrap_end_time = parse_time(gen.get("bootstrap_end_time", 0))
    _require(g.bootstrap_end_time >= 0, "general.bootstrap_end_time must be >= 0")
    g.data_directory = str(gen.get("data_directory", "shadow.data"))
    g.log_level = str(gen.get("log_level", "info")).lower()
    _require(g.log_level in LOG_LEVELS, f"bad general.log_level {g.log_level!r}")
    if gen.get("heartbeat_interval") is not None:
        g.heartbeat_interval = parse_time(gen["heartbeat_interval"])
        _require(g.heartbeat_interval > 0, "general.heartbeat_interval must be > 0")
    g.progress = bool(gen.get("progress", False))
    g.model_unblocked_syscall_latency = bool(gen.get("model_unblocked_syscall_latency", False))
    if gen.get("checkpoint_every") is not None:
        g.checkpoint_every = parse_time(gen["checkpoint_every"])
        _require(g.checkpoint_every > 0,
                 "general.checkpoint_every must be > 0")
    if gen.get("checkpoint_dir") is not None:
        g.checkpoint_dir = str(gen["checkpoint_dir"])
    g.state_digest_every = int(gen.get("state_digest_every", 0))
    _require(g.state_digest_every >= 0,
             "general.state_digest_every must be >= 0")
    g.sim_shards = int(gen.get("sim_shards", 1))
    _require(1 <= g.sim_shards <= 64,
             "general.sim_shards must be in [1, 64]")
    if gen.get("live_endpoint") is not None:
        g.live_endpoint = str(gen["live_endpoint"])
        _require(bool(g.live_endpoint),
                 "general.live_endpoint must be a socket path or 'auto'")
    if gen.get("replay_commands") is not None:
        g.replay_commands = str(gen["replay_commands"])
    if gen.get("supervise") is not None:
        sup = gen["supervise"]
        if sup is True:
            sup = {}
        elif sup is False:
            sup = None
        if sup is not None:
            _require(isinstance(sup, dict),
                     "general.supervise must be a mapping (or true/false)")
            unknown = set(sup) - {"max_restarts", "backoff"}
            _require(not unknown,
                     f"unknown general.supervise key(s) {sorted(unknown)}; "
                     f"known: max_restarts, backoff")
            sup = {"max_restarts": int(sup.get("max_restarts", 3)),
                   "backoff": float(sup.get("backoff", 1.0))}
            _require(sup["max_restarts"] >= 0,
                     "general.supervise.max_restarts must be >= 0")
            _require(sup["backoff"] >= 0,
                     "general.supervise.backoff must be >= 0")
        g.supervise = sup

    if doc.get("network"):
        cfg.network = doc["network"]
    _require("graph" in cfg.network, "network.graph is required")

    exp = doc.get("experimental", {}) or {}
    e = cfg.experimental
    e.scheduler_policy = str(exp.get("scheduler_policy", "thread_per_core"))
    _require(
        e.scheduler_policy in SCHEDULER_POLICIES,
        f"scheduler_policy must be one of {SCHEDULER_POLICIES}, got {e.scheduler_policy!r}",
    )
    if exp.get("runahead") is not None:
        e.runahead = parse_time(exp["runahead"])
        _require(e.runahead > 0, "experimental.runahead must be > 0")
    e.use_dynamic_runahead = bool(exp.get("use_dynamic_runahead", False))
    e.socket_send_buffer = parse_size(exp.get("socket_send_buffer", e.socket_send_buffer))
    e.socket_recv_buffer = parse_size(exp.get("socket_recv_buffer", e.socket_recv_buffer))
    e.strace_logging_mode = str(exp.get("strace_logging_mode", "off"))
    e.native_audit = bool(exp.get("native_audit", False))
    e.interface_qdisc = str(exp.get("interface_qdisc", "fifo"))
    e.max_unapplied_cpu_latency = parse_time(exp.get("max_unapplied_cpu_latency", 0))
    _require(e.max_unapplied_cpu_latency >= 0,
             "experimental.max_unapplied_cpu_latency must be >= 0")
    _require(e.interface_qdisc in ("fifo", "round_robin"),
             f"experimental.interface_qdisc must be fifo or round_robin, "
             f"got {e.interface_qdisc!r}")
    e.unit_mtus = int(exp.get("unit_mtus", 10))
    _require(1 <= e.unit_mtus <= 64,
             "experimental.unit_mtus must be in [1, 64]")
    e.tpu_max_batch = int(exp.get("tpu_max_batch", 65536))
    e.tpu_device_floor = int(exp.get("tpu_device_floor", 0))
    dwr = exp.get("device_window_rounds", "auto")
    if str(dwr).lower() == "auto":
        e.device_window_rounds = 0  # internal sentinel for auto
    else:
        e.device_window_rounds = int(dwr)
        _require(e.device_window_rounds >= 1,
                 "experimental.device_window_rounds must be >= 1 or 'auto'")
    e.tpu_mesh_shards = int(exp.get("tpu_mesh_shards", 0))
    e.tpu_mesh_floor = int(exp.get("tpu_mesh_floor", 2048))
    e.native_colcore = bool(exp.get("native_colcore", True))
    e.device_transport = bool(exp.get("device_transport", False))
    e.stream_loss_recovery = str(exp.get("stream_loss_recovery", "sack"))
    _require(e.stream_loss_recovery == "sack",
             "experimental.stream_loss_recovery must be sack (SACK-style "
             "block recovery replaced the one-retransmit-per-RTT dupack "
             "model; the engine-notification oracle was removed per "
             "COMPONENTS.md #13), "
             f"got {e.stream_loss_recovery!r}")
    e.congestion_control = str(exp.get("congestion_control", "newreno"))
    _require(e.congestion_control in CONGESTION_CONTROL_NAMES,
             f"experimental.congestion_control must be one of "
             f"{CONGESTION_CONTROL_NAMES}, got {e.congestion_control!r}")
    e.guest_turn_timeout = float(exp.get("guest_turn_timeout", 0.0))
    _require(e.guest_turn_timeout >= 0,
             "experimental.guest_turn_timeout must be >= 0")

    if "telemetry" in doc:  # bare `telemetry:` enables with defaults
        cfg.telemetry = _parse_telemetry(doc["telemetry"])

    if doc.get("faults") is not None:  # `faults:` left empty = absent
        cfg.faults = _parse_faults(doc["faults"])

    hosts_doc = doc.get("hosts", {}) or {}
    _require(isinstance(hosts_doc, dict), "hosts must be a mapping of name -> options")
    _require(len(hosts_doc) > 0, "at least one host is required")
    for name in hosts_doc:  # dict preserves YAML order -> deterministic host ids
        h = hosts_doc[name] or {}
        qty = int(h.pop("quantity", 1)) if isinstance(h, dict) else 1
        # quantity templates may cycle placement: copy i lands on
        # network_node_ids[i % len] — what keeps a 1M-host generated
        # config (examples/tor_1m.yaml) at O(templates) YAML instead of
        # one stanza per host while still spreading a contiguous-named
        # population (relay0..relayN-1) across the whole graph
        node_cycle = h.pop("network_node_ids", None) \
            if isinstance(h, dict) else None
        if node_cycle is not None:
            _require(isinstance(node_cycle, list) and len(node_cycle) > 0,
                     f"host {name!r} network_node_ids must be a non-empty "
                     f"list")
        if qty == 1 and node_cycle is None:
            cfg.hosts.append(_parse_host(str(name), h))
        else:
            _require(qty >= 1, f"host {name!r} quantity must be >= 1")
            for i in range(qty):
                ho = _parse_host(f"{name}{i}", h)
                if node_cycle is not None:
                    ho.network_node_id = int(node_cycle[i % len(node_cycle)])
                cfg.hosts.append(ho)
    names = [h.name for h in cfg.hosts]
    _require(len(set(names)) == len(names), "duplicate host names after expansion")
    return cfg


#: composed-YAML memo for load_yaml_doc(cache=True): a fleet worker runs
#: many seeds of ONE config in one interpreter, and composing a
#: multi-hundred-host document costs ~1.7 s (tor_400) — by far the
#: biggest per-seed fixed cost once the round loop is subsecond. Keyed
#: on (abspath, mtime_ns, size) so an edited file re-parses.
_DOC_CACHE: dict = {}


def load_yaml_doc(path: str, cache: bool = False) -> dict:
    """Read + compose the YAML document at ``path``. ``cache=True``
    memoizes the composed doc (callers must not mutate it —
    parse_config deep-copies before applying overrides)."""
    import os

    if not cache:
        with open(path, "r") as f:
            return yaml.safe_load(f)
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    doc = _DOC_CACHE.get(key)
    if doc is None:
        with open(path, "r") as f:
            doc = yaml.safe_load(f)
        _DOC_CACHE.clear()  # one config per process is the fleet shape
        _DOC_CACHE[key] = doc
    return doc


def load_config(path: str, overrides: Optional[dict] = None,
                cache_doc: bool = False) -> ConfigOptions:
    import os

    doc = load_yaml_doc(path, cache=cache_doc)
    cfg = parse_config(doc, overrides)
    # a network.graph file reference resolves relative to the CONFIG file
    # (the reference convention; lets committed configs carry committed
    # topology fixtures)
    g = cfg.network.get("graph", {})
    f = g.get("file")
    fpath = f.get("path") if isinstance(f, dict) else f
    if fpath and not os.path.isabs(fpath):
        resolved = os.path.join(os.path.dirname(os.path.abspath(path)),
                                fpath)
        if os.path.exists(resolved):
            if isinstance(f, dict):
                f["path"] = resolved
            else:
                g["file"] = resolved
    # process binary paths resolve the same way (managed processes spawn
    # with cwd inside the data directory, so a committed config's
    # relative "native/build/foo" would otherwise depend on the caller's
    # cwd). First try relative to the config file, then the caller's cwd;
    # pyapp: entries and absolute paths pass through untouched.
    for h in cfg.hosts:
        for p in h.processes:
            if p.path.startswith("pyapp:") or os.path.isabs(p.path):
                continue
            for base in (os.path.dirname(os.path.abspath(path)),
                         os.getcwd()):
                resolved = os.path.join(base, p.path)
                if os.path.exists(resolved):
                    p.path = resolved
                    break
    return cfg
