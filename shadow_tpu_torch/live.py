"""Live operations plane: streaming telemetry, runtime fault commands,
and time-travel debugging.

The port of shadow_tpu/live.py. The wire protocol (``PROTOCOL_VERSION``,
newline-framed JSON, the ``hello`` record) and the ``commands.jsonl`` line
format are the reference's byte for byte: a log written by either package
replays in the other, and either package's client talks to the other's
server. Two differences: ``LiveServer.close`` wakes its accept loop and
joins every serving thread within a bound (the reference closes the
listener under a thread that may sit in ``accept()``), and ``jump`` takes
the device the inspection run's kernels use (``--device``, default cuda).

Three capabilities over one AF_UNIX endpoint (``general.live_endpoint``):

* **Streaming** — a running sim (or sharded run, or fleet sweep)
  broadcasts newline-framed JSON records: heartbeats, raw
  ``metrics.jsonl``/``flows.jsonl`` lines as they are written, flow-group
  percentile snapshots, applied commands, and per-shard/per-seed status.
  ``tools/metrics_report.py --follow`` renders them live.  Supervised
  runs (``--supervise``, supervise.py) additionally publish
  ``{"type": "supervisor", "event": "restart", ...}`` records naming the
  failure, the restart attempt, and the checkpoint being resumed from;
  fleet sweeps publish ``seed_retry`` alongside ``seed_failed``.

* **Runtime fault commands** — clients send the ``faults:`` timeline
  verbs (``link_down``/``link_up``/``link_degrade``/``host_down``/
  ``host_up``) plus ``pause``/``resume``/``checkpoint_now``/``stop`` as
  JSON objects on the same socket.  Commands are validated through the
  config-grade parser, quantized to the NEXT round boundary (the same
  discipline as the config fault timeline), applied there, and appended
  to ``commands.jsonl`` in the run directory.  An interactively driven
  run replays byte-identically from config + command log via
  ``general.replay_commands`` / ``--replay-commands``.

* **Time travel** — ``python -m shadow_tpu_torch.live jump RUN_DIR --round R
  --config CFG`` restores the nearest single-process checkpoint strictly
  below round R, re-executes to R (determinism makes replay exact),
  recomputes the state digest, compares it against the recorded
  ``state_digests.jsonl`` entry, dumps host state, and optionally opens
  a REPL at that boundary.  ``--from-bisect`` consumes the JSON emitted
  by ``tools/bisect_divergence.py --json`` so "first divergent round"
  becomes "a shell AT that round".

Determinism contract: the endpoint itself is a pure wall-clock plane
(the DrawServer discipline — accept immediately, serve on niced
sibling threads, never block the sim thread; a slow or absent client
drops records, never stalls rounds).  The only way a client affects
simulation state is through the command path, which is quantized to
round boundaries and logged with sim timestamps — wall time never
leaks into simulation results.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import sys
import threading
import time as _walltime  # detlint: ok(wallclock): the live plane is pure wall-clock transport; commands only act at round boundaries via the logged sim timestamp
from pathlib import Path

#: Canonical command-log artifact in the run directory.
COMMANDS_FILE = "commands.jsonl"
#: Socket filename for ``general.live_endpoint: auto``.
SOCKET_NAME = "live.sock"
#: Framed-record protocol version (bumped on incompatible changes).
PROTOCOL_VERSION = 1
#: Control verbs (no fault payload; never materialize FaultActions).
CONTROL_KINDS = ("pause", "resume", "checkpoint_now", "stop")
#: All keys a command object may carry. ``_parse_fault_event`` silently
#: ignores unknown keys, so the whitelist check lives here: a typo'd
#: parameter must be refused, not dropped.
_COMMAND_KEYS = frozenset((
    "cmd", "src_nodes", "dst_nodes", "hosts",
    "latency_factor", "loss_add", "bandwidth_scale", "duration",
))
#: Per-client outbound bound. A reader this far behind loses the OLDEST
#: records (drop-oldest keeps the stream current and the sim unblocked).
MAX_QUEUE = 4096
#: AF_UNIX sun_path limit (about 108 bytes on Linux); refuse early with
#: a named error instead of a cryptic bind() failure.
_MAX_SOCKET_PATH = 100


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def resolve_endpoint(value, data_dir) -> str:
    """``auto`` means ``<data_dir>/live.sock``; anything else is a path."""
    if str(value) == "auto":
        return str(Path(data_dir) / SOCKET_NAME)
    return str(value)


def default_endpoint(path) -> str:
    """CLI convenience: a run directory means its ``live.sock``."""
    p = Path(path)
    if p.is_dir():
        return str(p / SOCKET_NAME)
    return str(p)


def command_log_path(data_dir) -> Path:
    return Path(data_dir) / COMMANDS_FILE


# ---------------------------------------------------------------------------
# Command validation + materialization
# ---------------------------------------------------------------------------

def normalize_command(payload) -> dict:
    """Validate one wire command and return its canonical dict.

    Fault verbs go through ``_parse_fault_event`` — the exact validator
    the config ``faults:`` timeline uses — so a live command can never
    express a fault the config language could not. The result is plain
    dict/list/str/int/float (JSON- and marshal-safe: it rides both the
    command log and the shard marker protocol).
    """
    from shadow_tpu_torch.config.schema import FAULT_KINDS, _parse_fault_event

    if not isinstance(payload, dict):
        raise ValueError(
            f"command must be a JSON object, got {type(payload).__name__}")
    kind = payload.get("cmd")
    if kind in CONTROL_KINDS:
        extra = sorted(set(payload) - {"cmd"})
        if extra:
            raise ValueError(f"command {kind!r} takes no parameters "
                             f"(got {extra})")
        return {"cmd": kind}
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"unknown command {kind!r} (want one of "
            f"{sorted(FAULT_KINDS) + list(CONTROL_KINDS)})")
    unknown = sorted(set(payload) - _COMMAND_KEYS)
    if unknown:
        raise ValueError(f"command {kind!r}: unknown keys {unknown}")
    e = {k: v for k, v in payload.items() if k != "cmd"}
    e["kind"] = kind
    e["time"] = 0  # commands take effect at the next round boundary
    ev = _parse_fault_event(e)
    out = {"cmd": kind}
    if ev.src_nodes:
        out["src_nodes"] = list(ev.src_nodes)
    if ev.dst_nodes:
        out["dst_nodes"] = list(ev.dst_nodes)
    if ev.hosts:
        out["hosts"] = list(ev.hosts)
    if kind == "link_degrade":
        out["latency_factor"] = float(ev.latency_factor)
        out["loss_add"] = float(ev.loss_add)
        out["bandwidth_scale"] = float(ev.bandwidth_scale)
    if ev.duration is not None:
        # canonical duration is an explicit-unit string: parse_time reads
        # a bare int as SECONDS (the config convention), so a ns integer
        # would not survive the log-load re-validation round trip
        out["duration"] = f"{int(ev.duration)} ns"
    return out


def materialize_command(controller, norm, t):
    """Turn a normalized fault command into ``FaultAction``s at sim time
    ``t`` (a round boundary) — the runtime mirror of
    ``faults.build_timeline``'s per-event block, including the paired
    end-action when ``duration`` is given."""
    from shadow_tpu_torch.faults import (FaultAction, _resolve_hosts,
                                         _resolve_nodes)

    kind = norm["cmd"]
    a = FaultAction(
        t=t, kind=kind,
        latency_factor=float(norm.get("latency_factor", 1.0)),
        loss_add=float(norm.get("loss_add", 0.0)),
        bandwidth_scale=float(norm.get("bandwidth_scale", 1.0)))
    if kind in ("link_down", "link_up", "link_degrade"):
        a.src = _resolve_nodes(norm.get("src_nodes") or [], controller.graph)
        a.dst = _resolve_nodes(norm.get("dst_nodes") or [], controller.graph,
                               all_but=a.src)
    else:
        # host lifecycle works for BOTH process models: pyapp plugins and
        # managed executables expose the same kill/spawn crash contract
        # (ManagedProcess.kill SIGKILLs + reaps the real guest; reboot
        # respawns a fresh instance, deterministically at the boundary)
        a.host_ids = _resolve_hosts(norm.get("hosts") or [],
                                    controller._by_name)
    acts = [a]
    dur = norm.get("duration")
    if dur is not None:
        from shadow_tpu_torch.core.time import parse_time

        end_kind = {"link_down": "link_up", "host_down": "host_up",
                    "link_degrade": "degrade_end"}[kind]
        acts.append(FaultAction(t=t + parse_time(dur), kind=end_kind,
                                src=a.src, dst=a.dst, host_ids=a.host_ids,
                                ref=a))
    return acts


def ensure_fault_injector(controller):
    """Lazily create the injector at the boundary where the FIRST
    runtime fault command lands.  A commandless live run keeps
    ``faults_active`` off and stays byte-identical to a detached run;
    flipping it here is deterministic because the live leg and its
    replay flip it at the same sim boundary (the counters it gates are
    plane-mirrored via ``Core_set_faults_active``)."""
    if controller.faults is not None:
        return controller.faults
    from shadow_tpu_torch.faults import FaultInjector

    controller.engine.faults_active = True
    for h in controller.hosts:
        h.faults_active = True
    core = getattr(controller, "_c_core", None)
    if core is not None:
        core.set_faults_active(True)
    controller.faults = FaultInjector(controller)
    if (controller.telemetry is not None
            and getattr(controller, "shard_id", 0) == 0):
        controller.faults.on_apply = controller.telemetry.record_fault
    return controller.faults


def apply_command(controller, norm, now):
    """Apply one normalized fault command at the boundary ``now``."""
    faults = ensure_fault_injector(controller)
    faults.insert_runtime(materialize_command(controller, norm, now))
    return faults


# ---------------------------------------------------------------------------
# Command log
# ---------------------------------------------------------------------------

def format_command_record(norm, seq, rnd, t, wall_only=False) -> str:
    """One canonical ``commands.jsonl`` line.  ``wall_only`` marks
    records (pause/resume) that never touch sim state — replay skips
    them, so a paused-and-resumed run and its replay write byte-equal
    fault/control entries."""
    rec = {"cmd": norm, "round": int(rnd), "seq": int(seq), "t": int(t)}
    if wall_only:
        rec["wall_only"] = True
    return _dumps(rec)


def append_command_lines(data_dir, lines) -> None:
    if not lines:
        return
    p = command_log_path(data_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write("\n".join(lines) + "\n")


def load_command_log(path):
    """Parse + re-validate a ``commands.jsonl``.  File order is
    application order; ``t`` (the boundary each command applied at)
    must be non-decreasing."""
    p = Path(path)
    recs = []
    with open(p) as f:
        for i, raw in enumerate(f):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except ValueError as exc:
                raise ValueError(f"{p}:{i + 1}: bad command record ({exc})")
            for k in ("cmd", "round", "seq", "t"):
                if k not in rec:
                    raise ValueError(
                        f"{p}:{i + 1}: command record missing {k!r}")
            rec["cmd"] = normalize_command(rec["cmd"])
            recs.append(rec)
    for a, b in zip(recs, recs[1:]):
        if b["t"] < a["t"]:
            raise ValueError(
                f"{p}: command log goes backwards in sim time "
                f"(seq {a['seq']} at t={a['t']} then seq {b['seq']} "
                f"at t={b['t']})")
    return recs


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _LiveClient:
    """One accepted connection: a reader thread (commands in) and a
    writer thread (records out) around a bounded drop-oldest queue."""

    def __init__(self, server, sock):
        self.server = server
        self.sock = sock
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._dropped = 0
        self._dead = False
        self._sending = False  # a batch left the queue, not yet sent
        self._threads = (
            threading.Thread(target=self._write_loop, daemon=True,
                             name="shadow-live-write"),
            threading.Thread(target=self._read_loop, daemon=True,
                             name="shadow-live-read"))
        for t in self._threads:
            t.start()

    def enqueue(self, line) -> None:
        with self._cond:
            if self._dead:
                return
            if len(self._queue) >= MAX_QUEUE:
                self._queue.popleft()
                self._dropped += 1
            self._queue.append(line)
            self._cond.notify()

    def flush(self, deadline) -> None:
        """Wait, until ``deadline`` at most, for every queued record to
        be SENT (a batch the writer took off the queue counts until its
        sendall returns: closing under it would cut the stream's tail,
        the end record included)."""
        while _walltime.monotonic() < deadline:
            with self._cond:
                if (not self._queue and not self._sending) or self._dead:
                    return
            _walltime.sleep(0.01)

    def _write_loop(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._queue and not self._dead:
                        self._cond.wait(timeout=1.0)
                    if self._dead and not self._queue:
                        return
                    batch = list(self._queue)
                    self._queue.clear()
                    self._sending = True
                self.sock.sendall(("\n".join(batch) + "\n").encode())
                with self._cond:
                    self._sending = False
        except OSError:
            pass
        finally:
            self._sending = False
            self.close()

    def _read_loop(self) -> None:
        buf = b""
        try:
            while True:
                chunk = self.sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._handle(line)
        except OSError:
            pass
        finally:
            self.close()

    def _handle(self, line) -> None:
        try:
            norm = normalize_command(json.loads(line))
            refused = self.server._refuse(norm)
            if refused:
                raise ValueError(refused)
        except ValueError as exc:
            self.enqueue(_dumps({"type": "error", "error": str(exc)}))
            return
        n = self.server._submit(norm)
        self.enqueue(_dumps({"type": "ack", "cmd": norm, "n": n}))

    def close(self) -> None:
        with self._cond:
            if self._dead:
                return
            self._dead = True
            self._cond.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the reader's recv
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._drop(self)

    def join(self, deadline) -> None:
        """Wait, until ``deadline`` at most, for both threads to end (a
        closed client's threads end within one queue wait)."""
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(max(0.0, deadline - _walltime.monotonic()))


class LiveServer:
    """AF_UNIX live endpoint.  The sim thread only ever calls
    :meth:`publish` / :meth:`publish_stream` (non-blocking broadcast)
    and :meth:`poll_commands` (drain validated commands); all socket
    work runs on niced daemon threads.

    ``refuse(norm) -> str | None`` lets the owner veto commands its
    topology cannot honor (sharded runs refuse pause/resume; fleet
    sweep endpoints are status-only).

    A bind that fails raises (OSError, or ValueError for a path past the
    AF_UNIX limit): a run asked for an endpoint never runs without one.
    :meth:`close` is idempotent and bounded: it wakes the accept loop
    (which polls its listener every ``_ACCEPT_POLL_S``), flushes and
    closes every client, and joins every serving thread, waiting
    ``_CLOSE_WAIT_S`` at most in all.
    """

    _ACCEPT_POLL_S = 0.2
    _CLOSE_WAIT_S = 2.0

    def __init__(self, address, log=None, refuse=None):
        self.address = str(address)
        if len(self.address.encode()) > _MAX_SOCKET_PATH:
            raise ValueError(
                f"live endpoint path exceeds the AF_UNIX limit "
                f"(~{_MAX_SOCKET_PATH} bytes): {self.address!r}")
        self._refuse_hook = refuse
        self._clients = []
        self._clients_lock = threading.Lock()
        self._cmd_cond = threading.Condition()
        self._commands = collections.deque()
        self._submitted = 0
        self._closing = False
        self._closed = False
        path = Path(self.address)
        if path.parent != Path("."):
            path.parent.mkdir(parents=True, exist_ok=True)
        if path.exists():
            path.unlink()  # stale socket from a previous run
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._listener.bind(self.address)
            self._listener.listen(8)
        except OSError:
            self._listener.close()
            raise
        # accept() wakes every _ACCEPT_POLL_S to see a close: closing a
        # listener under a thread blocked in accept() does not wake it
        self._listener.settimeout(self._ACCEPT_POLL_S)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="shadow-live-accept")
        self._accept_thread.start()
        if log is not None:
            log.info(f"live endpoint listening on {self.address}")

    def _accept_loop(self) -> None:
        try:
            # stay out of the sim thread's way (the DrawServer discipline)
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 5)
        except (AttributeError, OSError):
            pass
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setblocking(True)
            if self._closing:
                sock.close()
                return
            client = _LiveClient(self, sock)
            with self._clients_lock:
                self._clients.append(client)
            client.enqueue(_dumps({"type": "hello", "v": PROTOCOL_VERSION,
                                   "pid": os.getpid()}))

    # -- sim-thread API ---------------------------------------------------

    def publish(self, rec) -> None:
        """Broadcast one record to all connected clients; never blocks."""
        with self._clients_lock:
            clients = list(self._clients)
        if not clients:
            return
        line = _dumps(rec)
        for c in clients:
            c.enqueue(line)

    def publish_stream(self, name, lines) -> None:
        """Broadcast raw artifact lines (metrics.jsonl / flows.jsonl) as
        they are written, wrapped so followers can tee them verbatim."""
        with self._clients_lock:
            clients = list(self._clients)
        if not clients:
            return
        out = [_dumps({"type": "stream", "stream": name, "line": ln})
               for ln in lines]
        for c in clients:
            for line in out:
                c.enqueue(line)

    def poll_commands(self, timeout=0.0):
        """Drain all validated commands received so far (optionally
        waiting up to ``timeout`` wall seconds for the first one)."""
        with self._cmd_cond:
            if timeout and not self._commands:
                self._cmd_cond.wait(timeout)
            out = list(self._commands)
            self._commands.clear()
        return out

    # -- client-thread internals ------------------------------------------

    def _refuse(self, norm):
        if self._refuse_hook is not None:
            return self._refuse_hook(norm)
        return None

    def _submit(self, norm) -> int:
        with self._cmd_cond:
            self._commands.append(norm)
            self._submitted += 1
            n = self._submitted
            self._cmd_cond.notify_all()
        return n

    def _drop(self, client) -> None:
        with self._clients_lock:
            try:
                self._clients.remove(client)
            except ValueError:
                pass

    def close(self) -> None:
        """Stop accepting, flush and close every client, join every
        serving thread and remove the socket file; idempotent, and it
        waits ``_CLOSE_WAIT_S`` at most."""
        with self._clients_lock:
            if self._closed:
                return
            self._closed = True
        self._closing = True
        deadline = _walltime.monotonic() + self._CLOSE_WAIT_S
        # the accept loop sees _closing within one poll; joining it first
        # means no client is added after the snapshot below
        self._accept_thread.join(max(0.0, deadline - _walltime.monotonic()))
        try:
            self._listener.close()
        except OSError:
            pass
        with self._clients_lock:
            clients = list(self._clients)
        flush_by = min(deadline, _walltime.monotonic() + 1.0)
        for c in clients:
            c.flush(flush_by)
            c.close()
        for c in clients:
            c.join(deadline)
        try:
            Path(self.address).unlink()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Client helpers
# ---------------------------------------------------------------------------

def connect(address, timeout=10.0):
    """Connect to a live endpoint, retrying while the run binds it."""
    deadline = _walltime.monotonic() + timeout
    while True:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(str(address))
            return s
        except OSError:
            s.close()
            if _walltime.monotonic() >= deadline:
                raise
            _walltime.sleep(0.02)


def stream_records(address, timeout=10.0):
    """Yield parsed records from a live endpoint until it closes."""
    s = connect(address, timeout)
    buf = b""
    try:
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    yield json.loads(line)
    finally:
        s.close()


def send_command(address, payload, timeout=10.0):
    """Send one command and wait for its ``ack``/``error`` record
    (broadcast records interleave on the same socket and are skipped)."""
    s = connect(address, timeout)
    try:
        s.settimeout(timeout)
        s.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                raise OSError("live endpoint closed before acking")
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.get("type") in ("ack", "error"):
                    return rec
    finally:
        s.close()


# ---------------------------------------------------------------------------
# Time-travel debugging
# ---------------------------------------------------------------------------

def _jump_overrides(run_dir, inspect_dir) -> dict:
    """Volatile-key overrides for an inspection run: write nothing into
    the original run dir, bind no endpoint, force single-process, and
    replay the recorded command log if one exists."""
    over = {
        "general.data_directory": str(inspect_dir),
        "general.checkpoint_every": None,
        "general.checkpoint_dir": None,
        "general.state_digest_every": 0,
        "general.progress": False,
        "general.heartbeat_interval": None,
        "general.live_endpoint": None,
        "general.sim_shards": 1,
    }
    cl = command_log_path(run_dir)
    if cl.is_file():
        over["general.replay_commands"] = str(cl)
    return over


def _find_checkpoint(run_dir, target_round):
    """Newest single-process checkpoint strictly below ``target_round``
    (strict so the jump always re-executes >= 1 round and the digest is
    computed with the true round_end, matching the recorded stream).
    Sharded checkpoint sets are skipped — the jump re-executes from
    round 0 at shards=1 instead, which is byte-identical."""
    from shadow_tpu_torch import checkpoint as _ckpt

    best = None
    ckpt_dir = Path(run_dir) / "checkpoints"
    if not ckpt_dir.is_dir():
        return None
    for p in sorted(ckpt_dir.glob("ckpt_t*.ckpt")):
        if ".shard" in p.name:
            continue
        try:
            h = _ckpt.read_header(str(p))
        except Exception:
            continue
        if int(h.get("sim_shards", 1) or 1) != 1:
            continue
        r = int(h.get("rounds", 0))
        if r < target_round and (best is None or r > best[0]):
            best = (r, p)
    return best


def _digest_record(run_dir, rnd):
    p = Path(run_dir) / "state_digests.jsonl"
    if not p.is_file():
        return None
    with open(p) as f:
        for raw in f:
            raw = raw.strip()
            if raw:
                rec = json.loads(raw)
                if rec.get("round") == rnd:
                    return rec
    return None


def jump(run_dir, target_round, config_path, repl=False, inspect_dir=None,
         show_hosts=None, out=print, device: str = "cuda") -> int:
    """Restore the nearest checkpoint < ``target_round`` on ``device``,
    re-execute to it, verify the recomputed state digest against the
    recorded one, and dump (or REPL over) host state at that boundary.
    Returns 0 on digest match (or when no digest was recorded), 1 on
    mismatch."""
    from shadow_tpu_torch import checkpoint as _ckpt
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.telemetry.collector import host_columns

    run_dir = Path(run_dir)
    target_round = int(target_round)
    if target_round < 1:
        raise ValueError("--round must be >= 1")
    if inspect_dir is None:
        inspect_dir = run_dir / f"jump_r{target_round}"
    cfg = load_config(str(config_path), _jump_overrides(run_dir, inspect_dir))
    # a dotted override cannot REMOVE a section: silence telemetry on the
    # object (result-transparent — streams are volatile planes)
    cfg.telemetry = None

    best = _find_checkpoint(run_dir, target_round)
    if best is not None:
        ckpt_round, path = best
        ctl, resume_at = _ckpt.load_checkpoint(str(path), cfg,
                                               mirror_log=False,
                                               device=device)
        out(f"jump: restored {path.name} (round {ckpt_round}); "
            f"re-executing {target_round - ckpt_round} round(s)")
    else:
        ctl, resume_at = Controller(cfg, mirror_log=False,
                                    device=device), None
        out(f"jump: no single-process checkpoint below round "
            f"{target_round}; re-executing from round 0")

    state = {}

    def _at_round(controller, round_end):
        g, hosts = _ckpt.state_digest(controller, round_end)
        state.update(digest=g, hosts=hosts, t=round_end,
                     round=controller.rounds)
        rec = _digest_record(run_dir, controller.rounds)
        state["recorded"] = rec
        out(f"jump: at round {controller.rounds} (t={round_end} ns)")
        out(f"  state digest: {g}")
        if rec is None:
            out(f"  no recorded digest for round {controller.rounds} "
                f"in {run_dir / 'state_digests.jsonl'}")
        elif rec.get("digest") == g:
            out(f"  recorded digest: {rec['digest']}  [MATCH]")
        else:
            out(f"  recorded digest: {rec.get('digest')}  [MISMATCH]")
        names = list(show_hosts) if show_hosts else \
            sorted(h.name for h in controller.hosts)[:8]
        cols = host_columns(controller.hosts)
        by_name = {h.name: i for i, h in enumerate(controller.hosts)}
        for name in names:
            i = by_name.get(name)
            if i is None:
                out(f"  host {name!r}: not in this simulation")
                continue
            row = " ".join(f"{k}={v[i]}" for k, v in sorted(cols.items()))
            out(f"  host {name}: digest={hosts[name]} {row}")
        if repl:
            import code
            ns = {"controller": controller, "ctl": controller,
                  "hosts": controller.hosts, "by_name": by_name,
                  "digest": g, "host_digests": hosts, "columns": cols,
                  "round": controller.rounds, "t": round_end}
            code.interact(
                banner=(f"shadow_tpu_torch live jump: round "
                        f"{controller.rounds} "
                        f"(t={round_end} ns). Locals: "
                        f"{', '.join(sorted(ns))}. Ctrl-D resumes exit."),
                local=ns)

    ctl.stop_after_round = target_round
    ctl.on_stop_round = _at_round
    ctl.run(resume_at=resume_at)
    if "digest" not in state:
        raise ValueError(
            f"simulation ended at round {ctl.rounds}, before the "
            f"requested round {target_round}")
    rec = state["recorded"]
    if rec is not None and rec.get("digest") != state["digest"]:
        return 1
    return 0


# ---------------------------------------------------------------------------
# CLI: python -m shadow_tpu_torch.live {jump,send,tail}
# ---------------------------------------------------------------------------

def _read_bisect(src):
    raw = sys.stdin.read() if src == "-" else Path(src).read_text()
    rec = None
    for line in raw.splitlines():
        line = line.strip()
        if line.startswith("{"):
            rec = json.loads(line)
    if rec is None:
        raise ValueError(f"no JSON record found in bisect output {src!r}")
    return rec


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch.live",
        description="Live-operations client + time-travel debugger")
    sub = ap.add_subparsers(dest="op", required=True)

    j = sub.add_parser("jump", help="restore nearest checkpoint and "
                                    "re-execute to a round")
    j.add_argument("run_dir", help="original run's data directory")
    j.add_argument("--round", type=int, dest="round_", default=None,
                   help="target round (or use --from-bisect)")
    j.add_argument("--config", required=True,
                   help="the config the run was started from")
    j.add_argument("--from-bisect", default=None,
                   help="bisect_divergence --json output file, or - "
                        "for stdin")
    j.add_argument("--repl", action="store_true",
                   help="open an interactive shell at the target round")
    j.add_argument("--inspect-dir", default=None,
                   help="scratch data dir for the inspection run "
                        "(default: RUN_DIR/jump_rR)")
    j.add_argument("--hosts", default=None,
                   help="comma-separated host names to dump "
                        "(default: from bisect, else first 8)")
    j.add_argument("--device", default="cuda", metavar="DEVICE",
                   help="where the inspection run's kernels run: cuda "
                        "(default), cpu, or a comma list of entries such "
                        "as cuda:0,cuda:0; the checkpoint reattaches them "
                        "there")

    s = sub.add_parser("send", help="send one command, print the ack")
    s.add_argument("endpoint", help="socket path or run directory")
    s.add_argument("command", help='JSON object, e.g. '
                                   '\'{"cmd":"link_down","src_nodes":["3"]}\'')
    s.add_argument("--timeout", type=float, default=10.0,
                   help="seconds to wait for the run to bind and to ack "
                        "(default 10)")

    t = sub.add_parser("tail", help="stream records to stdout")
    t.add_argument("endpoint", help="socket path or run directory")
    t.add_argument("--max", type=int, default=0,
                   help="exit after N records (0 = until the run ends)")
    t.add_argument("--timeout", type=float, default=10.0,
                   help="seconds to wait for the run to bind (default 10)")

    args = ap.parse_args(argv)
    if args.op == "jump":
        target, hosts = args.round_, None
        if args.from_bisect is not None:
            rec = _read_bisect(args.from_bisect)
            if rec.get("kind") == "identical":
                print("bisect found no divergence; nothing to jump to")
                return 0
            target = rec.get("round") if target is None else target
            hosts = rec.get("hosts") or None
        if target is None:
            ap.error("jump needs --round or --from-bisect")
        if args.hosts:
            hosts = [h for h in args.hosts.split(",") if h]
        return jump(args.run_dir, target, args.config, repl=args.repl,
                    inspect_dir=args.inspect_dir, show_hosts=hosts,
                    device=args.device)
    if args.op == "send":
        rec = send_command(default_endpoint(args.endpoint),
                           json.loads(args.command), timeout=args.timeout)
        print(_dumps(rec))
        return 0 if rec.get("type") == "ack" else 1
    if args.op == "tail":
        n = 0
        for rec in stream_records(default_endpoint(args.endpoint),
                                  timeout=args.timeout):
            print(_dumps(rec), flush=True)
            n += 1
            if args.max and n >= args.max:
                break
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
