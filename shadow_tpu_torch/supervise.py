"""Supervised self-healing runs: liveness, automatic recovery, chaos.

The port of shadow_tpu/supervise.py. The participants are the shard
workers of parallel/shards.py, the single-process controller and its
managed guests (native/managed.py; fleet.py has its own member policy). A
shard worker can be SIGKILLed or wedge mid-run, a guest can stall
in-shim; this module turns such a failure into a *named, bounded,
recoverable* event, three layers:

**Liveness.** Every shard worker stamps a monotone progress word — its
round counter plus a wall stamp — into a per-run ``ProgressPage``
(one SharedMemory segment, one cache-line slot per shard, single writer
per slot). Waiters derive stall deadlines from the observed round-wall
EMA (``max(SHADOW_TPU_STALL_FLOOR_S, SHADOW_TPU_STALL_MULT x EMA)``), so
a dead peer is named by shard id, last round, and stamp age instead of
hanging every survivor.

**Recovery.** ``run_supervised`` wraps a run (single-process or sharded)
with a bounded restart budget (``general.supervise: {max_restarts,
backoff}`` / ``--supervise``): on a recoverable failure it tears the run
down coherently (workers are terminated by the plane's own error path;
managed guests are reaped through the ``guest_pids.jsonl`` registry),
rolls the append-mode output streams back to the newest complete
checkpoint boundary, and resumes from that checkpoint — producing final
trees/flows/digests byte-identical to an uninterrupted run. With no
usable checkpoint it re-runs from scratch (fresh-run truncation already
regenerates every stream). When the budget is exhausted it salvages what
is on disk, writes a structured ``crash_report.json`` (reason, attempt,
digest cursor, rlimit/RSS snapshot) and raises ``SupervisorGaveUp`` — a
named exit, never a hang and never a bare traceback from the CLI.

**Chaos.** ``SHADOW_TPU_CHAOS="kill@r500,s1:wedge@r900,..."`` (and
``tools/chaos.py``) injects worker SIGKILLs, ring-stall wedges, named
failures and managed-guest hangs at deterministic rounds. Every event
fires at most once per data directory (an O_EXCL marker file under
``<data_dir>/chaos/``), so the recovered attempt sails past the
injection point and the run converges — which is what lets CI *prove*
recovery by hashing the chaos run against the clean run
(tests/test_torch_supervise.py, chip_smoke.py phase ``shards``).

A recovered run on the card relaunches its kernels: the restart resumes
through checkpoint.load_checkpoint, which reattaches the draw plane (and
the device transport and mesh plane where configured) on the run's device
— the checkpoint itself never carries device state.

Determinism note: everything here is wall-clock policy. Progress stamps,
deadlines, restarts, and crash reports never touch simulation state; the
byte-identity of a recovered run is inherited from the checkpoint
plane's identity guarantee plus the stream rollback below.
"""

from __future__ import annotations

import json
import os
import signal
import struct
import sys
import time as _walltime  # detlint: ok(wallclock): liveness stamps, stall deadlines, restart backoff
from pathlib import Path

#: chaos harness spec (parse_chaos below); shared by the controller round
#: loop and the shard workers — each process fires only its own events
CHAOS_ENV = "SHADOW_TPU_CHAOS"
#: stall-deadline knobs: deadline = max(FLOOR, MULT x round-wall EMA).
#: The defaults are deliberately generous (CI boxes stall for seconds
#: under load); chaos tests tighten them per-run through the environment.
STALL_FLOOR_ENV = "SHADOW_TPU_STALL_FLOOR_S"
STALL_MULT_ENV = "SHADOW_TPU_STALL_MULT"
DEFAULT_STALL_FLOOR_S = 10.0
DEFAULT_STALL_MULT = 64.0
#: absolute ceiling: even a pathological EMA never waits longer than the
#: old fixed barrier timeout did
STALL_CEILING_S = 3600.0

CRASH_REPORT = "crash_report.json"
REPORT_FORMAT = "shadow_tpu-crash-report"
#: defaults for general.supervise (config/schema.py validates the keys)
DEFAULT_MAX_RESTARTS = 3
DEFAULT_BACKOFF_S = 1.0

#: duplicated literals from parallel/shards.py — supervise is imported BY
#: shards (ProgressPage), so it cannot import shards at module top
_SHARD_MANIFEST_SUFFIX = ".shards.json"
_SHARD_MANIFEST_FORMAT = "shadow_tpu_torch-shard-manifest"


class ChaosFailure(RuntimeError):
    """An injected in-process failure (chaos ``fail@rN``)."""


class GuestStallError(RuntimeError):
    """A managed guest stalled past its watchdog deadline while the run
    is supervised: escalated to the supervisor for checkpoint recovery
    instead of the unsupervised host_down conversion (native/managed.py
    _watchdog_fire)."""


class SupervisorGaveUp(RuntimeError):
    """The restart budget is exhausted (or the failure is not
    recoverable): crash_report.json is on disk; exit by name."""


def stall_deadline_s(ema_s) -> float:
    """THE stall-deadline policy, one source of truth for shard workers,
    the parent coordinator, and the fleet dispatch loop."""
    floor = float(os.environ.get(STALL_FLOOR_ENV, DEFAULT_STALL_FLOOR_S))
    mult = float(os.environ.get(STALL_MULT_ENV, DEFAULT_STALL_MULT))
    return min(max(floor, mult * float(ema_s or 0.0)), STALL_CEILING_S)


# -- the progress page ---------------------------------------------------------

def progress_name(tag: str) -> str:
    # "stpt_": the port's segments, apart from the reference's "stpu_"
    return f"stpt_{tag}_prog"


class ProgressPage:
    """Per-run liveness board: one 64-byte slot per shard in a shared
    SharedMemory segment. Slot k is written ONLY by shard k (single
    writer — no locks, no fences needed beyond x86-TSO, the same
    platform contract the ShmRing already imposes):

        [round u64][wall stamp (monotonic ns) u64][48 bytes pad]

    Readers (peers waiting at the marker barrier, the parent
    coordinator) use the stamp's age to distinguish a *slow* shard
    (stamp fresh, keep waiting) from a *dead or wedged* one (stamp stale
    past the deadline — name it and fail fast). Torn reads are benign:
    both words only ever feed staleness heuristics, never results."""

    SLOT = 64

    def __init__(self, name: str, n: int, create: bool = False) -> None:
        from multiprocessing import shared_memory

        self.n = int(n)
        size = self.SLOT * self.n
        if create:
            self.shm = shared_memory.SharedMemory(
                name=name, create=True, size=size)
            self.shm.buf[:size] = b"\x00" * size
        else:
            # attach without resource_tracker registration: the creator
            # owns the lifetime (the ShmRing attach discipline)
            from multiprocessing import resource_tracker

            orig = resource_tracker.register
            resource_tracker.register = lambda *a, **k: None
            try:
                self.shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = orig
        self.buf = self.shm.buf

    def stamp(self, k: int, rnd: int) -> None:
        struct.pack_into("<QQ", self.buf, k * self.SLOT,
                         rnd & 0xFFFFFFFFFFFFFFFF,
                         _walltime.monotonic_ns())

    def read(self, k: int):
        """-> (round, wall_stamp_ns); (0, 0) = never stamped."""
        return struct.unpack_from("<QQ", self.buf, k * self.SLOT)

    def age_s(self, k: int) -> float:
        """Seconds since shard k last stamped; +inf if it never did."""
        _rnd, ns = self.read(k)
        if ns == 0:
            return float("inf")
        return max(0.0, (_walltime.monotonic_ns() - ns) / 1e9)

    def snapshot(self) -> tuple:
        return tuple(self.read(k) for k in range(self.n))

    def close(self) -> None:
        self.buf = None
        self.shm.close()

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


# -- the chaos harness ---------------------------------------------------------

CHAOS_KINDS = ("kill", "wedge", "fail", "guest_wedge")


def parse_chaos(spec: str) -> list:
    """``[s<K>:]<kind>@r<N>[,...]`` -> [{"shard", "kind", "round"}].

    Kinds: ``kill`` (SIGKILL the worker process), ``wedge`` (stop
    draining/stamping forever — a ring-stall), ``fail`` (raise
    ChaosFailure), ``guest_wedge`` (SIGSTOP the newest managed guest so
    the guest watchdog path fires). Shard defaults to 0 (also the
    single-process controller's id)."""
    events = []
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        shard = 0
        body = item
        if body.startswith("s") and ":" in body:
            pre, body = body.split(":", 1)
            try:
                shard = int(pre[1:])
            except ValueError as exc:
                raise ValueError(f"bad chaos shard prefix in {item!r}") from exc
        if "@" not in body:
            raise ValueError(
                f"bad chaos event {item!r}: expected [s<K>:]<kind>@r<N>")
        kind, at = body.split("@", 1)
        if kind not in CHAOS_KINDS:
            raise ValueError(
                f"bad chaos kind {kind!r} in {item!r}: one of {CHAOS_KINDS}")
        if not at.startswith("r"):
            raise ValueError(
                f"bad chaos trigger {at!r} in {item!r}: expected r<round>")
        try:
            rnd = int(at[1:])
        except ValueError as exc:
            raise ValueError(
                f"bad chaos round in {item!r}") from exc
        events.append({"shard": shard, "kind": kind, "round": rnd})
    return events


class ChaosInjector:
    """Fires this process's chaos events at round tops. Each event fires
    AT MOST ONCE per data directory: the O_EXCL marker under
    ``<data_dir>/chaos/`` is claimed *before* firing, so the supervised
    re-run passes the injection round untouched and converges."""

    def __init__(self, events: list, data_dir, shard: int = 0,
                 in_process: bool = False) -> None:
        self.events = [e for e in events if e["shard"] == int(shard)]
        self.shard = int(shard)
        self.in_process = bool(in_process)
        self.dir = Path(data_dir) / "chaos"

    @classmethod
    def from_env(cls, data_dir, shard: int = 0, in_process: bool = False):
        spec = os.environ.get(CHAOS_ENV, "")
        if not spec:
            return None
        inj = cls(parse_chaos(spec), data_dir, shard=shard,
                  in_process=in_process)
        return inj if inj.events else None

    def _claim(self, ev: dict) -> bool:
        self.dir.mkdir(parents=True, exist_ok=True)
        marker = self.dir / (
            f"{ev['kind']}@r{ev['round']}.s{ev['shard']}.fired")
        try:
            os.close(os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            return False
        return True

    def maybe_fire(self, rnd: int, controller=None) -> None:
        for ev in self.events:
            # >= not ==: a resume may land past the exact round (skip-
            # ahead); the marker file is what makes firing once-only
            if rnd < ev["round"]:
                continue
            if not self._claim(ev):
                continue
            self._fire(ev, controller)

    def _fire(self, ev: dict, controller) -> None:
        kind = ev["kind"]
        print(f"chaos: firing {kind}@r{ev['round']} on shard "
              f"{ev['shard']} (pid {os.getpid()})",
              file=sys.stderr, flush=True)
        if kind == "fail":
            raise ChaosFailure(
                f"chaos fail@r{ev['round']} injected on shard {ev['shard']}")
        if kind == "kill":
            if self.in_process and controller is not None \
                    and getattr(controller, "_supervised", False):
                # an in-process SIGKILL would take the supervisor down
                # with the run: model the crash as a raised failure
                raise ChaosFailure(
                    f"chaos kill@r{ev['round']} injected in-process on "
                    f"shard {ev['shard']}")
            os.kill(os.getpid(), signal.SIGKILL)
            return  # unreachable
        if kind == "wedge":
            # a genuine ring-stall: stop draining, stop stamping, never
            # return. The process stays SIGTERM-able so the coordinator's
            # teardown (or the operator) can still reap it.
            while True:
                _walltime.sleep(3600)
        if kind == "guest_wedge":
            pid = _newest_guest_pid(
                controller.data_dir if controller is not None
                else self.dir.parent)
            if pid is None:
                raise ChaosFailure(
                    f"chaos guest_wedge@r{ev['round']}: no live guest pid "
                    f"in guest_pids.jsonl to wedge")
            try:
                os.kill(pid, signal.SIGSTOP)
            except (ProcessLookupError, PermissionError) as exc:
                raise ChaosFailure(
                    f"chaos guest_wedge@r{ev['round']}: SIGSTOP {pid} "
                    f"failed ({exc})") from exc


def _newest_guest_pid(data_dir):
    p = Path(data_dir) / "guest_pids.jsonl"
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        pid = rec.get("pid")
        if pid and Path(f"/proc/{pid}").is_dir():
            return int(pid)
    return None


# -- checkpoint discovery + stream rollback ------------------------------------

def find_restart_checkpoint(cfg):
    """Newest COMPLETE checkpoint for a restart of ``cfg``: the shard
    manifest whose per-shard files all exist (sharded), or the newest
    single checkpoint file (single-process; writes are atomic via
    os.replace, so existence is completeness). None = restart from
    scratch."""
    ckpt_dir = (Path(cfg.general.checkpoint_dir)
                if cfg.general.checkpoint_dir
                else Path(cfg.general.data_directory) / "checkpoints")
    if not ckpt_dir.is_dir():
        return None
    if cfg.general.sim_shards > 1:
        # ckpt_t<20-digit sim time>: lexicographic == chronological
        for man in sorted(ckpt_dir.glob("*" + _SHARD_MANIFEST_SUFFIX),
                          reverse=True):
            try:
                doc = json.loads(man.read_text())
            except (OSError, ValueError):
                continue
            if doc.get("format") != _SHARD_MANIFEST_FORMAT:
                continue
            if all((man.parent / f).is_file() for f in doc["files"]):
                return str(man)
        return None
    cands = sorted(p for p in ckpt_dir.glob("ckpt_t*.ckpt")
                   if ".shard" not in p.name)
    return str(cands[-1]) if cands else None


def _restart_boundary(resume_path):
    """(rounds, sim_time_ns, managed) of a restart checkpoint."""
    from shadow_tpu_torch import checkpoint as _ckpt

    p = Path(resume_path)
    if p.name.endswith(_SHARD_MANIFEST_SUFFIX):
        doc = json.loads(p.read_text())
        return int(doc["rounds"]), int(doc["sim_time_ns"]), False
    header = _ckpt.read_header(p)
    return (int(header["rounds"]), int(header["sim_time_ns"]),
            bool(header.get("managed")))


def _filter_jsonl(path: Path, keep) -> None:
    """Atomically rewrite a .jsonl file keeping only records ``keep``
    accepts (unparseable lines are kept — never silently destroy)."""
    if not path.is_file():
        return
    out = []
    with open(path) as f:
        for line in f:
            s = line.rstrip("\n")
            if not s:
                continue
            try:
                rec = json.loads(s)
            except ValueError:
                out.append(s)
                continue
            if keep(rec):
                out.append(s)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text("".join(x + "\n" for x in out))
    os.replace(tmp, path)


def stream_prefix_keep(ckpt_rounds: int, t0_ns: int) -> dict:
    """Per-stream keep predicates for truncating output streams at a
    checkpoint boundary (round ``ckpt_rounds``, sim time ``t0_ns``) so a
    resumed run's appends continue them byte-identically. Shared by the
    supervisor's in-place rollback and the fork runner's prefix copy
    (forks.py) — one set of rules, two consumers.

    The rules mirror the round-boundary order (commands -> checkpoint ->
    fault transitions -> round -> digest/telemetry):

    - digests + flow records: ``round <= ckpt_rounds`` (emitted before
      the boundary's checkpoint; later rounds re-emit on resume)
    - commands: ``t <= t0`` (applied before the same-boundary snapshot,
      so their effects are in the restored state and resume skips them)
    - metrics: meta records always stay; samples keep ``t <= t0`` (the
      sampler cursor restores past them); fault records keep ``t < t0``
      (transitions at the boundary apply AFTER the snapshot and re-emit)
    """
    by_round = lambda rec: int(rec.get("round", 0)) <= ckpt_rounds

    def keep_metric(rec):
        kind = rec.get("kind")
        if kind == "meta":
            return True
        if kind == "fault":
            return int(rec.get("t", 0)) < t0_ns
        if "t" in rec:
            return int(rec["t"]) <= t0_ns
        return True

    return {
        "state_digests.jsonl": by_round,
        "flows.jsonl": by_round,
        "commands.jsonl": lambda rec: int(rec.get("t", 0)) <= t0_ns,
        "metrics.jsonl": keep_metric,
    }


def rollback_streams(cfg, ckpt_rounds: int, t0_ns: int) -> None:
    """Trim the append-mode output streams back to the checkpoint
    boundary in place (keep rules: ``stream_prefix_keep``) so the
    resumed run's appends continue them byte-identically."""
    data_dir = Path(cfg.general.data_directory)
    tel = cfg.telemetry
    mdir = (Path(tel.metrics_dir) if tel is not None and tel.metrics_dir
            else data_dir)

    keeps = stream_prefix_keep(ckpt_rounds, t0_ns)
    _filter_jsonl(data_dir / "state_digests.jsonl",
                  keeps["state_digests.jsonl"])
    for p in sorted(data_dir.glob("state_digests.shard*.jsonl")):
        _filter_jsonl(p, keeps["state_digests.jsonl"])
    _filter_jsonl(mdir / "flows.jsonl", keeps["flows.jsonl"])
    for p in sorted(mdir.glob("flows.shard*.jsonl")):
        _filter_jsonl(p, keeps["flows.jsonl"])
    _filter_jsonl(data_dir / "commands.jsonl", keeps["commands.jsonl"])
    _filter_jsonl(mdir / "metrics.jsonl", keeps["metrics.jsonl"])


# -- crash reports -------------------------------------------------------------

def _digest_cursor(data_dir):
    """(last digest round, line count) of state_digests.jsonl."""
    last, n = None, 0
    try:
        with open(Path(data_dir) / "state_digests.jsonl") as f:
            for line in f:
                if not line.strip():
                    continue
                n += 1
                try:
                    last = json.loads(line).get("round", last)
                except ValueError:
                    pass
    except OSError:
        pass
    return last, n


def write_crash_report(data_dir, reason: str, exc=None, attempt: int = 0,
                       max_restarts: int = 0, extra: dict = None):
    """Structured post-mortem at ``<data_dir>/crash_report.json``: what
    failed, how far the run got (digest cursor), and the resource
    envelope at give-up time."""
    import resource

    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    last_round, cursor = _digest_cursor(data_dir)
    try:
        with open("/proc/self/statm") as f:
            rss_mb = round(int(f.read().split()[1])
                           * os.sysconf("SC_PAGE_SIZE") / (1 << 20), 1)
    except (OSError, ValueError, IndexError):
        rss_mb = None
    rep = {
        "format": REPORT_FORMAT,
        "reason": reason,
        "exc_type": type(exc).__name__ if exc is not None else None,
        "exc_message": str(exc) if exc is not None else None,
        "attempt": int(attempt),
        "max_restarts": int(max_restarts),
        "last_digest_round": last_round,
        "digest_cursor": cursor,
        "rlimit_nofile": list(resource.getrlimit(resource.RLIMIT_NOFILE)),
        "rlimit_as": list(resource.getrlimit(resource.RLIMIT_AS)),
        "rss_mb": rss_mb,
        **(extra or {}),
    }
    path = data_dir / CRASH_REPORT
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(rep, sort_keys=True, indent=1) + "\n")
    os.replace(tmp, path)
    return path


# -- the supervisor ------------------------------------------------------------

def supervise_options(cfg) -> dict:
    opts = {"max_restarts": DEFAULT_MAX_RESTARTS,
            "backoff": DEFAULT_BACKOFF_S}
    s = getattr(cfg.general, "supervise", None)
    if isinstance(s, dict):
        opts.update(s)
    return opts


def _reap_guests(data_dir) -> int:
    """Reap managed guest processes left behind by a dead attempt —
    the fleet's pid-reuse-safe registry walk (guest_pids.jsonl +
    /proc/<pid>/environ identity check)."""
    from shadow_tpu_torch.fleet import _reap_stale_guests

    return _reap_stale_guests(Path(data_dir))


def _is_recoverable(exc, sharded: bool) -> bool:
    if isinstance(exc, (ChaosFailure, GuestStallError)):
        return True
    if sharded:
        from shadow_tpu_torch.parallel.shards import _PeerDied, _ShardError

        # _ShardError covers every worker death: SIGKILL (pipe EOF),
        # wedge (peer stall detection), and in-worker exceptions
        return isinstance(exc, (_ShardError, _PeerDied))
    return False


def run_supervised(cfg, mirror_log: bool = True, resume_from=None,
                   device: str = "cuda") -> dict:
    """Run ``cfg`` under supervision: bounded automatic restarts from the
    newest complete checkpoint on recoverable failure, each attempt on
    ``device``. Returns the run summary with a ``supervisor`` key
    (attempts, restart records with per-restart MTTR); raises
    SupervisorGaveUp (crash_report.json on disk) when the budget is
    exhausted."""
    opts = supervise_options(cfg)
    max_restarts = int(opts.get("max_restarts", DEFAULT_MAX_RESTARTS))
    backoff = float(opts.get("backoff", DEFAULT_BACKOFF_S))
    data_dir = Path(cfg.general.data_directory)
    sharded = cfg.general.sim_shards > 1
    restarts: list = []
    attempt = 0
    resume = resume_from
    while True:
        runner = None
        try:
            if sharded:
                from shadow_tpu_torch.parallel.shards import ShardedRun

                runner = ShardedRun(cfg, mirror_log=mirror_log,
                                    resume_from=resume, device=device)
            else:
                if resume is not None:
                    from shadow_tpu_torch import checkpoint as _ckpt

                    runner, resume_at = _ckpt.load_checkpoint(
                        resume, cfg, mirror_log=mirror_log, device=device)
                else:
                    from shadow_tpu_torch.core.controller import Controller

                    runner = Controller(cfg, mirror_log=mirror_log,
                                        device=device)
                    resume_at = None
                runner._supervised = True
                runner.t_first_ready = _walltime.monotonic()
            if restarts and getattr(runner, "live", None) is not None:
                # live followers learn of the recovery: the failure, the
                # attempt and the checkpoint resumed from
                rec = {k: v for k, v in restarts[-1].items()
                       if not k.startswith("_")}
                runner.live.publish(
                    {"type": "supervisor", "event": "restart", **rec})
            result = (runner.run() if sharded
                      else runner.run(resume_at=resume_at))
            _note_mttr(restarts, runner)
            result["supervisor"] = {
                "attempts": attempt + 1,
                "max_restarts": max_restarts,
                "restarts": [{k: v for k, v in r.items()
                              if not k.startswith("_")} for r in restarts],
            }
            return result
        except KeyboardInterrupt:
            raise  # the operator's interrupt is never "recovered"
        except Exception as exc:
            t_detect = _walltime.monotonic()
            _note_mttr(restarts, runner)
            attempt += 1
            reason = f"{type(exc).__name__}: {exc}"
            recoverable = _is_recoverable(exc, sharded)
            reaped = _reap_guests(data_dir)
            if reaped:
                print(f"supervisor: reaped {reaped} stale guest "
                      f"process(es)", file=sys.stderr, flush=True)
            if not recoverable or attempt > max_restarts:
                why = ("failure is not recoverable" if not recoverable
                       else f"restart budget exhausted "
                            f"({max_restarts} restart(s))")
                path = write_crash_report(
                    data_dir, f"{why}: {reason}", exc=exc, attempt=attempt,
                    max_restarts=max_restarts,
                    extra={"restarts": [
                        {k: v for k, v in r.items()
                         if not k.startswith("_")} for r in restarts]})
                raise SupervisorGaveUp(
                    f"supervisor gave up after {attempt} attempt(s): "
                    f"{why} — {reason} (report: {path})") from exc
            resume = find_restart_checkpoint(cfg)
            if resume is not None:
                rounds, t0, managed = _restart_boundary(resume)
                if not managed:
                    # a managed re-execution restore regenerates every
                    # stream fresh from round 0: nothing to roll back
                    rollback_streams(cfg, rounds, t0)
                where = f"checkpoint {resume} (round {rounds})"
            else:
                where = "scratch (no complete checkpoint)"
            wait = backoff * (2 ** (attempt - 1))
            print(f"supervisor: attempt {attempt}/{max_restarts} — "
                  f"{reason}; restarting from {where} in {wait:.1f}s",
                  file=sys.stderr, flush=True)
            restarts.append({"attempt": attempt, "reason": reason,
                             "resume": resume or "scratch",
                             "_t_detect": t_detect})
            if wait > 0:
                _walltime.sleep(min(wait, 60.0))


def _note_mttr(restarts: list, runner) -> None:
    """Record mean-time-to-recovery for the newest restart: wall seconds
    from failure detection to the recovered attempt reaching ready."""
    if not restarts or runner is None:
        return
    rec = restarts[-1]
    tfr = getattr(runner, "t_first_ready", None)
    if tfr is not None and "mttr_s" not in rec and "_t_detect" in rec:
        rec["mttr_s"] = round(max(0.0, tfr - rec["_t_detect"]), 3)
