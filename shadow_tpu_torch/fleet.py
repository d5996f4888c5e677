"""Fleet mode: M seeded simulations per box behind one shared draw plane.

The port of shadow_tpu/fleet.py. No conclusion comes from one run, only
from N seeded runs with confidence intervals ("Once is Never Enough",
PAPERS.md); this module makes an N-seed sweep cheaper than N serial runs
on one box, and turns the per-seed telemetry into cross-run statistics.

**The sweep runner** (``FleetRunner`` / ``python -m shadow_tpu_torch.fleet
sweep config.yaml --seeds 10 --jobs M``) packs M concurrent seeded
simulations:

- ``jobs`` persistent worker processes, pinned to cores (best effort),
  each running its seeds one after another in one interpreter, so the
  imports and the parsed config amortize across seeds.
- Bounded admission: never more than ``jobs`` resident simulations, and
  an RSS guard that delays the next seed while the fleet's resident total
  is over budget.
- ONE card attach: the parent owns an ``ops.propagate.DrawServer`` (one
  CUDA context: kernel load, calibration and warm-up paid once) and the
  members route their draw windows to it through ``FleetDrawClient``,
  published into network/devroute.py's window machinery through
  ``SHADOW_TPU_DRAW_SERVICE``. The kernels take the threefry key as data,
  so every member seed shares the one plane. A served member never
  creates a CUDA context (it checks the device without initialising it,
  and its seed fails if CUDA came up). Unlike the reference, nothing
  falls back: a failed attach, launch or connection raises in the
  member, its seed fails and ``--retries`` reruns it;
  ``--no-device-service`` is the explicit opt-out (each member attaches
  the card itself).
- Fork after CUDA is unsafe, so workers fork only while this process has
  no CUDA context, no draw server and no other thread; otherwise (a
  worker respawned once the server exists, or a caller whose CUDA is up)
  they are spawned.
- Per-seed isolation: each seed runs with ``data_directory =
  <sweep_dir>/seed_<s>``, byte-identical to the same seed run
  standalone, and to the reference's.
- Failure containment with bounded retries: a seed that raises, a worker
  that dies, and a member that wedges past the stall deadline are routed
  through one retry budget (``--retries``) before counting as failed; a
  member over ``--member-max-rss-mb`` is killed and not retried. SIGINT
  tears down coherently and leaves a valid partial summary.
- ``--resume``: re-runs only the seeds whose manifest is missing, not
  ``ok`` (failed, or ``running`` when a worker died mid-seed), or written
  under a different config (``checkpoint.config_digest``). Manifests
  carry this package's own format name, so neither package resumes over
  the other's seeds.

**The reducer** (``reduce_sweep`` / ``... report <sweep-dir>``) merges the
per-seed ``LogHistogram`` states into ``sweep_summary.json``: pooled
percentiles and per-seed percentiles with t-based 95 % confidence
intervals per flow group (seeds are the independent unit). Its statistics
equal the reference's for the same arguments.

**Fork mode** (``sweep --fork-from CKPT --branches FILE``, or
``python -m shadow_tpu_torch fork``): a validated fork plan (forks.py)
turns the fleet into a fork orchestrator — the "seeds" are branch names
and every worker runs branches of ONE trunk checkpoint behind the same
shared draw service; ``report`` of a fork directory re-reduces it, and
``--compare`` renders only the comparison against the trunk.

**The sweep's live endpoint** (``--live-endpoint``, live.py) is status
only: it streams per-seed (or per-branch) lifecycle records and refuses
every command by name. Members never bind one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import sys
import time as _walltime  # detlint: ok(wallclock): worker admission, RSS polling, sweep wall report
from pathlib import Path

from shadow_tpu_torch.forks import FORK_MANIFEST, FORK_SUMMARY
from shadow_tpu_torch.network.devroute import SERVICE_ENV
from shadow_tpu_torch.ops.devcfg import DrawServiceError
from shadow_tpu_torch.utils.digest import output_tree_digest

__all__ = ["SERVICE_ENV", "FleetRunner", "FleetDrawClient",
           "output_tree_digest", "reduce_sweep", "render_report", "seed_dir",
           "t_ci95", "main"]

SEED_MANIFEST = "fleet_manifest.json"
TEL_STATE_FILE = "telemetry_state.json"
SWEEP_SUMMARY = "sweep_summary.json"
#: the port's own seed-manifest format: --resume trusts only its own
MANIFEST_FORMAT = "shadow_tpu_torch-fleet-seed"
#: the summary's statistics equal the reference's, format name included
SUMMARY_FORMAT = "shadow_tpu-sweep-summary"

#: chaos hook for the failure-path gates: comma-separated seeds that raise
#: instead of running, on EVERY attempt (so they exhaust their retries)
CHAOS_ENV = "SHADOW_TPU_FLEET_CHAOS_SEEDS"
#: harder chaos hooks: the worker SIGKILLs itself / wedges forever just
#: before running the listed seed, once per sweep (an O_EXCL marker under
#: <sweep_dir>/chaos/), so the retried attempt runs clean
CHAOS_KILL_ENV = "SHADOW_TPU_FLEET_CHAOS_KILL_SEEDS"
CHAOS_WEDGE_ENV = "SHADOW_TPU_FLEET_CHAOS_WEDGE_SEEDS"
#: fixed member-stall deadline override (wall seconds). Default: EMA
#: derived, max(supervise.stall_deadline_s(completed-seed wall EMA), 60)
#: once a seed has completed; before that members may run arbitrarily long
FLEET_STALL_ENV = "SHADOW_TPU_FLEET_STALL_S"


# -- the member-side draw proxy ----------------------------------------------
#
# Quacks like ops.propagate.DeviceDrawPlane (dispatch / dispatch_min /
# SPEC_BUCKET): the member ships its draw batches to the fleet parent's
# DrawServer and reads the results back through handles that satisfy the
# window machinery's read()/is_ready() contract. Responses arrive FIFO per
# member but are demuxed by request id, since the window pipeline and the
# speculative waves read out of order.

class _RemoteHandle:
    """An in-flight request to the fleet draw server."""

    __slots__ = ("_cl", "_rid")

    def __init__(self, cl, rid: int) -> None:
        self._cl = cl
        self._rid = rid

    def read(self):
        return self._cl._wait(self._rid)

    def is_ready(self) -> bool:
        return self._cl._check(self._rid)


class FleetDrawClient:
    """Member-side proxy for the fleet parent's DrawServer (module doc).
    Single-threaded by contract: the simulation round loop is the only
    caller (devroute publishes it like a device plane). Every transport
    failure, and every error the server sends, raises DrawServiceError."""

    name = "fleet"

    def __init__(self, conn, seed: int, dev_s: float, np_per_unit: float,
                 spec_bucket: int, max_batch: int, max_pkts: int) -> None:
        self._conn = conn
        self.seed = int(seed)
        self.dev_s = dev_s
        self.np_per_unit = np_per_unit
        self.SPEC_BUCKET = spec_bucket
        self.max_batch = max_batch
        self.max_pkts = max_pkts
        self._rid = 0
        self._results: dict = {}
        self._owed = 0  # requests sent whose responses have not landed
        self._error = None  # the failure every later call raises

    @classmethod
    def connect(cls, address: str, seed: int, max_batch: int,
                max_pkts: int, timeout: float = 60.0,
                abort=None):
        """Connect to the fleet draw service. The socket handshake is
        immediate (the server accepts before its attach finishes); the
        hello reply may take as long as the attach, so it is waited with
        an abortable poll — ``abort()`` returning True (the member run is
        tearing down) returns None instead of blocking. Raises
        DrawServiceError on a service that cannot be reached (also when
        the run ends while it still cannot), never answers within
        ``timeout``, or replies with its attach's error."""
        from multiprocessing import AuthenticationError
        from multiprocessing.connection import Client

        from shadow_tpu_torch.ops.propagate import DRAW_SERVICE_AUTHKEY

        t0 = _walltime.monotonic()
        deadline = t0 + timeout
        # a MISSING socket gets a shorter window than a busy one: a socket
        # that never appears means the service died
        missing_deadline = t0 + 20.0
        while True:
            try:
                conn = Client(address, family="AF_UNIX",
                              authkey=DRAW_SERVICE_AUTHKEY)
                break
            except (OSError, EOFError, AuthenticationError) as exc:
                now = _walltime.monotonic()
                if now > (missing_deadline
                          if isinstance(exc, FileNotFoundError)
                          else deadline):
                    raise DrawServiceError(
                        f"fleet draw service at {address!r} not reachable"
                        f": {exc!r}") from exc
                if abort is not None and abort():
                    raise DrawServiceError(
                        f"fleet draw service at {address!r} not reachable"
                        f" before the run ended: {exc!r}") from exc
                _walltime.sleep(0.25)
        try:
            conn.send(("hello", int(seed)))
            while not conn.poll(0.25):
                if abort is not None and abort():
                    conn.close()
                    return None  # reachable, still attaching: run is over
                if _walltime.monotonic() > deadline:
                    raise DrawServiceError(
                        f"fleet draw service at {address!r}: no hello "
                        f"reply within {timeout}s (attach stuck?)")
            reply = conn.recv()
        except (OSError, EOFError) as exc:
            conn.close()
            raise DrawServiceError(
                f"fleet draw service at {address!r} closed the "
                f"connection: {exc!r}") from exc
        except BaseException:
            conn.close()
            raise
        if reply[0] != "ok":
            conn.close()
            raise DrawServiceError(f"draw service refused: {reply[2]}")
        _op, dev_s, np_per_unit, spec_bucket, srv_max_batch = reply
        return cls(conn, seed, dev_s, np_per_unit, spec_bucket,
                   min(int(max_batch), int(srv_max_batch)), max_pkts)

    # -- plane interface (devroute window machinery) -----------------------
    def _send(self, msg) -> _RemoteHandle:
        if self._error is not None:
            raise DrawServiceError(self._error)
        rid = self._rid = self._rid + 1
        try:
            self._conn.send((msg[0], rid, *msg[1:]))
        except (OSError, ValueError) as exc:
            self._fail(f"fleet draw service: send failed: {exc!r}")
        self._owed += 1
        return _RemoteHandle(self, rid)

    def dispatch(self, uid_lo, uid_hi, npkts, thresh):
        return self._send(("draw", self.seed, uid_lo, uid_hi, npkts,
                           thresh))

    def dispatch_min(self, uid_lo, uid_hi, npkts, min_bucket: int = 0):
        return self._send(("min", self.seed, uid_lo, uid_hi, npkts,
                           min_bucket))

    # -- response demux ----------------------------------------------------
    def _fail(self, msg: str):
        self._error = msg
        raise DrawServiceError(msg)

    def _take(self, msg) -> None:
        """File one response; a server error fails this and every later
        call."""
        if msg[0] == "error":
            self._fail(msg[2])
        self._owed -= 1
        self._results[msg[0]] = msg[1]

    def _pump(self) -> None:
        """File whatever responses already landed (never blocks)."""
        try:
            while self._conn.poll(0):
                self._take(self._conn.recv())
        except (OSError, EOFError) as exc:
            self._fail(f"fleet draw service: connection lost: {exc!r}")

    def _check(self, rid: int) -> bool:
        if rid in self._results:
            return True
        if self._error is not None:
            return True  # read() raises it
        try:
            self._pump()
        except DrawServiceError:
            return True
        return rid in self._results

    def _wait(self, rid: int):
        """Block until response ``rid`` arrives (filing any siblings that
        land first)."""
        while rid not in self._results:
            if self._error is not None:
                raise DrawServiceError(self._error)
            try:
                msg = self._conn.recv()
            except (OSError, EOFError) as exc:
                self._fail(f"fleet draw service: connection lost: {exc!r}")
            self._take(msg)
        return self._results.pop(rid)

    def close_client(self) -> None:
        """Collect the responses still owed (a speculative wave the run
        never read), so that every request sent is one served launch, then
        say bye and close."""
        try:
            while self._owed > 0 and self._error is None:
                self._take(self._conn.recv())
        except (OSError, EOFError, DrawServiceError):
            pass  # the run is over: nothing is read from here on
        self._results.clear()
        try:
            self._conn.send(("bye",))
        except (OSError, ValueError):
            pass
        try:
            self._conn.close()
        except OSError:
            pass


# -- per-seed execution (worker side) -----------------------------------------

def seed_dir(sweep_dir, seed) -> Path:
    """A task's directory under the sweep: a seed's (an int) or a fork
    branch's (its name, a str: forks.branch_dir); the dispatch, watchdog
    and retry machinery treat both as opaque keys."""
    if isinstance(seed, str):
        return Path(sweep_dir) / f"branch_{seed}"
    return Path(sweep_dir) / f"seed_{int(seed)}"


def _stream_digests(data_dir) -> dict:
    out = {}
    for name in ("flows.jsonl", "metrics.jsonl", "state_digests.jsonl"):
        p = Path(data_dir) / name
        if p.is_file():
            out[name] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def _write_json(path: Path, doc: dict) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(doc, sort_keys=True, indent=1))
    os.replace(tmp, path)


def _member_config(config_path: str, overrides: dict, sweep_dir,
                   seed: int):
    from shadow_tpu_torch.config import load_config

    over = dict(overrides or {})
    over["general.seed"] = int(seed)
    over["general.data_directory"] = str(seed_dir(sweep_dir, seed))
    # members never bind a live endpoint: M concurrent seeds would race
    # on one socket path, and a sweep is a batch artifact
    over["general.live_endpoint"] = None
    # cache_doc: a worker parses the YAML once per process, not per seed
    return load_config(config_path, over, cache_doc=True)


def _reap_stale_guests(d) -> int:
    """SIGKILL real-binary guests leaked by an interrupted managed member
    run. A worker that died mid-run (SIGKILL, OOM) never reaped the
    executables it spawned; their pids live in the seed directory's
    ``guest_pids.jsonl`` side plane (Controller.note_guest_pid). Pids get
    recycled on a busy box, so each one is verified against the recorded
    clock-page path via ``/proc/<pid>/environ`` before the kill: only a
    process that still carries OUR shm path in its environment is one of
    ours."""
    import signal

    p = Path(d) / "guest_pids.jsonl"
    if not p.is_file():
        return 0
    killed = 0
    for raw in p.read_text().splitlines():
        try:
            rec = json.loads(raw)
            pid, shm = int(rec["pid"]), str(rec.get("shm") or "")
        except (ValueError, KeyError, TypeError):
            continue
        if pid <= 1 or not shm:
            continue
        try:
            env = Path(f"/proc/{pid}/environ").read_bytes()
        except OSError:
            continue  # already gone (the common case)
        if shm.encode() not in env:
            continue  # pid recycled by an unrelated process: hands off
        try:
            os.kill(pid, signal.SIGKILL)
            killed += 1
        except OSError:
            pass
    return killed


def _fleet_chaos(sweep_dir, seed: int) -> None:
    """Worker-side hard-failure injection (CHAOS_KILL_ENV/CHAOS_WEDGE_ENV):
    die or hang just before running the listed seed, once per sweep. The
    O_EXCL marker is claimed BEFORE firing so recovery converges."""
    import signal as _signal

    for env, kind in ((CHAOS_KILL_ENV, "kill"), (CHAOS_WEDGE_ENV, "wedge")):
        spec = os.environ.get(env, "")  # detlint: ok(envread): loop var over the SHADOW_TPU_FLEET_CHAOS_* module constants
        if not spec or str(seed) not in spec.split(","):
            continue
        mark_dir = Path(sweep_dir) / "chaos"
        mark_dir.mkdir(parents=True, exist_ok=True)
        try:
            fd = os.open(mark_dir / f"{kind}.s{seed}.fired",
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            continue  # fired on an earlier attempt: this retry runs clean
        print(f"fleet: CHAOS {kind} firing in worker for seed {seed}",
              file=sys.stderr, flush=True)
        if kind == "kill":
            os.kill(os.getpid(), _signal.SIGKILL)
        while True:  # wedge: hold the seed forever without progress
            _walltime.sleep(3600)


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _run_one_seed(config_path: str, overrides: dict, sweep_dir,
                  seed: int, device: str = "cuda") -> dict:
    """Run one member simulation into its seed directory on ``device`` and
    write its manifest and mergeable telemetry state. Raises on failure
    (the worker loop turns that into a failed manifest); a member served
    by the draw service that created a CUDA context fails too."""
    from shadow_tpu_torch import checkpoint as _ckpt
    from shadow_tpu_torch.core.controller import (VOLATILE_SUMMARY_KEYS,
                                                  Controller)

    chaos = os.environ.get(CHAOS_ENV, "")
    if chaos and str(seed) in chaos.split(","):
        raise RuntimeError(
            f"chaos hook: seed {seed} configured to fail ({CHAOS_ENV})")
    _fleet_chaos(sweep_dir, seed)
    d = seed_dir(sweep_dir, seed)
    # a fresh member run owns its directory: stale partial output from an
    # earlier attempt must not survive into the hashes
    stale = _reap_stale_guests(d)
    if stale:
        print(f"fleet: seed {seed}: reaped {stale} stale guest "
              f"process(es) from an interrupted earlier attempt",
              file=sys.stderr, flush=True)
    shutil.rmtree(d, ignore_errors=True)
    t0 = _walltime.perf_counter()
    cfg = _member_config(config_path, overrides, sweep_dir, seed)
    # mark the attempt in flight first: if this worker dies mid-run,
    # --resume sees status "running" (not "ok") and re-runs the seed
    d.mkdir(parents=True, exist_ok=True)
    _write_json(d / SEED_MANIFEST, {
        "format": MANIFEST_FORMAT,
        "seed": int(seed),
        "status": "running",
        "config_digest": _ckpt.config_digest(cfg),
    })
    ctl = Controller(cfg, mirror_log=False, device=device)
    result = ctl.run()
    if (getattr(ctl.engine, "_svc_addr", None)
            and getattr(ctl.engine, "devt", None) is None
            and _cuda_initialized()):
        raise RuntimeError(
            f"seed {seed}: a member served by the fleet draw service "
            f"created a CUDA context (it must launch nothing)")
    if ctl.telemetry is not None:
        (d / TEL_STATE_FILE).write_text(ctl.telemetry.export_state_json())
    wall = _walltime.perf_counter() - t0
    summary = {k: v for k, v in result.items()
               if k not in VOLATILE_SUMMARY_KEYS}
    man = {
        "format": MANIFEST_FORMAT,
        "seed": int(seed),
        "status": "ok",
        "config_digest": _ckpt.config_digest(cfg),
        "wall_seconds": round(wall, 3),
        "loop_wall_seconds": round(result["wall_seconds"], 3),
        "events": result["events"],
        "rounds": result["rounds"],
        "exit_reason": result["exit_reason"],
        "process_errors": result["process_errors"],
        "tree_sha256": output_tree_digest(d),
        "streams_sha256": _stream_digests(d),
        "summary": summary,
    }
    _write_json(d / SEED_MANIFEST, man)
    return man


def _write_failed_manifest(sweep_dir, seed, error: str,
                           tb: str = "") -> dict:
    if isinstance(seed, str):  # a fork branch failed, not a sweep seed
        from shadow_tpu_torch import forks as _forks

        return _forks.write_failed_branch_manifest(sweep_dir, seed,
                                                   error, tb)
    d = seed_dir(sweep_dir, seed)
    d.mkdir(parents=True, exist_ok=True)
    man = {
        "format": MANIFEST_FORMAT,
        "seed": int(seed),
        "status": "failed",
        "error": error,
        "traceback": tb,
    }
    _write_json(d / SEED_MANIFEST, man)
    return man


def _fleet_worker_main(conn, config_path: str, overrides: dict,
                       sweep_dir: str, worker_idx: int, service_addr,
                       pin: bool, device: str = "cuda",
                       fork: dict = None) -> None:
    """Worker process entry: run seeds (or, given a fork plan, branches)
    one after another as they arrive. One interpreter for many seeds is
    the amortization lever."""
    import gc as _gc
    import signal as _signal
    import traceback

    try:  # the parent owns signal policy
        _signal.signal(_signal.SIGINT, _signal.SIG_IGN)
    except (ValueError, OSError):
        pass
    if pin:
        try:
            ncpu = os.cpu_count() or 1
            os.sched_setaffinity(0, {worker_idx % ncpu})
            # one core: torch's CPU work (the plain kernels of a cpu run)
            # must not start a thread a core on it
            import torch

            torch.set_num_threads(1)
        except (AttributeError, OSError):
            pass  # pinning is a locality hint, never a requirement
    if service_addr:
        os.environ[SERVICE_ENV] = str(service_addr)
    else:
        os.environ.pop(SERVICE_ENV, None)
    seeds_run = 0
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg[0] == "exit":
            break
        seed = str(msg[1]) if fork is not None else int(msg[1])
        try:
            if fork is not None:
                from shadow_tpu_torch import forks as _forks

                man = _forks.run_branch(fork, seed, device)
            else:
                man = _run_one_seed(config_path, overrides, sweep_dir,
                                    seed, device)
            conn.send(("done", seed, man))
        except BaseException as exc:
            tb = traceback.format_exc()
            try:
                _write_failed_manifest(sweep_dir, seed, str(exc), tb)
            except OSError:
                pass
            try:
                conn.send(("failed", seed, str(exc), tb))
            except (OSError, ValueError):
                break
            if not isinstance(exc, Exception):
                break  # KeyboardInterrupt/SystemExit: stop the worker
        seeds_run += 1
        if seeds_run % 3 == 0:
            # a full cycle collection every few seeds bounds what refcount
            # reclamation of dead Controller graphs leaves behind
            _gc.collect()
    # everything durable is on disk and every message is sent: skip the
    # interpreter teardown of a large simulation heap
    try:
        conn.close()
    except OSError:
        pass
    os._exit(0)


# -- the sweep runner (parent side) -------------------------------------------

def _proc_rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except (OSError, ValueError, IndexError):
        return 0.0


def _default_rss_cap_mb() -> int:
    """80% of MemTotal — the admission guard's default budget."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(int(line.split()[1]) * 0.8) // 1024
    except (OSError, ValueError):
        pass
    return 0  # unknown: guard disabled


class FleetRunner:
    """Parent orchestrator: admission-bounded seed dispatch over ``jobs``
    pinned persistent workers plus the shared DrawServer (module doc).
    ``device`` is where the members' kernels run (``cuda`` or ``cpu``);
    the draw server attaches it."""

    def __init__(self, config_path: str, seeds: list, jobs: int,
                 sweep_dir, overrides: dict = None, resume: bool = False,
                 max_rss_mb: int = None, pin_cores: bool = True,
                 device_service: bool = True, quiet: bool = False,
                 retries: int = 1, member_max_rss_mb: int = 0,
                 device: str = "cuda", live_endpoint: str = None,
                 fork: dict = None) -> None:
        self.config_path = str(config_path)
        #: a validated fork plan (forks.plan_fork) turns the fleet into a
        #: fork orchestrator: ``seeds`` become branch names and every
        #: worker runs branches of ONE trunk checkpoint
        self.fork = fork
        if fork is not None:
            self.seeds = [str(s) for s in seeds]
            if resume:
                raise ValueError(
                    "a fork cannot --resume: branches are planned from "
                    "the trunk checkpoint each time — just re-run the "
                    "fork (completed branch directories are rebuilt)")
        else:
            self.seeds = [int(s) for s in seeds]
        if not self.seeds:
            raise ValueError("a sweep needs at least one seed")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"duplicate seeds in sweep: {self.seeds}")
        self.jobs = max(1, int(jobs))
        self.sweep_dir = Path(sweep_dir)
        self.overrides = dict(overrides or {})
        self.resume = bool(resume)
        self.max_rss_mb = (_default_rss_cap_mb() if max_rss_mb is None
                           else int(max_rss_mb))
        self.pin_cores = bool(pin_cores)
        self.device_service = bool(device_service)
        self.device = str(device)
        self.quiet = bool(quiet)
        self._server = None
        self._service_addr = None
        self._procs: list = []
        self._conns: list = []
        self._inflight: dict = {}  # worker idx -> seed
        self._respawns = 0
        #: bounded retry budget per seed: a crashed, wedged, or raising
        #: seed is requeued up to ``retries`` times before it counts failed
        self.retries = max(0, int(retries))
        #: per-member RSS ceiling (MB, 0 = off): a member over it is
        #: KILLED and not retried, unlike max_rss_mb which delays admission
        self.member_max_rss_mb = max(0, int(member_max_rss_mb or 0))
        self._attempts: dict = {}  # seed -> dispatch attempts so far
        self._inflight_t: dict = {}  # worker idx -> dispatch monotonic
        self._seed_wall_ema = 0.0  # completed-seed wall EMA (stall basis)
        self._interrupted = False
        #: the sweep's live endpoint (live.py): STATUS ONLY — lifecycle
        #: records for dashboards; every command is refused by name (a
        #: sweep is a batch of independent replayable runs, and mutating
        #: one seed mid-sweep would fork its identity). Its path is checked
        #: here; it binds in run() once the workers exist, so that they
        #: can still fork from a parent with no other thread.
        self.live = None
        self._live_address = None
        if live_endpoint:
            from shadow_tpu_torch import live as _live

            self._live_address = _live.resolve_endpoint(live_endpoint,
                                                        self.sweep_dir)
            if len(self._live_address.encode()) > _live._MAX_SOCKET_PATH:
                raise ValueError(
                    f"live endpoint path exceeds the AF_UNIX limit "
                    f"(~{_live._MAX_SOCKET_PATH} bytes): "
                    f"{self._live_address!r}")

    def _bind_live(self) -> None:
        from shadow_tpu_torch import live as _live

        self.live = _live.LiveServer(
            self._live_address,
            refuse=lambda norm: (
                f"sweep endpoint is status-only: {norm['cmd']!r} "
                f"would fork one seed's identity mid-sweep — attach "
                f"to a single run's live_endpoint instead"))

    def _publish(self, rec: dict) -> None:
        if self.live is None:
            return
        if self.fork is not None and isinstance(rec.get("seed"), str):
            # forked sweeps stream per-BRANCH progress: the same
            # lifecycle records, branch-keyed (branch_dispatched/...)
            rec = dict(rec)
            rec["branch"] = rec.pop("seed")
            if isinstance(rec.get("type"), str):
                rec["type"] = rec["type"].replace("seed_", "branch_")
        self.live.publish(rec)

    def _base_config(self):
        """The configuration every member shares the plane shape of: the
        first seed's, or for a fork the trunk's (the fork's overrides)."""
        if self.fork is not None:
            from shadow_tpu_torch.config import load_config

            return load_config(self.config_path,
                               dict(self.fork["overrides"]), cache_doc=True)
        return _member_config(self.config_path, self.overrides,
                              self.sweep_dir, self.seeds[0])

    def _log(self, msg: str) -> None:
        if not self.quiet:
            print(f"fleet: {msg}", file=sys.stderr, flush=True)

    # -- resume ------------------------------------------------------------
    def _completed_seeds(self) -> dict:
        """seed -> manifest for every seed already completed under THIS
        config (this package's format, status ok, config_digest match);
        everything else re-runs."""
        from shadow_tpu_torch import checkpoint as _ckpt

        done = {}
        for seed in self.seeds:
            p = seed_dir(self.sweep_dir, seed) / SEED_MANIFEST
            if not p.is_file():
                continue
            try:
                man = json.loads(p.read_text())
            except ValueError:
                continue
            if (man.get("format") != MANIFEST_FORMAT
                    or man.get("status") != "ok"):
                continue
            cfg = _member_config(self.config_path, self.overrides,
                                 self.sweep_dir, seed)
            if man.get("config_digest") == _ckpt.config_digest(cfg):
                done[seed] = man
        return done

    # -- workers -----------------------------------------------------------
    def _mp_ctx(self):
        """fork while it is safe — this process has no CUDA context, no
        draw server (whose attach creates one) and no other thread that
        could hold a lock the child inherits — else spawn. A forked worker
        inherits the imported simulation modules and the parsed config,
        which removes its cold start."""
        import multiprocessing as mp
        import threading

        if (self._server is not None or _cuda_initialized()
                or threading.active_count() > 1
                or not hasattr(os, "fork")):
            return mp.get_context("spawn")
        return mp.get_context("fork")

    def _spawn_worker(self, idx: int):
        ctx = self._mp_ctx()
        parent_conn, child_conn = ctx.Pipe()
        p = ctx.Process(
            target=_fleet_worker_main,
            args=(child_conn, self.config_path, self.overrides,
                  str(self.sweep_dir), idx, self._service_addr,
                  self.pin_cores, self.device, self.fork),
            name=f"shadow-fleet-{idx}", daemon=True)
        p.start()
        child_conn.close()
        return p, parent_conn

    def _rss_ok(self) -> bool:
        if not self.max_rss_mb or not self._inflight:
            return True  # nothing resident (or guard off): always admit
        total = sum(_proc_rss_mb(p.pid) for p in self._procs
                    if p is not None and p.is_alive())
        return total < self.max_rss_mb

    # -- the sweep ---------------------------------------------------------
    def run(self) -> dict:
        from shadow_tpu_torch.ops import devcfg

        t_sweep = _walltime.perf_counter()
        # the device, without calling cuInit: workers may fork after this
        devcfg.require_device(self.device)
        self.sweep_dir.mkdir(parents=True, exist_ok=True)
        # validate the config up front: a typo fails the sweep at once,
        # not once per worker (a fork plan was validated end to end by
        # forks.plan_fork)
        cfg0 = self._base_config()
        failed: dict = {}
        skipped: list = []
        pending = list(self.seeds)
        if self.resume:
            done = self._completed_seeds()
            skipped = sorted(done)
            pending = [s for s in pending if s not in done]
            self._log(f"resume: {len(skipped)} seed(s) already complete, "
                      f"{len(pending)} to run")
        if self.device_service and pending:
            # the socket path is chosen now (workers need it at spawn); the
            # server, whose attach creates the CUDA context, is built only
            # once the workers exist
            from shadow_tpu_torch.ops.propagate import draw_service_address

            self._service_addr = draw_service_address()
        # pre-import the simulation stack (no CUDA in any of it): forked
        # workers inherit warm modules and the parsed-config doc cache
        import shadow_tpu_torch.checkpoint  # noqa: F401
        import shadow_tpu_torch.core.controller  # noqa: F401
        import shadow_tpu_torch.faults  # noqa: F401
        import shadow_tpu_torch.forks  # noqa: F401
        import shadow_tpu_torch.live  # noqa: F401
        import shadow_tpu_torch.models.echo  # noqa: F401
        import shadow_tpu_torch.models.gossip  # noqa: F401
        import shadow_tpu_torch.models.tgen  # noqa: F401
        import shadow_tpu_torch.models.tor  # noqa: F401
        import shadow_tpu_torch.network.colplane  # noqa: F401
        import shadow_tpu_torch.network.engine  # noqa: F401
        import shadow_tpu_torch.telemetry.collector  # noqa: F401

        e = cfg0.experimental
        if (e.native_colcore and e.scheduler_policy in ("tpu_batch",
                                                        "tpu_mesh")):
            from shadow_tpu_torch.native import colcore

            colcore()  # build the C engine once, not once per worker
        try:
            if pending:
                for k in range(min(self.jobs, len(pending))):
                    p, conn = self._spawn_worker(k)
                    self._procs.append(p)
                    self._conns.append(conn)
            if self._live_address is not None:
                self._bind_live()  # after the workers: they could fork
            if pending:
                if self._service_addr is not None:
                    from shadow_tpu_torch.ops.propagate import DrawServer

                    self._server = DrawServer(
                        cfg0.general.seed, e.tpu_max_batch, e.unit_mtus,
                        address=self._service_addr, device=self.device)
                try:
                    self._dispatch_loop(pending, failed)
                except KeyboardInterrupt:
                    # mid-sweep interrupt: kill in-flight members, record
                    # their seeds as interrupted; the summary below is a
                    # valid partial artifact and --resume finishes it
                    self._interrupted = True
                    self._log("interrupted — tearing down in-flight "
                              "members")
                    for k in list(self._inflight):
                        seed = self._inflight[k]
                        self._kill_member(k)
                        try:
                            _write_failed_manifest(self.sweep_dir, seed,
                                                   "interrupted")
                        except OSError:
                            pass
                        failed[seed] = "interrupted"
                    self._inflight.clear()
                    self._inflight_t.clear()
        except BaseException:
            if self.live is not None:
                self.live.close()  # followers see the sweep's end
            raise
        finally:
            for conn in self._conns:
                if conn is not None:
                    try:
                        conn.send(("exit",))
                    except (OSError, ValueError):
                        pass
            for p in self._procs:
                if p is not None:
                    p.join(timeout=10)
                    if p.is_alive():
                        p.terminate()
                        p.join(timeout=10)
            if self._server is not None:
                self._server.close()
            if self._service_addr is not None:
                shutil.rmtree(os.path.dirname(self._service_addr),
                              ignore_errors=True)
        wall = _walltime.perf_counter() - t_sweep
        srv = self._server
        service_doc = ({"draw_service": {
            "served_batches": srv.served_batches,
            "served_units": srv.served_units,
            "attach_wall_seconds": round(srv.attach_wall, 3),
            "served": dict(srv.served),
            "attach_launches": dict(srv.attach_launches),
            "errors": list(srv.errors),
        }} if srv is not None else {})
        if self.fork is not None:
            from shadow_tpu_torch import forks as _forks

            fork_doc = {
                "config": self.config_path,
                "jobs": self.jobs,
                "branches_planned": self.seeds,
                "trunk_checkpoint": self.fork["ckpt"],
                "trunk_dir": self.fork["trunk_dir"],
                "failed": {str(s): failed[s] for s in sorted(failed)},
                "fork_wall_seconds": round(wall, 3),
                "exit_reason": ("interrupted" if self._interrupted
                                else "completed"),
                "retries": self.retries,
                "respawns": self._respawns,
                **service_doc,
            }
            summary = _forks.reduce_fork(self.sweep_dir, extra=fork_doc)
            n_ok = len(summary["completed"])
            self._log(f"fork done: {n_ok}/{len(self.seeds)} branch(es) "
                      f"ok, {len(failed)} failed, wall {wall:.1f}s -> "
                      f"{self.sweep_dir / _forks.FORK_SUMMARY}")
            self._end_live(n_ok, failed, wall)
            return summary
        sweep_doc = {
            "config": self.config_path,
            "jobs": self.jobs,
            "seeds": self.seeds,
            "skipped_resume": sorted(skipped),
            "failed": {str(s): failed[s] for s in sorted(failed)},
            "sweep_wall_seconds": round(wall, 3),
            "exit_reason": ("interrupted" if self._interrupted
                            else "completed"),
            "retries": self.retries,
            "respawns": self._respawns,
            **service_doc,
        }
        summary = reduce_sweep(self.sweep_dir, extra=sweep_doc)
        n_ok = len(summary["completed"])
        self._log(f"sweep done: {n_ok}/{len(self.seeds)} seeds ok, "
                  f"{len(failed)} failed, wall {wall:.1f}s -> "
                  f"{self.sweep_dir / SWEEP_SUMMARY}")
        self._end_live(n_ok, failed, wall)
        return summary

    def _end_live(self, n_ok: int, failed: dict, wall: float) -> None:
        if self.live is not None:
            self._publish({"type": "end", "ok": n_ok,
                           "failed": len(failed),
                           "wall_seconds": round(wall, 1)})
            self.live.close()

    def _dispatch_loop(self, pending: list, failed: dict) -> None:
        from multiprocessing.connection import wait as _mpwait

        idle = list(range(len(self._procs)))
        rss_note = 0.0
        while pending or self._inflight:
            # admission: one seed per idle worker, RSS-guarded
            while pending and idle:
                if not self._rss_ok():
                    now = _walltime.monotonic()
                    if now - rss_note > 10:
                        rss_note = now
                        self._log(
                            f"admission paused: fleet RSS over "
                            f"{self.max_rss_mb} MB "
                            f"({len(self._inflight)} resident)")
                    break
                k = idle.pop(0)
                seed = pending.pop(0)
                try:
                    self._conns[k].send(("run", seed))
                except (OSError, ValueError):
                    # worker died before taking the seed: requeue it and
                    # replace the worker
                    pending.insert(0, seed)
                    self._on_worker_death(k, pending, failed, idle)
                    continue
                self._inflight[k] = seed
                self._inflight_t[k] = _walltime.monotonic()
                self._attempts[seed] = self._attempts.get(seed, 0) + 1
                self._log(f"seed {seed} -> worker {k} "
                          f"({len(pending)} queued, "
                          f"{len(self._inflight)} resident)")
                self._publish({"type": "seed_dispatched", "seed": seed,
                               "worker": k, "queued": len(pending),
                               "resident": len(self._inflight)})
            live = [c for c in self._conns if c is not None]
            if not live:
                break
            ready = _mpwait(live, timeout=0.5)
            self._check_members(pending, failed, idle)
            for conn in ready:
                if conn not in self._conns:
                    continue  # its worker was killed this tick
                k = self._conns.index(conn)
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    self._on_worker_death(k, pending, failed, idle)
                    continue
                op = msg[0]
                self._inflight.pop(k, None)
                t0 = self._inflight_t.pop(k, None)
                idle.append(k)
                if op == "done":
                    _, seed, man = msg
                    if t0 is not None:
                        # completed-seed wall EMA: the basis of the member
                        # stall deadline
                        dt = _walltime.monotonic() - t0
                        self._seed_wall_ema = (
                            dt if self._seed_wall_ema == 0.0
                            else 0.7 * self._seed_wall_ema + 0.3 * dt)
                    self._log(f"seed {seed} ok "
                              f"({man['wall_seconds']}s wall, "
                              f"{man['events']} events)")
                    self._publish({"type": "seed_done", "seed": seed,
                                   "wall_seconds": man["wall_seconds"],
                                   "events": man["events"],
                                   "rounds": man["rounds"]})
                elif op == "failed":
                    _, seed, err, _tb = msg
                    self._seed_failed(seed, err, pending, failed)

    def _seed_failed(self, seed: int, err: str, pending: list,
                     failed: dict) -> None:
        """One attempt at a seed failed (member raised, died, wedged, or
        hit a ceiling): requeue while attempts remain, else record it
        failed — the final failed manifest is the last attempt's."""
        attempts = self._attempts.get(seed, 1)
        if attempts <= self.retries:
            left = self.retries - attempts + 1
            self._log(f"seed {seed} attempt {attempts} failed: {err} — "
                      f"retrying ({left} retr{'y' if left == 1 else 'ies'}"
                      f" left)")
            self._publish({"type": "seed_retry", "seed": seed,
                           "attempt": attempts, "error": err})
            pending.append(seed)
            return
        failed[seed] = err
        self._log(f"seed {seed} FAILED after {attempts} attempt(s): "
                  f"{err} — sweep continues")
        self._publish({"type": "seed_failed", "seed": seed, "error": err,
                       "attempts": attempts})

    def _member_deadline_s(self):
        """Wall seconds an in-flight member may run before it counts as
        wedged; None = no deadline yet (no completed-seed EMA basis)."""
        fixed = float(os.environ.get(FLEET_STALL_ENV, "0") or 0.0)
        if fixed > 0:
            return fixed
        if self._seed_wall_ema <= 0.0:
            return None
        from shadow_tpu_torch.supervise import stall_deadline_s

        # the supervisor's deadline curve over the seed-wall EMA, floored
        # at a minute: seeds are whole simulations, not rounds
        return max(stall_deadline_s(self._seed_wall_ema), 60.0)

    def _kill_member(self, k: int) -> None:
        """SIGKILL worker k and reap any guests its in-flight seed
        leaked."""
        p = self._procs[k]
        try:
            if p is not None and p.is_alive():
                p.kill()
        except (OSError, AttributeError):
            pass
        if p is not None:
            p.join(timeout=10)
        seed = self._inflight.get(k)
        if seed is not None:
            _reap_stale_guests(seed_dir(self.sweep_dir, seed))

    def _check_members(self, pending: list, failed: dict,
                       idle: list) -> None:
        """Liveness and resource policing of in-flight members, once per
        dispatch-loop tick: (a) a member past the stall deadline is
        wedged — kill it and retry the seed on a fresh worker; (b) a
        member over the per-member RSS ceiling is leaking — kill it,
        write a crash report, and do NOT retry."""
        if not self._inflight:
            return
        deadline = self._member_deadline_s()
        now = _walltime.monotonic()
        for k in list(self._inflight):
            seed = self._inflight[k]
            p = self._procs[k]
            if self.member_max_rss_mb and p is not None and p.is_alive():
                rss = _proc_rss_mb(p.pid)
                if rss > self.member_max_rss_mb:
                    err = (f"member RSS {rss:.0f} MB over the per-member "
                           f"ceiling {self.member_max_rss_mb} MB — killed")
                    self._log(f"seed {seed}: {err}")
                    self._kill_member(k)
                    from shadow_tpu_torch import supervise as _sup

                    d = seed_dir(self.sweep_dir, seed)
                    d.mkdir(parents=True, exist_ok=True)
                    try:
                        _sup.write_crash_report(
                            d, "member_rss_ceiling",
                            extra={"seed": seed,
                                   "rss_mb": round(rss, 1),
                                   "ceiling_mb": self.member_max_rss_mb})
                    except OSError:
                        pass
                    # exhaust the budget: an OOM-class failure is not
                    # transient
                    self._attempts[seed] = self.retries + 1
                    self._on_worker_death(k, pending, failed, idle,
                                          reason=err)
                    continue
            t0 = self._inflight_t.get(k)
            if deadline is None or t0 is None or now - t0 <= deadline:
                continue
            err = (f"member wedged: no completion after {now - t0:.1f}s "
                   f"(deadline {deadline:.1f}s) — killed by the fleet "
                   f"watchdog")
            self._log(f"seed {seed}: {err}")
            self._kill_member(k)
            self._on_worker_death(k, pending, failed, idle, reason=err)

    def _on_worker_death(self, k: int, pending: list, failed: dict,
                         idle: list, reason: str = None) -> None:
        """A worker died (hard crash, OOM kill, or the watchdog killed
        it): route its in-flight seed through the retry budget and
        respawn, so one crashed seed never sinks the fleet."""
        p = self._procs[k]
        code = p.exitcode if p is not None else None
        seed = self._inflight.pop(k, None)
        self._inflight_t.pop(k, None)
        if seed is not None:
            err = reason or f"worker process died (exit code {code})"
            try:
                _write_failed_manifest(self.sweep_dir, seed, err)
            except OSError:
                pass
            self._seed_failed(seed, err, pending, failed)
        try:
            self._conns[k].close()
        except OSError:
            pass
        self._conns[k] = None
        self._procs[k] = None
        self._respawns += 1
        if self._respawns > 2 * (len(self.seeds) * (self.retries + 1)
                                 + self.jobs):
            raise RuntimeError(
                "fleet: worker respawn limit exceeded — the environment "
                "is killing workers faster than seeds can run")
        self._procs[k], self._conns[k] = self._spawn_worker(k)
        if k not in idle:
            idle.append(k)


# -- the reducer --------------------------------------------------------------

#: two-sided 95% Student-t critical values by degrees of freedom (beyond
#: 30 the normal 1.96 is within rounding of t). Standard t tables, 3
#: decimals.
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131, 16: 2.120, 17: 2.110, 18: 2.101,
        19: 2.093, 20: 2.086, 21: 2.080, 22: 2.074, 23: 2.069, 24: 2.064,
        25: 2.060, 26: 2.056, 27: 2.052, 28: 2.048, 29: 2.045, 30: 2.042}


def t_ci95(vals: list) -> dict:
    """t-based 95% CI of the mean of per-seed statistics (the statistic is
    computed per run, the interval across runs)."""
    n = len(vals)
    if n == 0:
        return {"n": 0}
    mean = sum(vals) / n
    if n == 1:
        return {"n": 1, "mean": round(mean, 3)}
    var = sum((v - mean) ** 2 for v in vals) / (n - 1)
    s = math.sqrt(var)
    t = _T95.get(n - 1, 1.960)
    hw = t * s / math.sqrt(n)
    return {"n": n, "mean": round(mean, 3), "stdev": round(s, 3),
            "lo": round(mean - hw, 3), "hi": round(mean + hw, 3),
            "half_width": round(hw, 3)}


def reduce_sweep(sweep_dir, extra: dict = None) -> dict:
    """Merge the per-seed histogram states and manifests under
    ``sweep_dir`` into ``sweep_summary.json`` (module doc). Idempotent: a
    pure function of the on-disk per-seed artifacts."""
    from shadow_tpu_torch.telemetry.histogram import LogHistogram

    sweep_dir = Path(sweep_dir)
    if extra is None:
        # re-reduction (the report subcommand): carry the original run's
        # orchestration metadata forward instead of erasing it
        try:
            prev = json.loads((sweep_dir / SWEEP_SUMMARY).read_text())
            extra = {k: prev[k] for k in
                     ("config", "jobs", "seeds", "skipped_resume",
                      "sweep_wall_seconds", "draw_service")
                     if k in prev}
        except (OSError, ValueError):
            extra = None
    # the sweep's seed roster bounds the reduction: seed directories left
    # by an earlier, differently scoped sweep must not pollute it
    roster = set((extra or {}).get("seeds") or ()) or None
    manifests = []
    for p in sorted(sweep_dir.glob("seed_*/" + SEED_MANIFEST),
                    key=lambda p: int(p.parent.name.split("_", 1)[1])):
        try:
            man = json.loads(p.read_text())
        except ValueError:
            continue
        if man.get("format") != MANIFEST_FORMAT:
            continue
        if roster is not None and man.get("seed") not in roster:
            continue
        manifests.append(man)
    completed = [m for m in manifests if m.get("status") == "ok"]
    failed = {str(m["seed"]): m.get("error", "unknown")
              for m in manifests if m.get("status") != "ok"}
    # per-seed mergeable telemetry states, in seed order
    states = []  # (seed, state)
    for m in completed:
        p = seed_dir(sweep_dir, m["seed"]) / TEL_STATE_FILE
        if p.is_file():
            try:
                states.append((m["seed"], json.loads(p.read_text())))
            except ValueError:
                pass
    flows: dict = {}
    kinds = sorted({k for _s, st in states for k in st["flow_counts"]})
    labels = ("p50_ms", "p90_ms", "p99_ms", "p99_9_ms")
    for kind in kinds:
        pooled = LogHistogram.merged(
            [st["hist"][kind] for _s, st in states if kind in st["hist"]])
        per_seed = {lab: [] for lab in labels}
        seeds_with = []
        ok = failed_n = x_sum = x_n = 0
        for s, st in states:
            c = st["flow_counts"].get(kind)
            if c is not None:
                ok += c["ok"]
                failed_n += c["failed"]
                x_sum += c.get("x_sum", 0)
                x_n += c.get("x_n", 0)
            hs = st["hist"].get(kind)
            if hs is None:
                continue
            q = LogHistogram.from_state(hs).quantiles_ns_to_ms()
            seeds_with.append(s)
            for lab in labels:
                per_seed[lab].append(q[lab])
        flows[kind] = {
            "count": ok + failed_n,
            "ok": ok,
            "failed": failed_n,
            "pooled": pooled.quantiles_ns_to_ms(),
            "seeds": seeds_with,
            "per_seed": per_seed,
            "ci95": {lab: t_ci95(per_seed[lab]) for lab in labels},
        }
        if x_n:
            flows[kind]["x_mean"] = x_sum // x_n
    doc = {
        "format": SUMMARY_FORMAT,
        "n_seeds": len(manifests),
        "completed": [m["seed"] for m in completed],
        "failed": failed,
        "per_seed_wall_seconds": {
            str(m["seed"]): m.get("wall_seconds") for m in completed},
        "events_total": sum(m.get("events", 0) for m in completed),
        "flows": flows,
        **(extra or {}),
    }
    _write_json(sweep_dir / SWEEP_SUMMARY, doc)
    return doc


def render_report(summary: dict) -> str:
    """Human-readable sweep report (tools/metrics_report.py lineage)."""
    lines = []
    n_ok = len(summary.get("completed", []))
    failed = summary.get("failed", {})
    lines.append(
        f"sweep: {summary.get('n_seeds', n_ok)} seed(s), {n_ok} ok, "
        f"{len(failed)} failed"
        + (f", jobs={summary['jobs']}" if "jobs" in summary else "")
        + (f", wall {summary['sweep_wall_seconds']}s"
           if "sweep_wall_seconds" in summary else ""))
    for s, err in sorted(failed.items(), key=lambda kv: kv[0]):
        lines.append(f"  FAILED seed {s}: {err}")
    svc = summary.get("draw_service")
    if svc:
        lines.append(
            f"  shared draw service: {svc['served_batches']} batches / "
            f"{svc['served_units']} units served, one attach "
            f"({svc['attach_wall_seconds']}s)")
        for err in svc.get("errors", ()):
            lines.append(f"  DRAW SERVICE ERROR: {err}")
    flows = summary.get("flows", {})
    if not flows:
        lines.append("  (no flow telemetry recorded — enable telemetry "
                     "for cross-seed percentile CIs)")
        return "\n".join(lines)
    lines.append("")
    hdr = (f"  {'flow group':<18} {'n':>8} {'ok':>8} "
           f"{'pooled p50/p90/p99 ms':>26}   "
           f"{'p50 CI95':>20} {'p99 CI95':>20}")
    lines.append(hdr)
    lines.append("  " + "-" * (len(hdr) - 2))

    def ci_str(ci):
        if ci.get("n", 0) < 2:
            return f"{ci.get('mean', '-')} (n<2)"
        return f"{ci['mean']:.1f} ± {ci['half_width']:.1f}"

    for kind in sorted(flows):
        f = flows[kind]
        pooled = f["pooled"]
        lines.append(
            f"  {kind:<18} {f['count']:>8} {f['ok']:>8} "
            f"{pooled['p50_ms']:>8.1f}/{pooled['p90_ms']:>7.1f}/"
            f"{pooled['p99_ms']:>8.1f}   "
            f"{ci_str(f['ci95']['p50_ms']):>20} "
            f"{ci_str(f['ci95']['p99_ms']):>20}")
    lines.append("")
    lines.append("  CI95: t-based over per-seed percentiles (seeds are "
                 "the independent unit; pooled = all seeds merged into "
                 "one histogram)")
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch.fleet",
        description="fleet mode: N-seed simulation sweeps with mergeable "
                    "cross-run statistics")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sweep", help="run an N-seed sweep")
    ps.add_argument("config", help="simulation YAML config file")
    ps.add_argument("--seeds", type=int, default=10, metavar="N",
                    help="number of seeds (base, base+1, ..., base+N-1); "
                    "default 10")
    ps.add_argument("--seed-base", type=int, default=None,
                    help="first seed (default: the config's general.seed)")
    ps.add_argument("--jobs", type=int, default=2, metavar="M",
                    help="concurrent member simulations (default 2)")
    ps.add_argument("--sweep-dir", default=None,
                    help="sweep output root (default: <config-stem>.sweep)")
    ps.add_argument("--resume", action="store_true",
                    help="skip seeds whose per-seed manifest is already "
                    "complete under this config")
    ps.add_argument("--stop-time", help="override general.stop_time")
    ps.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any config option by dotted path; "
                    "repeatable")
    ps.add_argument("--max-rss-mb", type=int, default=None,
                    help="admission guard: pause handing out new seeds "
                    "while fleet RSS exceeds this (default: 80%% of "
                    "MemTotal; 0 disables)")
    ps.add_argument("--member-max-rss-mb", type=int, default=0,
                    metavar="MB",
                    help="per-member RSS ceiling: a member over it is "
                    "killed, its seed recorded failed with a crash "
                    "report, and NOT retried (default 0 = off)")
    ps.add_argument("--retries", type=int, default=1, metavar="N",
                    help="bounded retry budget per seed: a crashed or "
                    "wedged seed is requeued up to N times before it "
                    "counts as failed (default 1; 0 disables)")
    ps.add_argument("--no-pin", action="store_true",
                    help="do not pin worker processes to cores")
    ps.add_argument("--no-device-service", action="store_true",
                    help="members attach the device individually instead "
                    "of sharing the parent's attach")
    ps.add_argument("--no-telemetry", action="store_true",
                    help="do not auto-enable telemetry (no flow "
                    "percentiles or CIs in the sweep summary)")
    ps.add_argument("--live-endpoint", metavar="PATH",
                    help="bind a STATUS-ONLY AF_UNIX endpoint streaming "
                    "per-seed lifecycle records (dispatched/done/failed); "
                    "runtime commands are refused — 'auto' = "
                    "<sweep-dir>/live.sock")
    ps.add_argument("--quiet", action="store_true",
                    help="no progress lines on stderr")
    ps.add_argument("--json", action="store_true",
                    help="print the sweep summary as one JSON line on "
                    "stdout instead of the report")
    ps.add_argument("--fork-from", metavar="CKPT", default=None,
                    help="fork mode (forks.py): restore this trunk "
                    "checkpoint into every worker and run the --branches "
                    "divergence specs instead of seeds")
    ps.add_argument("--branches", metavar="FILE", default=None,
                    help="branches.yaml for --fork-from: the per-branch "
                    "divergence specs")
    ps.add_argument("--trunk-dir", metavar="DIR", default=None,
                    help="the trunk run directory for --fork-from "
                    "(default: derived from the checkpoint path's "
                    "<trunk>/checkpoints/ layout)")
    ps.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the members' kernels run and the shared "
                    "draw service attaches (default cuda; cpu runs the "
                    "plain PyTorch versions)")
    pr = sub.add_parser("report", help="re-reduce + render a sweep (or "
                        "fork) directory")
    pr.add_argument("sweep_dir")
    pr.add_argument("--json", action="store_true",
                    help="print the summary JSON instead of the report")
    pr.add_argument("--compare", action="store_true",
                    help="fork directories: render only the comparative "
                    "table (per-group percentile deltas vs the trunk "
                    "with CI95)")
    return p


def _sweep_overrides(args, fork: bool = False) -> dict:
    import yaml as _yaml

    over: dict = {}
    if args.stop_time:
        over["general.stop_time"] = args.stop_time
    for item in args.set:
        if "=" not in item:
            print(f"fleet: --set expects KEY=VALUE, got {item!r}",
                  file=sys.stderr)
            raise SystemExit(2)
        k, v = item.split("=", 1)
        over[k] = _yaml.safe_load(v)
    if fork:
        # a fork inherits the trunk's telemetry settings verbatim:
        # auto-enabling here would re-cadence streams the trunk already
        # started (forks.plan_fork refuses telemetry overlays by name)
        return over
    if not args.no_telemetry and not any(
            k.startswith("telemetry") for k in over):
        # a sweep is for cross-seed percentiles: enable telemetry (at its
        # default cadence) unless the config or overrides speak for it —
        # a standalone run with the same settings stays byte-identical
        from shadow_tpu_torch.config.schema import load_yaml_doc

        if "telemetry" not in (load_yaml_doc(args.config, cache=True)
                               or {}):
            over["telemetry.sample_every"] = "10s"
    return over


def _is_fork_dir(d) -> bool:
    d = Path(d)
    return ((d / FORK_SUMMARY).is_file()
            or any(sorted(d.glob("branch_*/" + FORK_MANIFEST))))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "report":
        if _is_fork_dir(args.sweep_dir):
            from shadow_tpu_torch import forks as _forks

            summary = _forks.reduce_fork(args.sweep_dir)
            print(json.dumps(summary) if args.json
                  else _forks.render_compare(summary) if args.compare
                  else _forks.render_fork_report(summary))
            return 0 if not summary["failed"] else 1
        if args.compare:
            print(f"fleet: {args.sweep_dir} is a seed sweep, not a fork "
                  f"— --compare diffs fork branches against their trunk",
                  file=sys.stderr)
            return 2
        summary = reduce_sweep(args.sweep_dir)
        print(json.dumps(summary) if args.json
              else render_report(summary))
        return 0 if not summary["failed"] else 1
    fork_plan = None
    if args.fork_from or args.branches or args.trunk_dir:
        if not (args.fork_from and args.branches):
            print("fleet: --fork-from and --branches go together (a fork "
                  "needs both the trunk checkpoint and the divergence "
                  "specs; --trunk-dir only names the trunk of such a fork)",
                  file=sys.stderr)
            return 2
        if args.resume:
            print("fleet: a fork cannot --resume — just re-run it",
                  file=sys.stderr)
            return 2
    try:
        over = _sweep_overrides(args, fork=bool(args.fork_from))
        if args.fork_from:
            from shadow_tpu_torch import forks as _forks

            sweep_dir = (args.sweep_dir
                         or (Path(args.config).stem + ".fork"))
            branches = _forks.load_branches(args.branches)
            fork_plan = _forks.plan_fork(
                args.config, args.fork_from, branches, sweep_dir,
                overrides=over, trunk_dir=args.trunk_dir)
            seeds = fork_plan["order"]
        else:
            if args.seed_base is not None:
                base = int(args.seed_base)
            else:
                from shadow_tpu_torch.config.schema import load_yaml_doc

                doc = load_yaml_doc(args.config, cache=True)
                base = int(((doc or {}).get("general") or {})
                           .get("seed", 1))
            seeds = [base + i for i in range(int(args.seeds))]
            sweep_dir = (args.sweep_dir
                         or (Path(args.config).stem + ".sweep"))
        runner = FleetRunner(
            args.config, seeds, args.jobs, sweep_dir, overrides=over,
            resume=args.resume, max_rss_mb=args.max_rss_mb,
            pin_cores=not args.no_pin,
            device_service=not args.no_device_service, quiet=args.quiet,
            retries=args.retries,
            member_max_rss_mb=args.member_max_rss_mb, device=args.device,
            live_endpoint=args.live_endpoint, fork=fork_plan)
        summary = runner.run()
    except FileNotFoundError as exc:
        print(f"fleet: config file not found: "
              f"{getattr(exc, 'filename', None) or exc}", file=sys.stderr)
        return 2
    except (ValueError, OSError) as exc:
        print(f"fleet: {exc}", file=sys.stderr)
        return 2
    if fork_plan is not None:
        from shadow_tpu_torch import forks as _forks

        print(json.dumps(summary) if args.json
              else _forks.render_fork_report(summary))
    else:
        print(json.dumps(summary) if args.json
              else render_report(summary))
    if summary.get("exit_reason") == "interrupted":
        return 130  # conventional SIGINT status; the summary above is a
        # valid partial artifact and --resume finishes the sweep
    return 0 if not summary["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
