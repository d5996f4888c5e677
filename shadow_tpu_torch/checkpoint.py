"""Checkpoint/restore with byte-identical resume + the determinism sentinel.

The port of shadow_tpu/checkpoint.py, its managed re-execution snapshots
included. Any run can be snapshotted at a round boundary and resumed so
that the continuation is byte-identical to the uninterrupted run — and to the
reference's — and any run can emit a canonical per-round state digest
stream equal to the reference's (``tools/bisect_divergence.py --a REF
--b PORT`` names the first round where two streams part).

Why whole-graph serialization works here: at a round *boundary* the entire
simulation is quiescent state — host event heaps, transport endpoint
machines, fluid bucket arrays, the columnar pending-arrival store,
counter-based RNG generators, the fault-timeline cursor. State held in the
C engine's objects (csrc/colcore.c endpoints, tor sinks/relays, gossip
states, packed store batches) exports to plain Python structures through
per-type ``_export_state`` reducers and rebuilds on load, through the
port's own loader (``native.colcore()``). The header's ``colcore``
fingerprint (the engine's state ABI and a hash of its source) refuses a
checkpoint from another build by name.

What a checkpoint never carries is device state. The draw plane (its
page-locked DrawSlots and in-flight DrawHandle/MinDrawHandle reads), the
mesh plane, the device transport (its AckSlots), the speculative
``min_draw`` waves, CUDA streams and events, and every torch tensor are
runtime plumbing: ``engine.flush_all()`` resolves every window and wave in
flight before the state walk (result-identical: flags are pure functions
of unit identity), the planes' ``__getstate__`` drop them, and
``Controller._reattach_runtime`` rebuilds them on the resume
invocation's device — which may differ from the writing run's
(``--device cuda`` written, ``--device cpu`` resumed, and the reverse).
A torch object that still reaches the pickler fails by name
(``_forbidden``) rather than being written.

Closures: event heaps and endpoint callbacks hold nested functions and
lambdas (model code), which stdlib pickle refuses. ``_SimPickler`` reduces
any non-importable function to (marshaled code object, module, defaults,
closure cells); cells are reconstructed empty and filled via a state setter
so shared cells keep their identity and recursive closures cannot loop the
pickler. Marshal ties a checkpoint to the interpreter that wrote it, so the
header records the (major, minor) Python version and loading refuses a
mismatch.

The file's ``format`` names this package: the reference refuses a port
checkpoint and the port refuses the reference's (their class paths
differ).

A config with managed (real-binary) processes cannot be pickled — its
guests are live OS processes — so it snapshots by re-execution instead
(``mode: "reexec"``): a JSON header and a JSON payload holding the state
digest at the boundary, every guest's observation-journal cursor and the
live commands applied so far. The restore rebuilds the controller from
the config and re-runs the deterministic prefix from round 0; at the
snapshot's boundary it verifies the digest and the cursors, and fails by
name where they differ.

SECURITY: a pickled checkpoint is a pickle — loading one executes code. Treat
checkpoint files like the simulation configs that produced them: trusted
local artifacts, never untrusted input.

The determinism sentinel (``general.state_digest_every``) reuses the same
quiescent-boundary walk, but hashes only *plane-independent* observables,
so one digest stream is comparable across all scheduler policies, both
host engines and the reference.
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import io
import json
import marshal
import mmap
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np

FORMAT = "shadow_tpu_torch-checkpoint"
#: the port's own format. Version 1: the reference's version-5 pickle
#: payload (C-engine state, SACK/congestion-control sender fields, sorted
#: scoreboards) under this package's class paths. Version 2: managed
#: (real-binary) configs checkpoint as re-execution snapshots (header
#: ``mode: "reexec"`` + a JSON payload of state digest, per-guest journal
#: cursors and applied live commands — no pickle); pickled payloads are
#: unchanged. No version-1 build could save a managed run, so a
#: managed-marked header below 2 is refused by name.
VERSION = 2
#: the first version that can describe a managed run
REEXEC_VERSION = 2
#: config keys that may legitimately differ between the checkpointing run
#: and the resuming invocation (run-location, snapshot policy, and the
#: data-plane implementation toggles — never simulation semantics:
#: native_colcore and device_transport are bit-identical on and off, and
#: the resume honors the invocation's values by rebuilding — or not — the
#: C engine and the transport). The device (``--device``) is not a config
#: key at all: the resume invocation's device is the one reattached.
VOLATILE_CONFIG_KEYS = (
    ("general", "data_directory"),
    ("general", "checkpoint_every"),
    ("general", "checkpoint_dir"),
    ("general", "state_digest_every"),
    ("general", "progress"),
    ("general", "heartbeat_interval"),
    ("general", "log_level"),
    ("general", "live_endpoint"),
    ("general", "replay_commands"),
    ("experimental", "native_colcore"),
    ("experimental", "device_transport"),
)

DIGEST_FILE = "state_digests.jsonl"


class CheckpointError(ValueError):
    """A checkpoint could not be written, read, or applied."""


# -- closure-capable pickling -------------------------------------------------

def _rebuild_function(code_bytes, module, name, defaults, kwdefaults,
                      closure, qualname=None):
    """Reconstruct a nested function/lambda from its marshaled code object.
    Globals are the (re-imported) defining module's dict — all model and
    simulator code is importable, which the save path verified. The
    original ``__qualname__`` is restored explicitly, so a rebuilt closure
    keeps its ``<locals>`` marker for the reducer's importability test at
    the NEXT checkpoint (a resumed run that checkpoints again)."""
    glb = importlib.import_module(module).__dict__ if module else {}
    fn = types.FunctionType(marshal.loads(code_bytes), glb, name,
                            defaults, closure)
    if kwdefaults:
        fn.__kwdefaults__ = kwdefaults
    if qualname:
        fn.__qualname__ = qualname
    return fn


def _make_cell():
    return types.CellType()


def _cell_set(cell, state):
    if state:  # () = the cell was empty (declared but never bound)
        cell.cell_contents = state[0]


# -- C-engine state (csrc/colcore.c) ------------------------------------------
#
# A run with the C engine attached holds live state in C extension objects:
# stream endpoints, tor relays/sinks/exit streams, gossip states, and packed
# store batches. Each exports its COMPLETE state as plain Python structures
# via ``_export_state`` and rebuilds from them — the pickler reduces every C
# object to (shell, (), state, _colcore_setstate), so shared references and
# reference cycles ride the memo exactly like Python objects. Core pointers
# are never pickled: ``Controller._reattach_runtime`` rebuilds the core and
# binds the restored objects via ``Core.adopt`` (finish_colcore_adopt
# below). Packed store batches reduce to the plain StoreBatch row-list form
# — the plane-neutral representation either plane can resume from.

#: restored C objects awaiting a core binding; drained by
#: finish_colcore_adopt after _reattach_runtime rebuilds the C engine
_PENDING_ADOPT: list = []
#: colcore type names whose instances need a core pointer at adopt time
_ADOPT_KINDS = frozenset(("Endpoint", "GossipState", "Relay"))


def _colcore_shell(kind):
    from shadow_tpu_torch.native import colcore

    return colcore().shell(kind)


def _colcore_setstate(obj, state):
    obj._restore_state(state)
    if type(obj).__name__ in _ADOPT_KINDS:
        _PENDING_ADOPT.append(obj)


def _rebuild_storebatch(rows, pos):
    from shadow_tpu_torch.network.colplane import StoreBatch

    b = StoreBatch(rows)
    b.pos = pos
    return b


class _DeadCoreHandle:
    """Stands in for a pickled reference to the old C core (reachable only
    through activation-hook closures): _reattach_runtime rewires every
    hook to the fresh core before the simulation resumes, so any call that
    reaches this object is a wiring bug — fail by name."""

    def __getattr__(self, name):
        def _dead(*_a, **_k):
            raise CheckpointError(
                f"stale C-core reference called ({name}) — "
                f"_reattach_runtime did not rewire an activation hook")

        return _dead


def _dead_core():
    return _DeadCoreHandle()


def finish_colcore_adopt(controller) -> None:
    """Bind every checkpoint-restored C object to the rebuilt core
    (called by Controller._reattach_runtime after attach_colcore)."""
    global _PENDING_ADOPT
    pend, _PENDING_ADOPT = _PENDING_ADOPT, []
    if not pend:
        return
    core = getattr(controller.engine, "_c", None)
    if core is None:
        raise CheckpointError(
            "checkpoint contains C-engine state but no C engine was "
            "rebuilt — resume with experimental.native_colcore enabled on "
            "a tpu policy (or re-checkpoint from a Python-plane run)")
    core.adopt(pend)


def colcore_fingerprint() -> str:
    """The C engine's build identity in a header: its state ABI and a
    hash of the port's engine source, so a checkpoint carrying C state
    resumes only on the engine that wrote it."""
    from shadow_tpu_torch.native import SOURCE, colcore

    src = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return f"abi{int(colcore().ABI)}-{src}"


@functools.lru_cache(maxsize=1)
def _forbidden() -> tuple:
    """Live runtime objects that must never appear in a checkpoint;
    hitting one means a snapshot-preparation bug, and the error should say
    WHAT leaked instead of pickle's opaque complaint (or, for a tensor,
    instead of silently writing device state). Built at first use: the
    torch classes are imported only by a run that checkpoints."""
    import torch

    from shadow_tpu_torch.live import LiveServer, _LiveClient
    from shadow_tpu_torch.ops.propagate import (DrawHandle, DrawSlot,
                                                MinDrawHandle)
    from shadow_tpu_torch.ops.transport_kernels import AckSlot, AckSlots

    return (
        (LiveServer, "live endpoint server (LiveServer)"),
        (_LiveClient, "live endpoint client (_LiveClient)"),
        (threading.Thread, "thread"),
        (io.IOBase, "open file"),
        (socket.socket, "socket"),
        (mmap.mmap, "memory map"),
        (subprocess.Popen, "subprocess"),
        (torch.Tensor, "torch tensor"),
        (torch.cuda.Event, "CUDA event"),
        (torch.cuda.Stream, "CUDA stream"),
        (DrawSlot, "draw-plane DrawSlot"),
        (DrawHandle, "draw-plane DrawHandle"),
        (MinDrawHandle, "draw-plane MinDrawHandle"),
        (AckSlot, "device-transport AckSlot"),
        (AckSlots, "device-transport AckSlots"),
    )


class _SimPickler(pickle.Pickler):
    def reducer_override(self, obj):
        tp = type(obj)
        if getattr(tp, "__module__", None) == "_colcore":
            name = tp.__name__
            if name == "CBatch":
                pos, rows = obj.export_rows()
                return (_rebuild_storebatch, (rows, pos))
            if name == "Core":
                # only reachable through activation-hook closures; the
                # restore path rebuilds a fresh core and rewires them
                return (_dead_core, ())
            if name in ("Endpoint", "Relay", "TorSink", "GossipState",
                        "ExitStream"):
                # shell first, state second: cycles (endpoint <-> relay
                # <-> model callbacks) resolve through the pickle memo
                return (_colcore_shell, (name,), obj._export_state(),
                        None, None, _colcore_setstate)
            raise CheckpointError(
                f"cannot checkpoint colcore object of type {name!r}")
        if isinstance(obj, types.FunctionType):
            qn = getattr(obj, "__qualname__", "")
            if "<locals>" not in qn and "<lambda>" not in qn:
                # importable IF the module really exposes this object under
                # its name; otherwise marshal it
                m = sys.modules.get(obj.__module__ or "")
                if m is not None and getattr(m, obj.__name__, None) is obj:
                    return NotImplemented  # pickle by reference
            mod = obj.__module__
            if mod is None or mod not in sys.modules:
                raise CheckpointError(
                    f"cannot checkpoint closure {qn!r}: defining module "
                    f"{mod!r} is not importable")
            return (_rebuild_function,
                    (marshal.dumps(obj.__code__), mod, obj.__name__,
                     obj.__defaults__, obj.__kwdefaults__, obj.__closure__,
                     qn))
        if isinstance(obj, types.CellType):
            try:
                state = (obj.cell_contents,)
            except ValueError:
                state = ()
            # contents ride as post-creation state (not a constructor arg)
            # so cells shared between closures dedupe through the memo and
            # self-referential closures terminate
            return (_make_cell, (), state, None, None, _cell_set)
        for t, label in _forbidden():
            if isinstance(obj, t):
                raise CheckpointError(
                    f"cannot checkpoint a live {label} ({tp.__name__}) — "
                    f"snapshot preparation should have detached it (a "
                    f"checkpoint never carries device state)")
        return NotImplemented


# -- config identity ----------------------------------------------------------

def config_digest(cfg) -> str:
    """Canonical digest of the simulation-semantic part of a config: a
    resume under a *different* config would not be the same simulation, so
    load refuses it. Keys in VOLATILE_CONFIG_KEYS are excluded."""
    import dataclasses

    doc = {
        "general": dataclasses.asdict(cfg.general),
        "network": cfg.network,
        "experimental": dataclasses.asdict(cfg.experimental),
        "hosts": [dataclasses.asdict(h) for h in cfg.hosts],
        "faults": (dataclasses.asdict(cfg.faults)
                   if cfg.faults is not None else None),
    }
    for section, key in VOLATILE_CONFIG_KEYS:
        doc[section].pop(key, None)
    # sim_shards is excluded from the digest but is NOT volatile: the
    # header records it explicitly and load refuses a mismatched count BY
    # NAME (a shard checkpoint is one piece of an N-way partition — it
    # can only resume into the same partition)
    doc["general"].pop("sim_shards", None)
    blob = json.dumps(doc, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def config_has_managed(cfg) -> bool:
    """True when any configured process is a real managed executable (not
    ``pyapp:``) — such configs checkpoint as re-execution snapshots."""
    from shadow_tpu_torch.host.process import PluginProcess

    return any(not PluginProcess.is_plugin_path(popts.path)
               for hopts in cfg.hosts for popts in hopts.processes)


# -- save / load --------------------------------------------------------------

def checkpoint_path(ckpt_dir: Path, sim_time: int,
                    shard: int = None) -> Path:
    if shard is not None:
        return Path(ckpt_dir) / f"ckpt_t{sim_time:020d}.shard{shard}.ckpt"
    return Path(ckpt_dir) / f"ckpt_t{sim_time:020d}.ckpt"


def save_checkpoint(controller, now: int) -> Path:
    """Serialize the complete simulation state at the round boundary
    ``now``. Must be called from the controller's round loop (or after it),
    when no scheduler worker is mid-round."""
    validate_config_checkpointable(controller.cfg)  # direct-API callers get
    #                                 the same clear refusal the CLI gets
    eng = controller.engine
    # resolve every draw window and speculative min_draw wave still in
    # flight in a page-locked slot: result-identical, and device-free
    eng.flush_all()
    if eng.outstanding:
        raise CheckpointError(
            "engine still holds outstanding draw batches after flush_all()")
    ckpt_dir = Path(controller.ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    n_shards = int(getattr(controller, "n_shards", 1))
    path = checkpoint_path(
        ckpt_dir, now,
        shard=controller.shard_id if n_shards > 1 else None)
    if config_has_managed(controller.cfg):
        if n_shards > 1:
            raise CheckpointError(
                "managed re-execution checkpoints are single-process only "
                "(sim_shards=1); sharded managed runs cannot checkpoint")
        return _save_reexec(controller, now, path)
    # C-engine fingerprint: when the engine is attached the payload
    # carries C-exported state, and resuming it on another engine build
    # must fail fast by name instead of diverging silently
    colcore_id = (colcore_fingerprint()
                  if getattr(eng, "_c", None) is not None else None)
    header = {
        "format": FORMAT,
        "version": VERSION,
        "python": list(sys.version_info[:2]),
        "sim_time_ns": now,
        "rounds": controller.rounds,
        "events": controller.events,
        "config_digest": config_digest(controller.cfg),
        "colcore": colcore_id,
        # multi-process sharding: the shard count is part of the state's
        # identity — a shard checkpoint holds 1/N of the host partition
        # and can only resume into an N-way run (load refuses by name)
        "sim_shards": n_shards,
        **({"shard": controller.shard_id} if n_shards > 1 else {}),
    }
    tmp = path.with_suffix(".tmp")
    try:
        # stream the pickle straight into the temp file: a checkpoint at
        # scale is GBs, and a BytesIO staging copy would hold the whole
        # thing in RAM twice on top of the live state
        with open(tmp, "wb") as f:
            f.write(json.dumps(header, sort_keys=True).encode() + b"\n")
            _SimPickler(f, protocol=4).dump(
                {"now": now, "controller": controller})
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)  # a torn write can never look like a checkpoint
    return path


def _save_reexec(controller, now: int, path: Path) -> Path:
    """Write a re-execution snapshot (format version 2) for a managed
    config: a JSON header + JSON payload (no pickle). The payload pins everything the
    restore must reproduce and verify — the round cursor, the canonical
    state digest at this boundary, each guest's journal cursor, and the
    live commands applied so far (embedded so the restore re-applies them
    at the same boundaries without needing the original run directory)."""
    g, hosts = state_digest(controller, now)
    commands = []
    cmd_log = Path(controller.data_dir) / "commands.jsonl"
    if cmd_log.is_file():
        from shadow_tpu_torch.live import load_command_log

        commands = [r for r in load_command_log(cmd_log) if r["t"] <= now]
    header = {
        "format": FORMAT,
        "version": VERSION,
        "mode": "reexec",
        "managed": True,
        "python": list(sys.version_info[:2]),
        "sim_time_ns": now,
        "rounds": controller.rounds,
        "events": controller.events,
        "config_digest": config_digest(controller.cfg),
        "colcore": None,  # no exported C state rides a reexec snapshot
        "sim_shards": 1,
    }
    payload = {
        "digest": g,
        "hosts": hosts,
        "cursors": controller.guest_journal_cursors(),
        "commands": commands,
    }
    tmp = path.with_suffix(".tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(json.dumps(header, sort_keys=True).encode() + b"\n")
            f.write(json.dumps(payload, sort_keys=True).encode() + b"\n")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)
    return path


def read_header(path) -> dict:
    with open(path, "rb") as f:
        line = f.readline()
    try:
        header = json.loads(line)
    except ValueError as exc:
        raise CheckpointError(
            f"{path}: not a shadow_tpu_torch checkpoint") from exc
    if not isinstance(header, dict) or header.get("format") != FORMAT:
        raise CheckpointError(
            f"{path}: not a shadow_tpu_torch checkpoint"
            + (" (written by the reference package shadow_tpu, whose class "
               "paths differ)" if isinstance(header, dict)
               and header.get("format") == "shadow_tpu-checkpoint" else ""))
    return header


def load_checkpoint(path, cfg=None, mirror_log: bool = True,
                    device: str = "cuda"):
    """Restore a checkpoint; returns ``(controller, resume_at)``.

    ``cfg`` is the current invocation's parsed config: its semantic digest
    must match the checkpoint's (VOLATILE_CONFIG_KEYS excepted — so the
    resume may redirect data_directory or change snapshot cadence), and its
    volatile keys are applied to the restored controller. ``device`` is the
    resume invocation's: the data-plane kernels reattach there.
    """
    header = read_header(path)
    if header.get("managed") and int(header.get("version") or 0) \
            < REEXEC_VERSION:
        # can only be a hand-rolled or corrupted artifact: every build
        # that could save a managed checkpoint wrote version 2
        # re-execution cursors. Name the real requirement instead of the
        # generic version complaint.
        raise CheckpointError(
            f"{path}: managed guests require checkpoint format version "
            f"{REEXEC_VERSION} (deterministic re-execution cursors); this "
            f"file claims version {header.get('version')} — re-checkpoint "
            f"the run with a current build")
    if header.get("version") != VERSION:
        raise CheckpointError(
            f"{path}: checkpoint version {header.get('version')} != "
            f"supported {VERSION}")
    if header.get("mode") == "reexec":
        return _load_reexec(path, header, cfg, mirror_log, device)
    if tuple(header.get("python", ())) != tuple(sys.version_info[:2]):
        raise CheckpointError(
            f"{path}: written by Python "
            f"{'.'.join(map(str, header.get('python', ())))}, running "
            f"{sys.version_info[0]}.{sys.version_info[1]} — marshaled "
            f"closures are not portable across interpreter versions")
    if cfg is not None:
        have_sh = int(header.get("sim_shards", 1))
        want_sh = int(getattr(cfg.general, "sim_shards", 1))
        if have_sh != want_sh:
            raise CheckpointError(
                f"{path}: checkpoint written with sim_shards={have_sh} "
                f"but this invocation has sim_shards={want_sh} — the host "
                f"partition is part of the snapshot's identity; resume "
                f"with general.sim_shards={have_sh} (results are "
                f"byte-identical at any shard count, so re-running from "
                f"scratch at the new count reproduces the same "
                f"simulation)")
    want_c = header.get("colcore")
    if want_c is not None:
        # the payload carries C-engine state: the resume needs the engine
        # build that wrote it, and the invocation must not disable the C
        # engine (C tor/tgen sink state has no Python rebuild path)
        try:
            have_c = colcore_fingerprint()
        except RuntimeError as exc:
            raise CheckpointError(
                f"{path}: checkpoint carries C-engine state ({want_c}) but "
                f"the C engine cannot be built here: {exc}") from exc
        if have_c != want_c:
            raise CheckpointError(
                f"{path}: checkpoint written by C engine {want_c}, this "
                f"build is {have_c} — the C state formats may differ; "
                f"resume on the writing build or re-checkpoint from a "
                f"Python-plane run")
        if cfg is not None and not cfg.experimental.native_colcore:
            raise CheckpointError(
                f"{path}: checkpoint carries C-engine state but the "
                f"resume invocation disables it "
                f"(experimental.native_colcore=false); C endpoint/sink "
                f"state cannot be demoted to the Python plane — resume "
                f"with the C engine enabled, or re-checkpoint from a "
                f"Python-plane run")
    if cfg is not None:
        want, got = header["config_digest"], config_digest(cfg)
        if want != got:
            raise CheckpointError(
                f"{path}: config mismatch — the checkpoint was written "
                f"under a different simulation config (digest {want[:12]} "
                f"vs {got[:12]}). Resume with the original config; only "
                f"data_directory / checkpoint / digest / logging keys may "
                f"differ.")
    global _PENDING_ADOPT
    _PENDING_ADOPT = []  # a failed earlier load must not leak stale objects
    with open(path, "rb") as f:
        f.readline()
        try:
            # stream-unpickle from the positioned handle: no staging copy
            # of a potentially multi-GB payload beside the object graph
            obj = pickle.load(f)
        except CheckpointError:
            raise
        except Exception as exc:
            raise CheckpointError(
                f"{path}: corrupt or unreadable checkpoint payload "
                f"({type(exc).__name__}: {exc})") from exc
    controller, now = obj["controller"], obj["now"]
    if cfg is not None:
        # apply the resume invocation's volatile keys — driven off
        # VOLATILE_CONFIG_KEYS so exclusion (config_digest) and
        # application can never drift apart
        for section, key in VOLATILE_CONFIG_KEYS:
            setattr(getattr(controller.cfg, section), key,
                    getattr(getattr(cfg, section), key))
        # the telemetry section is volatile too (result-transparent, not
        # in the config digest) but is a whole subsystem, not a scalar:
        # honor the resume invocation's section — enable, disable, or
        # re-cadence — instead of silently keeping the pickled state
        _apply_telemetry_resume(controller, cfg.telemetry, now)
    controller._reattach_runtime(mirror_log=mirror_log, device=device)
    controller.log.info(
        f"resumed from {path}: sim time {now} ns, round {controller.rounds}, "
        f"{controller.events} events, device {device}")
    return controller, now


def _load_reexec(path, header, cfg, mirror_log: bool, device: str):
    """Restore a managed re-execution snapshot: rebuild the controller
    from the config and hand back ``(controller, None)`` — the caller's
    ``run(resume_at=None)`` then re-executes the deterministic prefix from
    round 0. The snapshot's round cursor, state digest, and per-guest
    journal cursors are armed on the controller and verified when the
    round loop reaches the recorded boundary (divergence fails by name);
    the run keeps going from there, byte-identical to the uninterrupted
    run. Live commands recorded up to the boundary ride the snapshot and
    are re-applied at their original boundaries via the replay plane. The
    rebuilt controller attaches its kernels on the resuming invocation's
    ``device``."""
    if cfg is None:
        raise CheckpointError(
            f"{path}: a managed re-execution snapshot rebuilds the "
            f"simulation from its config — pass the config to "
            f"load_checkpoint (the CLI's --resume-from does)")
    if int(getattr(cfg.general, "sim_shards", 1)) != 1:
        raise CheckpointError(
            f"{path}: managed re-execution snapshots resume at "
            f"sim_shards=1 only")
    want, got = header["config_digest"], config_digest(cfg)
    if want != got:
        raise CheckpointError(
            f"{path}: config mismatch — the checkpoint was written "
            f"under a different simulation config (digest {want[:12]} "
            f"vs {got[:12]}). Resume with the original config; only "
            f"data_directory / checkpoint / digest / logging keys may "
            f"differ.")
    with open(path, "rb") as f:
        f.readline()
        try:
            payload = json.loads(f.readline())
        except ValueError as exc:
            raise CheckpointError(
                f"{path}: corrupt re-execution snapshot payload") from exc
    commands = payload.get("commands") or []
    if commands and not cfg.general.replay_commands:
        # the resume invocation has no command log of its own: replay the
        # embedded records so runtime faults land on the same boundaries
        ddir = Path(cfg.general.data_directory)
        ddir.mkdir(parents=True, exist_ok=True)
        replay = ddir / "reexec_commands.jsonl"
        with open(replay, "w") as f:
            for rec in commands:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        cfg.general.replay_commands = str(replay)
    from shadow_tpu_torch.core.controller import Controller

    controller = Controller(cfg, mirror_log=mirror_log, device=device)
    if payload.get("cursors") and controller.guest_journal_dir is None:
        # the resume invocation may not itself checkpoint, but cursor
        # verification needs the re-executed guests journaled
        controller.guest_journal_dir = controller.data_dir / "guest_oplogs"
    controller._reexec_verify = {
        "path": str(path),
        "t": int(header["sim_time_ns"]),
        "rounds": int(header["rounds"]),
        "digest": payload["digest"],
        "cursors": payload.get("cursors") or {},
    }
    controller.log.info(
        f"restoring {path} by deterministic re-execution: re-running "
        f"rounds 0..{header['rounds']} (sim {header['sim_time_ns']} ns), "
        f"digest-verified at the snapshot boundary")
    return controller, None


def _apply_telemetry_resume(controller, want, now: int) -> None:
    """Reconcile the restored controller's telemetry state with the
    resume invocation's ``telemetry:`` section (the volatile-key rule,
    section-shaped). Same section -> the pickled collector continues its
    streams bit-exactly; absent -> telemetry is disabled; newly present
    or re-cadenced -> a fresh/retimed collector starts sampling at the
    next grid point after ``now``. Flow records come from model code that
    captures the collector at process spawn, so ENABLING telemetry on
    resume covers samplers and fault annotations immediately but only
    processes spawned after the resume point produce flow records."""
    have = controller.telemetry
    if want is None:
        if have is not None:
            controller.telemetry = None
            for h in controller.hosts:
                h.telemetry = None
            if controller.faults is not None:
                controller.faults.on_apply = None
        controller.cfg.telemetry = None
        return
    from shadow_tpu_torch.telemetry import TelemetryCollector

    if have is None:
        tel = TelemetryCollector(want)
        controller.spans.totals.setdefault("telemetry", 0.0)
        tel.next_sample = ((now // tel.sample_every) + 1) * tel.sample_every
        controller.telemetry = tel
        for h in controller.hosts:
            h.telemetry = tel
        if controller.faults is not None:
            controller.faults.on_apply = tel.record_fault
    else:
        if int(want.sample_every) != have.sample_every:
            have.sample_every = int(want.sample_every)
            have.next_sample = (
                (now // have.sample_every) + 1) * have.sample_every
        have.metrics_dir = want.metrics_dir
    controller.cfg.telemetry = want


# -- determinism sentinel -----------------------------------------------------

def _feed(h, obj) -> None:
    """Canonical byte encoding of the digest structure (type-tagged,
    length-prefixed; dict keys sorted) — stable across runs, policies,
    and platforms."""
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        h.update(b"i%d;" % int(obj))
    elif isinstance(obj, float):
        h.update(b"f" + struct.pack("<d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"s%d:" % len(b) + b)
    elif isinstance(obj, (bytes, bytearray)):
        h.update(b"b%d:" % len(obj) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        h.update(b"[%d;" % len(obj))
        for x in obj:
            _feed(h, x)
    elif isinstance(obj, dict):
        h.update(b"{%d;" % len(obj))
        for k in sorted(obj):
            _feed(h, k)
            _feed(h, obj[k])
    elif isinstance(obj, np.ndarray):
        h.update(b"a" + str(obj.dtype).encode() + b"|"
                 + str(obj.shape).encode() + b"|")
        h.update(np.ascontiguousarray(obj).tobytes())
    else:
        raise CheckpointError(
            f"state digest: unhashable field type {type(obj).__name__}")


def _digest(obj) -> str:
    h = hashlib.sha256()
    _feed(h, obj)
    return h.hexdigest()


def state_digest(controller, sim_now: int):
    """Returns ``(global_digest_hex, {host_name: digest_hex})`` over the
    plane-independent state at the round boundary ``sim_now``.

    Calls ``engine.flush_all()`` first so both data planes (and the lazy
    draw coalescing inside each) sit at the same resolution frontier —
    early resolution is result-identical, so a digesting run stays
    byte-identical to a non-digesting one.
    """
    eng = controller.engine
    eng.flush_all()
    hosts = {}
    for h in controller.hosts:
        hosts[h.name] = _digest(h.state_fingerprint())
    g = {
        "t": sim_now,
        "rounds": controller.rounds,
        "events": controller.events,
        "units_sent": eng.units_sent,
        "units_dropped": eng.units_dropped,
        "units_blackholed": eng.units_blackholed,
        "bytes_sent": eng.bytes_sent,
        "ev_key": eng._ev_key,
        "tokens_down": eng.tokens_down,
        # egress buckets: hash the canonical observable, not the raw
        # (t_base, tokens, debt) triple — capped available-at-now
        # (fluid.TokenBuckets.levels, shared with the telemetry samplers)
        # is identical across planes: any divergence in actual bucket
        # BEHAVIOR must show here or in the unit counters.
        "bucket_avail": eng.buckets.levels(sim_now),
        "last_refill": eng._last_refill,
        # the effective latency/loss/rate matrices are deliberately NOT
        # hashed: they are pure functions of the config (pinned by
        # config_digest) and the applied-action cursor below, and at 10k+
        # graph nodes re-hashing O(nodes^2) matrices every sample would
        # dominate sentinel cost. A corrupted matrix without a moved
        # cursor still surfaces within a round or two through the arrival
        # times, unit counters, and endpoint state it must perturb.
        "faults": ((controller.faults.idx, controller.faults.applied)
                   if controller.faults is not None else None),
        "hosts": hosts,
    }
    return _digest(g), hosts


def shard_digest_partial(controller, sim_now: int) -> dict:
    """One shard worker's contribution to a sentinel record: fingerprints
    of its OWNED hosts plus its slice of the global observables. The
    parent merges partials (merge_shard_digests) into the byte-exact
    single-process record — per-host state lives wholly on its owning
    shard, the counters are disjoint sums, and the bucket/token arrays
    are valid exactly at the owned indices."""
    eng = controller.engine
    eng.flush_all()
    own = [h for h in controller.hosts if controller.owns(h.id)]
    ids = [h.id for h in own]
    return {
        "hosts": {h.name: _digest(h.state_fingerprint()) for h in own},
        "ids": ids,
        "events": controller.events,
        "units_sent": eng.units_sent,
        "units_dropped": eng.units_dropped,
        "units_blackholed": eng.units_blackholed,
        "bytes_sent": eng.bytes_sent,
        "ev_key": eng._ev_key,
        "tokens_down": eng.tokens_down[ids],
        "bucket_avail": eng.buckets.levels(sim_now)[ids],
        "last_refill": eng._last_refill,
        "faults": ((controller.faults.idx, controller.faults.applied)
                   if controller.faults is not None else None),
    }


def merge_shard_digests(parts: list, sim_now: int, rounds: int,
                        n_hosts: int):
    """Combine per-shard partials into the exact state_digest() result of
    the equivalent single-process run: ``(global_digest_hex, hosts)``."""
    tokens = np.zeros(n_hosts, dtype=np.int64)
    bucket = np.zeros(n_hosts, dtype=np.int64)
    hosts: dict = {}
    for p in parts:
        ids = p["ids"]
        tokens[ids] = p["tokens_down"]
        bucket[ids] = p["bucket_avail"]
        hosts.update(p["hosts"])
    g = {
        "t": sim_now,
        "rounds": rounds,
        "events": sum(p["events"] for p in parts),
        "units_sent": sum(p["units_sent"] for p in parts),
        "units_dropped": sum(p["units_dropped"] for p in parts),
        "units_blackholed": sum(p["units_blackholed"] for p in parts),
        "bytes_sent": sum(p["bytes_sent"] for p in parts),
        "ev_key": sum(p["ev_key"] for p in parts),
        "tokens_down": tokens,
        "bucket_avail": bucket,
        "last_refill": parts[0]["last_refill"],
        "faults": parts[0]["faults"],
        "hosts": hosts,
    }
    return _digest(g), hosts


def emit_digest(controller, sim_now: int) -> None:
    """Append one sentinel record to <data_dir>/state_digests.jsonl."""
    g, hosts = state_digest(controller, sim_now)
    controller.data_dir.mkdir(parents=True, exist_ok=True)
    rec = {"round": controller.rounds, "t": sim_now, "digest": g,
           "hosts": hosts}
    with open(controller.data_dir / DIGEST_FILE, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")


def validate_config_checkpointable(cfg) -> None:
    """THE checkpointability policy, single source of truth — pure config
    inspection, so it can fail at build time before anything is
    constructed. Refused: pcap hosts (captures stream to disk mid-run).
    Managed (real-binary) configs are checkpointable as re-execution
    snapshots, not pickles (format version 2), but only at
    sim_shards=1."""
    for hopts in cfg.hosts:
        if hopts.pcap_enabled:
            raise ValueError(
                f"checkpoint_every is unsupported with pcap capture: host "
                f"{hopts.name!r} has pcap_enabled (captures stream to disk "
                f"mid-run); disable one of the two")
    if config_has_managed(cfg) \
            and int(getattr(cfg.general, "sim_shards", 1)) != 1:
        raise ValueError(
            "checkpoint_every with managed native processes requires "
            "sim_shards=1: a re-execution snapshot re-runs the whole "
            "simulation prefix in one process")
