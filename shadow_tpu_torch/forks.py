"""Scenario multiverse: checkpoint-forked what-if trees + a comparative reducer.

The port of shadow_tpu/forks.py. Its manifests, plan and summary carry this
package's own format names (``shadow_tpu_torch-fork-branch``, ``-fork-plan``,
``-fork-summary``); a checkpoint of the reference package
(``shadow_tpu-checkpoint``) is refused by that name. A managed trunk (a
re-execution snapshot, checkpoint format version 2) forks by re-running
its prefix in every branch. Branches run on the fork's device
(``--device``, default cuda); behind the fleet's shared DrawServer a
restored branch reattaches its draw plane to the service, never to the
card, as a served seed does.

One expensive trunk run becomes N cheap counterfactuals: restore ONE
boundary checkpoint (checkpoint.py) into M fleet workers (fleet.py) and
diverge each branch AFTER the fork point — by injected live commands
replayed through the existing ``commands.jsonl`` machinery, by a volatile
config overlay, or (for divergence axes that are part of the checkpoint's
config identity: seed, fault timeline, congestion control) by an honest
cold re-run inside the same fleet. "Once is Never Enough"
(Jansen/Tracey/Goldberg, USENIX Security '21 — PAPERS.md) supplies the
statistics discipline the reducer applies: the per-branch statistic
first, the t-based CI across branches.

The honesty gate (what makes forked results citable): every branch's
output tree and streams are byte-identical to a cold-start run of the
same (config, commands, seed) tuple. For a restore branch that holds
because (a) the trunk's stream prefixes are copied into the branch
directory truncated at the fork boundary by exactly the
``supervise.rollback_streams`` keep rules, (b) the restored pickle
continues them bit-exactly (the checkpoint contract), and (c) the merged
replay log — trunk command history at or before the fork point plus the
branch's injected commands strictly after it — re-applies through the
round loop's replay plane, which skips the prefix on resume and logs the
suffix identically to a cold replay. For a managed (reexec) trunk the
prefix re-executes once per branch from round 0 with digest + guest
cursor verification at the fork boundary, so the branch IS a cold run.
Cold branches (seed, faults or congestion-control divergence) run from
scratch by construction and their manifests say so by name.

Every branch directory carries ``fork_manifest.json``: the trunk
checkpoint digest, the divergence spec, the mode (restore/cold, with the
cold reason named), and the output tree/stream sha256s.

The reducer (``reduce_fork`` / ``python -m shadow_tpu_torch.fleet report
FORK_DIR --compare``) k-way merges per-branch ``LogHistogram`` states, groups
branches (``group:`` in branches.yaml; default = the branch name), and
renders per-group flow percentiles diffed against the trunk with t-based
CI95 over per-branch percentile deltas, marking deltas whose CI excludes
zero. ``tools/bisect_divergence.py --a DIR --b DIR`` names the first
round where two branches' digest streams diverge.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import sys
import time as _walltime  # detlint: ok(wallclock): branch wall accounting
from pathlib import Path

FORK_MANIFEST = "fork_manifest.json"
FORK_SUMMARY = "fork_summary.json"
BRANCH_FORMAT = "shadow_tpu_torch-fork-branch"
FORK_SUMMARY_FORMAT = "shadow_tpu_torch-fork-summary"
PLAN_FORMAT = "shadow_tpu_torch-fork-plan"
#: the reference package's checkpoint format: its pickles name the
#: reference's classes, so no fork of this package can restore them
REFERENCE_CKPT_FORMAT = "shadow_tpu-checkpoint"
#: the merged replay log written into each branch directory (trunk
#: command history <= fork point + injected commands > fork point): the
#: "commands" leg of the (config, commands, seed) tuple the honesty gate
#: compares against
REPLAY_FILE = "fork_replay_commands.jsonl"

#: volatile config keys a branch overlay may set: run-shape policy that
#: checkpoint restore honors (VOLATILE_CONFIG_KEYS) *minus* the keys the
#: fork runner itself manages and the keys that would change the
#: already-started output streams mid-run
OVERLAY_ALLOWED = frozenset({
    "general.log_level",
    "general.progress",
    "general.heartbeat_interval",
    "general.checkpoint_every",
    "general.checkpoint_dir",
    "experimental.native_colcore",
    "experimental.device_transport",
})
#: volatile keys the fork runner owns per branch — an overlay naming one
#: is refused with its own wording (not the generic non-volatile error)
OVERLAY_FORK_MANAGED = frozenset({
    "general.data_directory",
    "general.replay_commands",
    "general.live_endpoint",
})
#: volatile, but changing it at the fork point re-cadences a stream that
#: is already half-written — the branch would no longer be byte-identical
#: to its cold twin
OVERLAY_STREAM_KEYS = frozenset({"general.state_digest_every"})

_BRANCH_KEYS = ("name", "group", "seed", "faults", "congestion_control",
                "overlay", "commands", "command_script")
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class ForkError(ValueError):
    """A fork plan could not be built or a branch could not run."""


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def branch_dir(fork_dir, name: str) -> Path:
    return Path(fork_dir) / f"branch_{name}"


# -- branches.yaml ------------------------------------------------------------

def load_branches(path) -> list:
    """Parse + validate a branches.yaml: a top-level ``branches:`` list
    of divergence specs. Each entry needs a filesystem-safe unique
    ``name``; everything else is a divergence axis (``seed``, ``faults``,
    ``congestion_control``, ``overlay``, ``commands``,
    ``command_script``) plus an optional ``group`` for the reducer."""
    import yaml

    try:
        doc = yaml.safe_load(Path(path).read_text())
    except OSError as exc:
        raise ForkError(f"cannot read branches file {path}: {exc}")
    branches = (doc or {}).get("branches") if isinstance(doc, dict) else None
    if not isinstance(branches, list) or not branches:
        raise ForkError(
            f"{path}: want a top-level 'branches:' list with at least "
            f"one entry")
    seen = set()
    for i, b in enumerate(branches):
        if not isinstance(b, dict):
            raise ForkError(f"{path}: branches[{i}] must be a mapping")
        name = b.get("name")
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ForkError(
                f"{path}: branches[{i}]: 'name' must be a filesystem-"
                f"safe string ([A-Za-z0-9._-], <= 64 chars), got {name!r}")
        if name in seen:
            raise ForkError(f"{path}: duplicate branch name {name!r}")
        seen.add(name)
        unknown = sorted(set(b) - set(_BRANCH_KEYS))
        if unknown:
            raise ForkError(
                f"{path}: branch {name!r}: unknown keys {unknown} "
                f"(want {list(_BRANCH_KEYS)})")
    return branches


# -- the fork plan ------------------------------------------------------------

def _validate_overlay(name: str, overlay: dict) -> None:
    for k in overlay:
        if k in OVERLAY_FORK_MANAGED:
            raise ForkError(
                f"branch {name!r}: overlay key {k!r} is managed by the "
                f"fork runner (each branch gets its own directory, replay "
                f"log, and no endpoint) — it cannot be overlaid")
        if k in OVERLAY_STREAM_KEYS:
            raise ForkError(
                f"branch {name!r}: overlay key {k!r} would re-cadence the "
                f"digest stream at the fork point, so the branch would no "
                f"longer be byte-identical to its cold-start twin — set "
                f"it on the trunk run instead")
        if k.startswith("telemetry"):
            raise ForkError(
                f"branch {name!r}: overlay key {k!r} would re-cadence the "
                f"telemetry streams mid-run and break the branch's "
                f"byte-identity with its cold-start twin — set it on the "
                f"trunk run instead")
        if k not in OVERLAY_ALLOWED:
            raise ForkError(
                f"branch {name!r}: overlay key {k!r} is not volatile — a "
                f"branch that changes simulation semantics is a different "
                f"simulation, not a fork of this one; diverge by 'seed:', "
                f"'faults:', or 'congestion_control:' (an honest cold "
                f"re-run), or overlay one of {sorted(OVERLAY_ALLOWED)}")


def _branch_commands(name: str, spec: dict, fork_t: int) -> list:
    """Normalize a branch's injected command script into replay records
    (strictly after the fork point; refused otherwise by name)."""
    from shadow_tpu_torch import live as _live
    from shadow_tpu_torch.core.time import parse_time

    recs = []
    for j, c in enumerate(spec.get("commands") or ()):
        if not isinstance(c, dict) or "t" not in c:
            raise ForkError(
                f"branch {name!r}: commands[{j}] must be a mapping with "
                f"a 't' (sim time) and a 'cmd'")
        try:
            t = int(parse_time(c["t"]))
            norm = _live.normalize_command(
                {k: v for k, v in c.items() if k != "t"})
        except ValueError as exc:
            raise ForkError(f"branch {name!r}: commands[{j}]: {exc}")
        recs.append({"cmd": norm, "round": 0, "seq": 0, "t": t})
    script = spec.get("command_script")
    if script:
        try:
            loaded = _live.load_command_log(script)
        except (OSError, ValueError) as exc:
            raise ForkError(
                f"branch {name!r}: command_script {script}: {exc}")
        recs.extend({"cmd": r["cmd"], "round": 0, "seq": 0,
                     "t": int(r["t"])} for r in loaded)
    recs.sort(key=lambda r: r["t"])
    for r in recs:
        if r["t"] <= fork_t:
            raise ForkError(
                f"branch {name!r}: injected command at t={r['t']} ns is "
                f"at or before the fork point (sim {fork_t} ns) — the "
                f"trunk prefix is already decided; inject commands "
                f"strictly after the checkpoint boundary")
    return recs


def plan_fork(config_path, ckpt_path, branches: list, fork_dir,
              overrides: dict = None, trunk_dir=None) -> dict:
    """Validate a fork up front and return the JSON-safe plan document
    the fleet ships to its workers: trunk checkpoint identity, per-branch
    divergence (restore vs. cold, with cold reasons named), and the
    merged replay records. Every refusal names its cause here, before a
    single worker spawns."""
    from shadow_tpu_torch import checkpoint as _ckpt
    from shadow_tpu_torch import live as _live
    from shadow_tpu_torch.config import load_config

    ckpt = Path(ckpt_path)
    try:
        with open(ckpt, "rb") as f:
            raw = json.loads(f.readline())
    except ValueError:
        raw = None
    if isinstance(raw, dict) and raw.get("format") == REFERENCE_CKPT_FORMAT:
        raise ForkError(
            f"{ckpt}: a {REFERENCE_CKPT_FORMAT} file (written by the "
            f"reference package shadow_tpu) cannot be forked here — its "
            f"pickle names the reference's classes; re-checkpoint the trunk "
            f"with shadow_tpu_torch (--checkpoint-every)")
    header = _ckpt.read_header(ckpt)  # CheckpointError on non-checkpoints
    ver = int(header.get("version") or 0)
    if header.get("managed") and ver < _ckpt.REEXEC_VERSION:
        raise ForkError(
            f"{ckpt}: managed guests require checkpoint format version "
            f"{_ckpt.REEXEC_VERSION} (deterministic re-execution cursors); "
            f"this file claims version {ver} — re-checkpoint the trunk "
            f"with a current build before forking")
    if ver != _ckpt.VERSION:
        raise ForkError(
            f"{ckpt}: cannot fork a version-{ver} checkpoint — forking "
            f"needs format v{_ckpt.VERSION} (re-checkpoint the trunk "
            f"with a current build)")
    fork_t = int(header["sim_time_ns"])
    fork_rounds = int(header["rounds"])
    reexec = header.get("mode") == "reexec"

    # fork-level overrides apply to EVERY branch — including telemetry
    # flags, which must reproduce the trunk invocation's (the same way
    # --resume-from re-passes them): the restored collector continues
    # its streams bit-exactly when the section matches. Per-BRANCH
    # telemetry divergence is refused (_validate_overlay).
    over = dict(overrides or {})
    base_cfg = load_config(str(config_path), over, cache_doc=True)
    want, got = header["config_digest"], _ckpt.config_digest(base_cfg)
    if want != got:
        raise ForkError(
            f"{ckpt}: config mismatch — the checkpoint was written under "
            f"a different simulation config (digest {want[:12]} vs "
            f"{got[:12]}); a fork trunk must be restored under the exact "
            f"configuration that produced it (volatile keys excepted). "
            f"Per-branch divergence goes in branches.yaml, not the base "
            f"config.")
    if base_cfg.telemetry is not None and base_cfg.telemetry.metrics_dir:
        raise ForkError(
            "telemetry.metrics_dir is set: every branch would append to "
            "one shared metrics directory — forking needs per-run stream "
            "locations (the default: the run's data_directory)")

    if trunk_dir is None and ckpt.parent.name == "checkpoints":
        # the default layout: <trunk>/checkpoints/ckpt_t*.ckpt
        trunk_dir = ckpt.parent.parent
    trunk_dir = Path(trunk_dir) if trunk_dir is not None else None

    # the trunk's command history: every branch inherits it (<= fork
    # point); a reexec snapshot embeds it, a pickle trunk recorded it in
    # the run directory's commands.jsonl
    trunk_cmds = []
    if reexec:
        with open(ckpt, "rb") as f:
            f.readline()
            try:
                payload = json.loads(f.readline())
            except ValueError as exc:
                raise ForkError(
                    f"{ckpt}: corrupt re-execution snapshot payload "
                    f"({exc})")
        trunk_cmds = [r for r in (payload.get("commands") or ())
                      if int(r["t"]) <= fork_t]
    elif trunk_dir is not None and (trunk_dir / "commands.jsonl").is_file():
        trunk_cmds = [r for r in
                      _live.load_command_log(trunk_dir / "commands.jsonl")
                      if int(r["t"]) <= fork_t]
    next_seq = max((int(r["seq"]) for r in trunk_cmds), default=0) + 1

    plans: dict = {}
    order: list = []
    for spec in branches:
        name = spec["name"]
        divergence = {k: spec[k] for k in _BRANCH_KEYS[2:] if k in spec}
        b_over = dict(over)
        cold_reason = None
        if "seed" in spec:
            b_over["general.seed"] = int(spec["seed"])
            cold_reason = ("general.seed is part of the checkpoint's "
                           "config identity")
        if "faults" in spec:
            b_over["faults"] = spec["faults"]
            cold_reason = ("the fault timeline is part of the "
                           "checkpoint's config identity")
        if "congestion_control" in spec:
            b_over["experimental.congestion_control"] = \
                str(spec["congestion_control"])
            cold_reason = ("experimental.congestion_control is part of "
                           "the checkpoint's config identity")
        _validate_overlay(name, spec.get("overlay") or {})
        b_over.update(spec.get("overlay") or {})
        injected = _branch_commands(name, spec, fork_t)
        for i, rec in enumerate(injected):
            rec["seq"] = next_seq + i
        mode = "cold" if cold_reason else "restore"
        if mode == "restore" and not reexec and trunk_dir is None:
            raise ForkError(
                f"branch {name!r} restores the trunk checkpoint, which "
                f"needs the trunk run directory (stream prefixes + "
                f"command history), but none could be derived from "
                f"{ckpt} — pass --trunk-dir")
        # the branch's (config, commands, seed) tuple: trunk history plus
        # this branch's injected suffix. A cold branch replays the whole
        # log from round 0; a restore branch resumes past the prefix.
        replay = trunk_cmds + injected
        plans[name] = {
            "name": name,
            "group": str(spec.get("group") or name),
            "mode": mode,
            "cold_reason": cold_reason,
            "overrides": b_over,
            "replay": replay,
            "divergence": divergence,
            "seed": int(b_over.get("general.seed",
                                   base_cfg.general.seed)),
        }
        order.append(name)
    return {
        "format": PLAN_FORMAT,
        "config": str(config_path),
        "overrides": over,
        "fork_dir": str(fork_dir),
        "ckpt": str(ckpt),
        "ckpt_sha256": hashlib.sha256(ckpt.read_bytes()).hexdigest(),
        "config_digest": want,
        "ckpt_t": fork_t,
        "ckpt_rounds": fork_rounds,
        "reexec": bool(reexec),
        "trunk_dir": str(trunk_dir) if trunk_dir is not None else None,
        "seed": int(base_cfg.general.seed),
        "branches": plans,
        "order": order,
    }


# -- branch execution (fleet worker side) -------------------------------------

def _copy_filtered(src: Path, dst: Path, keep) -> None:
    """Copy ``src`` to ``dst`` keeping only records ``keep`` accepts —
    the copying twin of supervise._filter_jsonl (unparseable lines are
    kept; an empty result writes no file, matching a run that never
    created the stream)."""
    if not src.is_file():
        return
    out = []
    with open(src) as f:
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
    if out:
        dst.write_text("".join(x + "\n" for x in out))


def _copy_prefix_streams(fork: dict, dst: Path) -> None:
    """Seed a restore branch's directory with the trunk's stream
    prefixes truncated at the fork boundary — the exact keep rules
    ``supervise.rollback_streams`` applies when truncating in place, so
    the restored run's appends continue them byte-identically."""
    from shadow_tpu_torch.supervise import stream_prefix_keep

    src = Path(fork["trunk_dir"])
    keeps = stream_prefix_keep(fork["ckpt_rounds"], fork["ckpt_t"])
    for name, keep in keeps.items():
        _copy_filtered(src / name, dst / name, keep)
    for sidecar in ("state_digests.shard*.jsonl", "flows.shard*.jsonl"):
        base = sidecar.split(".", 1)[0] + ".jsonl"
        for p in sorted(src.glob(sidecar)):
            _copy_filtered(p, dst / p.name, keeps[base])


def _branch_stream_digests(d: Path) -> dict:
    from shadow_tpu_torch.fleet import _stream_digests

    out = _stream_digests(d)
    p = Path(d) / "commands.jsonl"
    if p.is_file():
        out["commands.jsonl"] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def run_branch(fork: dict, name: str, device: str = "cuda") -> dict:
    """Run one branch of a fork plan into its directory on ``device`` and
    write its ``fork_manifest.json`` + mergeable telemetry state. Raises on
    failure (the fleet worker loop converts that into a failed manifest
    + retry accounting, exactly like a seed); a branch served by the
    fleet's draw service that created a CUDA context fails too."""
    from shadow_tpu_torch import checkpoint as _ckpt
    from shadow_tpu_torch import fleet as _fleet
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import (VOLATILE_SUMMARY_KEYS,
                                            Controller)

    plan = fork["branches"][name]
    d = branch_dir(fork["fork_dir"], name)
    _fleet._reap_stale_guests(d)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True, exist_ok=True)
    t0 = _walltime.perf_counter()
    base = {
        "format": BRANCH_FORMAT,
        "branch": name,
        "group": plan["group"],
        "mode": plan["mode"],
        "cold_reason": plan["cold_reason"],
        "seed": plan["seed"],
        "divergence": plan["divergence"],
        "trunk_checkpoint": fork["ckpt"],
        "trunk_checkpoint_sha256": fork["ckpt_sha256"],
        "trunk_config_digest": fork["config_digest"],
        "fork_t": fork["ckpt_t"],
        "fork_rounds": fork["ckpt_rounds"],
    }
    # mark the attempt in-flight BEFORE spawning anything (the fleet
    # manifest discipline: a worker that dies mid-run leaves "running",
    # never a trusted partial)
    _fleet._write_json(d / FORK_MANIFEST, {**base, "status": "running"})
    over = dict(plan["overrides"])
    over["general.data_directory"] = str(d)
    over["general.live_endpoint"] = None
    replay = plan.get("replay") or ()
    if replay:
        rp = d / REPLAY_FILE
        with open(rp, "w") as f:
            for rec in replay:
                f.write(_dumps(rec) + "\n")
        over["general.replay_commands"] = str(rp)
    cfg = load_config(fork["config"], over, cache_doc=True)
    if plan["mode"] == "restore":
        if not fork["reexec"]:
            _copy_prefix_streams(fork, d)
        ctl, resume_at = _ckpt.load_checkpoint(fork["ckpt"], cfg,
                                               mirror_log=False,
                                               device=device)
        result = ctl.run(resume_at=resume_at)
    else:
        ctl = Controller(cfg, mirror_log=False, device=device)
        result = ctl.run()
    if (getattr(ctl.engine, "_svc_addr", None)
            and getattr(ctl.engine, "devt", None) is None
            and _fleet._cuda_initialized()):
        raise RuntimeError(
            f"branch {name}: a branch served by the fleet draw service "
            f"created a CUDA context (it must launch nothing)")
    if ctl.telemetry is not None:
        (d / _fleet.TEL_STATE_FILE).write_text(
            ctl.telemetry.export_state_json())
    wall = _walltime.perf_counter() - t0
    man = {
        **base,
        "status": "ok",
        "wall_seconds": round(wall, 3),
        "loop_wall_seconds": round(result["wall_seconds"], 3),
        "events": result["events"],
        "rounds": result["rounds"],
        "exit_reason": result["exit_reason"],
        "process_errors": result["process_errors"],
        "tree_sha256": _fleet.output_tree_digest(d),
        "streams_sha256": _branch_stream_digests(d),
        "summary": {k: v for k, v in result.items()
                    if k not in VOLATILE_SUMMARY_KEYS},
    }
    _fleet._write_json(d / FORK_MANIFEST, man)
    return man


def write_failed_branch_manifest(fork_dir, name: str, error: str,
                                 tb: str = "") -> dict:
    d = branch_dir(fork_dir, name)
    d.mkdir(parents=True, exist_ok=True)
    from shadow_tpu_torch.fleet import _write_json

    man = {
        "format": BRANCH_FORMAT,
        "branch": name,
        "status": "failed",
        "error": error,
        "traceback": tb,
    }
    _write_json(d / FORK_MANIFEST, man)
    return man


# -- the comparative reducer --------------------------------------------------

_LABELS = ("p50_ms", "p90_ms", "p99_ms", "p99_9_ms")


def _trunk_state(trunk_dir):
    """The trunk's mergeable telemetry state: the fleet sidecar when the
    trunk was a fleet member, else rebuilt from its flows.jsonl (a plain
    run records every flow; the histogram is a pure function of them)."""
    from shadow_tpu_torch.fleet import TEL_STATE_FILE
    from shadow_tpu_torch.telemetry.histogram import LogHistogram

    if trunk_dir is None:
        return None
    trunk_dir = Path(trunk_dir)
    p = trunk_dir / TEL_STATE_FILE
    if p.is_file():
        try:
            return json.loads(p.read_text())
        except ValueError:
            pass
    fp = trunk_dir / "flows.jsonl"
    if not fp.is_file():
        return None
    hist: dict = {}
    counts: dict = {}
    with open(fp) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            kind = rec.get("flow")
            if kind is None:
                continue
            c = counts.setdefault(kind, {"ok": 0, "failed": 0})
            if rec.get("status") == "ok":
                c["ok"] += 1
                h = hist.get(kind)
                if h is None:
                    h = hist[kind] = LogHistogram()
                h.add(int(rec["latency_ns"]))
            else:
                c["failed"] += 1
    return {"hist": {k: h.state() for k, h in hist.items()},
            "flow_counts": counts}


def reduce_fork(fork_dir, extra: dict = None) -> dict:
    """K-way merge the per-branch manifests + histogram states under
    ``fork_dir`` into ``fork_summary.json``: per-branch flow percentiles,
    per-group pooled percentiles, and per-group percentile DELTAS vs the
    trunk with t-based CI95 across the group's branches (significant =
    the CI excludes zero; n=1 groups carry the delta without a CI).
    Idempotent — a pure function of the on-disk artifacts."""
    from shadow_tpu_torch.fleet import TEL_STATE_FILE, _write_json, t_ci95
    from shadow_tpu_torch.telemetry.histogram import LogHistogram

    fork_dir = Path(fork_dir)
    if extra is None:
        # re-reduction (the report subcommand): carry the original run's
        # orchestration metadata forward instead of erasing it
        try:
            prev = json.loads((fork_dir / FORK_SUMMARY).read_text())
            extra = {k: prev[k] for k in
                     ("config", "jobs", "branches_planned", "trunk_dir",
                      "trunk_checkpoint", "fork_wall_seconds",
                      "draw_service")
                     if k in prev}
        except (OSError, ValueError):
            extra = None
    roster = set((extra or {}).get("branches_planned") or ()) or None
    manifests = []
    for p in sorted(fork_dir.glob("branch_*/" + FORK_MANIFEST)):
        try:
            man = json.loads(p.read_text())
        except ValueError:
            continue
        if man.get("format") != BRANCH_FORMAT:
            continue
        if roster is not None and man.get("branch") not in roster:
            continue
        manifests.append(man)
    completed = [m for m in manifests if m.get("status") == "ok"]
    failed = {m["branch"]: m.get("error", "unknown")
              for m in manifests if m.get("status") != "ok"}
    trunk_dir = (extra or {}).get("trunk_dir") or (
        completed[0].get("trunk_dir") if completed else None)
    tstate = _trunk_state(trunk_dir)
    trunk_q: dict = {}
    if tstate:
        for kind, hs in sorted(tstate.get("hist", {}).items()):
            h = LogHistogram.from_state(hs)
            if h.total:
                c = tstate.get("flow_counts", {}).get(kind, {})
                trunk_q[kind] = {"ok": c.get("ok", 0),
                                 "failed": c.get("failed", 0),
                                 **h.quantiles_ns_to_ms()}
    states = []  # (manifest, state)
    branches_out: dict = {}
    groups: dict = {}
    for m in completed:
        branches_out[m["branch"]] = {
            "group": m["group"], "mode": m["mode"],
            "cold_reason": m.get("cold_reason"), "seed": m.get("seed"),
            "divergence": m.get("divergence") or {},
            "flows": {},
        }
        p = branch_dir(fork_dir, m["branch"]) / TEL_STATE_FILE
        if p.is_file():
            try:
                states.append((m, json.loads(p.read_text())))
            except ValueError:
                pass
    for m, st in states:
        flows = {}
        for kind in sorted(st.get("flow_counts", {})):
            c = st["flow_counts"][kind]
            row = {"count": c["ok"] + c["failed"], "ok": c["ok"],
                   "failed": c["failed"]}
            hs = st["hist"].get(kind)
            if hs is not None:
                h = LogHistogram.from_state(hs)
                if h.total:
                    row.update(h.quantiles_ns_to_ms())
            flows[kind] = row
        branches_out[m["branch"]]["flows"] = flows
        groups.setdefault(m["group"], []).append((m, st))
    groups_out: dict = {}
    for group in sorted(groups):
        members = groups[group]
        kinds = sorted({k for _m, st in members
                        for k in st.get("hist", {})})
        gflows: dict = {}
        for kind in kinds:
            pooled = LogHistogram.merged(
                [st["hist"][kind] for _m, st in members
                 if kind in st.get("hist", {})])
            per_branch = {}
            deltas = {lab: [] for lab in _LABELS}
            for m, st in members:
                hs = st.get("hist", {}).get(kind)
                if hs is None:
                    continue
                h = LogHistogram.from_state(hs)
                if not h.total:
                    continue
                q = h.quantiles_ns_to_ms()
                per_branch[m["branch"]] = q
                if kind in trunk_q:
                    for lab in _LABELS:
                        deltas[lab].append(
                            round(q[lab] - trunk_q[kind][lab], 3))
            row = {"pooled": pooled.quantiles_ns_to_ms(),
                   "per_branch": per_branch}
            if kind in trunk_q and any(deltas[lab] for lab in _LABELS):
                dvt = {}
                for lab in _LABELS:
                    ci = t_ci95(deltas[lab])
                    ci["deltas"] = deltas[lab]
                    # significant: the 95% CI over per-branch deltas
                    # excludes zero (needs n >= 2 — a single branch has
                    # no spread to bound)
                    ci["significant"] = bool(
                        ci.get("n", 0) >= 2
                        and (ci["lo"] > 0 or ci["hi"] < 0))
                    dvt[lab] = ci
                row["delta_vs_trunk"] = dvt
            gflows[kind] = row
        groups_out[group] = {
            "branches": sorted(m["branch"] for m, _st in members),
            "flows": gflows,
        }
    doc = {
        "format": FORK_SUMMARY_FORMAT,
        "n_branches": len(manifests),
        "completed": [m["branch"] for m in completed],
        "failed": failed,
        "per_branch_wall_seconds": {
            m["branch"]: m.get("wall_seconds") for m in completed},
        "events_total": sum(m.get("events", 0) for m in completed),
        "trunk_flows": trunk_q,
        "branches": branches_out,
        "groups": groups_out,
        **(extra or {}),
    }
    _write_json(fork_dir / FORK_SUMMARY, doc)
    return doc


def render_compare(summary: dict) -> str:
    """The comparison table: per flow kind, the trunk percentiles and
    each group's mean percentile delta with its CI95, starred when the
    CI excludes zero."""
    lines = []
    n_ok = len(summary.get("completed", []))
    failed = summary.get("failed", {})
    trunk = summary.get("trunk_checkpoint") or "?"
    lines.append(
        f"fork: {summary.get('n_branches', n_ok)} branch(es), {n_ok} ok, "
        f"{len(failed)} failed — trunk {trunk}")
    for b, err in sorted(failed.items()):
        lines.append(f"  FAILED branch {b}: {err}")
    trunk_q = summary.get("trunk_flows", {})
    groups = summary.get("groups", {})
    if not trunk_q:
        lines.append("  (no trunk flow telemetry — enable telemetry on "
                     "the trunk run for percentile diffs)")
        return "\n".join(lines)
    branches = summary.get("branches", {})
    for kind in sorted(trunk_q):
        tq = trunk_q[kind]
        lines.append("")
        lines.append(
            f"  flow {kind!r}: trunk p50 {tq['p50_ms']:.1f} / "
            f"p90 {tq['p90_ms']:.1f} / p99 {tq['p99_ms']:.1f} ms "
            f"({tq['ok']} ok, {tq['failed']} failed)")
        hdr = (f"    {'group':<20} {'n':>3} "
               f"{'Δp50 ms (CI95)':>22} {'Δp99 ms (CI95)':>22}")
        lines.append(hdr)
        lines.append("    " + "-" * (len(hdr) - 4))
        for group in sorted(groups):
            row = groups[group]["flows"].get(kind)
            if row is None or "delta_vs_trunk" not in row:
                continue
            modes = {branches.get(b, {}).get("mode")
                     for b in groups[group]["branches"]}
            tag = "" if modes == {"restore"} else " [cold]"

            def d_str(ci):
                if ci.get("n", 0) < 2:
                    return f"{ci.get('mean', 0):+.1f} (n=1)"
                star = " *" if ci.get("significant") else "  "
                return (f"{ci['mean']:+.1f} ± {ci['half_width']:.1f}"
                        f"{star}")

            dvt = row["delta_vs_trunk"]
            lines.append(
                f"    {group + tag:<20} {dvt['p50_ms'].get('n', 0):>3} "
                f"{d_str(dvt['p50_ms']):>22} {d_str(dvt['p99_ms']):>22}")
    lines.append("")
    lines.append("  Δ = group mean of per-branch (branch − trunk) "
                 "percentiles; CI95 is t-based across the group's "
                 "branches; * = the CI excludes zero. [cold] groups "
                 "re-ran the prefix (their divergence axis is part of "
                 "the config identity).")
    return "\n".join(lines)


def render_fork_report(summary: dict) -> str:
    """Branch-level fork report (the sweep report's lineage), ending in
    the comparison table."""
    lines = []
    n_ok = len(summary.get("completed", []))
    failed = summary.get("failed", {})
    lines.append(
        f"fork: {summary.get('n_branches', n_ok)} branch(es), {n_ok} ok, "
        f"{len(failed)} failed"
        + (f", jobs={summary['jobs']}" if "jobs" in summary else "")
        + (f", wall {summary['fork_wall_seconds']}s"
           if "fork_wall_seconds" in summary else ""))
    for b in summary.get("completed", []):
        info = summary.get("branches", {}).get(b, {})
        mode = info.get("mode", "?")
        why = (f" ({info.get('cold_reason')})"
               if mode == "cold" and info.get("cold_reason") else "")
        lines.append(f"  branch {b}: {mode}{why}, group "
                     f"{info.get('group', b)}")
    for b, err in sorted(failed.items()):
        lines.append(f"  FAILED branch {b}: {err}")
    return "\n".join(lines) + "\n" + render_compare(summary)


# -- CLI (the `python -m shadow_tpu_torch fork` verb) -------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch fork",
        description="fork one trunk checkpoint into a tree of what-if "
                    "branches and compare them against the trunk")
    p.add_argument("config", help="the trunk's simulation YAML config")
    p.add_argument("--from", dest="fork_from", required=True,
                   metavar="CKPT",
                   help="the trunk checkpoint to fork (a live "
                   "checkpoint_now response names the path)")
    p.add_argument("--branches", required=True, metavar="FILE",
                   help="branches.yaml: the divergence spec per branch")
    p.add_argument("--fork-dir", default=None,
                   help="fork output root (default: <config-stem>.fork)")
    p.add_argument("--trunk-dir", default=None,
                   help="the trunk run directory (default: derived from "
                   "the checkpoint path's <trunk>/checkpoints/ layout)")
    p.add_argument("--jobs", type=int, default=2, metavar="M",
                   help="concurrent branch simulations (default 2)")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a config option for EVERY branch by "
                   "dotted path (must keep the trunk's config digest); "
                   "repeatable")
    p.add_argument("--retries", type=int, default=1, metavar="N",
                   help="bounded retry budget per branch (default 1)")
    p.add_argument("--no-device-service", action="store_true",
                   help="branches attach the device individually")
    p.add_argument("--live-endpoint", metavar="PATH",
                   help="bind a STATUS-ONLY endpoint streaming per-branch "
                   "lifecycle records; 'auto' = <fork-dir>/live.sock")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the branches' kernels run and the shared "
                   "draw service attaches (default cuda; cpu runs the "
                   "plain PyTorch versions)")
    p.add_argument("--quiet", action="store_true",
                   help="no progress lines on stderr")
    p.add_argument("--json", action="store_true",
                   help="print the fork summary as one JSON line instead "
                   "of the comparison report")
    return p


def main(argv=None) -> int:
    from shadow_tpu_torch import fleet as _fleet

    args = build_parser().parse_args(argv)
    over: dict = {}
    for item in args.set:
        if "=" not in item:
            print(f"fork: --set expects KEY=VALUE, got {item!r}",
                  file=sys.stderr)
            return 2
        import yaml as _yaml

        k, v = item.split("=", 1)
        over[k] = _yaml.safe_load(v)
    fork_dir = args.fork_dir or (Path(args.config).stem + ".fork")
    try:
        branches = load_branches(args.branches)
        plan = plan_fork(args.config, args.fork_from, branches, fork_dir,
                         overrides=over, trunk_dir=args.trunk_dir)
        runner = _fleet.FleetRunner(
            args.config, plan["order"], args.jobs, fork_dir,
            overrides=over, fork=plan,
            device_service=not args.no_device_service, quiet=args.quiet,
            live_endpoint=args.live_endpoint, retries=args.retries,
            device=args.device)
        summary = runner.run()
    except FileNotFoundError as exc:
        print(f"fork: file not found: "
              f"{getattr(exc, 'filename', None) or exc}", file=sys.stderr)
        return 2
    except (ValueError, OSError) as exc:
        print(f"fork: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(summary) if args.json
          else render_fork_report(summary))
    if summary.get("exit_reason") == "interrupted":
        return 130
    return 0 if not summary["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
