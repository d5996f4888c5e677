"""Checkpoint-forked what-if trees in the port (shadow_tpu_torch/forks.py,
the fleet's fork side and the ``fork`` verb) against the reference
(shadow_tpu/forks.py).

One module-scoped fork of examples/web_cdn.yaml (12 s under tpu_batch on
the C engine, a checkpoint every 6 s; the fork restores the 6 s one) with
one branch of each kind: a restore baseline, injected inline commands, a
command script, a seed, a fault timeline and a congestion control (the
last three run cold, their reason named). Everything runs on ``--device
cpu``, tolerance 0:

- every branch's tree and streams equal the reference's cold-start run of
  the same (config, commands, seed) tuple, and the port's own cold run
  (the trunk for the baseline, a replay of the branch's merged log for the
  command branches; a cold branch is its own);
- the restore baseline equals the trunk, byte for byte;
- ``reduce_fork``'s summary equals the reference reducer's on the same
  manifests and histogram states, apart from its wall fields and format
  names; ``fleet report --compare`` renders the comparison and
  ``tools/bisect_divergence.py`` names a command branch's first divergent
  round after the fork point;
- refusals by name: a non-volatile overlay, a config-digest mismatch, a
  reference checkpoint, a managed header below the re-execution version, a
  command at or before the fork point, bad branch specs, ``--resume``;
- a fork of a managed trunk (real binaries, a re-execution snapshot): its
  branches equal the reference's fork of its own trunk and their cold
  twins.

The runs are CLI processes, a few at once: the fork (its workers fork from
a parent with no other thread), and beside it the cold twins.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from shadow_tpu import forks as ref_forks
from shadow_tpu_torch import checkpoint as ckpt
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch import fleet, forks
from shadow_tpu_torch.utils.digest import output_tree_digest

ROOT = Path(__file__).resolve().parent.parent
CDN_YAML = ROOT / "examples" / "web_cdn.yaml"
#: the trunk's, every branch's and every twin's run shape
COMMON = {
    "general.stop_time": "12s",
    "general.checkpoint_every": "6s",
    "general.state_digest_every": 50,
    "experimental.scheduler_policy": "tpu_batch",
}
FORK_T = 6_000_000_000  # the 6 s checkpoint the fork restores
#: the fault leg's replacement timeline: the partition 1 s later, shorter
QUIET_FAULTS = {"events": [
    {"time": "9s", "kind": "link_down", "src_nodes": [0, 1, 2, 3, 4, 5],
     "dst_nodes": [6, 7, 8, 9, 10, 11], "duration": "2s"}]}
#: the command script's one record: an edge down 9 s .. 10.5 s
SCRIPT = {"cmd": {"cmd": "host_down", "hosts": ["edge3"],
                  "duration": "1500000000 ns"},
          "round": 0, "seq": 1, "t": 9_000_000_000}
BRANCHES = [
    {"name": "baseline", "group": "base"},
    {"name": "cmd_degrade", "group": "cmd", "commands": [
        {"t": "8.5s", "cmd": "link_degrade", "src_nodes": [0, 1],
         "dst_nodes": [6, 7], "latency_factor": 2.0, "loss_add": 0.05,
         "bandwidth_scale": 0.5, "duration": "2s"}]},
    {"name": "cmd_script", "group": "cmd"},  # command_script: SCRIPT
    {"name": "seed101", "group": "seed", "seed": 101},
    {"name": "fault_quiet", "group": "fault", "faults": QUIET_FAULTS},
    {"name": "cc_cubic", "group": "cc", "congestion_control": "cubic"},
]
#: the cold-start overrides of each cold branch
COLD = {"seed101": {"general.seed": 101},
        "fault_quiet": {"faults": QUIET_FAULTS},
        "cc_cubic": {"experimental.congestion_control": "cubic"}}
#: what a fork summary may differ in from the reference reducer's
WALL_KEYS = ("per_branch_wall_seconds", "fork_wall_seconds", "format")


def _sets(over: dict) -> list:
    out = []
    for k, v in over.items():
        out += ["--set", f"{k}={json.dumps(v)}"]
    return out


def _run_cmd(pkg: str, d, over: dict) -> list:
    argv = [sys.executable, "-m", pkg, str(CDN_YAML), "--data-directory",
            str(d), "--quiet", "--json-summary", *_sets({**COMMON, **over})]
    return argv + (["--device", "cpu"] if pkg == "shadow_tpu_torch" else [])


def _run_all(cmds: list, jobs: int, env: dict = None) -> list:
    """Run the commands, ``jobs`` at once; their CompletedProcess-like
    (returncode, stdout, stderr) in order. A simulation may end with
    process errors at this cut (exit 1): the bytes are the gate."""
    env = {**(env or os.environ), "JAX_PLATFORMS": "cpu"}
    out = [None] * len(cmds)
    running = []
    pending = list(enumerate(cmds))
    while pending or running:
        while pending and len(running) < jobs:
            i, argv = pending.pop(0)
            running.append((i, subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=str(ROOT), env=env)))
        i, p = running.pop(0)
        so, se = p.communicate(timeout=900)
        out[i] = (p.returncode, so, se)
    for rc, so, se in out:
        assert rc in (0, 1), se
    return out


def _streams(d) -> dict:
    return forks._branch_stream_digests(Path(d))


@pytest.fixture(scope="module")
def forked(tmp_path_factory):
    """The trunks of both packages, the port's fork, and the twins."""
    base = tmp_path_factory.mktemp("forks")
    trunk, ref_trunk = base / "trunk", base / "ref_trunk"
    # first the trunks, and beside them the reference's cold starts (they
    # need no checkpoint)
    _run_all([_run_cmd("shadow_tpu_torch", trunk, {}),
              _run_cmd("shadow_tpu", ref_trunk, {})]
             + [_run_cmd("shadow_tpu", base / f"ref_{name}", over)
                for name, over in COLD.items()], jobs=5)
    ck = trunk / "checkpoints" / f"ckpt_t{FORK_T:020d}.ckpt"
    assert ck.is_file(), "the trunk wrote no 6 s checkpoint"
    script = base / "inject.jsonl"
    script.write_text(json.dumps(SCRIPT) + "\n")
    branches = [dict(b) for b in BRANCHES]
    for b in branches:
        if b["name"] == "cmd_script":
            b["command_script"] = str(script)
    bfile = base / "branches.yaml"
    bfile.write_text(yaml.safe_dump({"branches": branches}))
    fork_dir = base / "fork"
    plan = forks.plan_fork(str(CDN_YAML), ck, branches, fork_dir,
                           overrides=dict(COMMON))
    # then the fork, and beside it the command branches' cold replays of
    # their merged logs (as run_branch writes them) in both packages
    twins = []
    for name in ("cmd_degrade", "cmd_script"):
        rp = base / f"replay_{name}.jsonl"
        rp.write_text("".join(forks._dumps(r) + "\n"
                              for r in plan["branches"][name]["replay"]))
        for pkg, tag in (("shadow_tpu_torch", "port"), ("shadow_tpu", "ref")):
            twins.append(_run_cmd(pkg, base / f"{tag}_{name}",
                                  {"general.replay_commands": str(rp)}))
    fork_argv = [sys.executable, "-m", "shadow_tpu_torch", "fork",
                 str(CDN_YAML), "--from", str(ck), "--branches", str(bfile),
                 "--fork-dir", str(fork_dir), "--jobs", "3", "--device",
                 "cpu", "--quiet", "--json", *_sets(COMMON)]
    res = _run_all([fork_argv] + twins, jobs=5)
    assert res[0][0] == 0, res[0][2]
    return {"base": base, "trunk": trunk, "ref_trunk": ref_trunk,
            "ckpt": ck, "fork_dir": fork_dir, "plan": plan,
            "summary": json.loads(res[0][1]), "script": script}


def _manifest(forked, name: str) -> dict:
    return json.loads((forks.branch_dir(forked["fork_dir"], name)
                       / forks.FORK_MANIFEST).read_text())


def test_fork_completes_every_branch(forked):
    summary = forked["summary"]
    assert sorted(summary["completed"]) == sorted(b["name"]
                                                  for b in BRANCHES)
    assert summary["failed"] == {}
    assert summary["format"] == forks.FORK_SUMMARY_FORMAT \
        == "shadow_tpu_torch-fork-summary"
    sha = forked["plan"]["ckpt_sha256"]
    assert forked["plan"]["format"] == "shadow_tpu_torch-fork-plan"
    for b in BRANCHES:
        man = _manifest(forked, b["name"])
        assert man["format"] == "shadow_tpu_torch-fork-branch"
        assert man["status"] == "ok"
        assert man["trunk_checkpoint_sha256"] == sha
        assert man["fork_t"] == FORK_T
        assert man["mode"] == ("cold" if b["name"] in COLD
                               else "restore"), b["name"]
        if b["name"] in COLD:
            assert man["cold_reason"], b["name"]
        else:
            assert man["cold_reason"] is None
    assert "seed" in _manifest(forked, "seed101")["cold_reason"]


def test_baseline_equals_trunk_and_reference(forked):
    man = _manifest(forked, "baseline")
    for d in (forked["trunk"], forked["ref_trunk"]):
        assert man["tree_sha256"] == output_tree_digest(d)
        assert man["streams_sha256"] == _streams(d)


@pytest.mark.parametrize("name", ["cmd_degrade", "cmd_script"])
def test_command_branch_equals_cold_replays(forked, name):
    """A command branch equals a cold run replaying the SAME merged log, in
    both packages — commands.jsonl included."""
    man = _manifest(forked, name)
    bdir = forks.branch_dir(forked["fork_dir"], name)
    assert (bdir / forks.REPLAY_FILE).read_text() == \
        (forked["base"] / f"replay_{name}.jsonl").read_text()
    for tag in ("port", "ref"):
        twin = forked["base"] / f"{tag}_{name}"
        assert man["tree_sha256"] == output_tree_digest(twin), tag
        assert man["streams_sha256"] == _streams(twin), tag
    assert "commands.jsonl" in man["streams_sha256"]
    assert man["tree_sha256"] != _manifest(forked, "baseline")["tree_sha256"]


@pytest.mark.parametrize("name", sorted(COLD))
def test_cold_branch_equals_reference_cold_start(forked, name):
    man = _manifest(forked, name)
    twin = forked["base"] / f"ref_{name}"
    assert man["tree_sha256"] == output_tree_digest(twin)
    assert man["streams_sha256"] == _streams(twin)


def _as_reference(src: Path, dst: Path) -> None:
    """A copy of a fork directory whose manifests carry the reference's
    format name, for the reference's reducer."""
    shutil.copytree(src, dst)
    for p in dst.glob("branch_*/" + forks.FORK_MANIFEST):
        man = json.loads(p.read_text())
        man["format"] = ref_forks.BRANCH_FORMAT
        p.write_text(json.dumps(man))
    (dst / forks.FORK_SUMMARY).unlink(missing_ok=True)


def test_reducer_equals_reference(forked, tmp_path):
    extra = {k: forked["summary"][k] for k in
             ("config", "jobs", "branches_planned", "trunk_dir",
              "trunk_checkpoint")}
    port = forks.reduce_fork(forked["fork_dir"], extra=dict(extra))
    _as_reference(forked["fork_dir"], tmp_path / "ref")
    ref = ref_forks.reduce_fork(tmp_path / "ref", extra=dict(extra))
    strip = lambda doc: {k: v for k, v in doc.items() if k not in WALL_KEYS}
    assert strip(port) == strip(ref)
    assert port["trunk_flows"], "trunk telemetry missing"
    groups = port["groups"]
    assert set(groups) == {"base", "cmd", "seed", "fault", "cc"}
    assert groups["cmd"]["branches"] == ["cmd_degrade", "cmd_script"]
    kind = sorted(port["trunk_flows"])[0]
    dvt = groups["base"]["flows"][kind]["delta_vs_trunk"]["p50_ms"]
    assert dvt["n"] == 1 and dvt["mean"] == 0.0
    assert dvt["significant"] is False
    assert forks.render_compare(port) == ref_forks.render_compare(ref)
    assert forks.render_fork_report(port) == \
        ref_forks.render_fork_report(ref)
    # re-reduction carries the run's metadata forward (idempotent)
    again = forks.reduce_fork(forked["fork_dir"])
    assert again["groups"] == forked["summary"]["groups"]
    assert again["trunk_dir"] == str(forked["trunk"])


def test_report_compare_and_bisect(forked, capsys):
    assert fleet.main(["report", str(forked["fork_dir"]), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["format"] == forks.FORK_SUMMARY_FORMAT
    assert fleet.main(["report", str(forked["fork_dir"]), "--compare"]) == 0
    text = capsys.readouterr().out
    assert "Δp50" in text and "CI95" in text and "[cold]" in text
    assert fleet.main(["report", str(forked["fork_dir"])]) == 0
    assert "branch seed101: cold" in capsys.readouterr().out
    tool = str(ROOT / "tools" / "bisect_divergence.py")
    bis = subprocess.run(
        [sys.executable, tool, "--json", "--a", str(forked["trunk"]),
         "--b", str(forks.branch_dir(forked["fork_dir"], "cmd_degrade"))],
        capture_output=True, text=True, cwd=str(ROOT))
    assert bis.returncode == 1, bis.stderr
    rec = json.loads(bis.stdout)
    assert rec["kind"] == "digest"
    assert rec["round"] > forked["plan"]["ckpt_rounds"]
    assert rec["t"] >= 8_500_000_000
    bis = subprocess.run(
        [sys.executable, tool, "--a", str(forked["trunk"]),
         "--b", str(forks.branch_dir(forked["fork_dir"], "baseline"))],
        capture_output=True, text=True, cwd=str(ROOT))
    assert bis.returncode == 0, bis.stdout + bis.stderr


# -- refusals (each by name, before any worker spawns) ---------------------------

def _plan(forked, branches, ck=None, **kw):
    return forks.plan_fork(str(CDN_YAML), ck or forked["ckpt"], branches,
                           forked["base"] / "refused",
                           overrides=dict(COMMON), **kw)


def test_refuses_nonvolatile_overlay(forked):
    with pytest.raises(forks.ForkError, match="not volatile"):
        _plan(forked, [{"name": "b",
                        "overlay": {"general.parallelism": 4}}])
    with pytest.raises(forks.ForkError, match="managed by the fork"):
        _plan(forked, [{"name": "b",
                        "overlay": {"general.data_directory": "/x"}}])
    for key in ("telemetry.sample_every", "general.state_digest_every"):
        with pytest.raises(forks.ForkError, match="re-cadence"):
            _plan(forked, [{"name": "b", "overlay": {key: 1}}])
    plan = _plan(forked, [{"name": "ok",
                           "overlay": {"general.log_level": "warning"}}])
    assert plan["branches"]["ok"]["mode"] == "restore"


def test_refuses_config_digest_mismatch(forked):
    with pytest.raises(forks.ForkError, match="config mismatch"):
        forks.plan_fork(str(CDN_YAML), forked["ckpt"], [{"name": "b"}],
                        forked["base"] / "refused",
                        overrides={**COMMON, "general.stop_time": "13s"})


def test_refuses_reference_checkpoint(forked, tmp_path):
    ref_ck = forked["ref_trunk"] / "checkpoints" / f"ckpt_t{FORK_T:020d}.ckpt"
    with pytest.raises(forks.ForkError, match="shadow_tpu-checkpoint"):
        _plan(forked, [{"name": "b"}], ck=ref_ck)
    # through the fork verb: exit 2, named
    b = tmp_path / "b.yaml"
    b.write_text(yaml.safe_dump({"branches": [{"name": "b"}]}))
    rc = port_cli.main(["fork", str(CDN_YAML), "--from", str(ref_ck),
                        "--branches", str(b), "--fork-dir",
                        str(tmp_path / "f"), "--device", "cpu", "--quiet"])
    assert rc == 2


def test_refuses_managed_trunk(forked, tmp_path):
    """A managed trunk forks (re-execution), but a managed header below
    the port's re-execution version cannot describe one: refused by name,
    before the generic version gate."""
    fake = tmp_path / "managed.ckpt"
    hdr = dict(ckpt.read_header(forked["ckpt"]), managed=True,
               mode="reexec", version=1)
    fake.write_bytes((json.dumps(hdr) + "\n").encode())
    with pytest.raises(forks.ForkError,
                       match="managed guests require checkpoint format "
                             "version 2"):
        _plan(forked, [{"name": "b"}], ck=fake)


def test_refuses_command_at_or_before_fork_point(forked):
    with pytest.raises(forks.ForkError,
                       match="at or before the fork point"):
        _plan(forked, [{"name": "b", "commands": [
            {"t": "6s", "cmd": "checkpoint_now"}]}])
    with pytest.raises(forks.ForkError, match="mapping with"):
        _plan(forked, [{"name": "b", "commands": [{"cmd": "pause"}]}])


def _branches_yaml(tmp_path, branches) -> Path:
    p = tmp_path / "branches.yaml"
    p.write_text(yaml.safe_dump({"branches": branches}))
    return p


@pytest.mark.parametrize("branches, match", [
    ([{"name": "x"}, {"name": "x"}], "duplicate branch name"),
    ([{"name": "../evil"}], "filesystem-safe"),
    ([{"name": "x", "sed": 3}], "unknown keys"),
    ([], "branches"),
    (["x"], "must be a mapping"),
])
def test_refuses_bad_branch_specs(tmp_path, branches, match):
    p = _branches_yaml(tmp_path, branches)
    with pytest.raises(forks.ForkError, match=match):
        forks.load_branches(p)
    with pytest.raises(ref_forks.ForkError, match=match):
        ref_forks.load_branches(p)


def test_fork_refuses_resume(forked, capsys):
    with pytest.raises(ValueError, match="cannot --resume"):
        fleet.FleetRunner(str(CDN_YAML), ["b"], jobs=1,
                          sweep_dir=forked["base"] / "r",
                          fork=forked["plan"], resume=True, device="cpu")
    assert fleet.main(["sweep", str(CDN_YAML), "--fork-from",
                       str(forked["ckpt"]), "--branches", "b.yaml",
                       "--resume"]) == 2
    assert "cannot --resume" in capsys.readouterr().err


def test_failed_branch_manifest(tmp_path):
    """A branch that raises leaves a failed manifest (the fleet retries
    it), in the port's format."""
    # the fleet's watchdog and retry machinery key a branch by its name
    assert fleet.seed_dir(tmp_path, "b1") == forks.branch_dir(tmp_path, "b1")
    assert fleet.seed_dir(tmp_path, 7) == tmp_path / "seed_7"
    man = fleet._write_failed_manifest(tmp_path, "b1", "boom", "tb")
    assert man == {"format": forks.BRANCH_FORMAT, "branch": "b1",
                   "status": "failed", "error": "boom", "traceback": "tb"}
    doc = forks.reduce_fork(tmp_path, extra={"branches_planned": ["b1"]})
    assert doc["failed"] == {"b1": "boom"} and doc["completed"] == []


@pytest.mark.slow
def test_chip_smoke_fork_phase(tmp_path):
    """chip_smoke.py's phase ``fork`` on the CPU: the CI's gossip_churn
    fork leg and the full-width tgen_1k fork behind one DrawServer, whose
    baseline must be the trunk and whose seed3 the reference's tree."""
    from shadow_tpu_torch.ops import propagate as prop
    from tests.test_torch_e2e import _chip_smoke

    _chip_smoke().fork_path(port_cli, prop, output_tree_digest,
                            str(tmp_path), device="cpu")


# -- a managed trunk -----------------------------------------------------

#: managed_smoke forked at its 1 s snapshot (mid-transfer): the restore
#: baseline, a link_degrade after the fork point, and a seed (cold)
MANAGED_BRANCHES = [
    {"name": "baseline"},
    {"name": "degrade", "commands": [
        {"t": "1.2s", "cmd": "link_degrade", "src_nodes": [0],
         "dst_nodes": [1], "latency_factor": 2.0, "duration": "1s"}]},
    {"name": "seed5", "seed": 5},
]
MANAGED_COMMON = {"general.checkpoint_every": "500ms",
                  "general.state_digest_every": 5,
                  "experimental.scheduler_policy": "tpu_batch"}


def test_fork_of_a_managed_trunk(tmp_path):
    """A re-execution trunk forks: each branch re-runs the prefix from
    round 0 (its digest and guest cursors verified at the fork point).
    Every branch's hosts tree (less *.clock) and state digests equal the
    reference's fork of its own managed trunk, and its cold twin: the
    trunk (baseline), a cold replay of the merged log (degrade), a cold
    start at the seed (seed5)."""
    from shadow_tpu_torch.native.managed import missing_kernel_features
    from tests.test_torch_e2e import _chip_smoke
    from tests.test_torch_managed import build_ref_shim

    if missing_kernel_features():
        pytest.skip(f"kernel features missing: {missing_kernel_features()}")
    cs = _chip_smoke()
    guests = cs.build_guests(tmp_path / "g")
    ref_env = {"SHADOW_SHIM_LIB": str(build_ref_shim(guests)
                                      / "libshadow_shim.so")}
    cfg = cs.write_doc(cs.managed_doc("managed_smoke", guests),
                       tmp_path / "m.yaml")

    def run(pkg, d, over):
        argv = [sys.executable, "-m", pkg, cfg, "--data-directory", str(d),
                "--quiet", "--json-summary", *_sets(over)]
        return argv + (["--device", "cpu"] if pkg == "shadow_tpu_torch"
                       else ["--set", "experimental.native_colcore=false"])

    env = {**os.environ, **ref_env}
    trunks = {"port": tmp_path / "trunk", "ref": tmp_path / "ref_trunk"}
    _run_all([run("shadow_tpu_torch", trunks["port"], MANAGED_COMMON),
              run("shadow_tpu", trunks["ref"], MANAGED_COMMON)], jobs=2,
             env=env)
    name = f"ckpt_t{1_000_000_000:020d}.ckpt"
    hdr = ckpt.read_header(trunks["port"] / "checkpoints" / name)
    assert hdr["mode"] == "reexec" and hdr["managed"] is True
    bfile = _branches_yaml(tmp_path, MANAGED_BRANCHES)
    plan = forks.plan_fork(cfg, trunks["port"] / "checkpoints" / name,
                           MANAGED_BRANCHES, tmp_path / "plan",
                           overrides=dict(MANAGED_COMMON))
    assert plan["reexec"] is True
    rp = tmp_path / "replay_degrade.jsonl"
    rp.write_text("".join(forks._dumps(r) + "\n"
                          for r in plan["branches"]["degrade"]["replay"]))
    forkd = {"port": tmp_path / "fork", "ref": tmp_path / "ref_fork"}
    fork_cmds = [
        [sys.executable, "-m", pkg, "fork", cfg, "--from",
         str(trunks[tag] / "checkpoints" / name), "--branches", str(bfile),
         "--fork-dir", str(forkd[tag]), "--jobs", "2", "--quiet", "--json",
         *_sets(MANAGED_COMMON),
         *(["--device", "cpu"] if tag == "port" else [])]
        for pkg, tag in (("shadow_tpu_torch", "port"), ("shadow_tpu", "ref"))]
    twins = {"degrade": tmp_path / "twin_degrade",
             "seed5": tmp_path / "twin_seed5"}
    res = _run_all(fork_cmds + [
        run("shadow_tpu_torch", twins["degrade"],
            {**MANAGED_COMMON, "general.replay_commands": str(rp)}),
        run("shadow_tpu_torch", twins["seed5"],
            {**MANAGED_COMMON, "general.seed": 5})], jobs=4, env=env)
    for rc, so, se in res[:2]:
        assert rc == 0, se
        assert sorted(json.loads(so)["completed"]) == [
            "baseline", "degrade", "seed5"]
    twins["baseline"] = trunks["port"]
    for b in ("baseline", "degrade", "seed5"):
        man = json.loads((forks.branch_dir(forkd["port"], b)
                          / forks.FORK_MANIFEST).read_text())
        assert man["status"] == "ok" and man["process_errors"] == []
        assert man["mode"] == ("cold" if b == "seed5" else "restore"), b
        dirs = [forks.branch_dir(forkd["port"], b),
                ref_forks.branch_dir(forkd["ref"], b), twins[b]]
        assert len({cs.hosts_digest(d) for d in dirs}) == 1, b
        assert len({(d / "state_digests.jsonl").read_bytes()
                    for d in dirs}) == 1, b
    assert cs.hosts_digest(twins["degrade"]) != cs.hosts_digest(
        trunks["port"])
