"""Checkpoint/restore in the port (shadow_tpu_torch/checkpoint.py) against
the reference.

The reference's checkpoint documents (tests/test_checkpoint.py: BASE, a
lossy two-host tgen run, and its FAULTS partition) run once through the
reference, uninterrupted. The port then runs the same document on
``--device cpu`` with checkpoints on, under every policy and both host
engines, with the draw plane at tpu_device_floor 1 (windows in flight at
the boundaries), under tpu_mesh at tpu_mesh_floor 0 and with the Python
plane's device transport; and resumes from each checkpoint. The tolerance
is zero: the checkpointing run and every resumed run give the reference's
summary, hosts/ tree and state digest stream (a resumed run writes the
stream's suffix from its boundary on). Beside that: a resumed run that
checkpoints again, a resume under an active fault timeline, the refusals
(config mismatch, wrong Python, garbage, truncated payloads, the other
package's files, pcap, managed processes), the SIGINT final checkpoint,
``--device`` changed at resume (the card legs skip without one), the CLI
path, and the rule that no device state reaches a checkpoint.
"""

import json
import os
import re
import signal
import sys
from pathlib import Path

import pytest
import torch
import yaml

from shadow_tpu import checkpoint as ref_ckpt
from shadow_tpu.config import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.core.controller import VOLATILE_SUMMARY_KEYS as REF_VOLATILE
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu_torch import checkpoint as ckpt
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import (VOLATILE_SUMMARY_KEYS,
                                              Controller)
from shadow_tpu_torch.core.time import NS_PER_SEC
from shadow_tpu_torch.network import devtransport as dt
from shadow_tpu_torch.ops.devcfg import DeviceUnavailable
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_checkpoint import BASE, FAULTS
from tests.test_torch_e2e import _assert_identical, _run as _cli_run, _stable
from tests.test_torch_managed import ipc_slots  # noqa: F401 (a fixture)

DIGEST_EVERY = 50
#: the port's legs: policy, C engine, extra overrides, and the device
#: transport's floor (None: the transport is off)
LEGS = {
    "thread_per_core": ("thread_per_core", False, {}, None),
    "thread_per_host": ("thread_per_host", False, {}, None),
    "tpu_batch_c": ("tpu_batch", True, {}, None),
    "tpu_batch_py": ("tpu_batch", False, {}, None),
    "tpu_batch_c_floor1": ("tpu_batch", True,
                           {"experimental.tpu_device_floor": 1}, None),
    "tpu_batch_py_floor1": ("tpu_batch", False,
                            {"experimental.tpu_device_floor": 1}, None),
    "tpu_mesh_py_floor0": ("tpu_mesh", False,
                           {"experimental.tpu_mesh_floor": 0}, None),
    "tpu_mesh_c_floor0": ("tpu_mesh", True,
                          {"experimental.tpu_mesh_floor": 0}, None),
    "transport_floor1": ("tpu_batch", False,
                         {"experimental.device_transport": True}, 1),
}


def _doc(faults: bool = False) -> dict:
    d = yaml.safe_load(BASE)
    if faults:
        d["faults"] = yaml.safe_load(FAULTS)
    return d


def _overrides(data_dir, leg=None, **extra) -> dict:
    ov = {"general.data_directory": str(data_dir),
          "general.state_digest_every": DIGEST_EVERY}
    if leg is not None:
        policy, c, more, _ = LEGS[leg]
        ov.update({"experimental.scheduler_policy": policy,
                   "experimental.native_colcore": c, **more})
    ov.update(extra)
    return ov


def _cfg(data_dir, leg=None, faults=False, **extra):
    return parse_config(_doc(faults), _overrides(data_dir, leg, **extra))


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's uninterrupted run of BASE, without and with the
    FAULTS partition (its default policy, thread_per_core)."""
    out = {}
    for faults in (False, True):
        d = tmp_path_factory.mktemp(f"ref_{int(faults)}")
        cfg = ref_parse_config(_doc(faults), _overrides(d))
        out[faults] = (RefController(cfg, mirror_log=False).run(), d)
    return out


def _port_run(data_dir, leg=None, faults=False, **extra):
    ctl = Controller(_cfg(data_dir, leg, faults, **extra), mirror_log=False,
                     device="cpu")
    return ctl.run()


def _resume(path, data_dir, leg=None, faults=False, device="cpu",
            **extra):
    ctl, at = ckpt.load_checkpoint(
        path, _cfg(data_dir, leg, faults, **extra), mirror_log=False,
        device=device)
    return ctl.run(resume_at=at)


def _checkpoints(data_dir) -> list:
    paths = sorted((Path(data_dir) / "checkpoints").glob("*.ckpt"))
    assert paths, "no checkpoints written"
    return paths


def _assert_resumed(ref, ref_dir, res, res_dir):
    """A resumed run: the reference's summary and tree, and the suffix of
    its digest stream from the boundary on."""
    assert res["process_errors"] == []
    assert _stable(res, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(res_dir) == ref_tree_digest(ref_dir)
    got = (Path(res_dir) / "state_digests.jsonl").read_text().splitlines()
    want = (Path(ref_dir) / "state_digests.jsonl").read_text().splitlines()
    assert got and got == want[-len(got):]


@pytest.fixture
def transport_floor(monkeypatch):
    def _set(floor):
        if floor is not None:
            monkeypatch.setattr(dt, "_DEVICE_FLOOR", floor)
    return _set


# -- resume equivalence --------------------------------------------------------

@pytest.mark.parametrize("leg", sorted(LEGS))
def test_resume_matrix(tmp_path, ref_runs, transport_floor, leg):
    """Every policy, both host engines, the draw plane at floor 1, the
    mesh plane at floor 0 and the device transport: the checkpointing run
    is the reference's run, and a resume from every checkpoint is too."""
    transport_floor(LEGS[leg][3])
    ref, ref_dir = ref_runs[False]
    src = _port_run(tmp_path / "src", leg,
                    **{"general.checkpoint_every": "10s"})
    _assert_identical(ref, src, ref_dir, tmp_path / "src")
    assert src["phase_wall"]["checkpoint"] > 0
    paths = _checkpoints(tmp_path / "src")
    assert len(paths) >= 5
    for i, p in enumerate(paths):
        res = _resume(p, tmp_path / f"res{i}", leg)
        _assert_resumed(ref, ref_dir, res, tmp_path / f"res{i}")


def test_resumed_run_can_checkpoint_again(tmp_path, ref_runs):
    """A resumed run that keeps checkpointing writes loadable checkpoints
    of its own (the second-generation resume is the reference's run)."""
    ref, ref_dir = ref_runs[False]
    leg = "tpu_batch_c"
    _port_run(tmp_path / "src", leg, **{"general.checkpoint_every": "10s"})
    first = _checkpoints(tmp_path / "src")[0]
    res = _resume(first, tmp_path / "res", leg,
                  **{"general.checkpoint_every": "10s"})
    _assert_resumed(ref, ref_dir, res, tmp_path / "res")
    t1 = ckpt.read_header(first)["sim_time_ns"]
    gen2 = [p for p in _checkpoints(tmp_path / "res")
            if ckpt.read_header(p)["sim_time_ns"] > t1]
    assert gen2, "resumed run wrote no later checkpoints"
    res2 = _resume(gen2[0], tmp_path / "res2", leg)
    _assert_resumed(ref, ref_dir, res2, tmp_path / "res2")


@pytest.mark.parametrize("leg", ["tpu_batch_c", "tpu_batch_py_floor1",
                                 "thread_per_core"])
def test_resume_under_active_fault_timeline(tmp_path, ref_runs, leg):
    """A checkpoint taken mid-partition: the resumed run replays the heal
    and every later transition as the reference's uninterrupted run."""
    ref, ref_dir = ref_runs[True]
    assert ref["fault_transitions_applied"] == 2
    assert ref["units_blackholed"] > 0
    src = _port_run(tmp_path / "src", leg, faults=True,
                    **{"general.checkpoint_every": "3s"})
    _assert_identical(ref, src, ref_dir, tmp_path / "src")
    mid = [p for p in _checkpoints(tmp_path / "src")
           if 2 * NS_PER_SEC <= ckpt.read_header(p)["sim_time_ns"]
           < 5 * NS_PER_SEC]
    assert mid, "no checkpoint landed inside the partition window"
    res = _resume(mid[0], tmp_path / "res", leg, faults=True)
    _assert_resumed(ref, ref_dir, res, tmp_path / "res")


def test_restored_injector_shares_the_engine_arrays(tmp_path):
    """The fault injector rewrites latency, thresholds and rates in place
    and the C engine holds pointers into those arrays: after a restore the
    injector's arrays are the rebuilt engine's, object for object."""
    _port_run(tmp_path / "src", "tpu_batch_c", faults=True,
              **{"general.checkpoint_every": "3s"})
    path = _checkpoints(tmp_path / "src")[0]
    ctl, _ = ckpt.load_checkpoint(
        path, _cfg(tmp_path / "res", "tpu_batch_c", faults=True),
        mirror_log=False, device="cpu")
    inj, eng = ctl.faults, ctl.engine
    assert ctl._c_core is not None
    assert inj.engine is eng and inj.params is eng.params
    assert inj.graph is eng.graph
    assert eng.graph.latency_ns is ctl.graph.latency_ns


# -- refusals --------------------------------------------------------------------

def test_resume_rejects_config_mismatch(tmp_path):
    _port_run(tmp_path / "src", **{"general.checkpoint_every": "5s"})
    path = _checkpoints(tmp_path / "src")[0]
    other = _cfg(tmp_path / "res", **{"general.seed": 99})
    with pytest.raises(ckpt.CheckpointError, match="config mismatch"):
        ckpt.load_checkpoint(path, other, mirror_log=False, device="cpu")
    # volatile keys (data_directory, cadence) may differ: loads fine
    ok = _cfg(tmp_path / "res2", **{"general.checkpoint_every": "30s"})
    ctl, t = ckpt.load_checkpoint(path, ok, mirror_log=False, device="cpu")
    assert t == ckpt.read_header(path)["sim_time_ns"]


def test_load_rejects_garbage_wrong_python_and_the_other_package(tmp_path):
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"not a checkpoint\n")
    with pytest.raises(ckpt.CheckpointError, match="not a shadow_tpu_torch"):
        ckpt.load_checkpoint(junk)
    bad = tmp_path / "badpy.ckpt"
    header = {"format": ckpt.FORMAT, "version": ckpt.VERSION,
              "python": [2, 7], "config_digest": "x", "sim_time_ns": 0}
    bad.write_bytes(json.dumps(header).encode() + b"\n")
    with pytest.raises(ckpt.CheckpointError, match="Python"):
        ckpt.load_checkpoint(bad)
    trunc = tmp_path / "trunc.ckpt"
    header["python"] = list(sys.version_info[:2])
    trunc.write_bytes(json.dumps(header).encode() + b"\n" + b"\x80\x04K")
    with pytest.raises(ckpt.CheckpointError, match="corrupt"):
        ckpt.load_checkpoint(trunc)
    # a checkpoint of each package is refused by the other, by name
    ref_cfg = ref_parse_config(_doc(), {
        "general.data_directory": str(tmp_path / "ref"),
        "general.checkpoint_every": "20s"})
    RefController(ref_cfg, mirror_log=False).run()
    ref_file = sorted((tmp_path / "ref" / "checkpoints").glob("*.ckpt"))[0]
    with pytest.raises(ckpt.CheckpointError, match="reference package"):
        ckpt.load_checkpoint(ref_file, _cfg(tmp_path / "x"))
    _port_run(tmp_path / "port", **{"general.checkpoint_every": "20s"})
    port_file = _checkpoints(tmp_path / "port")[0]
    with pytest.raises(ref_ckpt.CheckpointError, match="not a shadow_tpu"):
        ref_ckpt.load_checkpoint(port_file)


def test_load_refuses_another_engine_build(tmp_path):
    """C-engine state resumes only on the engine build that wrote it, and
    never with the C engine switched off."""
    _port_run(tmp_path / "src", "tpu_batch_c",
              **{"general.checkpoint_every": "20s"})
    path = _checkpoints(tmp_path / "src")[0]
    head, payload = path.read_bytes().split(b"\n", 1)
    header = json.loads(head)
    assert header["colcore"] == ckpt.colcore_fingerprint()
    header["colcore"] = "abi4-0000000000000000"
    other = tmp_path / "other.ckpt"
    other.write_bytes(json.dumps(header).encode() + b"\n" + payload)
    with pytest.raises(ckpt.CheckpointError, match="C engine abi4-0000"):
        ckpt.load_checkpoint(other, _cfg(tmp_path / "r", "tpu_batch_c"))
    with pytest.raises(ckpt.CheckpointError, match="native_colcore=false"):
        ckpt.load_checkpoint(path, _cfg(tmp_path / "r2", "tpu_batch_py"))


def test_checkpoint_rejects_pcap_and_managed(tmp_path):
    """pcap is refused; managed configs checkpoint (as re-execution
    snapshots) but only single-process: the sharded combination is refused
    up front, by both packages."""
    cfg = _cfg(tmp_path / "pc", **{"general.checkpoint_every": "1s",
                                   "hosts.server.pcap_enabled": True})
    with pytest.raises(ValueError, match="pcap"):
        Controller(cfg, mirror_log=False, device="cpu")
    d = _doc()
    d["hosts"]["server"]["processes"][0]["path"] = "/bin/sh"
    ckpt.validate_config_checkpointable(
        parse_config(d, {"general.checkpoint_every": "1s"}))
    over = {"general.checkpoint_every": "1s", "general.sim_shards": 2}
    ref = ref_parse_config(d, over)
    with pytest.raises(ValueError, match="sim_shards=1") as want:
        ref_ckpt.validate_config_checkpointable(ref)
    with pytest.raises(ValueError, match="sim_shards=1") as got:
        ckpt.validate_config_checkpointable(parse_config(d, over))
    assert str(got.value) == str(want.value)


def test_load_refuses_managed_header_below_reexec_version(tmp_path):
    """A managed-marked header below the port's re-execution version (2)
    cannot describe a managed run (version 1 refused managed configs at
    save): refused naming the version it needs, before the generic
    version gate."""
    old = tmp_path / "old_managed.ckpt"
    header = {"format": ckpt.FORMAT, "version": 1, "managed": True,
              "mode": "reexec", "python": list(sys.version_info[:2]),
              "config_digest": "x", "sim_time_ns": 0}
    old.write_bytes(json.dumps(header).encode() + b"\n")
    with pytest.raises(ckpt.CheckpointError, match="format version 2"):
        ckpt.load_checkpoint(old)
    assert ckpt.VERSION == ckpt.REEXEC_VERSION == 2


# -- graceful shutdown -----------------------------------------------------------

def test_sigint_finishes_round_writes_summary_and_final_checkpoint(
        tmp_path, ref_runs):
    """SIGINT mid-run: a valid partial summary and a final checkpoint,
    whose resume completes the reference's run (its tree: the signal's
    own event adds to the counts, as in the reference's test)."""
    ref, ref_dir = ref_runs[False]
    ctl = Controller(_cfg(tmp_path / "int", "tpu_batch_c",
                          **{"general.checkpoint_every": "5s"}),
                     mirror_log=False, device="cpu")
    ctl.hosts[0].schedule(3 * NS_PER_SEC,
                          lambda: os.kill(os.getpid(), signal.SIGINT))
    summary = ctl.run()
    assert summary["exit_reason"] == "interrupted"
    assert summary["partial"] is True
    assert summary["interrupt_signal"] == "SIGINT"
    assert 0 < summary["sim_seconds"] < 60
    final = _checkpoints(tmp_path / "int")[-1]
    assert ckpt.read_header(final)["sim_time_ns"] >= 3 * NS_PER_SEC
    res = _resume(final, tmp_path / "res", "tpu_batch_c")
    assert res["exit_reason"] == "completed"
    assert output_tree_digest(tmp_path / "res") == ref_tree_digest(ref_dir)


# -- the device at resume --------------------------------------------------------

def test_device_is_the_resume_invocations(tmp_path):
    """The device is no config key: it never enters the config digest, a
    resume reattaches the kernels where the resuming invocation says, and
    asking for the card without one fails by name."""
    _port_run(tmp_path / "src", "tpu_batch_c_floor1",
              **{"general.checkpoint_every": "20s"})
    path = _checkpoints(tmp_path / "src")[0]
    ctl, _ = ckpt.load_checkpoint(
        path, _cfg(tmp_path / "res", "tpu_batch_c_floor1"),
        mirror_log=False, device="cpu")
    assert ctl.device == "cpu"
    assert ctl.engine.device is not None  # floor 1: the plane reattached
    assert ctl.engine.device.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable, match="is_available"):
            ckpt.load_checkpoint(
                path, _cfg(tmp_path / "res2", "tpu_batch_c_floor1"),
                mirror_log=False, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("write, read", [("cuda", "cpu"), ("cpu", "cuda")])
def test_resume_across_devices(tmp_path, ref_runs, write, read):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref, ref_dir = ref_runs[False]
    leg = "tpu_batch_c_floor1"
    ctl = Controller(_cfg(tmp_path / "src", leg,
                          **{"general.checkpoint_every": "20s"}),
                     mirror_log=False, device=write)
    _assert_identical(ref, ctl.run(), ref_dir, tmp_path / "src")
    res = _resume(_checkpoints(tmp_path / "src")[0], tmp_path / "res", leg,
                  device=read)
    _assert_resumed(ref, ref_dir, res, tmp_path / "res")


# -- no device state in a checkpoint ---------------------------------------------

def test_no_device_state_reaches_a_checkpoint(tmp_path, monkeypatch):
    """A controller holding the CPU draw plane with windows in flight at
    its boundaries: flush_all resolves them, the files name no torch or
    kernel-module object, and a tensor (or a slot) planted in host state
    fails by name instead of being written."""
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.ops import transport_kernels as tk

    seen = []
    orig = ckpt.save_checkpoint

    def save(controller, now):
        seen.append(len(controller.engine.outstanding))
        return orig(controller, now)

    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    ctl = Controller(_cfg(tmp_path / "src", "tpu_batch_py_floor1",
                          **{"general.checkpoint_every": "5s"}),
                     mirror_log=False, device="cpu")
    ctl.run()
    assert max(seen) > 0, "no draw window was in flight at a boundary"
    for p in _checkpoints(tmp_path / "src"):
        data = p.read_bytes()
        # torch's own modules (not this package's shadow_tpu_torch.*)
        assert not re.search(rb"(?<!_)torch", data), p.name
        for name in (b"ops.propagate", b"transport_kernels",
                     b"parallel.mesh", b"DeviceDrawPlane"):
            assert name not in data, (p.name, name)
    monkeypatch.setattr(ckpt, "save_checkpoint", orig)
    for planted, label in (
            (torch.zeros(3), "torch tensor"),
            (prop.DrawSlot("draw_flags", 256, torch.device("cpu")),
             "DrawSlot"),
            (tk.AckSlots("cpu"), "AckSlots")):
        ctl.hosts[0].planted = planted
        with pytest.raises(ckpt.CheckpointError, match=label):
            ckpt.save_checkpoint(ctl, 60 * NS_PER_SEC)
    assert not list((tmp_path / "src" / "checkpoints").glob("*.tmp"))


# -- the CLI ---------------------------------------------------------------------

def test_cli_checkpoint_and_resume(tmp_path, ref_runs, capsys):
    """--checkpoint-every and --resume-from through the port's CLI, with
    the reference's exit codes: a resumed run is the reference's, a
    missing file and a mismatched config exit 2 with one line."""
    ref, ref_dir = ref_runs[False]
    cfg = tmp_path / "base.yaml"
    cfg.write_text(BASE)
    common = ["--device", "cpu", "--state-digest-every", str(DIGEST_EVERY)]
    src = _cli_run(port_cli.main, cfg, tmp_path / "src",
                   common + ["--checkpoint-every", "20s"])
    _assert_identical(ref, src, ref_dir, tmp_path / "src")
    path = _checkpoints(tmp_path / "src")[1]
    res = _cli_run(port_cli.main, cfg, tmp_path / "res",
                   common + ["--resume-from", str(path)])
    _assert_resumed(ref, ref_dir, res, tmp_path / "res")
    capsys.readouterr()
    for extra, needle in ((["--resume-from", str(tmp_path / "no.ckpt")],
                           "checkpoint not found"),
                          (["--resume-from", str(path), "--seed", "9"],
                           "config mismatch")):
        rc = port_cli.main([str(cfg), "--data-directory",
                            str(tmp_path / "bad"), "--quiet",
                            "--scheduler-policy", "tpu_batch", *common,
                            *extra])
        err = capsys.readouterr().err
        assert rc == 2 and needle in err, err
        assert len(err.strip().splitlines()) == 1, err


# -- chip_smoke.py's checkpoint phase, on the CPU ---------------------------------

@pytest.mark.slow
def test_chip_smoke_checkpoint_phase(tmp_path):
    """Every leg of the phase on the CPU, at full width and full stop
    time: each checkpointing run and each resume gives the constants the
    phase pins (recomputed from the reference by the e2e, policies and
    faults tests' slow legs)."""
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.ops import transport_kernels as tk
    from shadow_tpu_torch.parallel import mesh
    from tests.test_torch_e2e import _chip_smoke

    _chip_smoke().checkpoint_path(port_cli, prop, tk, dt, mesh,
                                  output_tree_digest, str(tmp_path),
                                  device="cpu")


# -- managed processes: re-execution snapshots ---------------------------

def _managed(tmp_path):
    """managed_smoke (chip_smoke.py's document, its guests built into
    ``tmp_path``); None where the kernel features are missing."""
    from shadow_tpu_torch.native.managed import missing_kernel_features
    from tests.test_torch_e2e import _chip_smoke

    if missing_kernel_features():
        pytest.skip(f"kernel features missing: {missing_kernel_features()}")
    cs = _chip_smoke()
    return cs, cs.write_doc(cs.managed_doc(
        "managed_smoke", cs.build_guests(tmp_path / "guests")),
        tmp_path / "managed.yaml")


def _mrun(cfg, d, *extra, rc=0):
    """A managed run through the port's CLI (tpu_batch, a state digest
    every 5 rounds)."""
    from tests.test_torch_managed import run_port

    return run_port(cfg, d, ["--state-digest-every", "5", *extra], rc=rc)


@pytest.mark.parametrize("fast", [True, False], ids=["fast_on", "fast_off"])
def test_managed_reexec_checkpoint_resume_identity(tmp_path, monkeypatch,
                                                   ipc_slots, fast):
    """The reference's re-execution property on both sides of the shim's
    fast plane: a snapshot taken mid-transfer resumes by re-execution into
    the uninterrupted run's tree, summary and digest stream, and into the
    reference's; the boundary is digest- and cursor-verified."""
    from shadow_tpu.native import managed as ref_managed
    from shadow_tpu_torch.native import managed as port_managed
    from tests.test_torch_managed import build_ref_shim, run_ref

    monkeypatch.setattr(port_managed, "_FASTPATH_ON", fast)
    monkeypatch.setattr(ref_managed, "_FASTPATH_ON", fast)
    cs, cfg = _managed(tmp_path)
    full = _mrun(cfg, tmp_path / "full")
    src = _mrun(cfg, tmp_path / "src", "--checkpoint-every", "500ms")
    vol = VOLATILE_SUMMARY_KEYS
    assert src["process_errors"] == full["process_errors"] == []
    assert cs.managed_stable(src, vol) == cs.managed_stable(full, vol)
    assert cs.hosts_digest(tmp_path / "src") == cs.hosts_digest(
        tmp_path / "full")
    paths = _checkpoints(tmp_path / "src")
    hdr = ckpt.read_header(paths[0])
    assert (hdr["mode"], hdr["managed"], hdr["format"], hdr["version"]) == (
        "reexec", True, ckpt.FORMAT, 2)
    payload = json.loads(paths[0].read_text().splitlines()[1])
    assert payload["cursors"]
    assert list((tmp_path / "src" / "guest_oplogs").glob("*.jsonl"))
    res = _mrun(cfg, tmp_path / "res", "--resume-from", str(paths[0]))
    assert cs.managed_stable(res, vol) == cs.managed_stable(full, vol)
    assert cs.hosts_digest(tmp_path / "res") == cs.hosts_digest(
        tmp_path / "full")
    assert ((tmp_path / "res" / ckpt.DIGEST_FILE).read_bytes()
            == (tmp_path / "full" / ckpt.DIGEST_FILE).read_bytes())
    # and the reference's checkpointing run of the same document
    ref = run_ref(cfg, tmp_path / "ref", build_ref_shim(tmp_path),
                  ["--state-digest-every", "5", "--checkpoint-every",
                   "500ms"])
    assert cs.managed_stable(full, vol) == cs.managed_stable(
        ref, REF_VOLATILE)
    assert cs.hosts_digest(tmp_path / "ref") == cs.hosts_digest(
        tmp_path / "full")
    assert ((tmp_path / "ref" / ckpt.DIGEST_FILE).read_bytes()
            == (tmp_path / "full" / ckpt.DIGEST_FILE).read_bytes())
    assert len(_checkpoints(tmp_path / "ref")) == len(paths)


def test_managed_reexec_detects_divergence(tmp_path, ipc_slots):
    """A snapshot resumed under a different observation stream fails at
    the boundary, by name: a tampered state digest, then a tampered guest
    cursor."""
    _, cfg = _managed(tmp_path)
    _mrun(cfg, tmp_path / "src", "--checkpoint-every", "500ms")
    p = _checkpoints(tmp_path / "src")[0]
    header, payload = p.read_text().splitlines()[:2]
    for what, needle in (("digest", "state digest"), ("cursors",
                                                      "cursor mismatch")):
        doc = json.loads(payload)
        if what == "digest":
            doc["digest"] = "0" * len(doc["digest"])
        else:
            key = sorted(doc["cursors"])[0]
            doc["cursors"][key] = {"n": 0, "sha": "0" * 64}
        tampered = tmp_path / f"tampered_{what}.ckpt"
        tampered.write_text(header + "\n" + json.dumps(doc) + "\n")
        cfgo = parse_config(yaml.safe_load(Path(cfg).read_text()), {
            "general.data_directory": str(tmp_path / f"res_{what}"),
            "experimental.scheduler_policy": "tpu_batch"})
        ctl, resume_at = ckpt.load_checkpoint(tampered, cfgo,
                                              mirror_log=False, device="cpu")
        assert resume_at is None
        try:
            with pytest.raises(ckpt.CheckpointError,
                               match=f"diverged.*{needle}"):
                ctl.run(resume_at=resume_at)
        finally:
            # the abort skips _finalize: reap the real guests here
            for proc in ctl.processes:
                proc.kill()
            ctl.scheduler.shutdown()


def test_managed_host_down_respawns_and_resumes(tmp_path, ipc_slots):
    """A replayed host_down on the managed client mid-transfer SIGKILLs
    the real guest and host_up respawns it (the fresh ring_probe then
    finds its server gone: both guests still run at the stop time, the
    same process errors in both packages); the run is the reference's,
    and a snapshot taken after the fault embeds the command, so its
    resume replays the crash and respawn into the same run."""
    from tests.test_torch_managed import build_ref_shim, run_ref

    cs, cfg = _managed(tmp_path)
    cmds = tmp_path / "cmds.jsonl"
    cmds.write_text(json.dumps(
        {"cmd": {"cmd": "host_down", "hosts": ["client"],
                 "duration": "300000000 ns"},
         "round": 0, "seq": 0, "t": 1_200_000_000}) + "\n")
    # the Python plane: the reference's C engine counts one
    # units_emitted fewer than its Python plane after this crash (the
    # port's two engines repeat each: ROADMAP queue C)
    rc = ["--replay-commands", str(cmds), "--set",
          "experimental.native_colcore=false"]
    a = _mrun(cfg, tmp_path / "a", *rc, rc=1)
    assert len(a["process_errors"]) == 2
    assert a["counters"]["host_crashes"] == 1
    assert a["counters"]["host_boots"] == 1
    assert a["counters"]["processes_spawned"] == 3
    ref = run_ref(cfg, tmp_path / "ref", build_ref_shim(tmp_path),
                  ["--state-digest-every", "5", *rc], rc=1)
    vol = VOLATILE_SUMMARY_KEYS
    assert cs.managed_stable(a, vol) == cs.managed_stable(ref, REF_VOLATILE)
    assert cs.hosts_digest(tmp_path / "a") == cs.hosts_digest(
        tmp_path / "ref")
    assert ((tmp_path / "a" / ckpt.DIGEST_FILE).read_bytes()
            == (tmp_path / "ref" / ckpt.DIGEST_FILE).read_bytes())
    _mrun(cfg, tmp_path / "src", "--checkpoint-every", "500ms", *rc, rc=1)
    late = _checkpoints(tmp_path / "src")[-1]
    assert json.loads(late.read_text().splitlines()[1])["commands"]
    res = _mrun(cfg, tmp_path / "res", "--resume-from", str(late), *rc[2:],
                rc=1)
    assert cs.managed_stable(res, vol) == cs.managed_stable(a, vol)
    assert cs.hosts_digest(tmp_path / "res") == cs.hosts_digest(
        tmp_path / "a")
    assert ((tmp_path / "res" / ckpt.DIGEST_FILE).read_bytes()
            == (tmp_path / "a" / ckpt.DIGEST_FILE).read_bytes())
