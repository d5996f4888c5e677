"""Supervised runs in the port (shadow_tpu_torch/supervise.py) against the
reference.

The reference's supervision documents (tests/test_supervise.py:
gossip_churn cut to 5 s, telemetry every 2 s, a state digest every 50
rounds) run once through the reference, single-process and uninterrupted.
The port then survives injected failures under supervision on
``--device cpu``: two worker SIGKILLs and a ring-stall wedge on 2 shards
(C engine and Python plane), and an in-process kill of the single-process
controller. The tolerance is zero: the recovered run's hosts/ tree,
metrics.jsonl, flows.jsonl and state_digests.jsonl and its summary but for
its run-shape keys are the reference's. Every failure is named and
detected within a bound; below the checkpoint floor the supervisor gives
up by name with a crash report. The pure pieces (the chaos grammar, the
deadline policy, the progress page, the stream rollback, the crash
report) are held to the reference's own on the same inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import pytest
import yaml

from shadow_tpu import supervise as ref_sup
from shadow_tpu.config.schema import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.core.controller import VOLATILE_SUMMARY_KEYS as REF_VOLATILE
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu_torch import supervise as sup
from shadow_tpu_torch.config.schema import parse_config
from shadow_tpu_torch.core.controller import VOLATILE_SUMMARY_KEYS
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_torch_managed import ipc_slots  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parent.parent
CHURN_YAML = ROOT / "examples" / "gossip_churn.yaml"
STREAMS = ("flows.jsonl", "metrics.jsonl", "state_digests.jsonl")
#: generous bound over the 2 s stall floor the chaos legs pin: detection,
#: teardown and the recovered attempt's start land well inside it
DETECT_BOUND_S = 60.0


def _overrides(data_dir, shards: int, extra: dict = None) -> dict:
    return {
        "general.data_directory": str(data_dir),
        "general.stop_time": "5s",
        "general.sim_shards": shards,
        "general.state_digest_every": 50,
        "telemetry.sample_every": "2s",
        "experimental.scheduler_policy": "tpu_batch",
        **(extra or {}),
    }


def _cfg(data_dir, shards, extra=None):
    return parse_config(yaml.safe_load(CHURN_YAML.read_text()),
                        _overrides(data_dir, shards, extra))


def _streams(data_dir) -> dict:
    return {n: hashlib.sha256((Path(data_dir) / n).read_bytes()).hexdigest()
            for n in STREAMS}


def _stable(s: dict, volatile) -> dict:
    return {k: v for k, v in s.items() if k not in volatile}


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's clean single-process run (its Python plane)."""
    d = tmp_path_factory.mktemp("ref")
    cfg = ref_parse_config(
        yaml.safe_load(CHURN_YAML.read_text()),
        _overrides(d, 1, {"experimental.native_colcore": False}))
    return RefController(cfg, mirror_log=False).run(), d


def _assert_reference(ref_run, got, got_dir):
    ref, ref_dir = ref_run
    assert _stable(got, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(got_dir) == ref_tree_digest(ref_dir)
    assert _streams(got_dir) == _streams(ref_dir)


# -- the pure pieces, against the reference's ---------------------------------------

CHAOS_SPECS = ("kill@r500", " s1:wedge@r900 , fail@r7,s0:guest_wedge@r2", "",
               "s3:kill@r0,s0:fail@r12")


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_parse_chaos(spec):
    assert sup.parse_chaos(spec) == ref_sup.parse_chaos(spec)


@pytest.mark.parametrize("spec, needle", [
    ("explode@r5", "kind"), ("kill@500", "r<round>"), ("kill", "expected"),
    ("sX:kill@r5", "shard")])
def test_parse_chaos_refusals(spec, needle):
    with pytest.raises(ValueError, match=needle):
        sup.parse_chaos(spec)
    with pytest.raises(ValueError, match=needle):
        ref_sup.parse_chaos(spec)


def test_stall_deadline_policy(monkeypatch):
    for env in ({}, {sup.STALL_FLOOR_ENV: "3", sup.STALL_MULT_ENV: "10"}):
        monkeypatch.delenv(sup.STALL_FLOOR_ENV, raising=False)
        monkeypatch.delenv(sup.STALL_MULT_ENV, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for ema in (0.0, None, 0.01, 1.0, 2.0, 1e9):
            assert sup.stall_deadline_s(ema) == ref_sup.stall_deadline_s(ema)
    monkeypatch.delenv(sup.STALL_FLOOR_ENV, raising=False)
    monkeypatch.delenv(sup.STALL_MULT_ENV, raising=False)
    assert sup.stall_deadline_s(0.0) == sup.DEFAULT_STALL_FLOOR_S
    assert sup.stall_deadline_s(1e9) == sup.STALL_CEILING_S


def test_supervise_schema():
    doc = yaml.safe_load(CHURN_YAML.read_text())
    cfg = parse_config(doc, {"general.supervise": True})
    assert cfg.general.supervise == {"max_restarts": 3, "backoff": 1.0}
    assert sup.supervise_options(cfg)["max_restarts"] == 3
    cfg = parse_config(doc, {"general.supervise": {"max_restarts": 0,
                                                   "backoff": 0.5}})
    assert cfg.general.supervise == {"max_restarts": 0, "backoff": 0.5}
    with pytest.raises(ValueError, match="unknown general.supervise"):
        parse_config(doc, {"general.supervise": {"retries": 2}})
    assert parse_config(doc, {"general.supervise": False}) \
        .general.supervise is None


def test_progress_page_roundtrip():
    name = sup.progress_name(f"t{os.getpid():x}")
    assert name.startswith("stpt_")  # apart from the reference's "stpu_"
    assert ref_sup.progress_name("t").startswith("stpu_")
    page = sup.ProgressPage(name, 3, create=True)
    try:
        assert page.read(0) == (0, 0)
        assert page.age_s(0) == float("inf")
        page.stamp(0, 41)
        page.stamp(2, 7)
        peer = sup.ProgressPage(name, 3)
        try:
            r0, ns0 = peer.read(0)
            assert r0 == 41 and ns0 > 0
            assert peer.read(1) == (0, 0)
            assert peer.age_s(0) < 5.0
            assert [r for r, _ns in peer.snapshot()] == [41, 0, 7]
        finally:
            peer.close()
        page.stamp(0, 42)
        assert page.read(0)[0] == 42
    finally:
        page.close()
        page.unlink()


def _stream_files(d: Path, t0: int) -> None:
    def _w(name, recs):
        (d / name).write_text("".join(json.dumps(r) + "\n" for r in recs))

    _w("state_digests.jsonl", [{"round": 50, "digest": "a"},
                               {"round": 100, "digest": "b"},
                               {"round": 150, "digest": "c"}])
    _w("state_digests.shard0.jsonl", [{"round": 100, "digest": "b"},
                                      {"round": 150, "digest": "c"}])
    _w("flows.jsonl", [{"round": 99, "hid": 1}, {"round": 101, "hid": 2}])
    _w("flows.shard1.jsonl", [{"round": 100, "hid": 1},
                              {"round": 102, "hid": 3}])
    _w("commands.jsonl", [{"t": t0, "cmd": "x"}, {"t": t0 + 1, "cmd": "y"}])
    _w("metrics.jsonl", [
        {"kind": "meta", "v": 1},
        {"kind": "sample", "t": t0, "round": 100},
        {"kind": "sample", "t": t0 + 5, "round": 101},
        {"kind": "fault", "t": t0, "round": 100},
        {"kind": "fault", "t": t0 - 5, "round": 99},
    ])


def test_rollback_streams(tmp_path):
    """The port's rollback leaves every stream as the reference's does."""
    t0 = 2_000_000_000
    out = {}
    for tag, mod, parse in (("port", sup, parse_config),
                            ("ref", ref_sup, ref_parse_config)):
        d = tmp_path / tag
        d.mkdir()
        _stream_files(d, t0)
        cfg = parse(yaml.safe_load(CHURN_YAML.read_text()), {
            "general.data_directory": str(d),
            "telemetry.sample_every": "1s"})
        mod.rollback_streams(cfg, 100, t0)
        out[tag] = {p.name: p.read_text() for p in sorted(d.iterdir())}
    assert out["port"] == out["ref"]
    kept = [json.loads(x) for x in out["port"]["metrics.jsonl"].splitlines()]
    assert [r["kind"] for r in kept] == ["meta", "sample", "fault"]
    assert [json.loads(x)["round"] for x in
            out["port"]["state_digests.jsonl"].splitlines()] == [50, 100]


def test_crash_report_fields(tmp_path):
    (tmp_path / "state_digests.jsonl").write_text(
        json.dumps({"round": 70, "digest": "d"}) + "\n")
    p = sup.write_crash_report(tmp_path, "boom", exc=RuntimeError("r"),
                               attempt=2, max_restarts=1,
                               extra={"worker": 1})
    doc = json.loads(p.read_text())
    assert doc["format"] == sup.REPORT_FORMAT == ref_sup.REPORT_FORMAT
    assert doc["reason"] == "boom" and doc["exc_type"] == "RuntimeError"
    assert doc["attempt"] == 2 and doc["max_restarts"] == 1
    assert doc["last_digest_round"] == 70 and doc["digest_cursor"] == 1
    assert doc["worker"] == 1
    assert isinstance(doc["rlimit_nofile"], list)


def test_restart_checkpoint_discovery(tmp_path):
    """The newest complete checkpoint: a single file, or a shard manifest
    whose files all exist; an incomplete manifest is passed over."""
    d = tmp_path / "checkpoints"
    d.mkdir()
    cfg = _cfg(tmp_path, 1)
    assert sup.find_restart_checkpoint(cfg) is None
    for t in (1, 2):
        (d / f"ckpt_t{t:020d}.ckpt").write_bytes(b"")
    assert sup.find_restart_checkpoint(cfg).endswith(f"{2:020d}.ckpt")
    cfg2 = _cfg(tmp_path, 2)
    for t, files in ((3, 2), (4, 1)):
        names = [f"ckpt_t{t:020d}.shard{k}.ckpt" for k in range(2)]
        for n in names[:files]:
            (d / n).write_bytes(b"")
        (d / f"ckpt_t{t:020d}.shards.json").write_text(json.dumps(
            {"format": "shadow_tpu_torch-shard-manifest", "files": names}))
    assert sup.find_restart_checkpoint(cfg2).endswith(
        f"{3:020d}.shards.json")


# -- chaos identity ------------------------------------------------------------------

def _chaos_env(monkeypatch, spec: str):
    monkeypatch.setenv(sup.CHAOS_ENV, spec)
    # tight deadlines so detection is seconds, not the CI-safe defaults
    monkeypatch.setenv(sup.STALL_FLOOR_ENV, "2")
    monkeypatch.setenv(sup.STALL_MULT_ENV, "20")


@pytest.mark.parametrize("colcore", [True, False], ids=["c", "py"])
def test_supervised_chaos_identity_sharded(tmp_path, monkeypatch, ref_run,
                                           colcore):
    """Two worker SIGKILLs and a ring-stall wedge on a 2-shard churn run
    under supervision: each failure named and detected within the bound,
    and the recovered run is the reference's clean run, with the C engine
    and on the Python plane."""
    _chaos_env(monkeypatch, "s0:kill@r300,s1:kill@r600,s0:wedge@r850")
    cfg = _cfg(tmp_path / "run", 2, {
        "experimental.native_colcore": colcore,
        "general.checkpoint_every": "1s",
        "general.supervise": {"max_restarts": 4, "backoff": 0.2}})
    res = sup.run_supervised(cfg, mirror_log=False, device="cpu")
    _assert_reference(ref_run, res, tmp_path / "run")
    svr = res["supervisor"]
    assert svr["attempts"] == len(svr["restarts"]) + 1
    assert len(svr["restarts"]) == 3
    reasons = " | ".join(r["reason"] for r in svr["restarts"])
    assert "died" in reasons            # SIGKILLed workers, named
    assert "dead or wedged" in reasons  # the stale peer, named by shard
    for r in svr["restarts"]:
        assert r["mttr_s"] < DETECT_BOUND_S, r
        assert r["resume"] != "scratch"
    for part in res["shards"]["per_shard"]:
        assert not any(part["launches"].values())


def test_supervised_single_kill_resumes(tmp_path, monkeypatch, ref_run):
    """Single-process: an in-process chaos kill under supervision becomes
    a recoverable failure, the run resumes from the newest checkpoint and
    ends on the reference's bytes."""
    monkeypatch.setenv(sup.CHAOS_ENV, "kill@r600")
    cfg = _cfg(tmp_path / "run", 1, {
        "general.checkpoint_every": "1s",
        "general.supervise": {"max_restarts": 2, "backoff": 0.1}})
    res = sup.run_supervised(cfg, mirror_log=False, device="cpu")
    _assert_reference(ref_run, res, tmp_path / "run")
    svr = res["supervisor"]
    assert len(svr["restarts"]) == 1
    assert "ChaosFailure" in svr["restarts"][0]["reason"]
    assert svr["restarts"][0]["resume"].endswith(".ckpt")


def test_supervisor_gives_up_below_checkpoint_floor(tmp_path, monkeypatch):
    """No checkpoint to restart from and a zero budget: the structured
    crash report and a named SupervisorGaveUp, never a hang."""
    monkeypatch.setenv(sup.CHAOS_ENV, "fail@r60")
    cfg = _cfg(tmp_path / "run", 1, {
        "general.stop_time": "2s",
        "general.supervise": {"max_restarts": 0, "backoff": 0.0}})
    with pytest.raises(sup.SupervisorGaveUp,
                       match="restart budget exhausted"):
        sup.run_supervised(cfg, mirror_log=False, device="cpu")
    rep = json.loads((tmp_path / "run" / sup.CRASH_REPORT).read_text())
    assert rep["format"] == sup.REPORT_FORMAT
    assert rep["exc_type"] == "ChaosFailure"
    assert rep["attempt"] == 1 and rep["max_restarts"] == 0
    assert rep["digest_cursor"] >= 1


def test_cli_supervise_gives_up_with_exit_1(tmp_path, monkeypatch, capsys):
    from shadow_tpu_torch import cli

    monkeypatch.setenv(sup.CHAOS_ENV, "fail@r60")
    rc = cli.main([str(CHURN_YAML), "--device", "cpu", "--stop-time",
                   "2s", "--quiet", "--set",
                   "general.supervise={max_restarts: 0, backoff: 0}",
                   "--data-directory", str(tmp_path / "run")])
    err = capsys.readouterr().err
    assert rc == 1 and "supervisor gave up" in err, err


# -- chaos identity: managed guests -------------------------------------

def test_supervised_managed_guest_wedge_identity(tmp_path, monkeypatch,
                                                ipc_slots):
    """A managed run surviving one injected guest wedge (the newest guest
    SIGSTOPped, its watchdog stall escalated to the supervisor as
    GuestStallError, the run re-executed from scratch) equals the clean
    run and the reference's byte for byte: tree, state digests, summary
    (less shim_fast_*). The wedged guest is named, and the recovered run
    counts no unsupervised watchdog kill."""
    from shadow_tpu_torch.native.managed import missing_kernel_features
    from tests.test_torch_e2e import _chip_smoke
    from tests.test_torch_managed import build_ref_shim, run_port, run_ref

    if missing_kernel_features():
        pytest.skip(f"kernel features missing: {missing_kernel_features()}")
    monkeypatch.delenv(sup.CHAOS_ENV, raising=False)
    cs = _chip_smoke()
    doc = cs.managed_doc("managed_smoke", cs.build_guests(tmp_path / "g"))
    cfg = cs.write_doc(doc, tmp_path / "m.yaml")
    dig = ["--state-digest-every", "5"]
    clean = run_port(cfg, tmp_path / "clean", dig)
    ref = run_ref(cfg, tmp_path / "ref", build_ref_shim(tmp_path / "g"), dig)
    monkeypatch.setenv(sup.CHAOS_ENV, "guest_wedge@r25")
    over = {"general.data_directory": str(tmp_path / "chaos"),
            "general.state_digest_every": 5,
            "experimental.scheduler_policy": "tpu_batch",
            "experimental.guest_turn_timeout": 1,
            "general.supervise": {"max_restarts": 2, "backoff": 0.1}}
    from tests.test_torch_managed import _free_both_slots

    _free_both_slots()
    res = sup.run_supervised(parse_config(doc, over), mirror_log=False,
                             device="cpu")
    assert res["process_errors"] == []
    vol = VOLATILE_SUMMARY_KEYS
    for d, s, v in ((tmp_path / "clean", clean, vol),
                    (tmp_path / "ref", ref, REF_VOLATILE)):
        assert cs.hosts_digest(tmp_path / "chaos") == cs.hosts_digest(d)
        assert ((tmp_path / "chaos" / "state_digests.jsonl").read_bytes()
                == (d / "state_digests.jsonl").read_bytes())
        assert cs.managed_stable(res, vol) == cs.managed_stable(s, v)
    svr = res["supervisor"]
    assert len(svr["restarts"]) == 1
    r = svr["restarts"][0]
    assert "GuestStallError" in r["reason"] and "ring_probe" in r["reason"]
    assert r["mttr_s"] < DETECT_BOUND_S
    assert res["counters"].get("guest_watchdog_kills", 0) == 0
