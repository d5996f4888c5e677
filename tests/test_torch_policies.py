"""The thread policies and the per-unit plane against the reference.

``thread_per_core`` (the reference's default) and ``thread_per_host`` run
the per-unit plane (network/engine.py) with every loss draw on the host;
``tpu_batch`` and ``tpu_mesh`` run the columnar plane. Whatever the
policy, the port on ``--device cpu`` must give the reference's results
byte for byte: the same summary counts, the same hosts/ tree
(output_tree_digest) and the same state_digests.jsonl stream
(tools/bisect_divergence.py exits 0). The cases of the reference's
tests/test_colplane.py that need no faults hold the two planes of the port
to each other and to the reference.
"""

import contextlib
import dataclasses
import io
import json

import pytest
import yaml

from shadow_tpu import cli as ref_cli
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch.network import unit as U
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_colplane import GOSSIP, PARTITIONED, TGEN_LOSSY
from tests.test_torch_e2e import (COUNTS, ENGINES, EX, _assert_identical,
                                  _chip_smoke)


def _cli(main, cfg, data_dir, extra=()):
    """One run through a package's CLI, in this process; its summary.
    With no ``--scheduler-policy`` in ``extra`` the config's policy runs
    (the reference's default, thread_per_core, for every shipped
    config)."""
    argv = [str(cfg), "--data-directory", str(data_dir), "--json-summary",
            "--quiet", *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0, f"{main.__module__} {argv} exited {rc}"
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _policy(name, engine="c_engine"):
    return ["--scheduler-policy", name, *ENGINES[engine]]


#: the port's legs of tgen_100host: the user's default command (no policy
#: flag), thread_per_core on one worker thread, thread_per_host, and
#: tpu_batch on both host engines
TGEN100_LEGS = {
    "default": [],
    "thread_per_core_p1": ["--scheduler-policy", "thread_per_core",
                           "--parallelism", "1"],
    "thread_per_host": _policy("thread_per_host"),
    "tpu_batch_c_engine": _policy("tpu_batch"),
    "tpu_batch_python_plane": _policy("tpu_batch", "python_plane"),
}
DIGEST = ["--state-digest-every", "50"]


@pytest.fixture(scope="module")
def ref_tgen100(tmp_path_factory):
    """The reference's default command on tgen_100host (thread_per_core,
    the per-unit plane), with a state digest every 50 rounds."""
    d = tmp_path_factory.mktemp("ref_tgen100")
    return _cli(ref_cli.main, EX / "tgen_100host.yaml", d, DIGEST), d


@pytest.mark.parametrize("leg", sorted(TGEN100_LEGS))
def test_tgen_100host_identical_under_every_policy(tmp_path, ref_tgen100,
                                                   leg):
    """The reference's test_determinism_across_policies, held to the
    reference: every policy of the port gives the reference's default
    run, which gives chip_smoke.py's constants."""
    ref, ref_dir = ref_tgen100
    port = _cli(port_cli.main, EX / "tgen_100host.yaml", tmp_path,
                [*TGEN100_LEGS[leg], *DIGEST, "--device", "cpu"])
    _assert_identical(ref, port, ref_dir, tmp_path)
    assert port["native_colcore"] is (leg == "tpu_batch_c_engine")
    cs = _chip_smoke()
    assert {k: ref[k] for k in COUNTS} == cs.TGEN100_COUNTS
    assert ref_tree_digest(ref_dir) == cs.TGEN100_TREE_DIGEST


def test_per_unit_summary_has_no_window_state(tmp_path):
    """A plane without windows reports none: the per-unit plane's phase
    wall is the host events alone, it dispatches no window, and
    experimental.device_transport is a no-op on it (as in the reference),
    so the summary carries no transport keys."""
    s = _cli(port_cli.main, EX / "echo.yaml", tmp_path, [
        "--scheduler-policy", "thread_per_core", "--device", "cpu",
        "--set", "experimental.device_transport=true"])
    assert s["process_errors"] == []
    assert list(s["phase_wall"]) == ["events"]
    assert s["device_windows_dispatched"] == 0
    assert s["device"]["windows_dispatched"] == 0
    assert s["native_colcore"] is False
    assert "device_transport" not in s
    assert "device_transport_engaged" not in s
    assert output_tree_digest(tmp_path) == _chip_smoke().ECHO_TREE_DIGEST


#: the reference's tests/test_colplane.py cases that need no faults:
#: name -> (document, --set overrides, whether tpu_mesh runs it too)
PLANE_CASES = {
    "stream_loss": (TGEN_LOSSY, [], False),
    "gossip_ingress_pressure": (GOSSIP.replace(
        '"20 Mbit" host_bandwidth_down "20 Mbit"',
        '"20 Mbit" host_bandwidth_down "120 Kbit"'), [], False),
    "round_robin_qdisc": (TGEN_LOSSY, [
        "experimental.interface_qdisc=round_robin"], False),
    "multifrag_datagrams": (GOSSIP, ["experimental.unit_mtus=1"], False),
    "dynamic_runahead": (TGEN_LOSSY, [
        "experimental.use_dynamic_runahead=true"], False),
    "blackholes": (PARTITIONED, [], True),
}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_planes_agree_with_reference(tmp_path, case):
    """The per-unit plane (thread_per_core) and the columnar plane
    (tpu_batch on the C engine; tpu_mesh too on the partitioned topology)
    of the port give the reference's per-unit run: summaries, trees and
    digest streams."""
    doc, sets, mesh = PLANE_CASES[case]
    cfg = tmp_path / f"{case}.yaml"
    cfg.write_text(doc)
    extra = [*DIGEST, *(a for s in sets for a in ("--set", s))]
    ref_dir = tmp_path / "ref"
    ref = _cli(ref_cli.main, cfg, ref_dir, extra)
    legs = ["thread_per_core", "tpu_batch"] + (["tpu_mesh"] if mesh else [])
    for policy in legs:
        d = tmp_path / policy
        port = _cli(port_cli.main, cfg, d,
                    [*extra, "--scheduler-policy", policy, "--device", "cpu"])
        _assert_identical(ref, port, ref_dir, d)
    if case == "stream_loss":
        # the loss machinery engaged
        assert ref["units_dropped"] > 0 and ref["units_sent"] > 500
    if case == "blackholes":
        assert ref["units_blackholed"] > 0
    if case == "gossip_ingress_pressure":
        assert ref["units_sent"] > 2000


def test_thread_per_core_under_preemption(tmp_path):
    """Worker threads share the controller's active-host set (a host
    activates from inside its own events): with four times as many
    workers as cores and the interpreter switching threads every 10 µs,
    the gossip flood still gives the reference's run."""
    import os
    import sys

    cfg = tmp_path / "gossip.yaml"
    cfg.write_text(GOSSIP)
    ref = _cli(ref_cli.main, cfg, tmp_path / "ref", DIGEST)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        port = _cli(port_cli.main, cfg, tmp_path / "port", [
            *DIGEST, "--scheduler-policy", "thread_per_core",
            "--parallelism", str(4 * (os.cpu_count() or 1)),
            "--device", "cpu"])
    finally:
        sys.setswitchinterval(interval)
    _assert_identical(ref, port, tmp_path / "ref", tmp_path / "port")


def _drop_first_data(n):
    """A fault filter that force-drops the first ``n`` single-fragment
    DATA units it is shown."""
    left = {"n": n}

    def fault(u):
        if (u.kind == U.DATA and u.nbytes > 0 and u.nfrags == 1
                and left["n"] > 0):
            left["n"] -= 1
            return True
        return False

    fault.left = left
    return fault


def test_per_unit_device_branch_matches_host_twin(tmp_path, monkeypatch):
    """The device branch of the per-unit plane's barrier, which no config
    reaches (the thread policies run backend numpy): with the engine
    rebuilt on backend tpu at tpu_device_floor=1 (every batch dispatched
    to the draw plane, its plain version on the CPU, read at its causal
    deadline) and a fault filter (forced drops OR-ed in at read time), a
    thread_per_core run gives the reference's per-unit run under the same
    filter."""
    from shadow_tpu.config import parse_config as ref_parse
    from shadow_tpu.core.controller import Controller as RefController
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.network.engine import NetworkEngine

    doc = yaml.safe_load(TGEN_LOSSY)
    ref_cfg = ref_parse(doc, {"general.data_directory": str(tmp_path / "r")})
    ref_ctl = RefController(ref_cfg, mirror_log=False)
    ref_ctl.engine.fault_filter = _drop_first_data(3)
    ref = ref_ctl.run()

    cfg = parse_config(doc, {"general.data_directory": str(tmp_path / "p")})
    ctl = Controller(cfg, mirror_log=False, device="cpu")
    old = ctl.engine
    opts = dataclasses.replace(cfg.experimental, tpu_device_floor=1)
    eng = NetworkEngine(old.graph, old.params, ctl.hosts, ctl.round_ns,
                        backend="tpu", tpu_options=opts,
                        bootstrap_end=cfg.general.bootstrap_end_time,
                        device="cpu")
    eng.fault_filter = fault = _drop_first_data(3)
    ctl.engine = eng
    for h in ctl.hosts:
        h.engine = eng
    batches = []
    dispatch = eng.device.dispatch
    monkeypatch.setattr(eng.device, "dispatch",
                        lambda *a: batches.append(len(a[0])) or dispatch(*a))
    port = ctl.run()
    assert batches and fault.left["n"] == 0
    for k in ("rounds", "events", "units_sent", "units_dropped",
              "bytes_sent", "counters"):
        assert port[k] == ref[k], k
    assert output_tree_digest(tmp_path / "p") == ref_tree_digest(
        tmp_path / "r")


def test_thread_per_host_refuses_above_2048_hosts(tmp_path, capsys):
    """thread_per_host would start one OS thread a host: above 2,048 hosts
    both packages refuse it with the same message, exit 2."""
    doc = yaml.safe_load((EX / "echo.yaml").read_text())
    doc["hosts"]["client"]["quantity"] = 2048  # 2,049 hosts with server
    cfg = tmp_path / "big.yaml"
    cfg.write_text(yaml.safe_dump(doc))
    argv = [str(cfg), "--scheduler-policy", "thread_per_host",
            "--data-directory", str(tmp_path / "d"), "--quiet"]
    errs = []
    for main in (ref_cli.main, port_cli.main):
        assert main(argv + (["--device", "cpu"]
                            if main is port_cli.main else [])) == 2
        errs.append(capsys.readouterr().err.split(": ", 1)[1])
    assert errs[0] == errs[1]
    assert "thread_per_host with 2049 hosts" in errs[1]


@pytest.mark.slow
@pytest.mark.parametrize("policy", ["thread_per_core", "thread_per_host"])
def test_tgen_1k_thread_policies_give_chip_smoke_constants(tmp_path, policy):
    """chip_smoke.py's policies phase runs tgen_1k (1,000 hosts, under the
    thread_per_host cap) under both thread policies: the port gives the
    reference's counts and tree, which are chip_smoke.py's constants."""
    cs = _chip_smoke()
    extra = ["--scheduler-policy", policy]
    ref = _cli(ref_cli.main, EX / "tgen_1k.yaml", tmp_path / "ref", extra)
    port = _cli(port_cli.main, EX / "tgen_1k.yaml", tmp_path / "port",
                extra + ["--device", "cpu"])
    assert {k: ref[k] for k in COUNTS} == cs.TGEN1K_COUNTS
    assert ref_tree_digest(tmp_path / "ref") == cs.TGEN1K_TREE_DIGEST
    assert {k: port[k] for k in COUNTS} == cs.TGEN1K_COUNTS
    assert output_tree_digest(tmp_path / "port") == cs.TGEN1K_TREE_DIGEST
    assert port["process_errors"] == []


@pytest.mark.slow
def test_web_cdn_100k_thread_per_core_gives_chip_smoke_constants(tmp_path):
    """web_cdn_100k (100,000 hosts) under its own policy, thread_per_core,
    to 500 ms: the per-unit plane gives the counts and last state digest
    that the reference gives there (chip_smoke.py's WEB500 constants, which
    tests/test_torch_e2e.py derives from the reference)."""
    cs = _chip_smoke()
    port = _cli(port_cli.main, EX / "web_cdn_100k.yaml", tmp_path, [
        "--stop-time", "500ms", "--state-digest-every",
        str(cs.WEB500_COUNTS["rounds"]), "--device", "cpu"])
    assert port["process_errors"] == []
    assert {k: port[k] for k in COUNTS} == cs.WEB500_COUNTS
    assert output_tree_digest(tmp_path) == cs.WEB500_TREE_DIGEST
    assert cs.last_state_digest(tmp_path) == cs.WEB500_STATE_DIGEST


@pytest.mark.slow
@pytest.mark.parametrize("label", [
    leg[0] for leg in _chip_smoke().POLICY_LEGS if " cut " in leg[0]])
def test_policy_cut_legs_give_chip_smoke_constants(tmp_path, label):
    """chip_smoke.py's policies legs cut short of their stop time: the
    reference at the same cut gives the leg's constants (counts, tree,
    last state digest, process errors), and so does the port under the
    leg's policy on the CPU."""
    cs = _chip_smoke()
    leg = next(x for x in cs.POLICY_LEGS if x[0] == label)
    _, cfg, policy, extra, counts, tree, state, errors = leg

    def go(main, d, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([str(EX / cfg), "--data-directory", str(d),
                  "--json-summary", "--quiet", *argv])
        s = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert cs.errors_digest(s["process_errors"]) == (
            errors or cs.errors_digest([]))
        assert {k: s[k] for k in counts} == counts
        assert cs.last_state_digest(d) == state
        return s

    go(ref_cli.main, tmp_path / "ref",
       ["--scheduler-policy", "tpu_batch", *extra])
    assert ref_tree_digest(tmp_path / "ref") == tree
    go(port_cli.main, tmp_path / "port",
       ["--scheduler-policy", policy, "--device", "cpu", *extra])
    assert output_tree_digest(tmp_path / "port") == tree
