"""Fault injection in the port against the reference.

The reference's fault documents (tests/test_faults.py: TWO_NODE with a
healing partition, an unhealed cut, a crash, a crash and reboot, a degrade
window and two same-time degrades; CHURN_DOC with a partition, a degrade
and host churn) run once through the reference and through the port on
``--device cpu`` under every scheduler policy, on both host engines where
the policy runs the columnar plane, and at tpu_device_floor 1 (the plain
draw_flags under thresholds the injector rewrote). The tolerance is zero:
the same summary (fault_transitions_applied and the fault counters
included), the same hosts/ tree and the same state digest stream. Each
reference test's own property is then asserted on the port's run.

The ``slow`` tests run chip_smoke.py's faults phase on the CPU: each
shipped fault or telemetry config at full width, under each of its legs,
against the constants pinned there, which they recompute from the
reference.
"""

import json

import numpy as np
import pytest
import yaml

from shadow_tpu.config import load_config as ref_load_config
from shadow_tpu.config import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.core.rng import fault_rng as ref_fault_rng
from shadow_tpu.faults import build_timeline as ref_build_timeline
from shadow_tpu_torch.config import load_config, parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.core.rng import fault_rng
from shadow_tpu_torch.faults import build_timeline
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_faults import CHURN_DOC, TWO_NODE
from tests.test_torch_e2e import EX, _assert_identical, _chip_smoke
from tests.test_torch_models import LEGS

DIGEST_EVERY = 50
#: the port's legs: tests/test_torch_models.py's (every policy, both host
#: engines where the policy runs the columnar plane) and tpu_batch at
#: tpu_device_floor 1 on the C engine. leg -> (policy, C engine, overrides)
FAULT_LEGS = {name: (policy, c, {}) for name, (policy, c) in LEGS.items()}
FAULT_LEGS["tpu_batch_floor1"] = ("tpu_batch", True,
                                  {"experimental.tpu_device_floor": 1})

#: the fault timelines of tests/test_faults.py's TWO_NODE cases, with the
#: client environment each one sets
TWO_NODE_FAULTS = {
    "heal": ("""
events:
  - {time: 2s, kind: link_down, src_nodes: [0], dst_nodes: [1], duration: 3s}
""", None),
    "cut": ("""
events:
  - {time: 2s, kind: link_down, src_nodes: [0], dst_nodes: [1]}
""", {"TGEN_IDLE_TIMEOUT_SEC": "5"}),
    "crash": ("""
events:
  - {time: 2s, kind: host_down, hosts: [client]}
""", None),
    "reboot": ("""
events:
  - {time: 2s, kind: host_down, hosts: [server], duration: 8s}
""", {"TGEN_IDLE_TIMEOUT_SEC": "5", "TGEN_RETRIES": "2"}),
    "degrade": ("""
events:
  - {time: 1500 ms, kind: link_degrade, src_nodes: [0], dst_nodes: [1],
     latency_factor: 2.0, loss_add: 0.2, duration: 2s}
""", None),
    "degrade_pair": ("""
events:
  - {time: 1s, kind: link_degrade, src_nodes: [0, 1], dst_nodes: [0, 1],
     loss_add: 0.01, duration: 3s}
  - {time: 1s, kind: link_degrade, src_nodes: [0, 1], dst_nodes: [0, 1],
     latency_factor: 1.2, duration: 2s}
""", None),
}
CASES = sorted(TWO_NODE_FAULTS) + ["churn"]
#: the cases whose barriers can drop (TWO_NODE's graph is loss-free): at
#: tpu_device_floor 1 their draws go through the device plane
LOSSY = ("churn", "degrade", "degrade_pair")


def _doc(case: str) -> dict:
    """The reference test's document for ``case``."""
    if case == "churn":
        return yaml.safe_load(CHURN_DOC)
    d = yaml.safe_load(TWO_NODE)
    faults, env = TWO_NODE_FAULTS[case]
    d["faults"] = yaml.safe_load(faults)
    if env:
        d["hosts"]["client"]["processes"][0]["environment"] = env
    return d


def _run(parse, ctl_cls, doc, data_dir, overrides=(), **kw):
    cfg = parse(doc, {"general.data_directory": str(data_dir),
                      "general.state_digest_every": DIGEST_EVERY,
                      **dict(overrides)})
    ctl = ctl_cls(cfg, mirror_log=False, **kw)
    return ctl, ctl.run()


def _port(doc, data_dir, overrides=()):
    return _run(parse_config, Controller, doc, data_dir, overrides,
                device="cpu")


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's run of each case (its default policy,
    thread_per_core), once for all legs."""
    out = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(f"ref_{case}")
        out[case] = (_run(ref_parse_config, RefController, _doc(case), d)[1],
                     d)
    return out


def _client(ctl):
    return ctl.processes[1].app


def _assert_case_property(case, ctl, r):
    """The property the reference's test of ``case`` asserts, on the
    port's run."""
    c = r["counters"]
    if case == "heal":
        assert _client(ctl).completed == 1 and _client(ctl).failed == 0
        assert r["units_blackholed"] > 0
        assert c.get("stream_rto_retransmits", 0) > 0
    elif case == "cut":
        assert _client(ctl).completed == 0 and _client(ctl).failed == 1
        assert c.get("stream_resets", 0) >= 2
        assert c.get("stream_timeouts", 0) >= 2
    elif case == "crash":
        assert c.get("host_crashes", 0) == 1
        assert c.get("conns_torn_down", 0) >= 1
        assert c.get("units_teardown_dropped", 0) > 0
        assert c.get("stream_timeouts", 0) == 1
    elif case == "reboot":
        cl = _client(ctl)
        assert cl.completed == 1 and cl.failed == 0 and cl.retried >= 1
        assert c.get("host_crashes", 0) == 1 == c.get("host_boots", 0)
        assert c.get("processes_spawned", 0) == 3
    elif case == "degrade":
        assert r["units_dropped"] > 0 and _client(ctl).completed == 1
        assert r["fault_transitions_applied"] == 2
    elif case == "degrade_pair":
        assert r["fault_transitions_applied"] == 4
        assert _client(ctl).completed == 1
    else:
        assert c.get("host_crashes", 0) > 0
        assert r["units_blackholed"] > 0
    if case != "churn":
        for h in ctl.hosts:
            assert h._conns == {}, h.name


@pytest.mark.parametrize("leg", sorted(FAULT_LEGS))
@pytest.mark.parametrize("case", CASES)
def test_fault_case_identical_to_reference(tmp_path, ref_runs, case, leg):
    policy, c_engine, extra = FAULT_LEGS[leg]
    ctl, port = _port(_doc(case), tmp_path, {
        "experimental.scheduler_policy": policy,
        "experimental.native_colcore": c_engine, **extra})
    ref, ref_dir = ref_runs[case]
    _assert_identical(ref, port, ref_dir, tmp_path)
    # on the C engine, its teardown and blackhole accounting ran
    assert port["native_colcore"] is (c_engine and policy.startswith("tpu"))
    if extra and case in LOSSY:
        # windows of live (lossy) barriers went through the device plane
        assert port["device"]["windows_dispatched"] > 0
    _assert_case_property(case, ctl, port)


def test_churn_twice_identical(tmp_path):
    """Same seed, same churn config, run twice in one process: identical
    results (the reference's test_twice_run_byte_identical)."""
    runs = [_port(_doc("churn"), tmp_path / tag)[1] for tag in "ab"]
    assert runs[0]["fault_transitions_applied"] > 0
    for k in ("rounds", "events", "units_sent", "units_dropped",
              "units_blackholed", "bytes_sent", "counters",
              "fault_transitions_applied"):
        assert runs[0][k] == runs[1][k], k
    assert output_tree_digest(tmp_path / "a") == output_tree_digest(
        tmp_path / "b")


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_same_round_reboot_then_crash_cancels_respawn(tmp_path, pkg):
    """A reboot and the next crash at one round start: the crash cancels
    the pending BAND_FAULT respawn, in both packages alike."""
    parse, ctl_cls, kw = ((ref_parse_config, RefController, {})
                          if pkg == "reference"
                          else (parse_config, Controller, {"device": "cpu"}))
    cfg = parse(yaml.safe_load(TWO_NODE),
                {"general.data_directory": str(tmp_path)})
    h = ctl_cls(cfg, mirror_log=False, **kw).hosts[0]
    seen = []
    h.crash(0)
    seen.append(len(h.equeue))
    h.reboot(1000)
    h.crash(1000)
    seen.append(len(h.equeue))
    h.reboot(2000)
    seen.append(len(h.equeue))
    assert seen == [0, 0, 1]


#: tests/test_faults.py::test_schema_rejects_bad_fault_configs, case by case
BAD_FAULTS = {
    "kind": {"events": [{"time": "1s", "kind": "meteor_strike",
                         "hosts": ["server"]}]},
    "no_src": {"events": [{"time": "1s", "kind": "link_down"}]},
    "no_hosts": {"events": [{"time": "1s", "kind": "host_down"}]},
    "latency_factor": {"events": [{"time": "1s", "kind": "link_degrade",
                                   "src_nodes": [0],
                                   "latency_factor": 0.5}]},
    "duration": {"events": [{"time": "1s", "kind": "link_up",
                             "src_nodes": [0], "duration": "1s"}]},
    "empty": {},
}


def _message(parse, doc) -> str:
    with pytest.raises(ValueError) as exc:
        parse(doc, {})
    return str(exc.value)


@pytest.mark.parametrize("case", sorted(BAD_FAULTS))
def test_schema_rejects_bad_fault_configs_as_the_reference(case):
    d = yaml.safe_load(TWO_NODE)
    d["faults"] = BAD_FAULTS[case]
    assert _message(parse_config, d) == _message(ref_parse_config, d)


@pytest.mark.parametrize("faults, needle", [
    ({"events": [{"time": "1s", "kind": "host_down", "hosts": ["nope"]}]},
     "unknown host"),
    ({"events": [{"time": "1s", "kind": "link_down", "src_nodes": [99]}]},
     "not in graph")])
def test_unknown_fault_targets_fail_at_build(tmp_path, faults, needle):
    d = yaml.safe_load(TWO_NODE)
    d["faults"] = faults
    over = {"general.data_directory": str(tmp_path)}
    msgs = []
    for parse, ctl_cls, kw in ((ref_parse_config, RefController, {}),
                               (parse_config, Controller, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            ctl_cls(parse(d, over), mirror_log=False, **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and needle in msgs[1]


@pytest.mark.parametrize("config", ["abr_1k", "gossip_churn",
                                    "partition_heal", "web_cdn"])
def test_shipped_fault_configs_parse_as_the_reference(config):
    """The four shipped configs with a faults: or telemetry: section load
    into the same options in both packages."""
    import dataclasses

    ref = ref_load_config(str(EX / f"{config}.yaml"))
    port = load_config(str(EX / f"{config}.yaml"))
    for sec in ("faults", "telemetry"):
        a, b = getattr(ref, sec), getattr(port, sec)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert port.faults is not None or port.telemetry is not None


@pytest.mark.parametrize("seed, stream", [(0, 0), (7, 3), (11, 122),
                                          ((1 << 40) + 5, 65535)])
def test_fault_rng_draws_equal_reference(seed, stream):
    a = ref_fault_rng(seed, stream).random(64)
    b = fault_rng(seed, stream).random(64)
    assert a.tobytes() == b.tobytes()


def _actions(acts):
    return [(a.t, a.kind, None if a.src is None else a.src.tolist(),
             None if a.dst is None else a.dst.tolist(), list(a.host_ids),
             a.latency_factor, a.loss_add, a.bandwidth_scale,
             None if a.ref is None else acts.index(a.ref)) for a in acts]


@pytest.mark.parametrize("source", ["churn", "gossip_churn"])
def test_timeline_equals_reference(tmp_path, source):
    """build_timeline materializes the same actions (churn draws
    included) in the same order."""
    if source == "churn":
        doc = _doc("churn")
        ref_cfg = ref_parse_config(doc, {"general.data_directory":
                                         str(tmp_path)})
        cfg = parse_config(doc, {"general.data_directory": str(tmp_path)})
    else:
        ref_cfg = ref_load_config(str(EX / "gossip_churn.yaml"))
        cfg = load_config(str(EX / "gossip_churn.yaml"))
    ref_ctl = RefController(ref_cfg, mirror_log=False)
    ctl = Controller(cfg, mirror_log=False, device="cpu")
    stop = cfg.general.stop_time
    a = ref_build_timeline(ref_cfg, ref_ctl.graph, ref_ctl._by_name, stop)
    b = build_timeline(cfg, ctl.graph, ctl._by_name, stop)
    assert len(b) > 10 and _actions(b) == _actions(a)
    assert _actions(ctl.faults.actions) == _actions(a)


def test_injector_rewrites_the_arrays_the_engine_reads(tmp_path):
    """A degrade rewrites graph.latency_ns, params.drop_thresh and the
    NIC rates in place (the C engine holds pointers into these buffers),
    with the reference's values, and its end restores them."""
    doc = _doc("degrade")
    doc["faults"]["events"][0]["bandwidth_scale"] = 0.5
    over = {"general.data_directory": str(tmp_path),
            "experimental.scheduler_policy": "tpu_batch"}
    ref = RefController(ref_parse_config(doc, over), mirror_log=False)
    port = Controller(parse_config(doc, over), mirror_log=False,
                      device="cpu")
    assert port.engine._c is not None
    bufs = [port.graph.latency_ns, port.engine.params.drop_thresh,
            port.engine.params.rate_up, port.engine.params.rate_down]
    before = [b.copy() for b in bufs]
    for t in (1_500_000_000, 3_500_000_000):
        for ctl in (ref, port):
            ctl.faults.apply_due(t)
        p, r = port.engine.params, ref.engine.params
        assert np.array_equal(port.graph.latency_ns, ref.graph.latency_ns)
        assert np.array_equal(p.drop_thresh, r.drop_thresh)
        assert np.array_equal(p.rate_up, r.rate_up)
        assert np.array_equal(p.rate_down, r.rate_down)
        now = [port.graph.latency_ns, p.drop_thresh, p.rate_up, p.rate_down]
        assert all(x is y for x, y in zip(now, bufs))
        if t == 1_500_000_000:
            assert not np.array_equal(p.drop_thresh, before[1])
    assert all(np.array_equal(x, y) for x, y in zip(bufs, before))


# -- chip_smoke.py's faults phase on the CPU ---------------------------------

def _cli_run(main, cfg, data_dir, argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(cfg), "--data-directory", str(data_dir),
                   "--json-summary", "--quiet", *argv])
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.slow
@pytest.mark.parametrize("config", ["abr_1k", "abr_1k@4s", "gossip_churn",
                                    "partition_heal", "web_cdn",
                                    "web_cdn@10s"])
def test_fault_configs_give_chip_smoke_constants(tmp_path, monkeypatch,
                                                 config):
    """The reference, as a user runs it under tpu_batch, gives
    chip_smoke.py's FAULT_RESULTS for ``config`` (a name with "@" is the
    config cut at that stop time); then every leg of FAULT_LEGS for it
    gives them in the port on the CPU (the transport leg with every cohort
    on the device path, the cached leg after the user leg in one
    process)."""
    from shadow_tpu import cli as ref_cli
    from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
    from shadow_tpu_torch import cli as port_cli
    from shadow_tpu_torch.network import devtransport
    from shadow_tpu_torch.ops import propagate
    from tests.test_torch_models import _every_cohort_on_device

    cs = _chip_smoke()
    want = cs.FAULT_RESULTS[config]
    name, _, stop = config.partition("@")
    dig = ["--state-digest-every", str(want["counts"]["rounds"]),
           *(["--stop-time", stop] if stop else [])]
    cfg = EX / f"{name}.yaml"
    ref = _cli_run(ref_cli.main, cfg, tmp_path / "ref",
                   ["--scheduler-policy", "tpu_batch", *dig])
    assert cs.fault_result(ref, str(tmp_path / "ref"),
                           ref_tree_digest) == want
    legs = [leg for leg in cs.FAULT_LEGS if leg[1] == config]
    assert legs
    for label, _, policy, extra in legs:
        d = tmp_path / label.replace(" ", "_")
        if label.endswith("user"):
            propagate.DeviceDrawPlane._cache.clear()
        with monkeypatch.context() as m:
            if label.endswith("transport floor1"):
                _every_cohort_on_device(m, devtransport)
            port = _cli_run(port_cli.main, cfg, d, [
                "--scheduler-policy", policy, "--device", "cpu", *dig,
                *extra])
        assert port["process_errors"] == []
        assert cs.fault_result(port, str(d), output_tree_digest) == want, \
            label


def test_pcap_constants_in_chip_smoke_are_the_reference(tmp_path):
    """chip_smoke.py's echo capture leg: the reference's tree and .pcap
    files, and the port's on the C engine."""
    from shadow_tpu import cli as ref_cli
    from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
    from shadow_tpu_torch import cli as port_cli

    cs = _chip_smoke()
    argv = ["--scheduler-policy", "tpu_batch", *cs.PCAP_ARGV]
    _cli_run(ref_cli.main, EX / "echo.yaml", tmp_path / "ref", argv)
    want = (cs.ECHO_PCAP_TREE_DIGEST, cs.ECHO_PCAPS)
    assert cs.pcap_result(str(tmp_path / "ref"), ref_tree_digest) == want
    s = _cli_run(port_cli.main, EX / "echo.yaml", tmp_path / "port",
                 [*argv, "--device", "cpu"])
    assert s["native_colcore"] is True
    assert cs.pcap_result(str(tmp_path / "port"), output_tree_digest) == want
