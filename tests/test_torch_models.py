"""The gossip and Tor models of the port against the reference.

The reference's small GOSSIP and TOR documents (tests/test_colplane.py)
under every scheduler policy, and on both host engines where the policy
runs the columnar plane: the port on ``--device cpu`` gives the
reference's summary counts, hosts/ tree and state digest stream byte for
byte. On the C engine the models' C paths must really run (the gossip
state of ``core.gossip_register``; the relays and exits of
``core.relay_new``; the client sinks of ``core.tor_client_sink``), so that
the comparison is not Python against Python. ``test_identity_tor`` is the
reference's tests/test_devtransport.py test of the same name, with the
device transport on and off.
"""

import contextlib
import io
import json

import pytest
import yaml

from shadow_tpu import cli as ref_cli
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.models import tor as port_tor
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_colplane import GOSSIP, TOR
from tests.test_tor_cplane import TOR_CFG
from tests.test_torch_e2e import COUNTS, EX, _assert_identical, _chip_smoke

DIGEST_EVERY = 50
DOCS = {"gossip": GOSSIP, "tor": TOR}
#: leg -> (scheduler policy, whether the C engine may attach)
LEGS = {
    "thread_per_core": ("thread_per_core", True),
    "thread_per_host": ("thread_per_host", True),
    "tpu_batch_c_engine": ("tpu_batch", True),
    "tpu_batch_python_plane": ("tpu_batch", False),
    "tpu_mesh_c_engine": ("tpu_mesh", True),
    "tpu_mesh_python_plane": ("tpu_mesh", False),
}


def _ref(cfg, data_dir, extra=()):
    """The reference's run of a config file through its CLI (its default
    policy, thread_per_core, unless ``extra`` names another)."""
    argv = [str(cfg), "--data-directory", str(data_dir), "--json-summary",
            "--quiet", "--state-digest-every", str(DIGEST_EVERY), *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port(doc, data_dir, overrides):
    """The port's run of a document through its Controller on the CPU:
    (controller, summary)."""
    cfg = parse_config(yaml.safe_load(doc), {
        "general.data_directory": str(data_dir),
        "general.state_digest_every": DIGEST_EVERY, **overrides})
    ctl = Controller(cfg, mirror_log=False, device="cpu")
    return ctl, ctl.run()


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's run of each document, once for all legs."""
    out = {}
    for name, doc in DOCS.items():
        d = tmp_path_factory.mktemp(f"ref_{name}")
        cfg = d / f"{name}.yaml"
        cfg.write_text(doc)
        out[name] = (_ref(cfg, d / "out"), d / "out")
    return out


class _CountingConn(port_tor._Conn):
    """The Tor model's Python cell framer, counting its instances: a relay,
    exit or client connection that the C engine does not carry builds
    one."""

    made = 0

    def __init__(self, *args, **kwargs):
        type(self).made += 1
        super().__init__(*args, **kwargs)


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("model", sorted(DOCS))
def test_model_identical_to_reference(tmp_path, monkeypatch, ref_runs,
                                      model, leg):
    policy, c_engine = LEGS[leg]
    monkeypatch.setattr(_CountingConn, "made", 0)
    monkeypatch.setattr(port_tor, "_Conn", _CountingConn)
    ctl, port = _port(DOCS[model], tmp_path, {
        "experimental.scheduler_policy": policy,
        "experimental.native_colcore": c_engine})
    ref, ref_dir = ref_runs[model]
    _assert_identical(ref, port, ref_dir, tmp_path)
    on_c = leg.endswith("c_engine")
    assert port["native_colcore"] is on_c
    apps = [p.app for h in ctl.hosts for p in h.processes]
    if model == "gossip":
        # every node's message handling ran in the C engine, or none did
        assert {a._c is not None for a in apps} == {on_c}
        assert ref["units_sent"] > 2000
        return
    relays = [a for a in apps if isinstance(a, port_tor.TorRelay)]
    clients = [a for a in apps if isinstance(a, port_tor.TorClient)]
    assert relays and clients
    assert {r._c is not None for r in relays} == {on_c}
    # on the C engine no relay, exit or client connection took the Python
    # framer: the clients' circuits ran through core.tor_client_sink
    assert (_CountingConn.made == 0) is on_c
    assert sum(c.completed for c in clients) > 0


def _every_cohort_on_device(monkeypatch, devtransport):
    """Send every cohort of the device transport to its device path (the
    plain version of ack_advance on the CPU): the device floor at 1, and
    the kernel attached before round 0 instead of in the background."""
    monkeypatch.setattr(devtransport, "_DEVICE_FLOOR", 1)
    monkeypatch.setattr(devtransport.DeviceTransport, "start_device_attach",
                        devtransport.DeviceTransport._bg_attach)


#: the reference test's legs (tests/test_devtransport.py DEVT_OFF/DEVT_ON)
DEVT = {"experimental.scheduler_policy": "tpu_batch",
        "experimental.native_colcore": False}


@pytest.mark.parametrize("leg", ["off", "on", "on_floor1"])
def test_identity_tor(tmp_path, monkeypatch, leg):
    """The lossy, SACK-bearing family: a tor_400-shaped config with packet
    loss (tests/test_tor_cplane.py TOR_CFG, to 20 s) on the Python plane
    with the device transport off, on at the reference's device floor,
    and on at floor 1 (every cohort through ack_advance's plain version
    on the CPU): each gives the reference's run with the transport off."""
    from shadow_tpu_torch.network import devtransport

    if leg == "on_floor1":
        _every_cohort_on_device(monkeypatch, devtransport)
    cfg = tmp_path / "tor.yaml"
    cfg.write_text(TOR_CFG)
    ref_dir = tmp_path / "ref"
    ref = _ref(cfg, ref_dir, ["--scheduler-policy", "tpu_batch", "--set",
                              "experimental.native_colcore=false",
                              "--stop-time", "20s"])
    ctl, port = _port(TOR_CFG, tmp_path / "port", {
        **DEVT, "general.stop_time": "20s",
        "experimental.device_transport": leg != "off"})
    _assert_identical(ref, port, ref_dir, tmp_path / "port")
    devt = ctl.engine.devt
    if leg == "off":
        assert devt is None
        return
    assert devt is not None and devt.cohorts > 0
    assert port["device_transport_engaged"]
    if leg == "on_floor1":
        assert devt.summary()["device_cohorts"] == devt.cohorts


def _full_leg(tmp_path, cfg, overrides):
    """A shipped config through the port's Controller on the CPU."""
    from shadow_tpu_torch.config import load_config

    ctl = Controller(load_config(str(EX / cfg), {
        "general.data_directory": str(tmp_path), **overrides}),
        mirror_log=False, device="cpu")
    return ctl.run()


@pytest.mark.slow
@pytest.mark.parametrize("policy", ["thread_per_core", "tpu_batch"])
def test_gossip_10k_gives_chip_smoke_constants(tmp_path, policy):
    """chip_smoke.py's gossip_10k legs: 10,000 nodes, whose logs are empty
    (no node logs before its stop), so the state digest of the last round
    holds the run to the reference, beside the counts."""
    cs = _chip_smoke()
    rounds = cs.GOSSIP10K_COUNTS["rounds"]
    ref = _ref(EX / "gossip_10k.yaml", tmp_path / "ref",
               ["--state-digest-every", str(rounds)])
    assert {k: ref[k] for k in COUNTS} == cs.GOSSIP10K_COUNTS
    assert (cs.last_state_digest(tmp_path / "ref")
            == cs.GOSSIP10K_STATE_DIGEST)
    assert ref_tree_digest(tmp_path / "ref") == cs.EMPTY_TREE_DIGEST
    port = _full_leg(tmp_path / "port", "gossip_10k.yaml", {
        "experimental.scheduler_policy": policy,
        "general.state_digest_every": rounds})
    assert port["process_errors"] == []
    assert {k: port[k] for k in COUNTS} == cs.GOSSIP10K_COUNTS
    assert (cs.last_state_digest(tmp_path / "port")
            == cs.GOSSIP10K_STATE_DIGEST)


@pytest.mark.slow
@pytest.mark.parametrize("leg", ["thread_per_core", "thread_per_host",
                                 "tpu_batch", "device_transport"])
def test_tor_400relay_gives_chip_smoke_constants(tmp_path, monkeypatch, leg):
    """chip_smoke.py's tor_400relay legs (1,010 hosts): under both thread
    policies, under tpu_batch as a user runs it, and on the Python plane
    with the device transport at floor 1. The reference's counts and tree
    are chip_smoke.py's constants."""
    from shadow_tpu_torch.network import devtransport

    cs = _chip_smoke()
    ref = _ref(EX / "tor_400relay.yaml", tmp_path / "ref")
    assert {k: ref[k] for k in COUNTS} == cs.TOR400_COUNTS
    assert ref_tree_digest(tmp_path / "ref") == cs.TOR400_TREE_DIGEST
    over = {"experimental.scheduler_policy": leg}
    if leg == "device_transport":
        _every_cohort_on_device(monkeypatch, devtransport)
        over = {**DEVT, "experimental.device_transport": True}
    port = _full_leg(tmp_path / "port", "tor_400relay.yaml", over)
    assert port["process_errors"] == []
    assert {k: port[k] for k in COUNTS} == cs.TOR400_COUNTS
    assert output_tree_digest(tmp_path / "port") == cs.TOR400_TREE_DIGEST
    if leg == "device_transport":
        s = port["device_transport"]
        assert 0 < s["device_cohorts"] == s["cohorts"]
