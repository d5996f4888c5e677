"""Whole simulations under both packages: shadow_tpu (the reference) and
shadow_tpu_torch (the port), same config and seed, the port on
``--device cpu`` (its kernels' plain PyTorch versions).

The bar is byte identity, not closeness: the same hosts/ output tree
(output_tree_digest), the same summary counts, and the same per-round
state_digests.jsonl stream (tools/bisect_divergence.py --a REF --b PORT
exits 0). Under tpu_batch at tpu_device_floor 1 (every draw window through
the device plane) and 10**9 (every window on the host twin); under
tpu_mesh at the default tpu_mesh_floor and at 0 (every causal window
through the mesh exchange). The port runs with its C engine (the
default) and with the Python columnar plane (``native_colcore: false``);
the reference runs its Python plane, which needs no build of its engine.
Unported features are refused by name with exit 2; fault injection,
telemetry, packet capture, the ABR and httpd models and managed
processes, which the port runs, run echo as the reference does.
"""

import contextlib
import importlib.util
import io
import itertools
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import yaml

from shadow_tpu import cli as ref_cli
from shadow_tpu.core.controller import VOLATILE_SUMMARY_KEYS as REF_VOLATILE
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch.core.controller import VOLATILE_SUMMARY_KEYS
from shadow_tpu_torch.utils.digest import output_tree_digest

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
COUNTS = ("rounds", "events", "units_sent", "units_dropped", "bytes_sent")
#: the host engine of the port's run: the C engine or the Python plane
ENGINES = {"c_engine": [], "python_plane": [
    "--set", "experimental.native_colcore=false"]}
REF_PLANE = ENGINES["python_plane"]
#: device windows of tgen_100host at tpu_device_floor 1 with a state
#: digest every 50 rounds while the floor holds: the port's count, whose
#: forced floor never moves, and the reference's on a clock under which no
#: read stalls (test_reference_forced_floor_follows_its_clock)
TGEN100_FLOOR1_WINDOWS = 920


def _run(main, cfg, data_dir, extra=(), policy="tpu_batch"):
    argv = [str(cfg), "--scheduler-policy", policy, "--data-directory",
            str(data_dir), "--json-summary", "--quiet", *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0, f"{main.__module__} {argv} exited {rc}"
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _stable(summary, volatile):
    return {k: v for k, v in summary.items() if k not in volatile}


def _assert_identical(ref, port, ref_dir, port_dir):
    """Same summary (but for wall-clock telemetry), output tree and state
    digest stream; bisect_divergence finds no divergence."""
    assert port["process_errors"] == [] == ref["process_errors"]
    assert _stable(port, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(port_dir) == ref_tree_digest(ref_dir)
    assert (port_dir / "state_digests.jsonl").read_text() == (
        ref_dir / "state_digests.jsonl").read_text()
    bis = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "bisect_divergence.py"),
         "--a", str(ref_dir), "--b", str(port_dir)],
        capture_output=True, text=True, timeout=120)
    assert bis.returncode == 0, bis.stdout + bis.stderr


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("floor", [1, 10**9])
@pytest.mark.parametrize("config, digest_every", [
    # echo runs 24 rounds: digest every 5 so its stream is not empty
    ("echo.yaml", 5), ("tgen_100host.yaml", 50)])
def test_identical_to_reference(tmp_path, config, digest_every, floor,
                                engine):
    extra = ["--set", f"experimental.tpu_device_floor={floor}",
             "--state-digest-every", str(digest_every)]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = _run(ref_cli.main, EX / config, ref_dir, extra + REF_PLANE)
    port = _run(port_cli.main, EX / config, port_dir,
                extra + ENGINES[engine] + ["--device", "cpu"])
    assert port["native_colcore"] is (engine == "c_engine")
    _assert_identical(ref, port, ref_dir, port_dir)
    if config == "tgen_100host.yaml":  # chip_smoke.py's trace phase
        cs = _chip_smoke()
        assert {k: ref[k] for k in COUNTS} == cs.TGEN100_COUNTS
        assert ref_tree_digest(ref_dir) == cs.TGEN100_TREE_DIGEST
    if floor == 1 and config == "tgen_100host.yaml":
        # the forced floor really sent windows through the device plane.
        # The port's count is a function of the run alone; the
        # reference's is wall-clock routing (a stalled read backs its
        # forced floor off, so under load it dispatches fewer windows),
        # held here to the reference's own invariant (windows > 0) and to
        # the port's count on a clock that never stalls, below
        assert (port["device"]["windows_dispatched"]
                == TGEN100_FLOOR1_WINDOWS)
        assert ref["device"]["windows_dispatched"] > 0


def _set_plane_clock(monkeypatch, colplane, step: float) -> None:
    """Give a columnar plane module a wall clock that advances ``step``
    seconds at every reading: at 0 no read stalls, at 0.03 every timed
    window read takes 30 ms, as on a loaded host."""
    ticks = itertools.count()
    monkeypatch.setattr(colplane, "_walltime", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * step))


def _set_port_clock(monkeypatch, step: float) -> None:
    """The port's phase clock (utils/spans.py, ns), which its columnar
    plane times window reads by, advancing ``step`` seconds at every
    reading, as _set_plane_clock does for a reference plane."""
    from shadow_tpu_torch.utils import spans

    ticks = itertools.count()
    monkeypatch.setattr(spans, "now",
                        lambda: next(ticks) * round(step * 1e9))


def _floor1_argv(engine=None):
    argv = ["--set", "experimental.tpu_device_floor=1",
            "--state-digest-every", "50"]
    if engine is None:
        return argv + REF_PLANE
    return argv + ENGINES[engine] + ["--device", "cpu"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_forced_floor_window_count_ignores_read_stalls(tmp_path,
                                                       monkeypatch, engine):
    """A forced tpu_device_floor holds however long the window reads
    take: with every read a 30 ms stall the port dispatches the same
    windows as with none, and gives the reference's results. (A floor
    that backed off after slow reads would dispatch fewer windows on a
    loaded host, and the identity test's count would vary with the
    load.)"""
    _set_port_clock(monkeypatch, 0.03)
    port = _run(port_cli.main, EX / "tgen_100host.yaml", tmp_path / "port",
                _floor1_argv(engine))
    assert port["native_colcore"] is (engine == "c_engine")
    assert port["device"]["windows_dispatched"] == TGEN100_FLOOR1_WINDOWS
    cs = _chip_smoke()
    assert {k: port[k] for k in COUNTS} == cs.TGEN100_COUNTS
    assert output_tree_digest(tmp_path / "port") == cs.TGEN100_TREE_DIGEST


@pytest.mark.parametrize("step", [0.0, 0.03])
def test_reference_forced_floor_follows_its_clock(tmp_path, monkeypatch,
                                                  step):
    """Why the identity test pins the port's window count instead of
    comparing it with the reference's: on a clock that never stalls the
    reference dispatches TGEN100_FLOOR1_WINDOWS at floor 1, but its forced
    floor backs off after slow reads, and then it dispatches fewer (its
    results stay the same: routing is wall-clock policy there)."""
    from shadow_tpu.network import colplane as ref_colplane

    _set_plane_clock(monkeypatch, ref_colplane, step)
    ref = _run(ref_cli.main, EX / "tgen_100host.yaml", tmp_path / "ref",
               _floor1_argv())
    n = ref["device"]["windows_dispatched"]
    if step:
        assert 0 < n < TGEN100_FLOOR1_WINDOWS
    else:
        assert n == TGEN100_FLOOR1_WINDOWS
    assert ({k: ref[k] for k in COUNTS}
            == _chip_smoke().TGEN100_COUNTS)


@pytest.mark.parametrize("config", ["echo.yaml", "tgen_100host.yaml",
                                    "tgen_1k.yaml"])
def test_show_config_matches_reference(config, capsys):
    argv = [str(EX / config), "--scheduler-policy", "tpu_batch",
            "--show-config"]
    assert ref_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_cli.main(argv) == 0
    assert json.loads(capsys.readouterr().out) == want


def test_echo_constant_in_chip_smoke_is_the_reference(tmp_path):
    s = _run(ref_cli.main, EX / "echo.yaml", tmp_path / "ref")
    assert s["process_errors"] == []
    assert ref_tree_digest(tmp_path / "ref") == _chip_smoke().ECHO_TREE_DIGEST


@pytest.mark.slow
def test_tgen_1k_identical_and_chip_smoke_constants(tmp_path):
    cs = _chip_smoke()
    extra = ["--set", "experimental.tpu_device_floor=1"]
    ref = _run(ref_cli.main, EX / "tgen_1k.yaml", tmp_path / "ref", extra)
    port = _run(port_cli.main, EX / "tgen_1k.yaml", tmp_path / "port",
                extra + ["--device", "cpu"])
    assert {k: ref[k] for k in COUNTS} == cs.TGEN1K_COUNTS
    assert ref_tree_digest(tmp_path / "ref") == cs.TGEN1K_TREE_DIGEST
    assert _stable(port, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(tmp_path / "port") == cs.TGEN1K_TREE_DIGEST


@pytest.mark.parametrize("floor", [None, 1])
def test_device_transport_tgen_100host_gives_pinned_results(tmp_path,
                                                            monkeypatch,
                                                            floor):
    """tgen streams too: with experimental.device_transport on (at the
    reference's device floor, and at 1 so that every cohort takes the
    device path, here the plain PyTorch version), tgen_100host gives the
    counts and tree pinned above, which the reference gives with the
    feature off. The C engine is off: under it the transport stands
    down."""
    from shadow_tpu_torch.network import devtransport

    if floor is not None:
        monkeypatch.setattr(devtransport, "_DEVICE_FLOOR", floor)
    cs = _chip_smoke()
    port = _run(port_cli.main, EX / "tgen_100host.yaml", tmp_path / "port",
                ["--device", "cpu", "--set",
                 "experimental.device_transport=true", *REF_PLANE])
    assert port["process_errors"] == []
    assert {k: port[k] for k in COUNTS} == cs.TGEN100_COUNTS
    assert output_tree_digest(tmp_path / "port") == cs.TGEN100_TREE_DIGEST
    s = port["device_transport"]
    assert port["device_transport_engaged"] and s["cohorts"] > 0
    if floor is None:
        assert s["device_cohorts"] == 0  # no cohort reaches 4096 rows


@pytest.mark.slow
def test_web_cdn_100k_identical_and_chip_smoke_constants(tmp_path):
    """web_cdn_100k (100k hosts, the reference's device-transport config)
    at 500 ms as chip_smoke.py's user leg runs it: the reference and the
    port give chip_smoke.py's counts, tree and last state digest."""
    cs = _chip_smoke()
    extra = ["--set", "experimental.native_colcore=false", "--set",
             "experimental.device_transport=true", "--stop-time", "500ms",
             "--state-digest-every", str(cs.WEB500_COUNTS["rounds"])]
    cfg = EX / "web_cdn_100k.yaml"
    ref = _run(ref_cli.main, cfg, tmp_path / "ref", extra)
    port = _run(port_cli.main, cfg, tmp_path / "port",
                extra + ["--device", "cpu"])
    assert {k: ref[k] for k in COUNTS} == cs.WEB500_COUNTS
    assert ref_tree_digest(tmp_path / "ref") == cs.WEB500_TREE_DIGEST
    assert cs.last_state_digest(tmp_path / "ref") == cs.WEB500_STATE_DIGEST
    assert _stable(port, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(tmp_path / "port") == cs.WEB500_TREE_DIGEST
    assert (tmp_path / "port" / "state_digests.jsonl").read_text() == (
        tmp_path / "ref" / "state_digests.jsonl").read_text()
    assert port["device_transport"]["cohorts"] > 0


@pytest.mark.slow
def test_tgen_1k_device_transport_gives_chip_smoke_constants(tmp_path,
                                                            monkeypatch):
    """chip_smoke.py's first transport leg: tgen_1k with the device
    transport on (the C engine off, so that it does not stand down) and
    every cohort on the device path gives the tpu_batch constants."""
    from shadow_tpu_torch.network import devtransport

    monkeypatch.setattr(devtransport, "_DEVICE_FLOOR", 1)
    cs = _chip_smoke()
    port = _run(port_cli.main, EX / "tgen_1k.yaml", tmp_path / "port",
                ["--device", "cpu", "--set",
                 "experimental.device_transport=true", *REF_PLANE])
    assert {k: port[k] for k in COUNTS} == cs.TGEN1K_COUNTS
    assert output_tree_digest(tmp_path / "port") == cs.TGEN1K_TREE_DIGEST
    assert port["device_transport"]["device_cohorts"] > 0


#: copies of the reference tests' configs: 48 sources flooding one sink
#: (tests/test_multichip.py INCAST: every exchange slice maximally
#: destination-skewed) and bulk transfers under loss (tests/test_colplane.py
#: TGEN_LOSSY)
INCAST = """
general:
  stop_time: 20s
  seed: 9
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "20 Mbit" host_bandwidth_down "20 Mbit" ]
        node [ id 1 host_bandwidth_up "20 Mbit" host_bandwidth_down "20 Mbit" ]
        edge [ source 0 target 1 latency "15 ms" packet_loss 0.01 ]
        edge [ source 0 target 0 latency "4 ms" packet_loss 0.004 ]
        edge [ source 1 target 1 latency "4 ms" ]
      ]
hosts:
  sink:
    network_node_id: 1
    processes:
      - path: pyapp:shadow_tpu.models.echo:EchoServer
        args: ["9000"]
  src:
    network_node_id: 0
    quantity: 48
    processes:
      - path: pyapp:shadow_tpu.models.echo:EchoClient
        args: ["sink", "9000", "15", "xxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxx"]
"""

TGEN_LOSSY = """
general:
  stop_time: 30s
  seed: 7
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "20 Mbit" host_bandwidth_down "20 Mbit" ]
        node [ id 1 host_bandwidth_up "10 Mbit" host_bandwidth_down "5 Mbit" ]
        edge [ source 0 target 1 latency "25 ms" packet_loss 0.02 ]
        edge [ source 0 target 0 latency "5 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "5 ms" ]
      ]
hosts:
  server:
    network_node_id: 0
    processes:
      - path: pyapp:shadow_tpu.models.tgen:TGenServer
        args: ["8080"]
  client:
    network_node_id: 1
    quantity: 4
    processes:
      - path: pyapp:shadow_tpu.models.tgen:TGenClient
        args: ["400 kB", "2", serial, "8080", server]
        start_time: 500 ms
"""

#: name -> (config file or inline YAML, state digest interval)
MESH_CONFIGS = {"echo": (EX / "echo.yaml", 5),
                "tgen_100host": (EX / "tgen_100host.yaml", 50),
                "incast": (INCAST, 50), "tgen_lossy": (TGEN_LOSSY, 50)}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("floor", [None, 0])
@pytest.mark.parametrize("config", sorted(MESH_CONFIGS))
def test_tpu_mesh_identical_to_reference(tmp_path, config, floor, engine):
    """scheduler_policy tpu_mesh through both packages: the reference runs
    its sharded programs over conftest's 8 CPU devices, the port its plain
    versions with every shard on the CPU. At floor 0 every causal window
    goes through the exchange, and both count the same windows."""
    cfg, digest_every = MESH_CONFIGS[config]
    if isinstance(cfg, str):
        path = tmp_path / f"{config}.yaml"
        path.write_text(cfg)
        cfg = path
    extra = ["--state-digest-every", str(digest_every)]
    if floor is not None:
        extra += ["--set", f"experimental.tpu_mesh_floor={floor}"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = _run(ref_cli.main, cfg, ref_dir, extra + REF_PLANE,
               policy="tpu_mesh")
    port = _run(port_cli.main, cfg, port_dir,
                extra + ENGINES[engine] + ["--device", "cpu"],
                policy="tpu_mesh")
    assert port["native_colcore"] is (engine == "c_engine")
    _assert_identical(ref, port, ref_dir, port_dir)
    windows = port["phase_wall"]["mesh_windows"]
    assert windows == ref["phase_wall"]["mesh_windows"]
    if floor == 0 and config != "echo":
        assert windows > 0 and port["units_dropped"] > 0
    if config == "tgen_100host":  # chip_smoke.py's mesh trace phase
        assert {k: ref[k] for k in COUNTS} == _chip_smoke().TGEN100_COUNTS


@pytest.mark.slow
@pytest.mark.parametrize("floor", [None, 0])
def test_tgen_1k_tpu_mesh_identical_and_chip_smoke_constants(tmp_path, floor):
    """chip_smoke.py's mesh path holds tgen_1k under tpu_mesh to the
    tpu_batch constants: the reference gives them at both floors too."""
    cs = _chip_smoke()
    extra = [] if floor is None else [
        "--set", f"experimental.tpu_mesh_floor={floor}"]
    ref = _run(ref_cli.main, EX / "tgen_1k.yaml", tmp_path / "ref", extra,
               policy="tpu_mesh")
    port = _run(port_cli.main, EX / "tgen_1k.yaml", tmp_path / "port",
                extra + ["--device", "cpu"], policy="tpu_mesh")
    assert {k: ref[k] for k in COUNTS} == cs.TGEN1K_COUNTS
    assert ref_tree_digest(tmp_path / "ref") == cs.TGEN1K_TREE_DIGEST
    assert _stable(port, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(tmp_path / "port") == cs.TGEN1K_TREE_DIGEST
    assert (port["phase_wall"]["mesh_windows"]
            == ref["phase_wall"]["mesh_windows"])
    if floor == 0:
        assert port["phase_wall"]["mesh_windows"] > 0


def _echo_doc():
    return yaml.safe_load((EX / "echo.yaml").read_text())


def _with(mutate):
    doc = _echo_doc()
    mutate(doc)
    return doc


REFUSALS = {
    # the live plane is ported: what it refuses by name is a socket path
    # past the AF_UNIX limit and a replay log that is not a command log
    "live": (["--scheduler-policy", "tpu_batch", "--device", "cpu",
              "--live-endpoint", "/tmp/" + "x" * 120 + "/live.sock"],
             None, "exceeds the AF_UNIX limit"),
    "replay": (["--scheduler-policy", "tpu_batch", "--device", "cpu",
                "--replay-commands", str(EX / "echo.yaml")], None,
               "bad command record"),
    "mesh_shards_over_devices": (["--scheduler-policy", "tpu_mesh",
                                  "--device", "cpu", "--set",
                                  "experimental.tpu_mesh_shards=2"], None,
                                 "tpu_mesh_shards=2 exceeds the 1 device "
                                 "entry of --device cpu"),
    "no_card": (["--scheduler-policy", "tpu_batch", "--device", "cuda"],
                None, "torch.cuda.is_available() is false"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unported_features_are_refused_by_name(tmp_path, capsys, case):
    extra, mutate, needle = REFUSALS[case]
    if case == "no_card":
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
    cfg = EX / "echo.yaml"
    if mutate is not None:
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text(yaml.safe_dump(_with(mutate)))
    rc = port_cli.main([str(cfg), "--data-directory", str(tmp_path / "d"),
                        "--quiet", *extra])
    err = capsys.readouterr().err
    assert rc == 2, err
    assert err.startswith("shadow_tpu_torch: ") and needle in err, err
    assert len(err.strip().splitlines()) == 1, err


def _abr_echo(d):
    """echo's two hosts as an ABR server and a 3-segment session."""
    d["hosts"]["server"]["processes"][0].update(
        path="pyapp:shadow_tpu.models.abr:AbrServer")
    d["hosts"]["client"]["processes"][0].update(
        path="pyapp:shadow_tpu.models.abr:AbrClient",
        args=["server", "9000", "3", "2000", "400000", "1000000"])


#: a one-second degrade of echo's one graph node, while the echoes run
_DEGRADE = {"events": [{"time": "2s", "kind": "link_degrade",
                        "src_nodes": [0], "dst_nodes": [0],
                        "latency_factor": 2.0, "duration": "1s"}]}
#: features the port once refused by name: each runs echo, mutated,
#: through both packages (extra argv, mutation of the document)
PORTED = {
    "faults_thread_per_core": ([], lambda d: d.update(faults=_DEGRADE)),
    "faults": (["--scheduler-policy", "tpu_batch"],
               lambda d: d.update(faults=_DEGRADE)),
    "telemetry": (["--scheduler-policy", "tpu_batch"],
                  lambda d: d.update(telemetry=None)),
    "sample_every": (["--scheduler-policy", "tpu_batch", "--sample-every",
                      "1s"], None),
    "pcap": (["--scheduler-policy", "tpu_batch"], lambda d: d["hosts"][
        "server"].update(pcap_enabled=True)),
    "abr": (["--scheduler-policy", "tpu_batch"], _abr_echo),
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_once_refused_features_identical_to_reference(tmp_path, case):
    """Fault injection (under a thread policy and tpu_batch), telemetry
    (the section and --sample-every), packet capture and the ABR model,
    once refused by name, run echo as the reference does:
    the same summary, tree (capture files included), state digests and
    telemetry streams."""
    extra, mutate = PORTED[case]
    cfg = EX / "echo.yaml"
    if mutate is not None:
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text(yaml.safe_dump(_with(mutate)))
    policy = extra[1] if extra else "thread_per_core"
    argv = [*extra[2:], "--state-digest-every", "5"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = _run(ref_cli.main, cfg, ref_dir, argv, policy=policy)
    port = _run(port_cli.main, cfg, port_dir, argv + ["--device", "cpu"],
                policy=policy)
    _assert_identical(ref, port, ref_dir, port_dir)
    for name in ("metrics.jsonl", "flows.jsonl"):
        assert (port_dir / name).exists() is (ref_dir / name).exists()
        if (ref_dir / name).exists():
            assert ((port_dir / name).read_bytes()
                    == (ref_dir / name).read_bytes())
    if case.startswith("faults"):
        assert port["fault_transitions_applied"] == 2
    elif case == "pcap":
        assert (port_dir / "hosts" / "server" / "server.pcap").stat(
            ).st_size > 24
    elif case == "abr":
        assert port["counters"]["abr_segments"] == 3
    else:
        # the collector ran: its meta record, and samples at 1 s
        assert (port_dir / "metrics.jsonl").exists()
        assert port["telemetry"]["samples"] > 0 or case == "telemetry"


#: echo with its server replaced as the port once refused by name: the
#: httpd model, and a real binary (/bin/true, a managed process)
ONCE_REFUSED_SERVERS = {
    "httpd": "pyapp:shadow_tpu.models.httpd:HttpServer",
    "managed": "/bin/true",
}


@pytest.mark.parametrize("case", sorted(ONCE_REFUSED_SERVERS))
def test_once_refused_servers_identical_to_reference(tmp_path, case):
    """The httpd model and managed processes, once refused by name, run
    echo with that server as the reference does: the echo client gets no
    reply from either, so both packages exit 1 with the same process
    error, tree and state digests."""
    from tests.test_torch_managed import _free_both_slots

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_with(lambda d: d["hosts"]["server"][
        "processes"][0].update(path=ONCE_REFUSED_SERVERS[case]))))
    out = {}
    try:
        for main, mine, argv in ((ref_cli.main, "ref", REF_PLANE),
                                 (port_cli.main, "port",
                                  ["--device", "cpu"])):
            # both packages pin the shim's fd 995 and refuse a held one
            _free_both_slots()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main([str(cfg), "--scheduler-policy", "tpu_batch",
                           "--data-directory", str(tmp_path / mine),
                           "--json-summary", "--quiet",
                           "--state-digest-every", "5", *argv])
            assert rc == 1
            out[mine] = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        _free_both_slots()
    ref, port = out["ref"], out["port"]
    assert port["process_errors"] == ref["process_errors"] == [
        "client/echoclient.0: expected exit 0, still running"]
    assert _stable(port, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(tmp_path / "port") == ref_tree_digest(
        tmp_path / "ref")
    assert (tmp_path / "port" / "state_digests.jsonl").read_text() == (
        tmp_path / "ref" / "state_digests.jsonl").read_text()


def test_fork_verb_is_refused(tmp_path, capsys):
    """The fork verb runs (forks.py); what it refuses by name is a trunk
    checkpoint of the reference package."""
    ref = tmp_path / "ref.ckpt"
    ref.write_text(json.dumps({"format": "shadow_tpu-checkpoint",
                               "version": 5}) + "\n")
    branches = tmp_path / "b.yaml"
    branches.write_text("branches:\n  - name: b\n")
    assert port_cli.main(["fork", "examples/echo.yaml", "--from", str(ref),
                          "--branches", str(branches), "--fork-dir",
                          str(tmp_path / "f"), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("fork: ") and "shadow_tpu-checkpoint" in err
