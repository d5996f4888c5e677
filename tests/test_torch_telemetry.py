"""Telemetry, packet capture and the ABR model in the port against the
reference.

The reference's telemetry documents (tests/test_telemetry.py: TGEN, a
lossy tgen run sampled every 2 s; GOSSIP_CHURN, gossip under a partition
and host churn; the Tor fetches of tests/test_tor.py's TOR_CFG; DEGRADE_DOC
with and without its degrade window) run once through the reference and
through the port on ``--device cpu`` under every scheduler policy, on both
host engines where the policy runs the columnar plane, and at
tpu_device_floor 1. The tolerance is zero: metrics.jsonl and flows.jsonl
byte for byte, the summary's telemetry block, the hosts/ tree and the
state digest stream. The histogram is held to the reference's on seeded
values, the collector's state carries across through
``convert.telemetry_state_from_arrays``, and echo's .pcap files and a 12 s
cut of abr_1k (which spans its first degrade) are the reference's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from shadow_tpu.config import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.telemetry import TelemetryCollector as RefCollector
from shadow_tpu.telemetry import histogram as ref_hist
from shadow_tpu_torch import convert
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.telemetry import (FLOWS_FILE, METRICS_FILE,
                                        TelemetryCollector)
from shadow_tpu_torch.telemetry import histogram as port_hist
from tests.test_telemetry import DEGRADE_DOC, DEGRADE_FAULT, GOSSIP_CHURN, TGEN
from tests.test_tor import TOR_CFG
from tests.test_torch_e2e import EX, _assert_identical
from tests.test_torch_faults import FAULT_LEGS

DIGEST_EVERY = 50


def _tor_doc():
    doc = yaml.safe_load(TOR_CFG)
    doc["telemetry"] = {"sample_every": "5s"}
    return doc


def _degrade_doc(faults: bool):
    doc = yaml.safe_load(DEGRADE_DOC)
    if faults:
        doc["faults"] = yaml.safe_load(DEGRADE_FAULT)
    return doc


DOCS = {"tgen": lambda: yaml.safe_load(TGEN),
        "gossip_churn": lambda: yaml.safe_load(GOSSIP_CHURN),
        "tor": _tor_doc,
        "degrade": lambda: _degrade_doc(True),
        "degrade_nofault": lambda: _degrade_doc(False)}
#: document -> the port's legs it runs: every leg for the two documents
#: of the reference's cross-plane gate, the reference's own legs for the
#: others (the thread policy baseline and tpu_batch on both engines)
DOC_LEGS = {"tgen": sorted(FAULT_LEGS), "gossip_churn": sorted(FAULT_LEGS),
            "tor": ["thread_per_core", "tpu_batch_c_engine",
                    "tpu_batch_python_plane"],
            "degrade": ["thread_per_core", "tpu_batch_c_engine"],
            "degrade_nofault": ["tpu_batch_c_engine"]}
CASES = [(doc, leg) for doc in sorted(DOC_LEGS) for leg in DOC_LEGS[doc]]


def _run(parse, ctl_cls, doc, data_dir, overrides=(), **kw):
    cfg = parse(doc, {"general.data_directory": str(data_dir),
                      "general.state_digest_every": DIGEST_EVERY,
                      **dict(overrides)})
    ctl = ctl_cls(cfg, mirror_log=False, **kw)
    return ctl, ctl.run()


def _streams(d: Path) -> tuple:
    return (d / METRICS_FILE).read_bytes(), (d / FLOWS_FILE).read_bytes()


def _records(data: bytes) -> list:
    return [json.loads(ln) for ln in data.decode().splitlines()]


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's run of each document (its default policy,
    thread_per_core), once for all legs."""
    out = {}
    for name, make in DOCS.items():
        d = tmp_path_factory.mktemp(f"ref_{name}")
        out[name] = (_run(ref_parse_config, RefController, make(), d)[1], d)
    return out


@pytest.mark.parametrize("doc, leg", CASES)
def test_streams_identical_to_reference(tmp_path, ref_runs, doc, leg):
    policy, c_engine, extra = FAULT_LEGS[leg]
    _, port = _run(parse_config, Controller, DOCS[doc](), tmp_path, {
        "experimental.scheduler_policy": policy,
        "experimental.native_colcore": c_engine, **extra}, device="cpu")
    ref, ref_dir = ref_runs[doc]
    _assert_identical(ref, port, ref_dir, tmp_path)
    assert port["telemetry"] == ref["telemetry"]
    assert port["phase_wall"]["telemetry"] >= 0
    metrics, flows = _streams(tmp_path)
    assert (metrics, flows) == _streams(ref_dir)
    recs = _records(metrics)
    assert recs[0]["kind"] == "meta"
    assert sum(r["kind"] == "sample" for r in recs) == \
        port["telemetry"]["samples"]
    assert len(_records(flows)) == port["telemetry"]["flows_recorded"] > 0
    if doc == "gossip_churn":
        actions = {r["action"] for r in recs if r["kind"] == "fault"}
        assert {"link_down", "host_down"} <= actions


def test_degrade_window_visible_in_series_and_p99(tmp_path):
    """The reference's fault-visibility property, on the port's own run:
    the degrade window is annotated, retransmit pressure shows in the
    per-host series only inside it, and the flow p99 is worse than the
    loss-free twin's (both runs are the reference's byte for byte, above)."""
    outs = {}
    for name in ("degrade", "degrade_nofault"):
        d = tmp_path / name
        _, s = _run(parse_config, Controller, DOCS[name](), d,
                    device="cpu")
        outs[name] = (s, _records(_streams(d)[0]))
    faults = [r for r in outs["degrade"][1] if r["kind"] == "fault"]
    assert [f["action"] for f in faults] == ["link_degrade", "degrade_end"]
    t0, t1 = faults[0]["t"], faults[1]["t"]

    def retx(recs, lo, hi):
        return max((max(r["hosts"]["retx"]) for r in recs
                    if r["kind"] == "sample" and lo <= r["t"] < hi),
                   default=0)

    assert retx(outs["degrade"][1], t0, t1) > 0
    assert retx(outs["degrade"][1], 0, t0) == 0
    assert retx(outs["degrade_nofault"][1], 0, 1 << 62) == 0
    p_f = outs["degrade"][0]["telemetry"]["flows"]["tgen_fetch"]
    p_n = outs["degrade_nofault"][0]["telemetry"]["flows"]["tgen_fetch"]
    assert p_f["p99_ms"] > p_n["p99_ms"]


def test_cli_override_into_bare_telemetry_section(tmp_path):
    """A bare ``telemetry:`` key plus a --sample-every style override
    composes into the same options as in the reference."""
    import dataclasses

    doc = yaml.safe_load(TGEN)
    doc["telemetry"] = None
    over = {"telemetry.sample_every": "3s",
            "general.data_directory": str(tmp_path)}
    port = parse_config(doc, over).telemetry
    assert port.sample_every == 3_000_000_000
    assert dataclasses.asdict(port) == dataclasses.asdict(
        ref_parse_config(doc, over).telemetry)


def test_cli_sample_every_and_metrics_dir(tmp_path):
    """``--sample-every`` and ``--metrics-dir`` on a config without a
    telemetry: section enable the collector, as in the reference, and the
    streams land in the metrics directory."""
    import contextlib
    import io

    from shadow_tpu import cli as ref_cli
    from shadow_tpu_torch import cli as port_cli

    cfg = tmp_path / "tgen.yaml"
    doc = yaml.safe_load(TGEN)
    del doc["telemetry"]
    cfg.write_text(yaml.safe_dump(doc))
    out = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(cfg), "--data-directory", str(tmp_path / name),
                         "--sample-every", "1s", "--metrics-dir",
                         str(tmp_path / f"m_{name}"), "--json-summary",
                         "--quiet", *extra]) == 0
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert not (tmp_path / name / METRICS_FILE).exists()
    assert out["port"]["telemetry"] == out["ref"]["telemetry"]
    assert out["port"]["telemetry"]["samples"] > 0
    assert _streams(tmp_path / "m_port") == _streams(tmp_path / "m_ref")


def test_telemetry_off_writes_nothing(tmp_path):
    doc = yaml.safe_load(TGEN)
    del doc["telemetry"]
    ctl, res = _run(parse_config, Controller, doc, tmp_path, device="cpu")
    assert ctl.telemetry is None
    assert all(h.telemetry is None for h in ctl.hosts)
    assert "telemetry" not in res and "telemetry" not in res["phase_wall"]
    assert not (tmp_path / METRICS_FILE).exists()
    assert not (tmp_path / FLOWS_FILE).exists()


#: seeded values across the exact buckets, the octave edges and the
#: int64 range (negative values clamp to 0)
_RNG = np.random.default_rng(2024)
HIST_VALUES = sorted(set(
    list(range(-3, 200)) + [(1 << e) + d for e in range(6, 63)
                            for d in (-1, 0, 1)]
    + [int(v) for v in _RNG.integers(0, 1 << 62, 400)]
    + [int(v) for v in _RNG.integers(0, 10**10, 400)]))


def test_histogram_equals_reference():
    for v in HIST_VALUES:
        if v >= 0:
            i = port_hist.bucket_index(v)
            assert i == ref_hist.bucket_index(v), v
            assert (port_hist.bucket_lower_bound(i)
                    == ref_hist.bucket_lower_bound(i))
    a, b = ref_hist.LogHistogram(), port_hist.LogHistogram()
    for v in HIST_VALUES:
        a.add(v)
        b.add(v)
    assert b.state() == a.state()
    assert b.quantiles_ns_to_ms() == a.quantiles_ns_to_ms()
    for num, den in ((1, 1000), (50, 100), (99, 100), (999, 1000),
                     (1, 1)):
        assert b.percentile(num, den) == a.percentile(num, den)
    st = [a.state(), b.state(), port_hist.LogHistogram().state()]
    assert (port_hist.LogHistogram.merged(st).state()
            == ref_hist.LogHistogram.merged(st).state())
    assert port_hist.LogHistogram.from_state(a.state()).state() == a.state()


def _tel_cfg(tmp_path):
    return parse_config(yaml.safe_load(TGEN),
                        {"general.data_directory": str(tmp_path)}).telemetry


def test_telemetry_state_round_trip(tmp_path):
    """A whole run's collector state (the reference's, on the TGEN
    document: its histograms and counts) carried into a port collector
    through convert.telemetry_state_from_arrays: the same export, the
    same summary, and numpy integers accepted as Python ones."""
    ref_ctl, run = _run(ref_parse_config, RefController,
                        yaml.safe_load(TGEN), tmp_path / "ref")
    ref_col = ref_ctl.telemetry
    exported = ref_col.export_merge_state()
    assert exported["hist"] and ref_col.summary() == run["telemetry"]
    col = TelemetryCollector(_tel_cfg(tmp_path))
    col.adopt_merge_state(convert.telemetry_state_from_arrays(exported))
    assert col.export_merge_state() == exported
    assert col.summary() == run["telemetry"]
    assert col.export_state_json() == ref_col.export_state_json()
    as_np = json.loads(json.dumps(exported))
    as_np["samples"] = np.int64(as_np["samples"])
    as_np["next_sample"] = np.int32(7)
    for st in as_np["hist"].values():
        st["counts"] = {int(k): np.int64(v) for k, v in st["counts"].items()}
    col2 = TelemetryCollector(_tel_cfg(tmp_path))
    col2.adopt_merge_state(convert.telemetry_state_from_arrays(as_np))
    assert col2.export_merge_state() == exported and col2.next_sample == 7


@pytest.mark.parametrize("bad, needle", [
    ({"samples": 1, "flows_written": 0, "hist": {}}, "missing fields"),
    ({"samples": 1.5, "flows_written": 0, "hist": {}, "flow_counts": {}},
     "must be an integer"),
    ({"samples": 1, "flows_written": 0, "flow_counts": {},
      "hist": {"k": {"total": 3, "counts": {"1": 1}}}}, "not the sum"),
    ({"samples": 1, "flows_written": 0, "hist": {},
      "flow_counts": {"k": {"ok": 1}}}, "must hold ok and failed"),
    ({"samples": 1, "flows_written": 0, "hist": {}, "flow_counts": {},
      "wall": 0}, "unknown fields")])
def test_telemetry_state_from_arrays_refuses(bad, needle):
    with pytest.raises(ValueError, match=needle):
        convert.telemetry_state_from_arrays(bad)


def test_seeded_collectors_write_the_same_lines(ref_runs, tmp_path):
    """Two collectors seeded with the same state (the reference's, and the
    port's through convert) and fed the same flow closes and faults write
    the same flows.jsonl and fault records and reduce to the same
    summary."""
    import types

    from shadow_tpu.faults import FaultAction as RefAction
    from shadow_tpu_torch.faults import FaultAction

    cols = {}
    for name, col_cls, act_cls, parse in (
            ("ref", RefCollector, RefAction, ref_parse_config),
            ("port", TelemetryCollector, FaultAction, parse_config)):
        d = tmp_path / name
        d.mkdir()
        col = col_cls(parse(yaml.safe_load(TGEN), {}).telemetry)
        col.metrics_dir = str(d)
        seed = {"samples": 4, "flows_written": 2, "flow_counts": {
            "tgen_fetch": {"ok": 2, "failed": 0}}, "hist": {
            "tgen_fetch": {"total": 2, "counts": {"100": 1, "4000": 1}}}}
        if name == "ref":
            col.samples, col.flows_written = 4, 2
            col.flow_counts = json.loads(json.dumps(seed["flow_counts"]))
            col.hist = {k: ref_hist.LogHistogram.from_state(v)
                        for k, v in seed["hist"].items()}
        else:
            col.adopt_merge_state(convert.telemetry_state_from_arrays(seed))
        ctl = types.SimpleNamespace(data_dir=d, rounds=9)
        hosts = []
        for hid, name_ in ((3, "b"), (1, "a")):
            h = types.SimpleNamespace(id=hid, name=name_, _flow_buf=[
                ("tgen_fetch", "server", 10, 5000, 7, 300, "ok", 1, None),
                ("abr.segment", "video0", 20, 9000, None, 0, "timeout", 0,
                 400000)])
            hosts.append(h)
            col.note_flow_host(h)
        col.record_fault(100, 9, act_cls(
            t=90, kind="link_degrade", src=np.array([0]), dst=np.array([1]),
            latency_factor=2.0, loss_add=0.1))
        col.on_round_end(ctl, 1)
        col.finalize(ctl)
        cols[name] = (col, d)
    (a, da), (b, db) = cols["ref"], cols["port"]
    assert (db / FLOWS_FILE).read_bytes() == (da / FLOWS_FILE).read_bytes()
    assert (db / METRICS_FILE).read_bytes() == (da / METRICS_FILE).read_bytes()
    assert b.summary() == a.summary()
    assert b.export_merge_state() == a.export_merge_state()


def test_metrics_report_reads_the_port_streams(tmp_path):
    """tools/metrics_report.py builds its report from the port's streams
    (which are the reference's byte for byte)."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import metrics_report

    _run(parse_config, Controller, DOCS["gossip_churn"](), tmp_path,
         device="cpu")
    d = tmp_path
    rep = metrics_report.build_report(d / METRICS_FILE, d / FLOWS_FILE)
    assert rep["samples"] > 0 and rep["flows"] > 0
    assert rep["fault_transitions"] > 0 and rep["fault_windows"]


# -- packet capture and the ABR model ---------------------------------------

@pytest.mark.parametrize("leg", ["thread_per_core", "tpu_batch_c_engine",
                                 "tpu_batch_python_plane"])
def test_echo_pcap_identical_to_reference(tmp_path, leg):
    """echo with capture on both hosts: the same .pcap bytes in both
    packages, under the per-unit plane, the C engine (a capturing host's
    dispatch stays on the Python path) and the Python columnar plane."""
    from shadow_tpu.utils.pcap import read_packet_count
    from shadow_tpu_torch.utils.pcap import read_packet_count as port_count

    policy, c_engine, _ = FAULT_LEGS[leg]
    doc = yaml.safe_load((EX / "echo.yaml").read_text())
    for h in doc["hosts"].values():
        h["pcap_enabled"] = True
    every = {"general.state_digest_every": 5}  # echo runs 24 rounds
    ref_dir = tmp_path / "ref"
    _, ref = _run(ref_parse_config, RefController, doc, ref_dir, every)
    _, port = _run(parse_config, Controller, doc, tmp_path / "port", {
        **every, "experimental.scheduler_policy": policy,
        "experimental.native_colcore": c_engine}, device="cpu")
    _assert_identical(ref, port, ref_dir, tmp_path / "port")
    for name in ("client", "server"):
        rel = Path("hosts") / name / f"{name}.pcap"
        data = (tmp_path / "port" / rel).read_bytes()
        assert data == (ref_dir / rel).read_bytes()
        n = port_count(tmp_path / "port" / rel)
        assert n == read_packet_count(ref_dir / rel) == 10


@pytest.mark.parametrize("engine", ["c_engine", "python_plane"])
def test_abr_1k_cut_identical_to_reference(tmp_path, engine):
    """abr_1k (1,000 hosts: the ABR model under two link_degrade windows,
    sampled every 10 s) cut to 12 s, which spans the first degrade, under
    tpu_batch on both host engines."""
    import contextlib
    import io

    from shadow_tpu import cli as ref_cli
    from shadow_tpu_torch import cli as port_cli

    argv = ["--scheduler-policy", "tpu_batch", "--stop-time", "12s",
            "--state-digest-every", "500", "--json-summary", "--quiet",
            "--set", "experimental.native_colcore=false"]
    out = {}
    for name, main, extra in (
            ("ref", ref_cli.main, []),
            ("port", port_cli.main, ["--device", "cpu"] + (
                ["--set", "experimental.native_colcore=true"]
                if engine == "c_engine" else []))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([str(EX / "abr_1k.yaml"), "--data-directory",
                  str(tmp_path / name), *argv, *extra])
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    ref, port = out["ref"], out["port"]
    assert port["native_colcore"] is (engine == "c_engine")
    _assert_identical(ref, port, tmp_path / "ref", tmp_path / "port")
    assert _streams(tmp_path / "port") == _streams(tmp_path / "ref")
    assert port["fault_transitions_applied"] == 1
    flows = port["telemetry"]["flows"]
    assert flows["abr.segment"]["count"] > 1000
    assert flows["abr.segment"]["x_mean"] > 0
