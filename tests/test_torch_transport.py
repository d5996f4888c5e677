"""The port's device transport (shadow_tpu_torch/network/devtransport.py,
ops/transport_kernels.py) against the reference's
(shadow_tpu/network/devtransport.py, ops/transport_kernels.py).

- The ack-advance arithmetic: the port's numpy host version and plain
  PyTorch version against the reference's numpy version and its jitted
  twin (``DeviceAckKernel.attach()`` on CPU-XLA), bit for bit over a seeded
  sweep (chip_smoke.ack_sweep) and the cube root's edges. The CUDA kernel
  is held against the plain version on the card by tests/test_torch_cuda.py
  (marker ``cuda``) and by chip_smoke.py.
- The endpoint column snapshot: after identical runs, the port's
  ``export_columns`` equals the reference's through
  ``convert.transport_columns_from_arrays``; ``adopt_columns`` refuses
  atomically.
- Whole runs of a small web/CDN config (a copy of tests/test_devtransport.py
  WEB_CFG) with the device transport on and off, at the reference's device
  floor and at 1 (every cohort through the device path, here the plain
  PyTorch version): the summary counts, the hosts/ tree and the per-round
  state digests equal the reference's. Tolerance 0 throughout: all the
  math is integer.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from shadow_tpu.config import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu.network import devtransport as ref_dt
from shadow_tpu.network.transport import _icbrt as ref_scalar_icbrt
from shadow_tpu.ops import transport_kernels as REF_TK
from shadow_tpu_torch import convert
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.network import devtransport as dt
from shadow_tpu_torch.ops import transport_kernels as TK
from shadow_tpu_torch.utils.digest import output_tree_digest

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("rounds", "events", "units_sent", "units_dropped", "bytes_sent")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _sweep(seed, n=3000):
    return CS.ack_sweep(np, np.random.default_rng(seed), n)


# -- (a) the kernel arithmetic --------------------------------------------------

def test_sweep_covers_every_branch():
    """The sweep reaches each branch the kernel selects between."""
    cols = _sweep(1)
    cc_id, cwnd, ssthresh, w_max, eps, snd_una, _ba, cum, now = cols
    ca = cwnd >= ssthresh
    cubic = ca & (cc_id == TK.CC_CUBIC)
    e = np.where(eps == 0, now, eps)
    wmax = np.where(eps == 0, cwnd, w_max)
    t_ms = (now - e) // TK.NS_PER_MS
    k_ms = TK.icbrt((np.minimum(wmax, 1 << 32) * 3 // (4 * TK.MSS))
                    * 1_000_000_000)
    d = t_ms - k_ms
    cwnd2 = TK.ack_advance(*cols)[2]
    assert (~ca).sum() and (ca & (cc_id == TK.CC_NEWRENO)).sum()
    for mask in (cubic & (eps == 0), cubic & (d < 0), cubic & (d > 0),
                 cubic & (now < e), cubic & (w_max > 1 << 32),
                 cubic & (cwnd2 > cwnd) & (cwnd2 - cwnd < 1000)):
        assert mask.sum() > 20
    newly = cum - snd_una
    assert newly.min() == 1 and newly.max() == 1 << 21


@pytest.mark.parametrize("seed", [3, 20261017])
def test_ack_advance_matches_reference_numpy_and_jax(seed):
    """Port numpy, port plain torch, reference numpy and the reference's
    jitted twin give the same five columns, bit for bit."""
    cols = _sweep(seed)
    want = REF_TK.ack_advance(*cols)
    devk = REF_TK.DeviceAckKernel.attach()
    assert devk is not None, "the reference's jax x64 twin did not attach"
    jax_out = devk.run(*cols[:8], now=cols[8])
    port_np = TK.ack_advance(*cols)
    port_torch = TK.ack_advance_torch(*(torch.from_numpy(c) for c in cols))
    for i, w in enumerate(want):
        assert np.array_equal(np.asarray(jax_out[i]), w), i
        assert port_np[i].dtype == np.int64
        assert np.array_equal(port_np[i], w), i
        assert np.array_equal(port_torch[i].numpy(), w), i


def test_cc_on_ack_matches_reference():
    cols = _sweep(5)
    cc_id, cwnd, ssthresh, w_max, eps, snd_una, _ba, cum, now = cols
    newly = cum - snd_una
    want = REF_TK.cc_on_ack(cc_id, cwnd, ssthresh, w_max, eps, newly, now)
    got_np = TK.cc_on_ack(cc_id, cwnd, ssthresh, w_max, eps, newly, now)
    got_t = TK.cc_on_ack_torch(*(torch.from_numpy(c) for c in (
        cc_id, cwnd, ssthresh, w_max, eps, newly, now)))
    for w, a, b in zip(want, got_np, got_t):
        assert np.array_equal(a, w) and np.array_equal(b.numpy(), w)


def test_icbrt_edges_and_random_match_reference():
    rng = np.random.default_rng(11)
    xs = np.concatenate([rng.integers(0, 1 << 60, 2000),
                         CS.ICBRT_EDGES]).astype(np.int64)
    want = REF_TK.icbrt(xs)
    assert np.array_equal(TK.icbrt(xs), want)
    assert np.array_equal(TK.icbrt_torch(torch.from_numpy(xs)).numpy(), want)
    for x in CS.ICBRT_EDGES:
        assert int(TK.icbrt(np.array([x], np.int64))[0]) == \
            ref_scalar_icbrt(x)


def test_rto_min_scan_matches_reference():
    dl = np.random.default_rng(2).integers(1, 1 << 60, 64).astype(np.int64)
    assert TK.rto_min_scan(dl) == REF_TK.rto_min_scan(dl)


def test_constants_match_reference():
    for k in ("NS_PER_MS", "MSS", "INIT_CWND", "MIN_CWND", "CC_NEWRENO",
              "CC_CUBIC", "_ICBRT_ITERS"):
        assert getattr(TK, k) == getattr(REF_TK, k), k
    for k in ("COLUMNS", "KEY_COLUMNS", "ADOPT_COLUMNS", "_MIN_STAGE",
              "_DEVICE_FLOOR", "_EMA_ALPHA", "_ENGAGE", "_RELEASE"):
        assert getattr(dt, k) == getattr(ref_dt, k), k


@pytest.mark.parametrize("n", [1, 17, 161, 4096])
def test_device_kernel_on_cpu_runs_the_plain_version(n):
    """DeviceAckKernel on the CPU: any row count (no buckets, no chunking),
    equal to the reference's numpy version, and no launch counted."""
    cols = tuple(c[:n] for c in _sweep(7, max(n, 16)))
    TK.reset_launches()
    got = TK.DeviceAckKernel.attach("cpu").run(*cols)
    assert TK.LAUNCHES["ack_advance"] == 0
    for g, w in zip(got, REF_TK.ack_advance(*cols)):
        assert g.shape == (n,) and np.array_equal(g, w)


def test_wrapper_refuses_bad_input():
    good = torch.zeros((9, 4), dtype=torch.int64)
    assert TK.ack_advance_device(good[:, :0].contiguous()).shape == (5, 0)
    with pytest.raises(TypeError, match="int64"):
        TK.ack_advance_device(good.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(9, n\)"):
        TK.ack_advance_device(good[:8])
    with pytest.raises(ValueError, match="contiguous"):
        TK.ack_advance_device(torch.zeros((4, 9), dtype=torch.int64).T)
    with pytest.raises(TypeError, match="torch.Tensor"):
        TK.ack_advance_device(np.zeros((9, 4), np.int64))


# -- runs of the web/CDN config ------------------------------------------------

#: a copy of tests/test_devtransport.py WEB_CFG (clients -> edges -> origin +
#: DNS chain, loss-free, so every ack is a clean cumulative advance). Its
#: telemetry section is left out: the port refuses it, and it changes no
#: host output.
WEB_CFG = """
general:
  stop_time: 16s
  seed: 23
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "200 Mbit" host_bandwidth_down "200 Mbit" ]
        node [ id 1 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        node [ id 2 host_bandwidth_up "50 Mbit" host_bandwidth_down "50 Mbit" ]
        edge [ source 0 target 1 latency "20 ms" ]
        edge [ source 0 target 2 latency "35 ms" ]
        edge [ source 1 target 2 latency "15 ms" ]
        edge [ source 0 target 0 latency "2 ms" ]
        edge [ source 1 target 1 latency "2 ms" ]
        edge [ source 2 target 2 latency "2 ms" ]
      ]
hosts:
  origin0:
    network_node_id: 0
    processes:
      - path: pyapp:shadow_tpu.models.web:WebOrigin
        args: ["80"]
  dnsroot:
    network_node_id: 0
    processes:
      - path: pyapp:shadow_tpu.models.dns:DnsAuth
        args: ["53"]
  dnsauth:
    network_node_id: 0
    processes:
      - path: pyapp:shadow_tpu.models.dns:DnsAuth
        args: ["53"]
  resolver0:
    network_node_id: 1
    processes:
      - path: pyapp:shadow_tpu.models.dns:DnsResolver
        args: ["53", dnsroot, dnsauth]
  edge0:
    network_node_id: 1
    processes:
      - path: pyapp:shadow_tpu.models.web:WebEdge
        args: ["80", origin0, "80", "60"]
  edge1:
    network_node_id: 2
    processes:
      - path: pyapp:shadow_tpu.models.web:WebEdge
        args: ["80", origin0, "80", "60"]
  c0_:
    network_node_id: 1
    quantity: 5
    processes:
      - path: pyapp:shadow_tpu.models.web:WebClient
        args: ["4", "3", "200 kB", "60 kB", "80", resolver0, edge0, edge1]
        start_time: 300 ms
        environment: {WEB_RETRIES: "2", WEB_THINK_SEC: "1"}
  c1_:
    network_node_id: 2
    quantity: 5
    processes:
      - path: pyapp:shadow_tpu.models.web:WebClient
        args: ["4", "3", "200 kB", "60 kB", "80", resolver0, edge0, edge1]
        start_time: 700 ms
        environment: {WEB_RETRIES: "2", WEB_THINK_SEC: "1"}
"""


def _overrides(data_dir, devt: bool, **extra) -> dict:
    ov = {"general.data_directory": str(data_dir),
          "general.state_digest_every": 50,
          "experimental.scheduler_policy": "tpu_batch",
          "experimental.native_colcore": False,
          "experimental.device_transport": devt}
    ov.update(extra)
    return ov


def _run_ref(data_dir, devt: bool, **extra):
    cfg = ref_parse_config(yaml.safe_load(WEB_CFG),
                           _overrides(data_dir, devt, **extra))
    ctl = RefController(cfg, mirror_log=False)
    return ctl, ctl.run()


def _port_controller(data_dir, devt: bool, **extra):
    cfg = parse_config(yaml.safe_load(WEB_CFG),
                       _overrides(data_dir, devt, **extra))
    ctl = Controller(cfg, mirror_log=False, device="cpu")
    if ctl.engine.devt is not None:
        # attached before round 0, so every cohort at or above the floor
        # takes the device path (routing is wall-clock policy only)
        ctl.engine.devt._bg.join()
    return ctl


def _assert_same_run(ref, port, ref_dir, port_dir):
    assert port["process_errors"] == [] == ref["process_errors"]
    assert {k: port[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    assert port["counters"] == ref["counters"]
    assert output_tree_digest(port_dir) == ref_tree_digest(ref_dir)
    assert (port_dir / "state_digests.jsonl").read_text() == (
        ref_dir / "state_digests.jsonl").read_text()


@pytest.mark.parametrize("floor", [4096, 1])
@pytest.mark.parametrize("devt", [False, True])
def test_web_identical_to_reference(tmp_path, monkeypatch, devt, floor):
    monkeypatch.setattr(ref_dt, "_DEVICE_FLOOR", floor)
    monkeypatch.setattr(dt, "_DEVICE_FLOOR", floor)
    _ref_ctl, ref = _run_ref(tmp_path / "ref", devt)
    ctl = _port_controller(tmp_path / "port", devt)
    port = ctl.run()
    _assert_same_run(ref, port, tmp_path / "ref", tmp_path / "port")
    assert any((tmp_path / "port" / "hosts").rglob("*.log"))
    if not devt:
        assert ctl.engine.devt is None
        assert "device_transport" not in port
        return
    assert port["device_transport_engaged"] is True
    s = port["device_transport"]
    assert s["cohorts"] > 0 and s["acks_batched"] > 0
    assert s["misguesses"] == 0
    assert port["phase_wall"]["transport_tick"] > 0
    # floor 1: every cohort went through the device path (the plain
    # PyTorch version on the CPU); at 4096 none is that large
    assert s["device_cohorts"] == (s["cohorts"] if floor == 1 else 0)


def test_wrong_kernel_guess_is_verified(tmp_path, monkeypatch):
    """The classifier is forced to stage every ack (dup acks, window
    updates, non-advances): replay verification sends every bad row to
    the scalar twin, so misguesses are counted and results are still the
    reference's."""
    monkeypatch.setattr(dt.DeviceTransport, "_stageable",
                        staticmethod(lambda ep, s, cum: True))
    monkeypatch.setattr(dt, "_DEVICE_FLOOR", 1)
    _c, ref = _run_ref(tmp_path / "ref", False)
    ctl = _port_controller(tmp_path / "port", True)
    port = ctl.run()
    _assert_same_run(ref, port, tmp_path / "ref", tmp_path / "port")
    s = port["device_transport"]
    assert s["cohorts"] > 0 and s["device_cohorts"] > 0
    assert s["misguesses"] > 0, "the forced mis-stage rejected no row"


def test_failed_attach_raises_on_the_simulation_thread(tmp_path,
                                                       monkeypatch):
    """No fallback: a kernel that fails to attach is an error on the
    simulation thread, not a run served by the host version."""
    def broken(device="cuda"):
        raise RuntimeError("nvcc failed (exit 1) building libtransport")

    monkeypatch.setattr(TK.DeviceAckKernel, "attach",
                        classmethod(lambda cls, device="cuda": broken()))
    ctl = _port_controller(tmp_path / "port", True)
    with pytest.raises(RuntimeError,
                       match="device transport attach failed: nvcc"):
        ctl.run()


# -- (b) the endpoint column snapshot ------------------------------------------

def _snapshots(tmp_path):
    stop = {"general.stop_time": "6s"}
    ref_ctl, _ = _run_ref(tmp_path / "ref", False, **stop)
    ctl = _port_controller(tmp_path / "port", False, **stop)
    ctl.run()
    return ref_ctl, ctl


def test_export_columns_match_reference(tmp_path):
    ref_ctl, ctl = _snapshots(tmp_path)
    ref_cols = ref_dt.export_columns(ref_ctl.hosts)
    assert len(ref_cols["hid"]) > 0, "no live endpoints at the snapshot"
    carried = convert.transport_columns_from_arrays(ref_cols)
    mine = dt.export_columns(ctl.hosts)
    assert list(mine) == list(carried) == list(ref_cols)
    back = convert.transport_columns_to_arrays(mine)
    for name in ref_cols:
        assert np.array_equal(mine[name], carried[name]), name
        assert back[name].dtype == np.int64
        assert np.array_equal(back[name], ref_cols[name]), name
    # the snapshot's endpoints are the kernel's inputs: one advance of each
    # by the same ack gives the same columns in both packages
    n = len(mine["hid"])
    rng = np.random.default_rng(4)
    cum = mine["snd_una"] + rng.integers(1, 1 << 16, n)
    now = np.full(n, 6 * 10 ** 9, np.int64)
    cols = tuple(mine[k] for k in TK.IN_COLUMNS[:7]) + (cum, now)
    want = REF_TK.ack_advance(*(tuple(ref_cols[k] for k in
                                      TK.IN_COLUMNS[:7]) + (cum, now)))
    got = TK.ack_advance_torch(*(torch.from_numpy(c) for c in cols))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_adopt_columns_round_trips_and_refuses_atomically(tmp_path):
    ref_ctl, ctl = _snapshots(tmp_path)
    cols = convert.transport_columns_from_arrays(
        ref_dt.export_columns(ref_ctl.hosts))
    n = len(cols["hid"])
    assert dt.adopt_columns(ctl.hosts, cols) == n
    after = dt.export_columns(ctl.hosts)
    for name in cols:
        assert np.array_equal(after[name], cols[name]), name
    # a genuine writeback lands
    mutated = {k: v.copy() for k, v in after.items()}
    mutated["cwnd"][0] = max(int(mutated["cwnd"][0]) // 2, TK.MIN_CWND)
    dt.adopt_columns(ctl.hosts, mutated)
    assert dt.export_columns(ctl.hosts)["cwnd"][0] == mutated["cwnd"][0]
    # a row naming no live endpoint refuses, and refusal is atomic: an
    # earlier row's sentinel value must not have landed
    bogus = {k: v.copy() for k, v in mutated.items()}
    bogus["cwnd"][0] = 123456789
    bogus["local_port"][-1] = 1
    with pytest.raises(ValueError, match="no live Python endpoint"):
        dt.adopt_columns(ctl.hosts, bogus)
    short = {k: v.copy() for k, v in mutated.items()}
    short["cwnd"] = short["cwnd"][:0]
    with pytest.raises(ValueError, match="missing or not length"):
        dt.adopt_columns(ctl.hosts, short)
    final = dt.export_columns(ctl.hosts)
    for name in final:
        assert np.array_equal(final[name], mutated[name]), name


@pytest.mark.parametrize("case", ["missing", "extra", "float", "ragged",
                                  "2d"])
def test_transport_columns_from_arrays_refuses(case):
    names = dt.KEY_COLUMNS + dt.COLUMNS
    d = {k: np.arange(3, dtype=np.int64) for k in names}
    if case == "missing":
        del d["cwnd"]
    elif case == "extra":
        d["bogus"] = np.zeros(3, np.int64)
    elif case == "float":
        d["cwnd"] = d["cwnd"].astype(np.float64)
    elif case == "ragged":
        d["cwnd"] = d["cwnd"][:2]
    else:
        d["cwnd"] = d["cwnd"].reshape(3, 1)
    with pytest.raises(ValueError, match="transport_columns_from_arrays"):
        convert.transport_columns_from_arrays(d)
