"""The port's C engine (shadow_tpu_torch/csrc/colcore.c, built by
shadow_tpu_torch/native) on the CPU.

- The copy equals the reference's native/colcore/colcore.c but for the
  named lines; drift in either file fails here.
- Its inline loss draw equals the port's numpy loss_flags.
- With the engine on (the default), the port gives the same summary, hosts/
  tree and state-digest stream as the port with it off and as the reference
  with ``native_colcore: false``, which needs no build of the reference's
  engine (tests/test_colcore.py pins the reference's two engines to each
  other).
- Speculative min_draw windows engage and change nothing.
- The device transport stands down under the engine, and a failed build
  raises instead of running the Python plane.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import yaml

from shadow_tpu import cli as ref_cli
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch import native
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.network.colplane import ColumnarPlane
from shadow_tpu_torch.network.fluid import loss_flags
from shadow_tpu_torch.ops import propagate as prop
from tests.test_torch_e2e import (
    EX, COUNTS, _assert_identical, _chip_smoke, _run, _stable)
from shadow_tpu_torch.core.controller import VOLATILE_SUMMARY_KEYS

ROOT = Path(__file__).resolve().parents[1]
REF_SRC = ROOT / "native" / "colcore" / "colcore.c"
#: the copy's only differences from the reference source: line number ->
#: (reference line, port line)
ALLOWED = {
    2370: ('  PyObject *mod = PyImport_ImportModule('
           '"shadow_tpu.network.colplane");',
           '  PyObject *mod = PyImport_ImportModule('
           '"shadow_tpu_torch.network.colplane");'),
}
ENGINE_OFF = ["--set", "experimental.native_colcore=false"]


def test_copy_differs_from_reference_only_on_named_lines():
    ref = REF_SRC.read_text().split("\n")
    port = native.SOURCE.read_text().split("\n")
    assert len(port) == len(ref)
    diff = {i + 1: (a, b) for i, (a, b) in enumerate(zip(ref, port))
            if a != b}
    assert diff == ALLOWED


def test_spec_min_npk_matches_the_engine():
    m = re.search(r"^#define SPEC_MIN_NPK (\d+)", native.SOURCE.read_text(),
                  re.M)
    assert int(m.group(1)) == ColumnarPlane.SPEC_MIN_NPK


def test_unit_dropped_matches_loss_flags():
    """The engine's inline threefry draw == fluid.loss_flags on 5,000
    seeded units (the reference's test_threefry_twin_exact)."""
    c = native.colcore()
    rng = np.random.default_rng(7)
    n = 5000
    uid = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    npk = rng.integers(1, 64, n).astype(np.uint32)
    th = rng.integers(0, 1 << 24, n).astype(np.uint32)
    th[rng.random(n) < 0.25] = 0
    seed = 0xDEADBEEF1234
    want = loss_flags(seed, (uid & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (uid >> np.uint64(32)).astype(np.uint32), npk, th)
    got = np.array([c.unit_dropped(seed, int(u), int(k), int(t))
                    for u, k, t in zip(uid, npk, th)])
    assert want.any() and (want == got).all()


#: (config, policy, extra flags, state digest interval)
CASES = {
    "echo-tpu_batch": ("echo.yaml", "tpu_batch", [], 5),
    "tgen_100host-tpu_batch": ("tgen_100host.yaml", "tpu_batch", [], 50),
    "tgen_100host-tpu_mesh-floor0": (
        "tgen_100host.yaml", "tpu_mesh",
        ["--set", "experimental.tpu_mesh_floor=0"], 50),
    "tgen_100host-tpu_mesh": ("tgen_100host.yaml", "tpu_mesh", [], 50),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_on_equals_engine_off_and_reference(tmp_path, case):
    cfg, policy, extra, every = CASES[case]
    extra = extra + ["--state-digest-every", str(every)]
    dirs = {k: tmp_path / k for k in ("ref", "on", "off")}
    ref = _run(ref_cli.main, EX / cfg, dirs["ref"], extra + ENGINE_OFF,
               policy=policy)
    on = _run(port_cli.main, EX / cfg, dirs["on"], extra + ["--device", "cpu"],
              policy=policy)
    off = _run(port_cli.main, EX / cfg, dirs["off"],
               extra + ENGINE_OFF + ["--device", "cpu"], policy=policy)
    assert on["native_colcore"] is True and off["native_colcore"] is False
    _assert_identical(ref, on, dirs["ref"], dirs["on"])
    _assert_identical(ref, off, dirs["ref"], dirs["off"])
    if "mesh" in case:
        assert (on["phase_wall"]["mesh_windows"]
                == off["phase_wall"]["mesh_windows"]
                == ref["phase_wall"]["mesh_windows"])
        if "floor0" in case:  # the C barrier's hand-off reached the plane
            assert on["phase_wall"]["mesh_windows"] > 0


def test_speculation_engages_and_changes_nothing(tmp_path, monkeypatch):
    """With the draw plane attached before round 0 (a second auto-floor
    run in one process finds it cached), the engine demands speculative
    prefix-min windows: min_draw's plain version serves them, the engine
    consults them, and the run equals the reference's."""
    monkeypatch.setattr(prop.DeviceDrawPlane, "_cache", {})
    seed = yaml.safe_load((EX / "tgen_100host.yaml").read_text())[
        "general"]["seed"]
    prop.DeviceDrawPlane.attach_cached(seed, 65536, 10, "cpu")
    calls = []
    orig = prop.DeviceDrawPlane.dispatch_min

    def counted(self, *a, **k):
        calls.append(len(a[0]))
        return orig(self, *a, **k)

    monkeypatch.setattr(prop.DeviceDrawPlane, "dispatch_min", counted)
    extra = ["--state-digest-every", "50"]
    ref = _run(ref_cli.main, EX / "tgen_100host.yaml", tmp_path / "ref",
               extra + ENGINE_OFF)
    port = _run(port_cli.main, EX / "tgen_100host.yaml", tmp_path / "port",
                extra + ["--device", "cpu"])
    assert len(calls) > 0  # waves, never a fixed count: wall-clock policy
    assert port["device"]["spec_hits"] > 0
    _assert_identical(ref, port, tmp_path / "ref", tmp_path / "port")
    cs = _chip_smoke()
    assert {k: port[k] for k in COUNTS} == cs.TGEN100_COUNTS


def _echo_controller(tmp_path, **ov):
    doc = yaml.safe_load((EX / "echo.yaml").read_text())
    over = {"general.data_directory": str(tmp_path / "d"),
            "experimental.scheduler_policy": "tpu_batch"}
    over.update(ov)
    return Controller(parse_config(doc, over), mirror_log=False,
                      device="cpu")


def test_device_transport_stands_down_under_the_engine(tmp_path):
    ctl = _echo_controller(tmp_path, **{
        "experimental.device_transport": True})
    assert ctl.engine._c is not None and ctl.engine.devt is None
    assert all(h.devt is None for h in ctl.hosts)
    assert ctl.engine.attach_devtransport(ctl.cfg.experimental, "cpu") is None
    summary = ctl.run()
    assert summary["native_colcore"] is True
    assert "device_transport" not in summary
    assert "device_transport_engaged" not in summary
    assert ctl.engine._c is None  # dropped at teardown


def test_engine_is_not_attached_off_fifo_or_when_disabled(tmp_path):
    off = _echo_controller(tmp_path, **{"experimental.native_colcore": False})
    assert off.engine._c is None and off._c_core is None
    rr = _echo_controller(tmp_path, **{
        "experimental.interface_qdisc": "round_robin"})
    assert rr.engine._c is None
    s = rr.run()
    assert s["native_colcore"] is False and s["process_errors"] == []


def test_failed_build_raises_at_controller_construction(tmp_path,
                                                        monkeypatch):
    """A broken engine source: Controller construction raises with the
    compiler's output and the way out, and nothing runs."""
    bad = tmp_path / "colcore.c"
    bad.write_text("#include <Python.h>\nthis is not C;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_mod", None)
    with pytest.raises(RuntimeError) as err:
        _echo_controller(tmp_path)
    msg = str(err.value)
    assert "building the C engine failed" in msg and "error" in msg
    assert "this is not C" in msg  # the compiler's own diagnostic
    assert "experimental.native_colcore: false" in msg
    assert not (tmp_path / "d").exists()
    assert not any((tmp_path / "build").glob("*.so"))


def test_summary_stable_keys_ignore_the_engine(tmp_path):
    """native_colcore is wall-clock telemetry: listed as volatile, so the
    identity gates above compare everything else."""
    assert "native_colcore" in VOLATILE_SUMMARY_KEYS
    on = _run(port_cli.main, EX / "echo.yaml", tmp_path / "on",
              ["--device", "cpu"])
    off = _run(port_cli.main, EX / "echo.yaml", tmp_path / "off",
               ENGINE_OFF + ["--device", "cpu"])
    assert _stable(on, VOLATILE_SUMMARY_KEYS) == _stable(
        off, VOLATILE_SUMMARY_KEYS)
