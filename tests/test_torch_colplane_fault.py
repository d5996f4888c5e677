"""The columnar plane's ``fault_filter`` against the reference.

``engine.fault_filter`` is the per-unit forced-drop hook the reference's
own tests set (no config does). On the columnar plane it sees a
``_RowView`` of each egress row of a filtered round, its verdicts ride the
batch in ``_Outstanding.forced`` (also through the mesh plane's lazy
batches) and join the loss flags wherever they are read; a filtered round
never takes the scalar barrier, and under the C engine it runs the Python
barrier. The reference's two cases run through both packages with the
same filter: tests/test_colplane.py's TGEN_LOSSY (the first 3
single-fragment DATA units dropped) and tests/test_colcore.py's
tgen_100host at 20 s (``dst == 3 and kind == 2``). The port runs on
``--device cpu`` under tpu_batch on both host engines at tpu_device_floor
1 and auto, and under tpu_mesh at tpu_mesh_floor 0 and its default; the
reference runs its Python plane. The counts, the hosts/ tree, the state
digest stream and the number of the filter's calls must be equal,
tolerance 0.
"""

import pytest
import yaml

from shadow_tpu.config import parse_config as ref_parse
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.core.controller import VOLATILE_SUMMARY_KEYS as REF_VOLATILE
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import VOLATILE_SUMMARY_KEYS, Controller
from shadow_tpu_torch.network import unit as U
from shadow_tpu_torch.network.colplane import _RowView
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_colplane import TGEN_LOSSY
from tests.test_torch_e2e import EX


class _DropFirstData:
    """tests/test_colplane.py's filter: drop the first ``n`` single-fragment
    DATA units with a payload; counts its calls."""

    def __init__(self, n=3):
        self.left = n
        self.calls = 0

    def __call__(self, u):
        self.calls += 1
        if (u.kind == U.DATA and u.nbytes > 0 and u.nfrags == 1
                and u.t_emit >= 0 and self.left > 0):
            self.left -= 1
            return True
        return False


class _DstKind:
    """tests/test_colcore.py's filter: every unit of ``kind`` to ``dst``."""

    def __init__(self, dst=3, kind=2):
        self.dst, self.kind = dst, kind
        self.calls = 0
        self.dropped = 0

    def __call__(self, u):
        self.calls += 1
        hit = u.dst == self.dst and u.kind == self.kind
        self.dropped += hit
        return hit


#: case -> (document or config path, overrides, filter factory, digests)
CASES = {
    "tgen_lossy": (TGEN_LOSSY, {}, _DropFirstData, 1),
    "tgen_100host_dst3": (EX / "tgen_100host.yaml",
                          {"general.stop_time": "20s"}, _DstKind, 50),
}
#: the port's legs: (policy, native_colcore, floor key and value)
LEGS = {
    "batch_c_floor1": ("tpu_batch", True, {"tpu_device_floor": 1}),
    "batch_c_auto": ("tpu_batch", True, {"tpu_device_floor": 0}),
    "batch_py_floor1": ("tpu_batch", False, {"tpu_device_floor": 1}),
    "batch_py_auto": ("tpu_batch", False, {"tpu_device_floor": 0}),
    "mesh_c_floor0": ("tpu_mesh", True, {"tpu_mesh_floor": 0}),
    "mesh_py_floor0": ("tpu_mesh", False, {"tpu_mesh_floor": 0}),
    # the default floor: the lazy mesh batches convert to host batches
    "mesh_c_default": ("tpu_mesh", True, {"tpu_mesh_floor": 2048}),
}
#: TGEN_LOSSY, seed 7, with the filter: the reference's counts
TGEN_LOSSY_FILTERED = {"rounds": 1081, "events": 874, "units_sent": 794,
                       "units_dropped": 72, "bytes_sent": 3301949}


def _doc(src):
    return yaml.safe_load(src if isinstance(src, str) else src.read_text())


def _overrides(case, leg, data_dir, colcore):
    src, over, _f, every = CASES[case]
    policy, _c, floor = LEGS[leg]
    o = {"experimental.scheduler_policy": policy,
         "experimental.native_colcore": colcore,
         "general.data_directory": str(data_dir),
         "general.state_digest_every": every, **over}
    o.update({f"experimental.{k}": v for k, v in floor.items()})
    return o


def run_ref(case, leg, data_dir):
    """The reference's Python plane under the leg's policy and floor."""
    src, _o, make, _e = CASES[case]
    cfg = ref_parse(_doc(src), _overrides(case, leg, data_dir, False))
    ctl = RefController(cfg, mirror_log=False)
    ctl.engine.fault_filter = f = make()
    return ctl.run(), f


def run_port(case, leg, data_dir, device="cpu"):
    """The port on ``device`` under the leg's policy, engine and floor;
    returns its summary, its filter and its plane."""
    src, _o, make, _e = CASES[case]
    cfg = parse_config(_doc(src),
                       _overrides(case, leg, data_dir, LEGS[leg][1]))
    ctl = Controller(cfg, mirror_log=False, device=device)
    ctl.engine.fault_filter = f = make()
    return ctl.run(), f, ctl.engine


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """One reference run a (case, policy): its result does not depend on
    the floor (the tests of the reference's planes hold that)."""
    cache = {}

    def get(case, leg):
        key = (case, LEGS[leg][0])
        if key not in cache:
            d = tmp_path_factory.mktemp(f"ref_{case}_{key[1]}")
            cache[key] = (*run_ref(case, leg, d), d)
        return cache[key]
    return get


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_filter_identical_to_reference(tmp_path, ref_runs, case, leg):
    ref, ref_f, ref_dir = ref_runs(case, leg)
    port, f, plane = run_port(case, leg, tmp_path)
    # (tgen_100host at 20 s stops its clients mid-transfer: both packages
    # name the same running processes)
    assert port["process_errors"] == ref["process_errors"]
    assert f.calls == ref_f.calls > 0
    stable = {k: v for k, v in port.items() if k not in VOLATILE_SUMMARY_KEYS}
    assert stable == {k: v for k, v in ref.items() if k not in REF_VOLATILE}
    assert output_tree_digest(tmp_path) == ref_tree_digest(ref_dir)
    assert (tmp_path / "state_digests.jsonl").read_text() == (
        ref_dir / "state_digests.jsonl").read_text()
    assert port["native_colcore"] is LEGS[leg][1]
    if case == "tgen_lossy":
        # the reproduction of the fault (seed 7): today's port without the
        # filter's drops gives rounds 1,041, events 772, units_sent 704
        assert f.left == 0
        assert {k: port[k] for k in TGEN_LOSSY_FILTERED} == \
            TGEN_LOSSY_FILTERED
    else:
        assert f.dropped > 0
    if leg.endswith("floor1"):
        assert port["device"]["windows_dispatched"] > 0
    if leg.startswith("mesh"):
        assert plane.mesh_plane is not None
        assert (port["phase_wall"]["mesh_windows"] > 0) is \
            leg.endswith("floor0")


def test_filtered_round_skips_the_scalar_barrier(tmp_path, monkeypatch):
    """A filtered round of at most SMALL_BARRIER units takes the vector
    barrier, where the filter sees each row (the reference's condition)."""
    from shadow_tpu_torch.network import colplane

    scalar = []
    orig = colplane.ColumnarPlane._barrier_scalar
    monkeypatch.setattr(colplane.ColumnarPlane, "_barrier_scalar",
                        lambda self, *a: scalar.append(1) or orig(self, *a))
    _s, f, _p = run_port("tgen_lossy", "batch_py_auto", tmp_path)
    assert f.calls > 0 and not scalar


def test_row_view_has_the_unit_surface():
    """_RowView reads each field the per-unit plane's Unit has from the
    egress row tuple."""
    row = (U.DATA, 5, 1400, 123, 80, 9000, 1300, 42, 0, 1, b"x")
    v = _RowView(row, 3, (3 << 32) | 7)
    assert (v.kind, v.dst, v.size, v.t_emit, v.src_port, v.dst_port,
            v.nbytes, v.seq, v.frag_idx, v.nfrags, v.payload) == row
    assert (v.src, v.uid) == (3, (3 << 32) | 7)


def test_chip_smoke_filter_constants_are_the_reference(ref_runs):
    """chip_smoke.py's fault-filter leg is this file's tgen_100host case:
    its FILTER_RESULTS are the reference's counts, tree, last state
    digest, process errors and the filter's calls and drops."""
    from tests.test_torch_e2e import _chip_smoke

    cs = _chip_smoke()
    ref, f, ref_dir = ref_runs("tgen_100host_dst3", "batch_py_floor1")
    assert cs.FILTER_OVERRIDES == CASES["tgen_100host_dst3"][1] | {
        "general.state_digest_every": CASES["tgen_100host_dst3"][3]}
    assert {k: ref[k] for k in cs.FILTER_RESULTS["counts"]} == \
        cs.FILTER_RESULTS["counts"]
    assert ref_tree_digest(ref_dir) == cs.FILTER_RESULTS["tree"]
    assert cs.last_state_digest(ref_dir) == cs.FILTER_RESULTS["state"]
    assert cs.errors_digest(ref["process_errors"]) == \
        cs.FILTER_RESULTS["errors"]
    assert (f.calls, f.dropped) == (cs.FILTER_RESULTS["calls"],
                                    cs.FILTER_RESULTS["dropped"])
