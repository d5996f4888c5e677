"""The span recorder (shadow_tpu_torch/utils/spans.py) on the path of
tpu_batch at device floor 1 under the C engine, on ``--device cpu``.

examples/tgen_100host.yaml, cut to 4 simulated seconds, runs once with
spans recorded, and once without under the benchmark's draw recorder
(portbench/record.py), which counts the windows resolved on the host at
``colplane.loss_flags`` (and hands the plane handles of its own, whose
reads the spans cannot split into wait and copy). Recording changes no
result; each
phase_wall key is the sum of its records; the records nest; with
recording off none are kept; the plane's host-window count is the
recorder's; the window phases are counted once.
"""

import pickle

import numpy as np
import pytest

from portbench.record import Recorder
from shadow_tpu_torch.config import load_config
from shadow_tpu_torch.core.controller import (VOLATILE_SUMMARY_KEYS,
                                              Controller)
from shadow_tpu_torch.utils import spans as S
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_torch_e2e import EX

SEED = 7


def _stable(summary):
    return {k: v for k, v in summary.items()
            if k not in VOLATILE_SUMMARY_KEYS}


def _simulate(out, record, overrides=()):
    cfg = load_config(str(EX / "tgen_100host.yaml"), {
        "general.stop_time": "4s", "general.seed": SEED,
        "general.data_directory": str(out),
        "experimental.scheduler_policy": "tpu_batch",
        "experimental.tpu_device_floor": 1, **dict(overrides)})
    sim = None
    if record:
        ctl = Controller(cfg, mirror_log=False, device="cpu",
                         record_spans=True)
        summary = ctl.run()
    else:
        with Recorder(out / "draws") as rec:
            sim = rec.begin(SEED, 0, recorded=False)
            ctl = Controller(cfg, mirror_log=False, device="cpu")
            summary = ctl.run()
    return {"ctl": ctl, "summary": summary, "sim": sim,
            "records": ctl.spans.take(), "dir": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("spans")
    return {"on": _simulate(base / "on", True),
            "off": _simulate(base / "off", False),
            "per_unit": _simulate(base / "per_unit", False, {
                "experimental.scheduler_policy": "thread_per_core"})}


def test_recording_changes_no_result(runs):
    on, off = runs["on"], runs["off"]
    assert _stable(on["summary"]) == _stable(off["summary"])
    assert output_tree_digest(on["dir"]) == output_tree_digest(off["dir"])
    assert (on["summary"]["device_windows_dispatched"]
            == off["summary"]["device_windows_dispatched"] > 0)


@pytest.mark.parametrize("key", sorted(S.PHASE_NAMES))
def test_phase_total_is_the_sum_of_its_records(runs, key):
    """phase_wall[key] and its span names' records come from the same
    clock reads: equal within 1 us a record."""
    rec = runs["on"]["records"]
    totals = runs["on"]["ctl"].spans.totals
    names = S.PHASE_NAMES[key]
    n = int(np.isin(rec["name"], [S.NAMES.index(x) for x in names]).sum())
    if key not in totals:  # a phase this run never entered
        assert n == 0
        return
    assert abs(totals[key] - S.total_s(rec, *names)) <= 1e-6 * max(n, 1)


def test_records_nest(runs):
    """Every child lies inside its parent, no self time is negative, and
    the roots are the controller's construct and run."""
    rec = runs["on"]["records"]
    parent, start, end = rec["parent"], rec["start"], rec["end"]
    assert (end >= start).all()
    kids = np.flatnonzero(parent >= 0)
    assert (parent[kids] < kids).all()
    assert (start[kids] >= start[parent[kids]]).all()
    assert (end[kids] <= end[parent[kids]]).all()
    assert (S.self_ns(rec) >= 0).all()
    roots = [S.NAMES[i] for i in rec["name"][parent < 0]]
    assert roots == ["construct", "run"]
    summary = runs["on"]["summary"]
    loop = int(np.flatnonzero(rec["name"] == S.LOOP)[0])
    assert abs((end[loop] - start[loop]) / 1e9
               - summary["wall_seconds"]) < 1e-9
    by_parent = {S.NAMES[rec["name"][i]] for i in kids
                 if parent[i] == loop}
    assert {"round.start", "events", "round.end", "gc"} <= by_parent


def test_recording_off_keeps_no_records(runs):
    spans = runs["off"]["ctl"].spans
    assert not spans.on and runs["off"]["records"] is None
    assert all(getattr(spans, c) is None
               for c in ("name", "parent", "start", "end", "window"))
    assert spans.nbytes() == 0
    # a checkpoint carries the totals, never records
    back = pickle.loads(pickle.dumps(runs["on"]["ctl"].spans))
    assert back.totals == runs["on"]["ctl"].spans.totals
    assert not back.on and back.start is None


@pytest.mark.parametrize("run", ["on", "off", "per_unit"])
def test_host_windows_are_the_harness_count(runs, run):
    """The plane's host-window count, by reason, sums to the windows the
    benchmark's recorder saw resolve at colplane.loss_flags (the per-unit
    plane counts its host batches, which the recorder does not see). At
    a forced floor the routing is a function of the run alone, so the
    recorded run counts the same."""
    r = runs[run]
    dev = r["summary"]["device"]
    assert set(dev["host_windows"]) == {"below_floor", "slots_busy",
                                        "flushed_open"}
    total = sum(dev["host_windows"].values())
    if run == "per_unit":
        assert r["sim"].host_windows == 0
        assert total == dev["host_windows"]["below_floor"] > 0
        return
    off = runs["off"]
    assert dev["host_windows"] == off["summary"]["device"]["host_windows"]
    assert total == off["sim"].host_windows > 0
    assert dev["waits"] == off["sim"].card_windows > 0
    if run == "on":
        assert 0 <= dev["waits_blocked"] <= dev["waits"]
    else:
        assert dev["waits_blocked"] == 0


def test_window_phases_counted_once(runs):
    """No record of a window phase (window_build, window_dispatch,
    window_readback) lies under another record of the same phase, and
    each card window has one build, one launch, one wait and one copy
    out, joined by its window id."""
    rec = runs["on"]["records"]
    names, parent, window = rec["name"], rec["parent"], rec["window"]
    key_of = {S.NAMES.index(n): k for k, ns in S.PHASE_NAMES.items()
              for n in ns if k.startswith("window_")}
    for i in np.flatnonzero(np.isin(names, list(key_of))):
        j = parent[i]
        while j >= 0:
            assert key_of.get(int(names[j])) != key_of[int(names[i])]
            j = parent[j]
    ids = window[names == S.DRAW_LAUNCH].tolist()
    assert len(ids) == len(set(ids)) == runs["off"]["sim"].card_windows
    for name in ("draw.build", "draw.wait", "draw.copy_out"):
        assert window[names == S.NAMES.index(name)].tolist() == ids, name
    runs_total = runs["on"]["summary"]["phase_wall"]
    assert "spec_install" in runs_total
    assert list(runs_total)[0] == "events"


def test_innermost_segments_and_gap_overlap():
    """A gap is given to the innermost span open through each part of
    it; time under no span is given to none."""
    sp = S.Spans(record=True)
    sp.open(S.RUN, 0)
    sp.open(S.LOOP, 10)
    sp.add(S.EVENTS, 12, 20)
    sp.close(40)
    sp.open(S.FINALIZE, 45)
    sp.add(S.FINALIZE_FLUSH_LOGS, 50, 60)
    sp.close(70)
    sp.close(100)
    sp.add(S.GC, 120, 130)
    rec = sp.take()
    assert sp.take()["name"].size == 0
    assert S.self_ns(rec).tolist() == [45, 22, 8, 15, 10, 10]
    seg = S.innermost(rec)
    assert seg[0].tolist() == [0, 10, 12, 20, 40, 45, 50, 60, 70, 120]
    assert seg[2].tolist() == [0, 1, 2, 1, 0, 3, 4, 3, 0, 5]
    got = S.overlap_by_record(seg, [(5, 15), (35, 55), (90, 125)])
    assert got == {0: 5 + 5 + 10, 1: 2 + 5, 2: 3, 3: 5, 4: 5, 5: 5}
