"""A run of a cell on the CPU at a few simulated seconds: the result
line, the rate's definition, and ``correct`` coming out false for the
control and for each fault a cell can have, planted in the program's
plain kernels underneath the timed path. One test drives a real run on
the card and skips without one."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run, spec

BENCH = spec.load()
CELL = "tgen_1k.batch_every_window"
CUT = "2s"
SEED = (1 << 31) + 4242


def _measure(name=CELL, **kw):
    cell = spec.cell(BENCH, name)
    result = run.measure(cell, SEED, 0, device="cpu", stop_time=CUT, **kw)
    return cell, result


@pytest.fixture(scope="module")
def sound():
    return _measure()


def test_result_line(sound):
    cell, result = sound
    line = run.result_line(cell, result, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"host_peak_mib", "setup_s"}
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())
    json.dumps(line)
    sim = result["window"].sims[0]
    assert sim.draws, "the run recorded no loss decision"
    assert sim.tree is not None and sim.tree == sim.witness_tree
    assert result["e2e"]["host_peak_mib"] > 0


def test_rate_is_simulated_seconds_over_window_wall(sound):
    _, result = sound
    w = result["window"]
    sim_s = sum(s.summary["sim_seconds"] for s in w.sims)
    assert sim_s == pytest.approx(2.0 * len(w.sims))
    rate = spec.reader("traced_sim_s_per_wall_s")(w)
    assert rate == sim_s / w.wall_s
    assert w.wall_s >= sum(s.wall_s for s in w.sims)


def test_per_layer_readers(sound):
    cell, result = sound
    line = run.result_line(cell, result, True)
    got = line["metrics"]
    # no card and no trace: the card's metrics find nothing to read
    assert set(got) == {"traced_sim_s_per_wall_s", "controller_ms_per_sim_s",
                        "events_ms_per_sim_s", "finalize_ms_per_sim_s",
                        "barrier_ms_per_sim_s", "draw_flush_ms_per_window"}
    assert all(v["value"] > 0 for v in got.values())


def test_the_control_is_not_correct():
    cell, result = _measure(CELL, control_rounds=13)
    line = run.result_line(cell, result, False)
    assert line["correct"] is False
    assert line["checks"]["draw_flag_mismatches"]["value"] > 0


def _unchanged(monkeypatch):
    from shadow_tpu_torch.ops import propagate

    monkeypatch.setattr(propagate.DrawSlot, "launch",
                        lambda self, n, key, width, stream: None)


def _half(monkeypatch):
    from shadow_tpu_torch.ops import propagate

    rows, dtype, out, plain = propagate._KERNELS["draw_flags"]
    monkeypatch.setitem(propagate._KERNELS, "draw_flags", (
        rows, dtype, out, lambda p, key, width, n: plain(p, key, width,
                                                         n // 2)))


def _altered(monkeypatch):
    from shadow_tpu_torch.ops import propagate

    rows, dtype, out, plain = propagate._KERNELS["draw_flags"]

    def flip(p, key, width, n):
        flags = plain(p, key, width, n).clone()
        flags[0] ^= 1
        return flags

    monkeypatch.setitem(propagate._KERNELS, "draw_flags",
                        (rows, dtype, out, flip))


def _output(monkeypatch):
    """The hosts/ tree of each simulation in the window gains a byte,
    where the witness's does not."""
    simulate = run.simulate

    def faulty(cfg_file, overrides, seed, data_dir, *args, **kw):
        sim = simulate(cfg_file, overrides, seed, data_dir, *args, **kw)
        if data_dir.name.startswith("sim-"):
            log = sorted((data_dir / "hosts").rglob("*.log"))[0]
            log.write_text(log.read_text() + "x")
        return sim

    monkeypatch.setattr(run, "simulate", faulty)


@pytest.mark.parametrize("plant", [_unchanged, _half, _altered, _output],
                         ids=["unchanged", "half", "altered", "output"])
def test_a_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    cell, result = _measure(CELL)
    line = run.result_line(cell, result, False)
    assert line["correct"] is False, line["checks"]
    if plant is _output:
        assert line["checks"]["hosts_tree_mismatches"]["value"] == 1


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tgen_1k.batch_every_window", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tgen_1k.batch_every_window", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert "shadow_tpu_torch" in sys.modules
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "tgen_1k.batch_every_window", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["host_peak_mib"]["value"])
