"""BENCHMARK.json and the files it names load as data and keep to the
benchmark's rules; a new cell is found from new files alone; the
reference imports nothing of the program."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from portbench import spec

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_and_limits():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            extra = set(entry) - KEYS[group]
            assert extra <= {"workloads"}, (group, entry["name"], extra)
            assert KEYS[group] <= set(entry), (group, entry["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            names.append(entry["name"])
            assert spec.NAME.fullmatch(entry["name"]), entry["name"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], key)
            if "unit" in entry:
                assert spec.UNIT.fullmatch(entry["unit"]), entry["unit"]
            if "better" in entry:
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    assert len(names) == len(set(names))


def test_every_metric_has_a_reader_and_a_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", CELLS)
def test_cells_load_as_data(name):
    cell = spec.cell(BENCH, name)
    assert cell["config_file"].is_file()
    assert {"policy", "overrides"} <= set(cell["traffic"])
    meta = cell["config_meta"]
    assert {"source", "reduced", "assumed", "deployment", "guarantee",
            "warmup_stop_time"} <= set(meta)
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]


def test_a_new_cell_is_found_from_new_files(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "portbench")
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "portbench" / "traffic" / "batch_floor_4.json").write_text(
        json.dumps({"policy": "tpu_batch",
                    "overrides": {"experimental.tpu_device_floor": 4}}))
    bench["workloads"].append({
        "name": "tor_400relay.batch_floor_4", "config": "tor_400relay",
        "traffic": "batch_floor_4", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(spec.load(tmp_path), "tor_400relay.batch_floor_4",
                     root=tmp_path)
    assert cell["traffic"]["overrides"] == {
        "experimental.tpu_device_floor": 4}
    assert cell["config_file"].parent.name == "tor_400relay"
    with pytest.raises(spec.SpecError):
        spec.cell(bench, "no_such.cell", root=tmp_path)


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert set(_imported_tops(path)) <= {"__future__", "numpy",
                                              "portbench"}, path
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import portbench.reference.draws; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True)
    tops = set(out.stdout.split())
    assert not tops & {"shadow_tpu_torch", "shadow_tpu", "jax", "jaxlib",
                       "flax", "torch"}


def test_harness_loads_no_jax():
    for path in spec.HERE.rglob("*.py"):
        tops = set(_imported_tops(path))
        assert not tops & {"jax", "jaxlib", "flax", "shadow_tpu"}, path
