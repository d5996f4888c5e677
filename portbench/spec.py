"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) pairs a configuration with a traffic mix:

- ``configs`` entry -> its ``file`` (``portbench/configs/<name>/config.yaml``,
  the simulation config as it is run) and ``config.json`` beside it (its
  source, cuts, assumptions, guarantee, and the simulated time of the
  warm-up simulation);
- ``traffic`` -> ``portbench/traffic/<name>.json``: the scheduler policy,
  the config overrides and the device entries the simulations run with;
- each ``per_layer`` metric -> ``portbench/metrics/<name>.py``, whose
  ``read(window)`` returns the metric or None where it finds nothing.

A metric's unit, layer and cells live only in ``BENCHMARK.json``, so a
later cell, configuration, traffic mix or metric is a new file and a new
entry, with no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def _read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise SpecError(f"cannot read {path}: {exc}") from exc


def load(root: Path = ROOT) -> dict:
    return _read_json(Path(root) / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` needs, found by name."""
    works = {w["name"]: w for w in bench["workloads"]}
    work = works.get(name)
    if work is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(works)})")
    conf = {c["name"]: c for c in bench["configs"]}.get(work["config"])
    if conf is None:
        raise SpecError(f"workload {name!r} names no known config "
                        f"{work['config']!r}")
    yaml_path = Path(root) / conf["file"]
    if not yaml_path.is_file():
        raise SpecError(f"config file {yaml_path} is missing")
    return {
        "name": name,
        "chips": int(work["chips"]),
        "config_file": yaml_path,
        "config_meta": _read_json(yaml_path.with_name("config.json")),
        "traffic": _read_json(
            Path(root) / "portbench" / "traffic" / f"{work['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }


def reader(name: str, root: Path = ROOT):
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise SpecError(f"per-layer metric {name!r} has no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
