"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``shadow_tpu_torch``, on a machine
with as many CUDA cards as the cell asks for. Without them it exits 1 and
prints no result.

Set-up (``setup_s``) runs from the process's start through ``import
torch``, CUDA's start, the cell's config parsed once, and one warm-up
simulation of it at a seed outside the measured ones, cut to the
config's ``warmup_stop_time``, which loads or builds the port's kernels
and C engine into ``shadow_tpu_torch/_build/`` and touches every staging
bucket the cell's simulations use.

The window then runs whole simulations back to back, each as ``python -m
shadow_tpu_torch`` runs it (the config loader, ``Controller``,
``Controller.run()``), at seeds ``--seed``, ``--seed`` + 1, ... and each
at the config's own stop time, construction and teardown included. It
closes when the first simulation that ends after ``--seconds`` of wall
ends. Each writes its data directory under ``$TMPDIR``, and the
decisions of the first four (record.py) go to files there too. Once the
window has closed the harness judges those four (check.py): it reads
their decisions and hosts/ trees back, runs each seed again on the
witness path (``WITNESS``), counts the bytes written and deletes it all,
so that none of this is timed.

The end-to-end metrics are ``host_peak_mib`` and ``setup_s``. The rate,
simulated seconds of the window's whole simulations over its wall, goes
to standard error; it spreads too widely from run to run to be held to a
bound, and is a per-layer metric of the traced run
(``traced_sim_s_per_wall_s``).

``host_peak_mib`` is the process's peak resident memory at the window's
end less what it held resident once torch and CUDA had started, before
the first simulation: the memory that the simulator takes at its peak,
above the libraries and CUDA's context. It covers the warm-up too, whose
simulation runs to only a part of the config's stop time; standard error
gives the peak at the end of set-up beside it.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (simulations started in the window), ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a ``torch.profiler`` trace of the whole
window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the comparison with the reference reads
(check.py) beside its limit, which standard error's last lines repeat.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, outcome, spec  # noqa: E402
from portbench.record import Recorder, SimRecord  # noqa: E402
from portbench.trace import Spans, Trace  # noqa: E402

#: build and kernel caches a library may keep, at fixed paths inside the
#: checkout (the port itself builds into shadow_tpu_torch/_build/)
CACHE = ROOT / ".portbench_cache"
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "shadow_tpu")
#: the warm-up simulation's seed lies this far above the measured ones
WARMUP_SEED_OFFSET = 1 << 40
#: what check.py runs each checked seed again on: the user's default
#: command on the host (the automatic device floor, so every window's
#: draws resolve on the host), which the guarantee says gives the same
#: hosts/ tree and counts
WITNESS = ({"experimental.scheduler_policy": "tpu_batch"}, "cpu")
#: the window's first simulations, which check.py judges: a sample drawn
#: from the seed, of a fixed size so that the judging takes less time than
#: the window
CHECKED_SIMS = 4


@dataclass
class Window:
    """What the per-layer readers read: the window's simulations
    (record.SimRecord), its wall time, the port's kernel launches in it by
    wrapper, the device trace's reading (or None), and whether the
    simulations were cut short of the config's stop time."""

    sims: list
    wall_s: float
    launches: dict
    trace: dict
    cut: bool = False


def process_age_s() -> float:
    """Seconds since this process started, on the kernel's clock."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def resident_mib() -> float:
    """This process's resident set now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise KeyError("VmRSS")


def peak_mib() -> float:
    """This process's peak resident set so far."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _dir_bytes(path: Path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _launch_counts() -> dict:
    from shadow_tpu_torch.ops import propagate
    from shadow_tpu_torch.parallel import mesh

    return {**propagate.LAUNCHES, **mesh.LAUNCHES}


def tree(data_dir: Path, summary: dict) -> tuple:
    """(sha256 of the hosts/ tree's paths and bytes, the counts the
    guarantee covers) of one simulation."""
    h = hashlib.sha256()
    hosts = data_dir / "hosts"
    for p in sorted(hosts.rglob("*")) if hosts.is_dir() else ():
        if p.is_file():
            h.update(str(p.relative_to(hosts)).encode() + b"\0")
            h.update(p.read_bytes())
    counts = (summary["units_sent"], summary["units_dropped"],
              summary["units_blackholed"], summary["bytes_sent"],
              tuple(sorted(summary["counters"].items())))
    return h.hexdigest(), counts


def simulate(cfg_file: Path, overrides: dict, seed: int, data_dir: Path,
             device: str, rec: Recorder, spans: Spans,
             recorded: bool = True) -> SimRecord:
    """One simulation as the CLI runs it; returns its SimRecord. With a
    Recorder, its decisions are recorded where ``recorded`` is true."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    sim = (rec.begin(seed, 0, recorded) if rec is not None
           else SimRecord(int(seed), 0, False))
    t0 = time.perf_counter()
    ctl = None
    try:
        ns = time.time_ns()
        cfg = load_config(str(cfg_file), {
            **overrides, "general.seed": seed,
            "general.data_directory": str(data_dir)}, cache_doc=True)
        sim.width = cfg.experimental.unit_mtus
        sim.phases["config"] = spans.add("sim.config", ns)
        ns = time.time_ns()
        ctl = Controller(cfg, mirror_log=False, device=device)
        sim.phases["construct"] = spans.add("sim.construct", ns)
        ns = time.time_ns()
        sim.summary = ctl.run()
        sim.phases["run"] = spans.add("sim.run", ns)
    except Exception:  # noqa: BLE001 - a failed simulation is counted
        sim.error = traceback.format_exc()
        print(f"portbench: simulation at seed {seed} raised:\n{sim.error}",
              file=sys.stderr)
    finally:
        ns = time.time_ns()
        del ctl
        gc.collect()
        sim.phases["teardown"] = spans.add("sim.teardown", ns)
        if rec is not None:
            rec.end()
    sim.wall_s = time.perf_counter() - t0
    return sim


def _device_info(torch, device: str, chips: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": max(
                torch.cuda.max_memory_allocated(i) for i in range(chips))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        info["power_limit_w"] = None
    return info


def measure(cell: dict, seed: int, seconds: float, trace: bool = False,
            device: str = None, stop_time: str = None,
            control_rounds: int = None) -> dict:
    """Set-up, the window and the comparison of one run of ``cell``
    (spec.cell). ``device`` replaces the traffic's device entries
    (``"cpu"`` runs the kernels' plain versions), ``stop_time`` every
    simulation's stop time, ``control_rounds`` the program's draws by the
    reference's at that many rounds (record.py): the CPU tests' knobs,
    which no benchmark run turns. Returns the result line's fields and
    the window's readings."""
    base = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        out = _measure(cell, seed, seconds, trace, device, stop_time,
                       control_rounds, base)
        out["bytes_written"] = _dir_bytes(base)
        return out
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _measure(cell, seed, seconds, trace, device, stop_time, control_rounds,
             base: Path) -> dict:
    import torch

    traffic, meta = cell["traffic"], cell["config_meta"]
    device = device or traffic.get("device", "cuda:0")
    overrides = {"experimental.scheduler_policy": traffic["policy"],
                 **traffic.get("overrides", {})}
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.init()
    rss_base = resident_mib()
    spans = Spans()
    with Recorder(base / "draws", control_rounds) as rec:
        warm = dict(overrides, **{"general.stop_time":
                                  stop_time or meta["warmup_stop_time"]})
        sim = simulate(cell["config_file"], warm, seed + WARMUP_SEED_OFFSET,
                       base / "warmup", device, rec, spans, recorded=False)
        warm_failed = check.sim_failed(sim, cut=True)
        if cuda:
            torch.cuda.synchronize()
        setup_s = process_age_s()
        hwm_setup = peak_mib()
        if stop_time:
            overrides["general.stop_time"] = stop_time
        prof = Trace() if trace else None
        before = _launch_counts()
        sims = []
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        while True:
            s = seed + len(sims)
            sims.append(simulate(cell["config_file"], overrides, s,
                                 base / f"sim-{s}", device, rec, spans,
                                 recorded=len(sims) < CHECKED_SIMS))
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    peak = peak_mib()
    memory = {"base_rss_mib": rss_base, "setup_peak_mib": hwm_setup,
              "window_peak_mib": peak}
    dev = _device_info(torch, device, cell["chips"])
    reading = prof.read(spans) if prof is not None else None
    window = Window(sims, wall, launches, reading, stop_time is not None)
    check_sims(cell, window, base, spans, stop_time)
    e2e = {"host_peak_mib": peak - rss_base, "setup_s": setup_s}
    readings = check.judge(sims, window.cut)
    if warm_failed:
        v, limit = readings["failed_sims"]
        readings["failed_sims"] = (v + 1, limit)
    return {"window": window, "e2e": e2e, "readings": readings,
            "device": dev, "memory": memory}


def check_sims(cell: dict, window: Window, base: Path, spans: Spans,
               stop_time: str = None) -> None:
    """Once the window has closed: read back what each checked simulation
    decided, digest its hosts/ tree, read its clients' completions, and run
    its seed again on the WITNESS path for the tree that the guarantee
    says it must equal."""
    overrides, device = dict(WITNESS[0]), WITNESS[1]
    if stop_time:
        overrides["general.stop_time"] = stop_time
    plan = outcome.Plan(cell["config_file"])
    for sim in window.sims:
        if not sim.recorded or check.sim_failed(sim, window.cut):
            continue
        Recorder.load(sim)
        data = base / f"sim-{sim.seed}"
        sim.tree = tree(data, sim.summary)
        sim.shortfall = plan.shortfall(data / "hosts")
        other = simulate(cell["config_file"], overrides, sim.seed,
                         base / f"witness-{sim.seed}", device, None, spans)
        if not check.sim_failed(other, window.cut):
            sim.witness_tree = tree(base / f"witness-{sim.seed}",
                                    other.summary)


def result_line(cell: dict, run: dict, trace: bool) -> dict:
    """The result's JSON object, ``checks`` last."""
    window = run["window"]
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = spec.reader(m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": run["e2e"][m["name"]],
                                  "unit": m["unit"]}
    out = {
        "correct": check.passed(run["readings"]),
        "attempted": len(window.sims),
        "failed": sum(check.sim_failed(s, window.cut) for s in window.sims),
        "metrics": metrics,
        "device": dict(run["device"]),
    }
    if trace and window.trace is not None:
        out["device"]["busy_s"] = window.trace["busy_s"]
        out["device"]["window_s"] = window.trace["window_s"]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in window.trace["device_ops"]],
            "idle_gaps": window.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run["readings"].items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not 0 <= args.seed < (1 << 62):
        print(f"portbench: --seed must be in [0, 2**62), got {args.seed}",
              file=sys.stderr)
        return 2
    CACHE.mkdir(exist_ok=True)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE / sub)
    try:
        cell = spec.cell(spec.load(), args.workload)
    except spec.SpecError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import shadow_tpu_torch
    import torch

    if Path(shadow_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"portbench: shadow_tpu_torch comes from "
              f"{shadow_tpu_torch.__file__}, not from this checkout {ROOT}",
              file=sys.stderr)
        return 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this process sees {cards}", file=sys.stderr)
        return 1
    run = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the port must not load "
              f"JAX or the JAX package", file=sys.stderr)
        return 1
    window = run["window"]
    sim_s = sum(s.summary["sim_seconds"] for s in window.sims
                if not check.sim_failed(s, window.cut))
    print(f"portbench: {args.workload}: {len(window.sims)} simulations in "
          f"{window.wall_s:.3f} s of window (seeds {args.seed}.."
          f"{args.seed + len(window.sims) - 1}), {sim_s / window.wall_s} "
          f"simulated s per wall s, set-up {run['e2e']['setup_s']:.2f} s",
          file=sys.stderr)
    for sim in window.sims:
        ctl = sim.summary["wall_seconds"] if sim.summary else None
        print(f"portbench: simulation {sim.seed}: {sim.wall_s:.3f} s "
              f"({', '.join(f'{k} {v:.3f}' for k, v in sim.phases.items())}"
              f"; controller {ctl}; windows {sim.card_windows} on the card,"
              f" {sim.host_windows} on the host)", file=sys.stderr)
        if sim.tree is not None:
            same = ("equals" if sim.tree == sim.witness_tree
                    else "DIFFERS from")
            print(f"portbench: simulation {sim.seed}: hosts/ {sim.tree[0]} "
                  f"{same} the witness's; {len(sim.draws)} decisions kept; "
                  f"outcome shortfall {sim.shortfall}", file=sys.stderr)
    print(f"portbench: memory (MiB) {run['memory']}", file=sys.stderr)
    print(f"portbench: {run['bytes_written']} bytes written",
          file=sys.stderr)
    print(f"portbench: kernel launches in the window {window.launches}",
          file=sys.stderr)
    if window.trace is not None:
        seen = sum(len(v) for v in window.trace["kernels"].values())
        print(f"portbench: the profiler saw {seen} kernel launches of "
              f"{sum(window.launches.values())} counted", file=sys.stderr)
    line = result_line(cell, run, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
