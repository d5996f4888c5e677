"""Where a simulation's host time goes, and what the card did meanwhile,
from the port's span records (shadow_tpu_torch/utils/spans.py).

    python3 tools/span_report.py CONFIG.yaml [--set KEY=VALUE ...] \\
        [--seed N] [--sims N] [--device cuda:0] [--spans 1|0] \\
        [--warmup-stop 10s] [--json OUT.json]

One warm-up simulation cut to ``--warmup-stop`` loads the kernels and the
C engine; then ``--sims`` whole simulations run back to back at seeds
``--seed``, ``--seed`` + 1, ..., each as the CLI runs it, under
``torch.profiler`` (the card's activity on a CUDA device), with
``Controller(record_spans=...)``. With ``--spans 0`` the simulations keep
only the phase totals, which measures what recording costs.

Printed, summed over the simulations (``--json`` writes the same and each
simulation's figures):

- the loop (``wall_seconds``), the round spans, draw.flush, window.tick,
  idle.skip and ``_finalize`` by child span and self time, in seconds a
  simulation;
- ``loop_self_ms_per_sim_s``, ``flush_logs_ms_per_sim_s``,
  ``draw_wait_ms_per_window`` (draw.wait over card windows),
  ``host_windows_pct`` (the plane's host windows, by reason, over all
  windows), ``controller_ms_per_sim_s``;
- the card's idle seconds inside each ``run`` span by the innermost
  program span open through them, and ``idle_named_pct``: the share of
  that idle time under a span other than ``run`` and the loop's self
  time;
- the ten longest idle gaps of the whole window, each named
  ``<span of this script>/<innermost program span covering most of it>``;
- the clock check (``clock_check``, ``api_check``): each window's
  draw.launch and draw.wait spans against its ``draw_flags_kernel`` in
  the trace, each draw.launch against the launch call the profiler saw
  on the host, and how far the wall clock moved against the monotonic
  clocks over the window;
- the records' bytes a simulation and the process's peak resident set.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.trace import Spans as ScriptSpans, Trace, kernel_name  # noqa: E402
from shadow_tpu_torch.utils import spans as S  # noqa: E402

KERNEL = "draw_flags_kernel"


def simulate(cfg_file, overrides, seed, data_dir, device, record, script):
    """One simulation as the CLI runs it: (summary, records, record
    bytes), timed by this script's own spans (``script``)."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    ns = time.time_ns()
    cfg = load_config(str(cfg_file), {
        **overrides, "general.seed": seed,
        "general.data_directory": str(data_dir)}, cache_doc=True)
    script.add("sim.config", ns)
    ns = time.time_ns()
    ctl = Controller(cfg, mirror_log=False, device=device,
                     record_spans=record)
    script.add("sim.construct", ns)
    ns = time.time_ns()
    summary = ctl.run()
    script.add("sim.run", ns)
    ns = time.time_ns()
    nbytes = ctl.spans.nbytes()
    records = ctl.spans.take()
    del ctl
    gc.collect()
    script.add("sim.teardown", ns)
    return summary, records, nbytes


def idle_gaps(events, a, b):
    """(start, end) of every interval of [a, b) with no card activity."""
    gaps, cursor = [], a
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if b > cursor:
        gaps.append((cursor, b))
    return gaps


def clip(gaps, a, b):
    return [(max(s, a), min(e, b)) for s, e in gaps if min(e, b) > max(s, a)]


#: the spans whose children breakdown() reports
BROKEN_DOWN = (S.LOOP, S.ROUND_START, S.ROUND_END, S.DRAW_FLUSH,
               S.WINDOW_TICK, S.IDLE_SKIP, S.FINALIZE)


def breakdown(rec) -> dict:
    """Seconds of each BROKEN_DOWN span's children, by name, and of its
    self time ("(self)"), summed over its records."""
    dur = S.durations(rec)
    own = S.self_ns(rec)
    out = {}
    for span in BROKEN_DOWN:
        idx = np.flatnonzero(rec["name"] == span)
        kids = np.isin(rec["parent"], idx)
        out[S.NAMES[span]] = {k: v / 1e9 for k, v in
                              S.by_name(rec, dur, kids).items()}
        out[S.NAMES[span]]["(self)"] = float(own[idx].sum()) / 1e9
    return out


def _stats_us(ns) -> dict:
    ns = np.asarray(ns, np.int64)
    if not ns.size:
        return {"n": 0}
    q = np.percentile(ns, [1, 50, 99]) / 1e3
    return {"n": int(ns.size), "min": float(ns.min()) / 1e3,
            "p1": float(q[0]), "p50": float(q[1]), "p99": float(q[2]),
            "max": float(ns.max()) / 1e3}


def clock_check(records, kernels) -> dict:
    """Each draw.launch joined to its draw_flags_kernel: by order where
    the trace holds as many kernels as there are launches, else to the
    first kernel that starts after the launch began and within 2 ms of
    its end. Returns, in us: the kernel's start less the launch's start
    (a kernel cannot start before its launch) and less the launch's end,
    both early and late in the window (a drift between the clocks shows
    as a change), and each draw.wait's end less its kernel's end (a wait
    cannot end before its kernel does), over all waits and over those
    that began before their kernel ended."""
    launches = []
    for i, rec in enumerate(records):
        sel = rec["name"] == S.DRAW_LAUNCH
        launches += [(int(s), int(e), i, int(w)) for s, e, w in zip(
            rec["start"][sel], rec["end"][sel], rec["window"][sel])]
    launches.sort()
    k_start = np.array([s for s, _ in kernels], np.int64)
    k_end = np.array([e for _, e in kernels], np.int64)
    by_order = len(kernels) == len(launches)
    joined = {}
    for j, (s, e, i, w) in enumerate(launches):
        if by_order:
            k = j
        else:
            k = int(np.searchsorted(k_start, s))
            if k >= len(k_start) or k_start[k] > e + 2_000_000:
                continue
        joined[(i, w)] = (s, e, k)
    lag = np.array([k_start[k] - s for s, _, k in joined.values()],
                   np.int64)
    after_end = np.array([k_start[k] - e for _, e, k in joined.values()],
                         np.int64)
    ends, ends_blocked = [], []
    for i, rec in enumerate(records):
        sel = np.flatnonzero(rec["name"] == S.DRAW_WAIT)
        for r in sel.tolist():
            hit = joined.get((i, int(rec["window"][r])))
            if hit is None:
                continue
            off = int(rec["end"][r] - k_end[hit[2]])
            ends.append(off)
            if rec["start"][r] < k_end[hit[2]]:
                ends_blocked.append(off)
    n = len(lag)
    return {"kernels_in_trace": len(kernels), "launches": len(launches),
            "joined_by": "order" if by_order else "time",
            "joined": n,
            "kernel_start_after_launch_start_us": _stats_us(lag),
            "kernel_start_after_launch_end_us": _stats_us(after_end),
            "first_500_after_launch_start_us": _stats_us(lag[:500]),
            "last_500_after_launch_start_us": _stats_us(lag[-500:]),
            "wait_end_after_kernel_end_us": _stats_us(ends),
            "blocked_wait_end_after_kernel_end_us": _stats_us(ends_blocked),
            "waits_ending_over_20us_early": int(
                (np.asarray(ends, np.int64) < -20_000).sum())}


def host_api_events(prof) -> dict:
    """(start ns, end ns) of the CUDA API calls (``cu*``) the profiler
    saw on the host, by name, in time order: they stamp the profiler's
    own host clock."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof._prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU and name.startswith("cu"):
            s = e.start_ns()
            out.setdefault(name, []).append((s, s + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def api_check(records, api) -> dict:
    """Each draw.launch joined by order to a kernel-launch call the
    profiler saw on the host (where there are as many): the call's start
    less the span's start and the span's end less the call's end, in us;
    both are at least 0 where the two host clocks agree."""
    calls = max((v for k, v in api.items() if "LaunchKernel" in k),
                key=len, default=[])
    spans = sorted((int(s), int(e)) for rec in records for s, e in zip(
        rec["start"][rec["name"] == S.DRAW_LAUNCH],
        rec["end"][rec["name"] == S.DRAW_LAUNCH]))
    out = {"calls": {k: len(v) for k, v in api.items()},
           "launch_spans": len(spans)}
    if len(calls) != len(spans) or not spans:
        return out
    s = np.array(spans, np.int64)
    c = np.array(calls, np.int64)
    out["call_start_after_span_start_us"] = _stats_us(c[:, 0] - s[:, 0])
    out["span_end_after_call_end_us"] = _stats_us(s[:, 1] - c[:, 1])
    out["first_500_call_after_span_start_us"] = _stats_us(
        c[:500, 0] - s[:500, 0])
    out["last_500_call_after_span_start_us"] = _stats_us(
        c[-500:, 0] - s[-500:, 0])
    return out


def clock_offsets() -> dict:
    """time.time_ns() less the monotonic clocks now, in ns: where these
    move between two readings, the wall clock was slewed meanwhile."""
    t = time.time_ns()
    return {"monotonic": t - time.monotonic_ns(),
            "monotonic_raw": t - time.clock_gettime_ns(
                time.CLOCK_MONOTONIC_RAW)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/span_report.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sims", type=int, default=3)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--warmup-stop", default="10s")
    p.add_argument("--stop")
    p.add_argument("--json")
    args = p.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v
    base = Path(tempfile.mkdtemp(prefix="span-report-"))
    try:
        report = measure(args, overrides, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({k: v for k, v in report.items() if k != "per_sim"},
                     indent=1))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


def measure(args, overrides: dict, base: Path) -> dict:
    """The warm-up, the traced simulations and the report (module doc),
    the data directories under ``base``."""
    import torch

    cuda = args.device.startswith("cuda")
    if cuda:
        torch.cuda.init()
    script = ScriptSpans()
    warm = dict(overrides, **{"general.stop_time": args.warmup_stop})
    simulate(args.config, warm, args.seed + (1 << 40), base / "warm",
             args.device, False, script)
    if args.stop:
        overrides["general.stop_time"] = args.stop
    rss_warm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    script = ScriptSpans()
    prof = Trace()
    prof.start()
    offsets_start = clock_offsets()
    sims = []
    for i in range(args.sims):
        summary, rec, nbytes = simulate(
            args.config, overrides, args.seed + i, base / f"sim-{i}",
            args.device, bool(args.spans), script)
        sims.append((summary, rec, nbytes))
    if cuda:
        torch.cuda.synchronize()
    offsets_stop = clock_offsets()
    prof.stop()
    events = prof.device_events()
    rss_end = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    kernels = sorted((s, e) for n, s, e in events
                     if kernel_name(n) == KERNEL)
    gaps = idle_gaps(events, prof.start_ns, prof.stop_ns)
    sim_s = sum(s["sim_seconds"] for s, _, _ in sims)
    card = sum(s["device_windows_dispatched"] for s, _, _ in sims)
    host = sum(sum(s["device"]["host_windows"].values()) for s, _, _ in sims)
    reasons = {}
    for s, _, _ in sims:
        for k, v in s["device"]["host_windows"].items():
            reasons[k] = reasons.get(k, 0) + v
    report = {
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "sims": len(sims), "spans": bool(args.spans),
        "controller_ms_per_sim_s": 1e3 * sum(
            s["wall_seconds"] for s, _, _ in sims) / sim_s,
        "host_windows_pct": 100.0 * host / (host + card) if host + card
        else None,
        "host_windows": reasons, "card_windows": card,
        "waits": sum(s["device"]["waits"] for s, _, _ in sims),
        "waits_blocked": sum(s["device"]["waits_blocked"]
                             for s, _, _ in sims),
        "peak_rss_mib_after_warmup": rss_warm, "peak_rss_mib": rss_end,
        "window_s": (prof.stop_ns - prof.start_ns) / 1e9,
        "card_busy_s": (prof.stop_ns - prof.start_ns
                        - sum(e - s for s, e in gaps)) / 1e9,
        "per_sim": [],
    }
    if args.spans:
        idle_by = {}
        idle_run = idle_named = 0
        parts = {S.NAMES[span]: {} for span in BROKEN_DOWN}
        all_records = []
        for i, (summary, rec, nbytes) in enumerate(sims):
            seg = S.innermost(rec)
            runs = np.flatnonzero(rec["name"] == S.RUN)
            mine = []
            for r in runs.tolist():
                mine += clip(gaps, int(rec["start"][r]), int(rec["end"][r]))
            by_rec = S.overlap_by_record(seg, mine)
            sim_idle = {}
            for r, ns in by_rec.items():
                name = S.NAMES[int(rec["name"][r])]
                sim_idle[name] = sim_idle.get(name, 0) + ns
            run_idle = sum(e - s for s, e in mine)
            named = sum(v for k, v in sim_idle.items()
                        if k not in ("run", "loop"))
            idle_run += run_idle
            idle_named += named
            for k, v in sim_idle.items():
                idle_by[k] = idle_by.get(k, 0) + v
            b = breakdown(rec)
            for group, acc in parts.items():
                for k, v in b[group].items():
                    acc[k] = acc.get(k, 0.0) + v
            all_records.append((rec, seg))
            report["per_sim"].append({
                "seed": args.seed + i, "sim_seconds": summary["sim_seconds"],
                "wall_seconds": summary["wall_seconds"],
                "records": int(len(rec["name"])), "record_bytes": nbytes,
                "breakdown": b,
                "idle_s_by_span": {k: v / 1e9 for k, v in
                                   sorted(sim_idle.items(),
                                          key=lambda kv: -kv[1])},
                "idle_in_run_s": run_idle / 1e9})
        n = len(sims)
        report["s_a_sim_by_child"] = {
            group: {k: v / n for k, v in sorted(acc.items(),
                                                key=lambda kv: -kv[1])}
            for group, acc in parts.items()}
        loop, fin = parts["loop"], parts["finalize"]
        report["loop_self_ms_per_sim_s"] = 1e3 * loop.get("(self)", 0) / sim_s
        report["flush_logs_ms_per_sim_s"] = 1e3 * fin.get(
            "finalize.flush_logs", 0) / sim_s
        waits = sum(S.total_s(rec, "draw.wait") for _, rec, _ in sims)
        report["draw_wait_ms_per_window"] = (1e3 * waits / card
                                             if card else None)
        report["idle_s_by_span_a_sim"] = {
            k: v / 1e9 / n for k, v in sorted(idle_by.items(),
                                              key=lambda kv: -kv[1])}
        report["idle_in_run_s_a_sim"] = idle_run / 1e9 / n
        report["idle_named_pct"] = (100.0 * idle_named / idle_run
                                    if idle_run else None)
        report["record_bytes_a_sim"] = sum(b for _, _, b in sims) / n
        report["clock"] = clock_check([r for _, r, _ in sims], kernels)
        report["clock"]["host_api"] = api_check(
            [r for _, r, _ in sims], host_api_events(prof))
        report["clock"]["wall_clock_slew_us"] = {
            k: (offsets_stop[k] - offsets_start[k]) / 1e3
            for k in offsets_start}
        top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named_gaps = []
        for a, b in top:
            prog, most = "", 0
            for rec, seg in all_records:
                for r, ns in S.overlap_by_record(seg, [(a, b)]).items():
                    if ns > most:
                        prog, most = S.NAMES[int(rec["name"][r])], ns
            named_gaps.append([f"{script.name_of(a, b)}/{prog}".rstrip("/"),
                               (b - a) / 1e9])
        report["idle_gaps"] = named_gaps
    return report


if __name__ == "__main__":
    sys.exit(main())
