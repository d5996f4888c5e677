#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (shadow_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — a CUDA card is visible; prints its name and power limit.
2. build   — builds (or loads) the kernel library of shadow_tpu_torch/csrc
             with nvcc; prints the seconds.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs on the card, bit for bit (tolerance 0: integer math),
             over every bucket shape, ragged batch lengths, lane widths,
             thresholds and two seeds.
4. echo    — examples/echo.yaml through the port's CLI on the card; its
             output tree must equal the reference's (constant below).
5. main    — examples/tgen_1k.yaml under tpu_batch through the port's CLI
             on the card, once with tpu_device_floor=1 (every draw window
             on the card) and once as a user runs it (auto floor); both
             must give the reference's counts and output tree. Kernel
             launch counts are reset just before and read just after: every
             kernel must have launched. The floor-1 run keeps a copy of
             every window it hands draw_flags.
6. timing  — both kernels and their plain versions timed on those windows
             (the run's own traffic): card time per launch, with the bound
             for the same work.
7. trace   — examples/tgen_100host.yaml at tpu_device_floor=1 under
             torch.profiler; its counts and output tree must equal the
             reference's. Prints the card's busy share of the run's wall
             time and device time by kernel/copy name (a profiler that
             cannot trace the card is reported; the run's own failures
             are not caught).

Prints a JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``. The reference constants come from
``python -m shadow_tpu <config> --scheduler-policy tpu_batch`` and
``shadow_tpu.fleet.output_tree_digest``; tests/test_torch_e2e.py re-derives
them from the reference package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXAMPLES = ROOT / "examples"

#: the reference's results (shadow_tpu, tpu_batch; identical at every
#: tpu_device_floor and with the C engine on or off)
ECHO_TREE_DIGEST = (
    "5c2b64d71ce68c32f3b7f0ed992ec3e913e748c88733c1e7fb98bd5cd14737ce")
TGEN1K_COUNTS = {"rounds": 10238, "events": 220446, "units_sent": 217202,
                 "units_dropped": 1401, "bytes_sent": 1909082179}
TGEN1K_TREE_DIGEST = (
    "a66167dad8a34d10f2e61c5710c6bfc6a46da94c120a79f881424aee941fc7c7")
TGEN100_COUNTS = {"rounds": 1787, "events": 90523, "units_sent": 89478,
                  "units_dropped": 316, "bytes_sent": 903630840}
TGEN100_TREE_DIGEST = (
    "5bfed8c0366841aae26cfad1711448251f31cd0c62b7bcb67111cc699c3d4d24")

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
#: and INT32 operations outside the tensor cores — 64 INT32 lanes per SM
#: against 128 FP32 lanes, so a quarter of the 67 TFLOP/s FP32 rate, which
#: counts an FMA as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
#: integer operations per packet lane, counting only what differs from lane
#: to lane (the key schedule's k+j sums and the first word's c0+k0 are the
#: same for every lane of a unit): 20 rounds x (add, funnel-shift rotate,
#: xor), 5 key injections x 2 adds, the second word's initial add, the
#: counter's shift and OR, and the draw's shift and compare (or min)
OPS_PER_LANE = 20 * 3 + 5 * 2 + 1 + 2 + 2

PLAN = {
    "draw_flags": ("shadow_tpu_torch/csrc/draw.cu",
                   "shadow_tpu/ops/propagate.py:85"),
    "min_draw": ("shadow_tpu_torch/csrc/draw.cu",
                 "shadow_tpu/ops/propagate.py:58"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------

def sweep_inputs(rng, p: int, rows: int):
    """(rows, p) uint32 inputs covering the edge cases: npkts in
    {0, 1, 10, 64} and random, thresholds {0, 1, 2**24} and random."""
    import numpy as np

    lo = rng.integers(0, 1 << 32, p, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 26, p, dtype=np.uint64).astype(np.uint32)
    npk = np.where(rng.random(p) < 0.5,
                   rng.choice(np.array([0, 1, 10, 64], np.uint32), p),
                   rng.integers(0, 65, p).astype(np.uint32))
    th = np.where(rng.random(p) < 0.6,
                  rng.choice(np.array([0, 1, 1 << 24], np.uint32), p),
                  rng.integers(0, 1 << 24, p).astype(np.uint32))
    cols = (lo, hi, npk, th)[:rows]
    return np.ascontiguousarray(np.stack(cols))


def abs_err(torch, got, want) -> int:
    """Largest absolute difference, element by element (flags unpacked)."""
    if got.dtype == torch.uint8:  # packed flags: compare bit by bit
        bits = torch.arange(8, device=got.device)
        got = (got.to(torch.int64)[:, None] >> bits) & 1
        want = (want.to(torch.int64)[:, None] >> bits) & 1
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_kernels(torch, np, prop, dev) -> dict:
    """Every bucket x width x seed, kernel == plain bit for bit; then
    ragged batch lengths through DeviceDrawPlane.dispatch on the card.
    Returns the largest absolute error per kernel (the tolerance is 0)."""
    rng = np.random.default_rng(20261017)
    seeds = (2, (1 << 32) + 0xDEADBEEF)  # one key word, then both
    err = {"draw_flags": 0, "min_draw": 0}
    n_cmp = 0
    b = prop.MIN_BUCKET
    while b <= 65536:
        for rows, kern, plain in ((4, prop.draw_flags, prop.draw_flags_plain),
                                  (3, prop.min_draw, prop.min_draw_plain)):
            x = torch.from_numpy(sweep_inputs(rng, b, rows)).to(dev)
            for width in (1, 10, 64):
                for seed in seeds:
                    key = (seed & 0xFFFFFFFF, seed >> 32)
                    got = kern(x, key, width)
                    want = plain(x, key, width)
                    torch.cuda.synchronize()
                    e = abs_err(torch, got, want)
                    err[kern.__name__] = max(err[kern.__name__], e)
                    if got.dtype != want.dtype or e != 0:
                        fail(f"{kern.__name__} differs from its plain "
                             f"version at P={b} width={width} seed={seed}"
                             f" (max abs err {e})")
                    n_cmp += 1
        b <<= 1
    for n in (1, 255, 257, 700):
        for seed in seeds:
            plane = prop.DeviceDrawPlane(seed, 65536, max_pkts=10,
                                         device="cuda")
            x = sweep_inputs(rng, n, 4)
            got = plane.dispatch(*x).read()
            p = prop._bucket(n, 65536)
            pad = np.zeros((4, p), np.uint32)
            pad[:, :n] = x
            want = prop.draw_flags_plain(
                torch.from_numpy(pad).to(dev), plane._seed_key(None), 10)
            want = np.unpackbits(want.cpu().numpy(),
                                 bitorder="little")[:n].astype(bool)
            if not np.array_equal(got, want):
                fail(f"dispatch of {n} units differs from the plain version")
            gmin = plane.dispatch_min(*x[:3], min_bucket=plane.SPEC_BUCKET)
            pad = np.zeros((3, plane.SPEC_BUCKET), np.uint32)
            pad[:, :n] = x[:3]
            wmin = prop.min_draw_plain(
                torch.from_numpy(pad).to(dev), plane._seed_key(None), 10)
            if not np.array_equal(gmin.read(), wmin.cpu().numpy()[:n]):
                fail(f"dispatch_min of {n} units differs from the plain "
                     f"version")
            n_cmp += 2
    print(f"{n_cmp} kernel/plain comparisons, all bit-identical", flush=True)
    return err


# -- phase 5: the main path, with its draw windows kept ------------------------

@contextlib.contextmanager
def recording_windows(prop):
    """Keep a device copy of every (4, P) batch that DeviceDrawPlane hands
    the draw_flags wrapper while the block runs, with its key and width.
    The copy is made around the wrapper, so its launch count is untouched."""
    windows = []
    wrapper = prop.draw_flags

    def record(packed, seed_key, width):
        out = wrapper(packed, seed_key, width)
        windows.append((packed.clone(), tuple(int(k) for k in seed_key),
                        int(width)))
        return out

    prop.draw_flags = record
    try:
        yield windows
    finally:
        prop.draw_flags = wrapper


def window_mix(torch, prop, windows) -> dict:
    """What the recorded windows hold: buckets, units, npkts, thresholds,
    and the lanes the kernel needs (with and without its early exit)."""
    buckets: dict = {}
    for w, _, _ in windows:
        buckets[w.shape[1]] = buckets.get(w.shape[1], 0) + 1
    units = real_units(torch, windows)
    key, width = windows[0][1], windows[0][2]

    def top(v):
        vals, counts = torch.unique(v.to(torch.int64), return_counts=True)
        order = torch.argsort(counts, descending=True)[:6]
        return {int(vals[i]): int(counts[i]) for i in order}

    return {
        "windows": len(windows), "buckets": dict(sorted(buckets.items())),
        "units": units.shape[1],
        "max_units": max(int((w[2].long() > 0).sum())
                         for w, _, _ in windows),
        "npkts_top": top(units[2]), "thresh_top": top(units[3]),
        "thresh_zero_share": float((units[3] == 0).double().mean()),
        "lanes_all": lanes_needed(torch, prop, units, key, width, False),
        "lanes_early_exit": lanes_needed(torch, prop, units, key, width,
                                         True)}


# -- phase 6: kernel times on the main path's windows --------------------------

def lanes_needed(torch, prop, x, key, width: int, early_exit: bool) -> int:
    """Threefry evaluations the kernel needs for these inputs: every lane
    below min(npkts, width) for min_draw; for draw_flags only units with a
    threshold, up to and including the first lane that drops the unit."""
    draws, valid = prop._lane_draws(x, key, width)
    lanes = valid.sum(dim=1)
    if not early_exit:
        return int(lanes.sum())
    th = x[3].to(torch.int64)
    hit = (draws < th[:, None]) & valid
    first = torch.where(hit.any(1), hit.to(torch.int32).argmax(1) + 1,
                        lanes)
    return int(torch.where(th > 0, first, torch.zeros_like(first)).sum())


def spin_rate(torch) -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    torch.cuda._sleep(1000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def card_ms(torch, calls: list, rate: float, reps: int = 20,
            chunk: int = 64) -> float:
    """Card time per call of ``calls`` (zero-argument callables), by CUDA
    events. Each chunk of calls is queued behind a spin kernel that lasts
    long enough for the host to queue them all, so the card runs them back
    to back and the events time the card alone, not the host's launch
    cost. A chunk must stay within the driver's queue of pending launches
    (about a thousand), past which the host blocks until the card drains
    it. Median over ``reps`` of the total, divided by the calls."""
    for fn in calls[:3]:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls[:chunk]:
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2 * host_ms + 1
    totals = []
    for _ in range(reps):
        total = 0.0
        for i in range(0, len(calls), chunk):
            for _ in range(3):  # lengthen the spin if the host fell behind
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(int(rate * spin_ms))
                a.record()
                t0 = time.perf_counter()
                for fn in calls[i:i + chunk]:
                    fn()
                b.record()
                queued = not a.query()  # the card had not reached a yet
                took_ms = (time.perf_counter() - t0) * 1e3
                b.synchronize()
                if queued:
                    break
                spin_ms *= 4
            else:
                fail(f"the host took {took_ms:.3f} ms to queue {chunk} "
                     f"calls behind a {spin_ms / 4:.3f} ms spin and the "
                     f"card caught up; a card-only time cannot be taken")
            total += a.elapsed_time(b)
        totals.append(total)
    return statistics.median(totals) / len(calls)


def host_ms(torch, calls: list, reps: int = 20) -> float:
    """Time per call of ``calls`` issued back to back, by CUDA events: the
    host's launch cost included (whichever of host and card is slower)."""
    for fn in calls[:3]:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for fn in calls:
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / len(calls)


def profiled(torch, fn):
    """Run ``fn()`` under torch.profiler; returns (its result, a list of
    (name, device us) of the card's activity, or None when the profiler
    itself failed). Errors of ``fn`` propagate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as exc:  # the profiler, not the program, failed
        print(f"  torch.profiler did not start ({exc})", flush=True)
        prof = None
    try:
        result = fn()
        torch.cuda.synchronize()
    except BaseException:
        if prof is not None:
            with contextlib.suppress(Exception):
                prof.stop()
        raise
    if prof is None:
        return result, None
    try:
        prof.stop()
        device = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    except Exception as exc:  # the profiler, not the program, failed
        print(f"  torch.profiler did not report ({exc})", flush=True)
        return result, None
    return result, device


def profiler_ms(torch, calls: list, kernel: str):
    """Cross-check of card_ms: device time per launch of the CUDA kernel
    named ``kernel`` as torch.profiler saw it, or None (with what it did
    see) when it saw no launch of it."""
    def run():
        for fn in calls:
            fn()

    _, device = profiled(torch, run)
    if device is None:
        return None
    mine = [us for name, us in device if kernel in name]
    if not mine:
        names = sorted({name[:50] for name, _ in device})
        print(f"  torch.profiler saw no {kernel} in {len(device)} device "
              f"events ({len(calls)} calls); it saw {names}", flush=True)
        return None
    if len(mine) != len(calls):
        print(f"  torch.profiler saw {len(mine)} of {len(calls)} {kernel} "
              f"launches", flush=True)
    return sum(mine) / len(mine) / 1e3


def evenly(items: list, k: int) -> list:
    """At most ``k`` items, evenly spaced across ``items``."""
    if len(items) <= k:
        return list(items)
    return [items[i * len(items) // k] for i in range(k)]


def measure(torch, prop, name: str, inputs: list, key, width: int,
            rate: float, plane) -> dict:
    """One row of the timing table: ``name``'s kernel and plain version
    over ``inputs`` (a list of packed device tensors), each launched once
    per rep, with the bound for the same work."""
    kern = getattr(prop, name)
    plain = getattr(prop, f"{name}_plain")
    calls = [lambda x=x: kern(x, key, width) for x in inputs]
    plain_calls = [lambda x=x: plain(x, key, width) for x in inputs]
    host_arrays = [x.cpu().numpy() for x in inputs]
    if name == "draw_flags":
        trips = [lambda a=a: plane.dispatch(*a).read() for a in host_arrays]
    else:
        trips = [lambda a=a: plane.dispatch_min(
            *a, min_bucket=a.shape[1]).read() for a in host_arrays]
    nbytes = ops = 0
    for x in inputs:
        p = x.shape[1]
        nbytes += x.shape[0] * 4 * p + (p // 8 if name == "draw_flags"
                                        else 4 * p)
        ops += OPS_PER_LANE * lanes_needed(torch, prop, x, key, width,
                                           name == "draw_flags")
    t_bytes = nbytes / len(inputs) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / len(inputs) / PEAK_INT32_OPS_PER_S * 1e3
    row = {
        "P": sorted({x.shape[1] for x in inputs}), "calls": len(inputs),
        "ms": card_ms(torch, calls, rate),
        # the plain version is about 220 small kernels a call
        "plain_ms": card_ms(torch, plain_calls, rate, chunk=2),
        "profiler_ms": profiler_ms(torch, calls, f"{name}_kernel"),
        "launch_ms": host_ms(torch, calls),
        "plain_launch_ms": host_ms(torch, plain_calls),
        "dispatch_read_ms": host_ms(torch, trips),
        "bytes": nbytes / len(inputs), "ops": ops / len(inputs),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  {name} P={row['P']} x{row['calls']}: card {row['ms']:.6f} ms "
          f"(profiler {row['profiler_ms']}), plain {row['plain_ms']:.6f} ms,"
          f" with host launch {row['launch_ms']:.6f} / plain "
          f"{row['plain_launch_ms']:.6f} ms, dispatch+read "
          f"{row['dispatch_read_ms']:.6f} ms, bound {row['bound_ms']:.9f} "
          f"ms ({row['bound_by']})", flush=True)
    return row


def real_units(torch, windows):
    """(4, U) int64: the windows' real units (npkts > 0; the rest is the
    bucket's padding), in run order. int64, as PyTorch indexes no uint32
    tensor."""
    wide = [w.long() for w, _, _ in windows]
    return torch.cat([w[:, w[2] > 0] for w in wide], dim=1)


def spread_units(torch, windows, p: int, rows: int):
    """(rows, p) uint32: ``p`` of the windows' real units, evenly spaced
    across the run, as one full bucket."""
    units = real_units(torch, windows)
    idx = torch.linspace(0, units.shape[1] - 1, p,
                         device=units.device).round().to(torch.int64)
    return units[:rows, idx].to(torch.uint32).contiguous()


def time_kernels(torch, prop, windows) -> dict:
    """Per kernel: a headline row on the main path's own inputs, then rows
    at bigger buckets. draw_flags: 64 of the floor-1 run's windows evenly
    spaced across it (the headline; with more than one bucket in the run,
    a row per bucket too), then the 1024 and 65536 buckets filled with the
    run's units. min_draw (its consumer, speculation, comes with the C
    engine): the pinned 16384 bucket filled with the run's units."""
    rate = spin_rate(torch)
    key, width = windows[0][1], windows[0][2]
    plane = prop.DeviceDrawPlane((key[1] << 32) | key[0], 65536,
                                 max_pkts=width, device="cuda")
    packed = [w for w, _, _ in windows]
    rows = [measure(torch, prop, "draw_flags", evenly(packed, 64), key,
                    width, rate, plane)]
    buckets = sorted({w.shape[1] for w in packed})
    for p in buckets if len(buckets) > 1 else ():
        rows.append(measure(torch, prop, "draw_flags",
                            evenly([w for w in packed if w.shape[1] == p],
                                   64), key, width, rate, plane))
    for p in (1024, 65536):
        rows.append(measure(torch, prop, "draw_flags",
                            [spread_units(torch, windows, p, 4)] * 16, key,
                            width, rate, plane))
    spec = prop.DeviceDrawPlane.SPEC_BUCKET
    mins = [measure(torch, prop, "min_draw",
                    [spread_units(torch, windows, spec, 3)] * 16, key,
                    width, rate, plane)]
    return {"draw_flags": rows, "min_draw": mins}


def dispatch_breakdown(torch, prop, window, dev, n: int = 200) -> dict:
    """Host wall microseconds per step of one DeviceDrawPlane.dispatch of
    ``window`` (the steps of DeviceDrawPlane._launch, each timed alone over
    n repeats, then the whole dispatch)."""
    w, key, width = window
    x = w.cpu().numpy()
    p = x.shape[1]
    plane = prop.DeviceDrawPlane((key[1] << 32) | key[0], 65536,
                                 max_pkts=width, device="cuda")
    stage = torch.empty((4, p), dtype=torch.uint32, pin_memory=True)
    stage.numpy()[:] = x
    dev_in = stage.to(dev)
    dev_out = prop.draw_flags(dev_in, key, width)
    host = torch.empty(p // 8, dtype=torch.uint8, pin_memory=True)
    steps = {
        "pinned_alloc": lambda: torch.empty((4, p), dtype=torch.uint32,
                                            pin_memory=True),
        "stage_fill": lambda: stage.numpy().__setitem__(slice(None), x),
        "h2d": lambda: stage.to(dev, non_blocking=True),
        "launch": lambda: prop.draw_flags(dev_in, key, width),
        "d2h": lambda: host.copy_(dev_out, non_blocking=True),
        "event": lambda: torch.cuda.Event().record(),
        "dispatch": lambda: plane.dispatch(*x),
    }
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print(f"  dispatch host us at P={p}: "
          f"{json.dumps({k: round(v, 2) for k, v in out.items()})}",
          flush=True)
    return out


# -- phases 4, 5, 7: the port's CLI on the card --------------------------------

def run_cli(cli, argv: list) -> dict:
    """Run the port's CLI in this process; returns its JSON summary."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--json-summary", "--quiet"])
    if rc != 0:
        fail(f"shadow_tpu_torch {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_run(summary: dict, data_dir: str, digest, counts, tree,
              what: str) -> None:
    """The run had no process errors, and its counts and output tree are
    the reference's."""
    if summary["process_errors"]:
        fail(f"{what}: process errors {summary['process_errors']}")
    got = {k: summary[k] for k in counts}
    if got != counts:
        fail(f"{what}: counts {got} != reference {counts}")
    have = digest(data_dir)
    if have != tree:
        fail(f"{what}: output tree {have} != reference {tree}")


def trace_run(torch, cli, digest, tmp: str) -> None:
    """Profile one device-heavy run (checked against the reference); print
    the card's busy share."""
    d = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    s, device = profiled(torch, lambda: run_cli(cli, [
        str(EXAMPLES / "tgen_100host.yaml"), "--scheduler-policy",
        "tpu_batch", "--device", "cuda", "--set",
        "experimental.tpu_device_floor=1", "--data-directory", d]))
    wall = time.perf_counter() - t0
    check_run(s, d, digest, TGEN100_COUNTS, TGEN100_TREE_DIGEST,
              "tgen_100host (floor 1, profiled)")
    if s["device"]["windows_dispatched"] <= 0:
        fail("tgen_100host at floor 1 dispatched no window to the card")
    if device is None:
        print("trace: torch.profiler could not trace the card; busy share "
              "not measured", flush=True)
        return
    by_name: dict = {}
    for name, us in device:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"trace: tgen_100host floor 1 under the profiler: counts and tree "
          f"match the reference; wall {wall:.3f} s, "
          f"{s['device']['windows_dispatched']} windows, device busy "
          f"{busy_s:.6f} s = {busy_s / wall:.6f} of wall "
          f"(idle {1 - busy_s / wall:.6f}); device us by name: "
          f"{json.dumps({k[:60]: round(v, 1) for k, v in top})}",
          flush=True)


def main() -> int:
    phase("device")
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"cannot import torch/numpy: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    try:
        from shadow_tpu_torch import cli
        from shadow_tpu_torch.ops import devcfg
        from shadow_tpu_torch.ops import propagate as prop
        from shadow_tpu_torch.utils.digest import output_tree_digest
    except ImportError as exc:
        fail(f"cannot import the port (run from a checkout): {exc}")
    if not (EXAMPLES / "tgen_1k.yaml").exists():
        fail(f"{EXAMPLES} is missing (run from a checkout)")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)
    dev = torch.device("cuda", 0)

    phase("build")
    built = not any(devcfg.BUILD.glob("libdraw-*.so"))
    t0 = time.perf_counter()
    devcfg.kernel_lib("draw")
    print(f"kernel_lib('draw') {'built' if built else 'loaded'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    phase("kernels")
    max_err = check_kernels(torch, np, prop, dev)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    phase("echo")
    d = os.path.join(tmp, "echo")
    s = run_cli(cli, [str(EXAMPLES / "echo.yaml"), "--scheduler-policy",
                      "tpu_batch", "--device", "cuda",
                      "--data-directory", d])
    if s["process_errors"]:
        fail(f"echo: process errors {s['process_errors']}")
    tree = output_tree_digest(d)
    if tree != ECHO_TREE_DIGEST:
        fail(f"echo output tree {tree} != reference {ECHO_TREE_DIGEST}")
    print(f"echo: tree digest matches the reference ({tree[:16]})",
          flush=True)

    phase("main path")
    prop.reset_launches()
    runs = {}
    for label, extra in (("floor1", ["--set",
                                     "experimental.tpu_device_floor=1"]),
                         ("auto", [])):
        d = os.path.join(tmp, f"tgen_1k_{label}")
        argv = [str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy",
                "tpu_batch", "--device", "cuda", "--data-directory", d]
        t0 = time.perf_counter()
        if label == "floor1":
            with recording_windows(prop) as windows:
                s = run_cli(cli, argv + extra)
        else:
            s = run_cli(cli, argv + extra)
        wall = time.perf_counter() - t0
        check_run(s, d, output_tree_digest, TGEN1K_COUNTS,
                  TGEN1K_TREE_DIGEST, f"tgen_1k ({label})")
        runs[label] = s
        dv = s["device"]
        print(f"tgen_1k ({label}): counts and tree match the reference; "
              f"wall {wall:.3f} s (controller {s['wall_seconds']:.3f} s), "
              f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, "
              f"{dv['windows_dispatched']} windows (largest "
              f"{dv['max_window_units']} units), {dv['window_units']} "
              f"window units = "
              f"{dv['window_units'] / s['units_sent']:.4f} of units_sent, "
              f"phase_wall {json.dumps(s['phase_wall'])}", flush=True)
    launches = dict(prop.LAUNCHES)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if launches["draw_flags"] < runs["floor1"]["device"]["windows_dispatched"]:
        fail(f"draw_flags launched {launches['draw_flags']} times, fewer "
             f"than the {runs['floor1']['device']['windows_dispatched']} "
             f"windows the floor-1 run dispatched")
    if not windows:
        fail("the floor-1 run handed draw_flags no window")
    mix = window_mix(torch, prop, windows)
    print(f"floor-1 windows: {json.dumps(mix)}", flush=True)

    phase("timing")
    timing = time_kernels(torch, prop, windows)
    dispatch_breakdown(torch, prop, max(windows, key=lambda w: w[0].shape[1]),
                       dev)
    del windows

    phase("trace")
    trace_run(torch, cli, output_tree_digest, tmp)
    shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, rows in timing.items():
        head = rows[0]  # the main path's own inputs
        src, replaces = PLAN[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shapes": rows})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
