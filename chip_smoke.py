#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (shadow_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — a CUDA card is visible; prints its name and power limit.
2. build   — builds (or loads) the kernel libraries of shadow_tpu_torch/csrc
             with nvcc, one process per source, all at once; prints the
             seconds.
3. kernels — each draw kernel against its plain PyTorch version on the same
             inputs on the card, bit for bit (tolerance 0: integer math),
             over every bucket shape, ragged batch lengths, lane widths,
             thresholds and two seeds.
4. mesh kernels — mesh_exchange, mesh_round_step and mesh_scan against
             their plain versions, bit for bit, over N in {1, 2, 8} shards,
             m in the four exchange buckets with w at each, C in {256,
             2048}, K in {1, 8, 32}, two seeds (one above 2**32), a
             destination-skewed window, blackholed (rok = 0) units, the
             uint64 edge of the bucket math, need <= 0 rows and saturating
             rebases.
5. transport kernels — ack_advance against its plain version, bit for
             bit, over a sweep of both congestion controls, slow start and
             congestion avoidance, CUBIC epoch adoption, d < 0 and d > 0,
             now before the epoch, cwnd at or above the CUBIC target,
             w_max above 2**32 and newly up to 2**21, at n in {1, 17, 161,
             4096, 65536, 70000} rows and two seeds; and the whole
             DeviceAckKernel.run round trip against the numpy host version.
6. echo    — examples/echo.yaml through the port's CLI on the card; its
             output tree must equal the reference's (constant below).
7. main    — examples/tgen_1k.yaml under tpu_batch through the port's CLI
             on the card, once with tpu_device_floor=1 (every draw window
             on the card) and once as a user runs it (auto floor); both
             must give the reference's counts and output tree. Kernel
             launch counts are reset just before and read just after: every
             kernel must have launched. The floor-1 run keeps a copy of
             every window it hands draw_flags.
8. mesh path — examples/tgen_1k.yaml under tpu_mesh, once at
             tpu_mesh_floor=0 (every causal window through mesh_exchange)
             and once as a user runs it (default floor); the same counts
             and tree again. Launch counts reset before, read after:
             mesh_exchange must have launched once per window formed.
             Nothing wraps the program in these two runs; a third floor-0
             run, untimed, keeps a copy of every exchange window and the
             columns of every barrier batch.
9. mesh standalone — the standalone round API (MeshDataPlane.round_step
             and scan_rounds) at tgen_1k's size (1,000 hosts, 2,048 unit
             slots, K up to 32) on that run's own barrier batches, in
             order, the bucket state carried through all of them; 64
             round_steps and a sample of scans held against the plain
             versions; launch counts reset before, read after.
10. transport path — experimental.device_transport on, through the CLI:
             tgen_1k under tpu_batch with the device floor lowered to 1
             in this process (every cohort on the card) and as a user
             runs it (the reference's floor, 4096 rows); web_cdn_100k to
             1,500 ms at floor 1, and to 500 ms as a user runs it. Each gives the
             reference's counts, tree and (web_cdn_100k) last state digest;
             launch counts are reset before each leg and read after:
             ack_advance launches once per cohort sent to the card plus
             once for the attach's warm-up. The 1,500 ms leg keeps a copy
             of every cohort for the timing phase.
11. timing  — every kernel and its plain version timed on the main paths'
             own inputs: card time per launch, with the bound for the same
             work.
12. trace  — examples/tgen_100host.yaml under torch.profiler, at
             tpu_device_floor=1 under tpu_batch and at tpu_mesh_floor=0
             under tpu_mesh; counts and output tree must equal the
             reference's. Prints the card's busy share of each run's wall
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
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
#: examples/web_cdn_100k.yaml cut to a stop time (identical with the device
#: transport on and off), from
#:   python -m shadow_tpu examples/web_cdn_100k.yaml --scheduler-policy \
#:     tpu_batch --set experimental.native_colcore=false \
#:     --set experimental.device_transport=true --stop-time <t> \
#:     --state-digest-every <last round>
#: with the tree from shadow_tpu.fleet.output_tree_digest and the state
#: digest from the last line of state_digests.jsonl. At 500 ms no host has
#: written its log yet (the tree is empty), so the state digest of the last
#: round is what holds the run to the reference there.
WEB500_COUNTS = {"rounds": 62, "events": 71478, "units_sent": 59591,
                 "units_dropped": 0, "bytes_sent": 44159115}
WEB500_TREE_DIGEST = (
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855")
WEB500_STATE_DIGEST = (
    "416f6aa8ac3fe4127ff0ef5e1cfab4f87698e06abe94d93d8fd64935b03fcd64")
WEB1500_COUNTS = {"rounds": 562, "events": 2344677, "units_sent": 2382834,
                  "units_dropped": 0, "bytes_sent": 8755431092}
WEB1500_TREE_DIGEST = (
    "f2363262ec4fc7d2d00dde59c3265e6bcc33ff032f7048a7eef451375834367c")
WEB1500_STATE_DIGEST = (
    "f5098e07dbac31757bdcd2d44740b4bd263f60ef9166f94e75a37f0b96642ab3")

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

#: kernel -> (its source, the TPU program it replaces, the CUDA kernels
#: one wrapper call launches, as torch.profiler names them)
PLAN = {
    "draw_flags": ("shadow_tpu_torch/csrc/draw.cu",
                   "shadow_tpu/ops/propagate.py:85", ("draw_flags_kernel",)),
    "min_draw": ("shadow_tpu_torch/csrc/draw.cu",
                 "shadow_tpu/ops/propagate.py:58", ("min_draw_kernel",)),
    "mesh_exchange": ("shadow_tpu_torch/csrc/mesh.cu",
                      "shadow_tpu/parallel/mesh.py:222",
                      ("mesh_send_kernel", "mesh_recv_kernel")),
    "mesh_round_step": ("shadow_tpu_torch/csrc/mesh.cu",
                        "shadow_tpu/parallel/mesh.py:103",
                        ("mesh_round_step_kernel", "mesh_reduce_kernel")),
    "mesh_scan": ("shadow_tpu_torch/csrc/mesh.cu",
                  "shadow_tpu/parallel/mesh.py:202",
                  ("mesh_scan_kernel", "mesh_reduce_kernel")),
    "ack_advance": ("shadow_tpu_torch/csrc/transport.cu",
                    "shadow_tpu/ops/transport_kernels.py:112",
                    ("ack_advance_kernel",)),
}
#: the exchange buckets (MeshDataPlane.EXCHANGE_BUCKETS)
MESH_BUCKETS = (256, 1024, 4096, 16384)
#: MAX_RATE of network/fluid.py: the uint64 edge of the bucket math
MAX_RATE = 16_000_000_000


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


# -- phase 3: kernels against their plain versions ----------------------------

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


# -- phase 5: transport kernels against their plain version -------------------

#: the cube root's edges: around 0, 1, 2, 3 cubed and the top of its range
ICBRT_EDGES = (0, 1, 7, 8, 26, 27, (1 << 20) ** 3 - 1, (1 << 20) ** 3)


def ack_sweep(np, rng, n: int) -> tuple:
    """Nine (n,) int64 ack_advance input columns [cc_id, cwnd, ssthresh,
    w_max, epoch_start, snd_una, bytes_acked, cum_ack, now] covering: both
    congestion controls; slow start and congestion avoidance; CUBIC epoch
    adoption (epoch_start 0); CUBIC's d < 0 and d > 0 (now a few seconds
    or many hours past the epoch), and now before the epoch (a negative
    floor division); cwnd at or above the CUBIC target (the creep step);
    w_max above 2**32; newly from 1 to 2**21. cwnd >= MIN_CWND, as the
    transport keeps it."""
    min_cwnd = 2 * 1460
    cc_id = rng.integers(0, 2, n)
    cwnd = np.where(rng.random(n) < 0.2,
                    rng.choice(np.array([min_cwnd, min_cwnd + 1, 14600]), n),
                    rng.integers(min_cwnd, 1 << 34, n))
    ssthresh = np.where(rng.random(n) < 0.4, 1 << 62,
                        rng.integers(min_cwnd, 1 << 34, n))
    w_max = np.where(rng.random(n) < 0.3,
                     rng.choice(np.array([0, (1 << 32) - 1, 1 << 32,
                                          (1 << 32) + 1, 1 << 36]), n),
                     rng.integers(0, 1 << 36, n))
    now = rng.integers(10 ** 12, 10 ** 13, n)
    since = rng.choice(np.array([-1, 0, 1, 2]), n)
    gap = np.select([since == -1, since == 0, since == 1],
                    [-rng.integers(1, 10 ** 12, n),
                     rng.integers(0, 10 ** 9, n),
                     rng.integers(10 ** 9, 2 * 10 ** 11, n)],
                    rng.integers(2 * 10 ** 11, 10 ** 15, n))
    epoch_start = np.where(rng.random(n) < 0.25, 0, now - gap)
    snd_una = rng.integers(0, 1 << 40, n)
    newly = np.where(rng.random(n) < 0.2,
                     rng.choice(np.array([1, (1 << 20) - 1, 1 << 20,
                                          (1 << 20) + 1, 1 << 21]), n),
                     rng.integers(1, (1 << 21) + 1, n))
    bytes_acked = rng.integers(0, 1 << 40, n)
    cols = (cc_id, cwnd, ssthresh, w_max, epoch_start, snd_una,
            bytes_acked, snd_una + newly, now)
    return tuple(np.ascontiguousarray(c, dtype=np.int64) for c in cols)


#: row counts of the transport sweep: one row, the shipped configs' cohort
#: sizes, the reference's device floor, its top bucket and past it
ACK_SIZES = (1, 17, 161, 4096, 65536, 70000)


def check_transport_kernels(torch, np, tk, dev) -> int:
    """ack_advance against its plain version on the card, bit for bit,
    over the sweep at every size of ACK_SIZES and two seeds; then the
    whole DeviceAckKernel.run round trip (staging, copies, launch) against
    the numpy host version. Returns the largest absolute error (the
    tolerance is 0)."""
    err = 0
    n_cmp = 0
    kern = tk.DeviceAckKernel("cuda")
    for seed in (3, 20261017):
        rng = np.random.default_rng(seed)
        for n in ACK_SIZES:
            cols = ack_sweep(np, rng, n)
            x = torch.from_numpy(np.stack(cols)).to(dev)
            got = tk.ack_advance_device(x)
            want = torch.stack(tk.ack_advance_torch(*x.unbind(0)))
            torch.cuda.synchronize()
            err = max(err, same(torch, (got,), (want,),
                                f"ack_advance n={n} seed={seed}"))
            for i, (a, b) in enumerate(zip(kern.run(*cols),
                                           tk.ack_advance(*cols))):
                if not np.array_equal(a, b):
                    fail(f"DeviceAckKernel.run n={n} seed={seed} differs "
                         f"from the numpy host version in output {i}")
            n_cmp += 2
    print(f"{n_cmp} transport kernel comparisons, all bit-identical",
          flush=True)
    return err


# -- phase 4: mesh kernels against their plain versions -----------------------

def same(torch, got, want, what: str) -> int:
    """Largest absolute difference between two tuples of int64 tensors;
    fails unless they are equal in shape, dtype and every value."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what}: {tuple(a.shape)} {a.dtype} != plain "
                 f"{tuple(b.shape)} {b.dtype}")
        if a.numel():
            err = max(err, int((a - b).abs().max()))
        if not torch.equal(a, b):
            fail(f"{what}: differs from the plain version (max abs err "
                 f"{err})")
    return err


def exchange_inputs(np, rng, n: int, m: int, skew: bool):
    """(6, n, m) int64 exchange input: destinations over 1,000 hosts (all
    on shard 0 when ``skew``), arrival times, 64-bit uids, npkts in
    [-1, 12], thresholds {0, 1, 16106, 2**24} and random, 3/4 valid."""
    u = np.zeros((6, n, m), np.int64)
    u[0] = rng.integers(0, 1000, (n, m)) * (n if skew else 1)
    u[1] = rng.integers(0, 1 << 40, (n, m))
    u[2] = rng.integers(0, 1 << 58, (n, m))
    u[3] = rng.integers(-1, 13, (n, m))
    u[4] = np.where(rng.random((n, m)) < 0.7,
                    rng.choice(np.array([0, 1, 16106, 1 << 24]), (n, m)),
                    rng.integers(0, 1 << 24, (n, m)))
    u[5] = rng.random((n, m)) < 0.75
    return u


def round_tables(np, rng, n: int, h: int = 1000, g: int = 32):
    """(host_node, latency_ns, drop_thresh, rate, cap) for h hosts padded
    to a multiple of n, every seventh host at MAX_RATE (the uint64 edge)."""
    hs = -(-h // n)
    hp = hs * n
    lat = rng.integers(1_000_000, 60_000_000, (g, g))
    th = np.where(rng.random((g, g)) < 0.5, 0,
                  rng.choice(np.array([1, 16106, 1 << 24]), (g, g)))
    rate = rng.integers(125_000, MAX_RATE, hp)
    rate[::7] = MAX_RATE
    cap = np.maximum(16384, rate * 2_000_000 // 10 ** 9)
    cap = np.minimum(cap, (1 << 31) - 2)
    return (rng.integers(0, g, hp), lat, th, rate, cap), hs


def round_state(np, rng, tables, n: int, hs: int, t_now: int):
    """(3, n, hs) bucket state mixing, host by host: the uint64 edge (a
    refill interval ending at a second's last nanosecond; debt making
    need = k * rate + rate - 1 for a 60-byte first unit), full buckets
    (need <= 0), idle ones (a saturating rebase) and random state."""
    rate = tables[3].reshape(hs, n).T
    cap = tables[4].reshape(hs, n).T
    st = np.zeros((3, n, hs), np.int64)
    case = rng.integers(0, 4, (n, hs))
    case[rate == MAX_RATE] = 0
    for s_, j in zip(*np.nonzero(case == 0)):
        st[0, s_, j] = t_now - (3 * 10 ** 9 + 10 ** 9 - 1)
        st[2, s_, j] = 11 * rate[s_, j] + rate[s_, j] - 1 - 60
    full = case == 1
    st[0][full], st[1][full] = t_now, cap[full]
    idle = case == 2
    st[0][idle], st[1][idle] = t_now - 50 * 10 ** 9, cap[idle] // 3
    rnd = case == 3
    st[0][rnd] = t_now - rng.integers(0, 3 * 10 ** 9, int(rnd.sum()))
    st[1][rnd] = rng.integers(0, cap[rnd])
    st[2][rnd] = rng.integers(0, 4 * cap[rnd])
    return st


def round_units(np, rng, n: int, hs: int, c: int, t_now: int):
    """(6, n, c) int64 round input: per shard a random count of src-sorted
    units (the first ones 60 bytes, the rest up to 15,000), padding
    (src_l == hs) last, one unit in ten blackholed (rok = 0)."""
    u = np.zeros((6, n, c), np.int64)
    u[0] = hs
    for s_ in range(n):
        k = int(rng.integers(0, c + 1))
        u[0, s_, :k] = np.sort(rng.integers(0, hs, k))
        u[0, s_, :min(k, 1)] = 0  # shard 0's host 0 runs at MAX_RATE
    u[1] = rng.integers(0, hs * n, (n, c))
    u[2] = rng.integers(40, 15001, (n, c))
    u[2, :, :2] = 60
    u[3] = t_now + rng.integers(0, 2_000_000, (n, c))
    u[4] = rng.integers(0, 1 << 58, (n, c))
    u[5] = rng.random((n, c)) < 0.9
    return u


def check_mesh_kernels(torch, np, mesh, dev) -> dict:
    """Every mesh kernel against its plain version on the card over the
    sweep of the module docstring. Returns the largest absolute error per
    kernel (the tolerance is 0)."""
    rng = np.random.default_rng(20261018)
    seeds = (2, (1 << 32) + 0xDEADBEEF)  # one key word, then both
    err = {k: 0 for k in mesh.LAUNCHES}
    n_cmp = 0
    for n in (1, 2, 8):
        for m in MESH_BUCKETS:
            for skew in (False, True):
                x = torch.from_numpy(exchange_inputs(np, rng, n, m,
                                                     skew)).to(dev)
                for w in sorted({min(n * m, b) for b in MESH_BUCKETS}):
                    for seed in seeds:
                        got = mesh.mesh_exchange(x, seed, 10, w)
                        want = mesh.exchange_rounds_plain(x, seed, 10, w)
                        err["mesh_exchange"] = max(err["mesh_exchange"], same(
                            torch, got, want, f"mesh_exchange n={n} m={m} "
                            f"w={w} seed={seed} skew={skew}"))
                        n_cmp += 1
    for n in (1, 2, 8):
        tabs, hs = round_tables(np, rng, n)
        tables = tuple(torch.from_numpy(np.asarray(t, np.int64)).to(dev)
                       for t in tabs)
        t0 = 40 * 10 ** 9
        for c in (256, 2048):
            state = torch.from_numpy(round_state(np, rng, tabs, n, hs,
                                                 t0)).to(dev)
            for seed in seeds:
                st, t_now = state, t0
                for rnd in range(3):  # stateful: the kernel's state carries
                    units = torch.from_numpy(round_units(
                        np, rng, n, hs, c, t_now)).to(dev)
                    got = mesh.mesh_round_step(st, units, tables, t_now,
                                               seed, 10)
                    want = mesh.round_step_plain(st, units, tables, t_now,
                                                 seed, 10)
                    err["mesh_round_step"] = max(
                        err["mesh_round_step"], same(
                            torch, got, want, f"mesh_round_step n={n} c={c} "
                            f"seed={seed} round={rnd}"))
                    st = got[1]
                    t_now += 3 * 10 ** 9 + 10 ** 9 - 1
                    n_cmp += 1
                for k in (1, 8, 32):
                    units = torch.from_numpy(np.stack([round_units(
                        np, rng, n, hs, c, t0 + j * 2_000_000)
                        for j in range(k)])).to(dev)
                    t_nows = torch.arange(k, device=dev) * 2_000_000 + t0
                    got = mesh.mesh_scan(state, units, tables, t_nows, seed,
                                         10)
                    want = mesh.scan_rounds_plain(state, units, tables,
                                                  t_nows, seed, 10)
                    err["mesh_scan"] = max(err["mesh_scan"], same(
                        torch, got, want, f"mesh_scan n={n} c={c} k={k} "
                        f"seed={seed}"))
                    n_cmp += 1
    print(f"{n_cmp} mesh kernel/plain comparisons, all bit-identical",
          flush=True)
    return err


# -- phase 7: the main path, with its draw windows kept -----------------------

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


# -- phases 8 and 9: the mesh path and the standalone round API ---------------

@contextlib.contextmanager
def recording_exchanges(mesh):
    """Keep a device copy of every (6, N, m) window MeshDataPlane hands the
    mesh_exchange wrapper while the block runs, with its seed, width and
    w. The copy is made around the wrapper, so its launch count is
    untouched."""
    windows = []
    wrapper = mesh.mesh_exchange

    def record(units, seed, max_pkts, w):
        out = wrapper(units, seed, max_pkts, w)
        windows.append((units.clone(), seed, max_pkts, w))
        return out

    mesh.mesh_exchange = record
    try:
        yield windows
    finally:
        mesh.mesh_exchange = wrapper


@contextlib.contextmanager
def recording_barriers():
    """Keep the columns (t_now, src, dst, size, t_emit, uid, rok) of every
    barrier batch the mesh plane's runs form after bootstrap while the block
    runs, in order: what MeshDataPlane.round_step would take for that round
    (rok: the unit's route is not blackholed)."""
    import numpy as np

    from shadow_tpu_torch.network.colplane import ColumnarPlane
    from shadow_tpu_torch.network.graph import INF_I64

    barriers = []
    vector = ColumnarPlane._barrier_vector

    def record(self, rows, segs, round_start, round_end, uids_l=None):
        if self.mesh_plane is not None and round_start >= self.bootstrap_end:
            src, dst, size, t_emit, uid = self._batch_columns(rows, segs,
                                                              uids_l)
            p = self.params
            rok = self.graph.latency_ns[p.host_node[src],
                                        p.host_node[dst]] < INF_I64
            barriers.append((int(round_start), src, dst, size, t_emit,
                             uid.astype(np.int64), rok))
        return vector(self, rows, segs, round_start, round_end, uids_l)

    ColumnarPlane._barrier_vector = record
    try:
        yield barriers
    finally:
        ColumnarPlane._barrier_vector = vector


def traffic_mix(np, windows, barriers) -> dict:
    """What the recorded floor-0 run hands the mesh kernels: units per
    exchange window, and units, sizes and blackholed share per barrier."""
    per_window = [int((u[5] != 0).sum()) for u, _, _, _ in windows]
    per_barrier = np.array([len(b[1]) for b in barriers])
    sizes = np.concatenate([b[3] for b in barriers])
    rok = np.concatenate([b[6] for b in barriers])
    vals, counts = np.unique(sizes, return_counts=True)
    top = np.argsort(-counts)[:6]
    return {
        "windows": len(windows), "window_units": sum(per_window),
        "units_a_window": sum(per_window) / max(1, len(windows)),
        "largest_window": max(per_window, default=0),
        "buckets": sorted({u.shape[2] for u, _, _, _ in windows}),
        "barriers": len(barriers), "barrier_units": int(per_barrier.sum()),
        "units_a_barrier": float(per_barrier.mean()),
        "largest_barrier": int(per_barrier.max()),
        "size_top": {int(vals[i]): int(counts[i]) for i in top},
        "size_15000_share": float((sizes == 15000).mean()),
        "blackholed_share": float(1 - rok.mean())}


def mesh_path(cli, mesh, digest, tmp: str, device: str = "cuda") -> tuple:
    """tgen_1k under tpu_mesh at floor 0 and at the default floor, checked
    against the reference, with nothing around the program; then a third,
    untimed floor-0 run that records every exchange window and every
    barrier batch. Returns (launches of the first two runs, the windows,
    the barriers)."""
    mesh.reset_launches()
    runs = {}
    for label, extra in (("floor0", ["--set",
                                     "experimental.tpu_mesh_floor=0"]),
                         ("default", [])):
        d = os.path.join(tmp, f"tgen_1k_mesh_{label}")
        argv = [str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy",
                "tpu_mesh", "--device", device, "--data-directory", d]
        t0 = time.perf_counter()
        s = run_cli(cli, argv + extra)
        wall = time.perf_counter() - t0
        check_run(s, d, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
                  f"tgen_1k tpu_mesh ({label})")
        runs[label] = s
        pw = s["phase_wall"]
        mesh_keys = {k: v for k, v in pw.items() if k.startswith("mesh_")}
        print(f"tgen_1k tpu_mesh ({label}): counts and tree match the "
              f"reference; wall {wall:.3f} s (controller "
              f"{s['wall_seconds']:.3f} s), "
              f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, "
              f"{pw['mesh_windows']} windows; {json.dumps(mesh_keys)}; "
              f"phase_wall {json.dumps(pw)}", flush=True)
    launches = dict(mesh.LAUNCHES)
    print(f"launches on the mesh path: {json.dumps(launches)}", flush=True)
    formed = runs["floor0"]["phase_wall"]["mesh_windows"]
    if formed <= 0:
        fail("the floor-0 tpu_mesh run formed no exchange window")
    if launches["mesh_exchange"] < formed:
        fail(f"mesh_exchange launched {launches['mesh_exchange']} times, "
             f"fewer than the {formed} windows the floor-0 run formed")
    d = os.path.join(tmp, "tgen_1k_mesh_recorded")
    with recording_exchanges(mesh) as windows, \
            recording_barriers() as barriers:
        s = run_cli(cli, [str(EXAMPLES / "tgen_1k.yaml"),
                          "--scheduler-policy", "tpu_mesh", "--device",
                          device, "--data-directory", d, "--set",
                          "experimental.tpu_mesh_floor=0"])
    check_run(s, d, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
              "tgen_1k tpu_mesh (floor0, recorded)")
    pw = s["phase_wall"]
    print(f"tgen_1k tpu_mesh (floor0, recorded, untimed): controller "
          f"{s['wall_seconds']:.3f} s, {s['sim_sec_per_wall_sec']:.3f} "
          f"sim-s/wall-s, mesh_* "
          f"{pw['mesh_build'] + pw['mesh_dispatch'] + pw['mesh_readback']:.4f}"
          f" s (the recording's cost shows against the floor0 run above)",
          flush=True)
    if len(windows) != formed or not barriers:
        fail(f"the recorded floor-0 run kept {len(windows)} windows (the "
             f"timed run formed {formed}) and {len(barriers)} barriers")
    import numpy as np

    print(f"floor-0 traffic (recorded run, untimed): "
          f"{json.dumps(traffic_mix(np, windows, barriers))}", flush=True)
    return launches, windows, barriers


def mesh_standalone(torch, np, mesh, barriers, tmp: str,
                    device: str = "cuda", picks: int = 64,
                    scans_kept: int = 8) -> dict:
    """MeshDataPlane.round_step and scan_rounds at tgen_1k's size, fed the
    floor-0 run's own barrier batches in order, the bucket state carried
    from the first to the last. ``picks`` barriers spread over the run go
    through round_step, the runs of barriers between them through
    scan_rounds (7 barriers, then 1, then groups of up to 32; padded to K
    in {1, 8, 32}). Every
    round_step, the first group of each K and ``scans_kept`` K=32 groups
    spread over the run are held against the plain versions. Returns the
    launches, the largest absolute errors, the checked rounds and K=32
    groups (for timing), and the plane."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    cfg = load_config(str(EXAMPLES / "tgen_1k.yaml"), {
        "experimental.scheduler_policy": "tpu_mesh",
        "general.data_directory": os.path.join(tmp, "standalone")})
    ctrl = Controller(cfg, mirror_log=False, device=device)
    plane = ctrl.engine.mesh_plane  # the run's own plane: tgen_1k's params
    print(f"standalone plane: {plane.params.rate_up.shape[0]} hosts, "
          f"{plane.n_shards} shard(s) of {plane.hs}, "
          f"{plane.units_per_shard} unit slots; {len(barriers)} barriers",
          flush=True)
    seed, mp, tables = plane._seed, plane._max_pkts, plane._tables
    err = {"mesh_round_step": 0, "mesh_scan": 0}
    rounds, scans, seen_k = [], [], set()
    total = len(barriers)
    pick = set(evenly(list(range(total)), picks))
    pad = np.stack(plane.shard_units_np([], [], [], [], []))
    caps = [7, 1]  # the first two groups: K = 8 with a padding round, K = 1
    mesh.reset_launches()
    i = 0
    while i < total:
        if i in pick:
            t_now, *cols = barriers[i]
            units = plane.shard_units(*cols)
            before = plane.state.clone()
            recv, g_min, counters = plane.round_step(units, t_now)
            want = mesh.round_step_plain(before, units, tables, t_now, seed,
                                         mp)
            got = (torch.from_numpy(recv).to(units.device), plane.state,
                   torch.tensor([g_min], device=units.device),
                   torch.from_numpy(counters).to(units.device))
            err["mesh_round_step"] = max(err["mesh_round_step"], same(
                torch, got, want, f"MeshDataPlane.round_step barrier {i}"))
            rounds.append((before, units, t_now))
            i += 1
            continue
        cap = caps.pop(0) if caps else plane.SCAN_KMAX
        j = i
        while j < total and j - i < cap and j not in pick:
            j += 1
        part = [(plane.shard_units_np(*cols), t) for t, *cols in
                barriers[i:j]]
        k_real = j - i
        k = 1 if k_real == 1 else (8 if k_real <= 8 else plane.SCAN_KMAX)
        keep = k == plane.SCAN_KMAX and i >= len(scans) * total / scans_kept
        check = keep or k not in seen_k
        before = plane.state.clone() if check else None
        got = plane.scan_rounds(part)
        if check:
            dev = before.device
            units = torch.from_numpy(np.stack(
                [np.stack(c[0]) for c in part] + [pad] * (k - k_real))).to(
                dev)
            t_nows = torch.tensor([c[1] for c in part] + [part[-1][1]]
                                  * (k - k_real), device=dev)
            want = mesh.scan_rounds_plain(before, units, tables, t_nows,
                                          seed, mp)
            err["mesh_scan"] = max(err["mesh_scan"], same(
                torch, (torch.from_numpy(np.stack(got)).to(dev),
                        plane.state), (want[0][:k_real], want[1]),
                f"MeshDataPlane.scan_rounds K={k} from barrier {i}"))
            seen_k.add(k)
            if keep:
                scans.append((before, units, t_nows))
        i = j
    launches = dict(mesh.LAUNCHES)
    print(f"launches on the standalone round API: {json.dumps(launches)}; "
          f"checked {len(rounds)} round_steps and scans of K in "
          f"{sorted(seen_k)} ({len(scans)} K=32 groups kept)", flush=True)
    for name in ("mesh_round_step", "mesh_scan"):
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched by the standalone "
                 f"round API")
    if not scans:
        fail("the standalone round API formed no K=32 scan group")
    return {"launches": launches, "err": err, "rounds": rounds,
            "scans": scans, "ctx": (seed, mp, tables), "plane": plane}


# -- phase 10: the device transport through the CLI ---------------------------

@contextlib.contextmanager
def recording_cohorts(dt):
    """Keep a copy of the nine columns of every cohort the device transport
    hands the device path while the block runs. The copy is made around
    DeviceTransport._kernel, so no launch count moves."""
    cohorts = []
    kernel = dt.DeviceTransport._kernel

    def record(self, cols, n):
        if self._devk is not None and n >= dt._DEVICE_FLOOR:
            cohorts.append(tuple(c.copy() for c in cols))
        return kernel(self, cols, n)

    dt.DeviceTransport._kernel = record
    try:
        yield cohorts
    finally:
        dt.DeviceTransport._kernel = kernel


def last_state_digest(data_dir: str) -> str:
    """The digest on the last line of a run's state_digests.jsonl."""
    with open(os.path.join(data_dir, "state_digests.jsonl")) as f:
        return json.loads(f.read().strip().splitlines()[-1])["digest"]


def transport_path(cli, tk, dt, digest, tmp: str) -> tuple:
    """The device transport (experimental.device_transport) through the
    port's CLI, four legs, each with the launch count reset just before
    and read just after: tgen_1k under tpu_batch with every cohort on the
    card (the module's device floor lowered to 1 in this process), then
    as a user runs it (the reference's floor, so the two legs' transport
    ticks compare the card with the numpy host version on the same
    cohorts); web_cdn_100k at floor 1 to 1,500 ms, keeping a copy of every
    cohort; web_cdn_100k as a user runs it (the reference's floor) to
    500 ms. Each leg must give the reference's counts, tree and (for
    web_cdn_100k) last state digest, and launch ack_advance once per cohort
    it sent to the card, plus once for the attach's warm-up. Returns the
    launches of all legs and the recorded cohorts."""
    web = ["--set", "experimental.native_colcore=false"]
    legs = (
        ("tgen_1k floor1", "tgen_1k.yaml", 1, [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("tgen_1k user", "tgen_1k.yaml", None, [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("web_cdn_100k floor1 1500ms", "web_cdn_100k.yaml", 1,
         web + ["--stop-time", "1500ms", "--state-digest-every",
                str(WEB1500_COUNTS["rounds"])],
         WEB1500_COUNTS, WEB1500_TREE_DIGEST, WEB1500_STATE_DIGEST),
        ("web_cdn_100k user 500ms", "web_cdn_100k.yaml", None,
         web + ["--stop-time", "500ms", "--state-digest-every",
                str(WEB500_COUNTS["rounds"])],
         WEB500_COUNTS, WEB500_TREE_DIGEST, WEB500_STATE_DIGEST),
    )
    floor0 = dt._DEVICE_FLOOR
    launches = 0
    recorded = []
    for label, cfg, floor, extra, counts, tree, state in legs:
        d = os.path.join(tmp, label.replace(" ", "_"))
        argv = [str(EXAMPLES / cfg), "--scheduler-policy", "tpu_batch",
                "--device", "cuda", "--data-directory", d, "--set",
                "experimental.device_transport=true", *extra]
        dt._DEVICE_FLOOR = floor0 if floor is None else floor
        gc.collect()  # the previous leg's hosts, outside this leg's wall
        try:
            tk.reset_launches()
            t0 = time.perf_counter()
            if label.startswith("web_cdn_100k floor1"):
                with recording_cohorts(dt) as recorded:
                    s = run_cli(cli, argv)
            else:
                s = run_cli(cli, argv)
            wall = time.perf_counter() - t0
            n = tk.LAUNCHES["ack_advance"]
        finally:
            dt._DEVICE_FLOOR = floor0
        check_run(s, d, digest, counts, tree, f"{label} (device transport)")
        if state is not None and last_state_digest(d) != state:
            fail(f"{label}: last state digest {last_state_digest(d)} != "
                 f"reference {state}")
        dtr = s["device_transport"]
        print(f"{label}: counts, tree"
              f"{' and state digest' if state else ''} match the "
              f"reference; wall {wall:.3f} s (controller "
              f"{s['wall_seconds']:.3f} s), {s['sim_sec_per_wall_sec']:.6f}"
              f" sim-s/wall-s, ack_advance launches {n}, device_transport "
              f"{json.dumps(dtr)}, phase_wall {json.dumps(s['phase_wall'])}",
              flush=True)
        if n != dtr["device_cohorts"] + 1:
            fail(f"{label}: ack_advance launched {n} times, not once per "
                 f"device cohort ({dtr['device_cohorts']}) plus the "
                 f"attach's warm-up")
        if floor is not None and dtr["device_cohorts"] <= 0:
            fail(f"{label}: no cohort went to the card at floor {floor}")
        launches += n
    if not recorded:
        fail("the web_cdn_100k floor-1 leg recorded no cohort")
    sizes = [len(c[0]) for c in recorded]
    print(f"web_cdn_100k floor-1 cohorts: {len(sizes)}, rows "
          f"{sum(sizes)} (mean {sum(sizes) / len(sizes):.2f}, largest "
          f"{max(sizes)})", flush=True)
    return launches, recorded


# -- phase 11: kernel times on the main paths' inputs -------------------------

def lanes_needed(torch, prop, x, key, width: int, early_exit: bool) -> int:
    """Threefry evaluations the kernel needs for these inputs: every lane
    below min(npkts, width) for min_draw; for draw_flags only units with a
    threshold, up to and including the first lane that drops the unit."""
    draws, valid = prop._packed_draws(x, key, width)
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


def profiler_ms(torch, calls: list, kernels: tuple):
    """Cross-check of card_ms: device time per call of the CUDA kernels
    named in ``kernels`` (each call launches one of each) as torch.profiler
    saw them, or None (with what it did see) when it saw no launch."""
    def run():
        for fn in calls:
            fn()

    _, device = profiled(torch, run)
    if device is None:
        return None
    mine = [us for name, us in device if any(k in name for k in kernels)]
    if not mine:
        names = sorted({name[:50] for name, _ in device})
        print(f"  torch.profiler saw no {kernels} in {len(device)} device "
              f"events ({len(calls)} calls); it saw {names}", flush=True)
        return None
    want = len(calls) * len(kernels)
    if len(mine) != want:
        print(f"  torch.profiler saw {len(mine)} of {want} launches of "
              f"{kernels}", flush=True)
    return sum(mine) / len(mine) * len(kernels) / 1e3


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
        "profiler_ms": profiler_ms(torch, calls, PLAN[name][2]),
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


def mesh_lanes(torch, prop, uid, lanes, th, seed: int, width: int) -> int:
    """Threefry evaluations the mesh kernels need for these units (int64
    tensors): for each unit with a threshold, its lanes below
    min(lanes, width) up to and including the first that drops it (the
    kernels' early exit)."""
    m32 = 0xFFFFFFFF
    draws, valid = prop._lane_draws(uid & m32, (uid >> 32) & m32, lanes,
                                    (seed & m32, (seed >> 32) & m32), width)
    hit = (draws < th[:, None]) & valid
    first = torch.where(hit.any(1), hit.to(torch.int32).argmax(1) + 1,
                        valid.sum(1))
    return int(torch.where(th > 0, first, torch.zeros_like(first)).sum())


def exchange_work(torch, prop, units, seed: int, width: int, w: int) -> tuple:
    """(bytes, operations) of one mesh_exchange call. Bytes: the valid
    column of every one of the (N, m) slots, the other five fields of the
    valid units only, the (N, w, 4) table and g_min written once.
    Operations: 75 per threefry lane its valid units need."""
    n, m = units.shape[1:]
    ok = units[5] != 0
    n_ok = int(ok.sum())
    lanes = torch.clamp(units[3][ok], max=width) & 0xFFFFFFFF
    nbytes = n * m * 8 + 5 * 8 * n_ok + n * w * 32 + 8
    return nbytes, OPS_PER_LANE * mesh_lanes(
        torch, prop, units[2][ok], lanes, units[4][ok] & 0xFFFFFFFF, seed,
        width)


def round_work(torch, prop, state, units_k, tables, seed: int,
               width: int) -> tuple:
    """(bytes, operations) of K rounds in one call on (K, 6, N, C) units,
    the bucket state carried. Bytes: the state and every host's rate and
    cap read once and the state written once (the rebase touches every
    host); every slot's src_l column and the other five fields of the
    units in use (src_l < Hs); the table entries the routed units gather
    (host_node of their sources and destinations, latency and threshold of
    their node pairs), each distinct entry once; the (K, N, N, C, 4)
    tables, K g_min and K counter pairs written once. Operations: 75 per
    threefry lane the routed units need (thresholds gathered as the kernel
    does)."""
    host_node, _lat, thresh = tables[:3]
    k, _, n, c = units_k.shape
    hs = state.shape[2]
    h_pad = host_node.shape[0]
    src_l, dst_g, size, _te, uid, rok = units_k.unbind(1)
    used = src_l < hs
    route = used & (rok != 0)
    shard = torch.arange(n, device=units_k.device)[:, None]
    src_g = (torch.clamp(src_l, max=hs - 1) * n + shard)[route]
    dst_g = torch.clamp(dst_g[route], max=h_pad - 1)
    sn, dn = host_node[src_g], host_node[dst_g]
    g = thresh.shape[0]
    nbytes = (2 * state.numel() + 2 * h_pad) * 8 \
        + k * n * c * 8 + 5 * 8 * int(used.sum()) \
        + 8 * int(torch.unique(torch.cat([src_g, dst_g])).numel()) \
        + 16 * int(torch.unique(sn * g + dn).numel()) \
        + k * (n * n * c * 32 + 24)
    npk = torch.clamp(-((-size) // 1500), min=1, max=width)
    return nbytes, OPS_PER_LANE * mesh_lanes(
        torch, prop, uid[route], npk[route], thresh[sn, dn] & 0xFFFFFFFF,
        seed, width)


def measure_mesh(torch, name: str, calls: list, plain_calls: list,
                 nbytes: float, ops: float, rate: float, what: str) -> dict:
    """One row of the timing table for a mesh kernel: card time per call
    (queued behind a spin kernel), the profiler's, the plain version's,
    the host's launch cost, and the bound for ``nbytes`` and ``ops`` a
    call."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    row = {
        "inputs": what, "calls": len(calls),
        "ms": card_ms(torch, calls, rate),
        # the plain version is hundreds of small kernels a call (thousands
        # for a K-round scan, past the CUDA launch queue), so it is
        # timed back to back with the host's launch cost included
        "plain_ms": host_ms(torch, plain_calls, reps=5),
        "profiler_ms": profiler_ms(torch, calls, PLAN[name][2]),
        "launch_ms": host_ms(torch, calls),
        "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  {name} {what} x{row['calls']}: card {row['ms']:.6f} ms "
          f"(profiler {row['profiler_ms']}), plain with host launch "
          f"{row['plain_ms']:.6f} ms, kernel with host launch "
          f"{row['launch_ms']:.6f} ms, bound "
          f"{row['bound_ms']:.9f} ms ({row['bound_by']})", flush=True)
    return row


def time_mesh_kernels(torch, np, prop, mesh, windows, rounds, scans, ctx,
                      plane) -> dict:
    """mesh_exchange on 64 of the floor-0 run's windows spread over the run
    (the headline; a row per bucket when the run used several), with the
    host's whole MeshDataPlane.exchange_rounds of the same windows beside
    it; mesh_round_step on the standalone phase's rounds and mesh_scan on
    its K = 32 groups (the run's own barriers)."""
    rate = spin_rate(torch)
    seed, width, tables = ctx
    out = {"mesh_exchange": [], "mesh_round_step": [], "mesh_scan": []}
    buckets = sorted({u.shape[2] for u, _, _, _ in windows})
    groups = [("run windows", evenly(windows, 64))] + [
        (f"m={m}", evenly([x for x in windows if x[0].shape[2] == m], 64))
        for m in (buckets if len(buckets) > 1 else ())]
    for what, sel in groups:
        work = [exchange_work(torch, prop, u, s_, mp, w)
                for u, s_, mp, w in sel]
        row = measure_mesh(
            torch, "mesh_exchange",
            [lambda x=x: mesh.mesh_exchange(*x) for x in sel],
            [lambda x=x: mesh.exchange_rounds_plain(*x) for x in sel],
            sum(b for b, _ in work) / len(sel),
            sum(o for _, o in work) / len(sel), rate,
            f"{what} m={sorted({u.shape[2] for u, _, _, _ in sel})}")
        arrs = []
        for u, _, _, _ in sel:  # N = 1: the shard axis holds every unit
            ok = (u[5, 0] != 0).cpu().numpy()
            a = u[:5, 0].cpu().numpy()[:, ok]
            arrs.append((np.zeros(a.shape[1], np.int64), *a))
        row["plane_window_ms"] = host_ms(
            torch, [lambda a=a: plane.exchange_rounds(*a) for a in arrs],
            reps=5)
        print(f"  MeshDataPlane.exchange_rounds of those windows (build, "
              f"copy in, launch, wait, copy out): "
              f"{row['plane_window_ms']:.6f} ms a window", flush=True)
        out["mesh_exchange"].append(row)
    work = [round_work(torch, prop, st, u[None], tables, seed, width)
            for st, u, _ in rounds]
    used = sum(int((u[0] < st.shape[2]).sum()) for st, u, _ in rounds)
    out["mesh_round_step"].append(measure_mesh(
        torch, "mesh_round_step",
        [lambda r=r: mesh.mesh_round_step(r[0], r[1], tables, r[2], seed,
                                          width) for r in rounds],
        [lambda r=r: mesh.round_step_plain(r[0], r[1], tables, r[2], seed,
                                           width) for r in rounds],
        sum(b for b, _ in work) / len(rounds),
        sum(o for _, o in work) / len(rounds), rate,
        f"{len(rounds)} run barriers C={rounds[0][1].shape[-1]}, "
        f"{used / len(rounds):.2f} units a round"))
    work = [round_work(torch, prop, st, uk, tables, seed, width)
            for st, uk, _ in scans]
    k = scans[0][1].shape[0]
    used = sum(int((uk[:, 0] < st.shape[2]).sum()) for st, uk, _ in scans)
    out["mesh_scan"].append(measure_mesh(
        torch, "mesh_scan",
        [lambda g=g: mesh.mesh_scan(g[0], g[1], tables, g[2], seed, width)
         for g in scans],
        [lambda g=g: mesh.scan_rounds_plain(g[0], g[1], tables, g[2], seed,
                                            width) for g in scans[:2]],
        sum(b for b, _ in work) / len(scans),
        sum(o for _, o in work) / len(scans), rate,
        f"{len(scans)} groups of K={k} run barriers, "
        f"{used / len(scans) / k:.2f} units a round"))
    return out


#: integer operations of one ack_advance row, by the branch the row takes
#: (csrc/transport.cu): every row subtracts for newly, adds bytes_acked and
#: compares for slow start (3); slow start adds a min and an add (2);
#: NewReno's step is a multiply, a divide, a max and an add after the
#: cc_id compare (5); CUBIC's is the cc_id compare, epoch adoption (a
#: compare, two selects), t_ms (subtract, divide), the 2**32 cap, the cube
#: root's argument (multiply, divide, multiply), the cube root (21 trips
#: of add, add, shift, multiply, multiply, compare, select), d (subtract,
#: two clamps), |d|, delta (three multiplies, two divides), the target
#: (add or subtract, two clamps), the 2**20 cap, the target compare, and
#: the increment (subtract, min, multiply, divide, max, add, min)
ACK_OPS_BASE = 3
ACK_OPS_SLOW_START = 2
ACK_OPS_NEWRENO = 5
ACK_OPS_CUBIC = 1 + 3 + 2 + 1 + 3 + 21 * 7 + 3 + 1 + 5 + 3 + 1 + 1 + 7
#: bytes of one row: nine int64 inputs read, five int64 outputs written
ACK_BYTES_A_ROW = (9 + 5) * 8


def ack_work(np, cols) -> tuple:
    """(bytes, operations) of one ack_advance call on the nine columns
    ``cols``: the branch each row takes decides its operations."""
    cc_id, cwnd, ssthresh = cols[0], cols[1], cols[2]
    ss = cwnd < ssthresh
    cubic = ~ss & (cc_id == 1)
    ops = (len(cc_id) * ACK_OPS_BASE + int(ss.sum()) * ACK_OPS_SLOW_START
           + int(cubic.sum()) * ACK_OPS_CUBIC
           + int((~ss & ~cubic).sum()) * ACK_OPS_NEWRENO)
    return len(cc_id) * ACK_BYTES_A_ROW, ops


def spread_rows(np, cohorts, n: int) -> tuple:
    """Nine columns of ``n`` rows: the recorded cohorts' rows, evenly
    spaced across the run (repeated when the run had fewer)."""
    rows = [np.concatenate([c[i] for c in cohorts]) for i in range(9)]
    idx = np.linspace(0, len(rows[0]) - 1, n).round().astype(np.int64)
    return tuple(np.ascontiguousarray(r[idx]) for r in rows)


def time_transport_kernel(torch, np, tk, cohorts, dev) -> list:
    """ack_advance on 64 of the web_cdn_100k floor-1 leg's cohorts spread
    over the run (the headline), then on 4,096 and 65,536 of their rows:
    card time per launch (queued behind a spin kernel), the profiler's, the
    plain version's on the card, the host's launch cost, the whole
    DeviceAckKernel.run round trip and the numpy host version (which
    serves cohorts below the device floor) by the host clock, and the
    bound."""
    rate = spin_rate(torch)
    kern = tk.DeviceAckKernel("cuda")
    groups = [("run cohorts", evenly(cohorts, 64))] + [
        (f"{n} rows", [spread_rows(np, cohorts, n)] * 16)
        for n in (4096, 65536)]
    rows = []
    for what, sel in groups:
        xs = [torch.from_numpy(np.stack(c)).to(dev) for c in sel]
        work = [ack_work(np, c) for c in sel]
        nbytes = sum(b for b, _ in work) / len(sel)
        ops = sum(o for _, o in work) / len(sel)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
        calls = [lambda x=x: tk.ack_advance_device(x) for x in xs]
        plain = [lambda x=x: tk.ack_advance_torch(*x.unbind(0)) for x in xs]
        for c in sel[:3]:
            kern.run(*c)
        t0 = time.perf_counter()
        for _ in range(5):
            for c in sel:
                kern.run(*c)
        trip_ms = (time.perf_counter() - t0) * 1e3 / (5 * len(sel))
        t0 = time.perf_counter()
        for _ in range(5):
            for c in sel:
                tk.ack_advance(*c)
        numpy_ms = (time.perf_counter() - t0) * 1e3 / (5 * len(sel))
        row = {
            "inputs": what, "calls": len(sel),
            "rows_a_call": sum(len(c[0]) for c in sel) / len(sel),
            "ms": card_ms(torch, calls, rate),
            # about 200 small kernels a call
            "plain_ms": card_ms(torch, plain, rate, chunk=2),
            "profiler_ms": profiler_ms(torch, calls, PLAN["ack_advance"][2]),
            "launch_ms": host_ms(torch, calls),
            "round_trip_ms": trip_ms, "numpy_ms": numpy_ms,
            "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"  ack_advance {what} x{row['calls']} "
              f"({row['rows_a_call']:.2f} rows a call): card "
              f"{row['ms']:.6f} ms (profiler {row['profiler_ms']}), plain "
              f"{row['plain_ms']:.6f} ms, with host launch "
              f"{row['launch_ms']:.6f} ms, DeviceAckKernel.run round trip "
              f"{trip_ms:.6f} ms against the numpy host version's "
              f"{numpy_ms:.6f} ms (host clock), bound "
              f"{row['bound_ms']:.9f} ms ({row['bound_by']}); no single "
              f"PyTorch call computes this function", flush=True)
        rows.append(row)
    return rows


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


# -- phases 6-8, 10 and 12: the port's CLI on the card ------------------------

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


def trace_run(torch, cli, digest, tmp: str, policy: str = "tpu_batch") -> None:
    """Profile one device-heavy run of tgen_100host under ``policy``
    (tpu_batch at tpu_device_floor=1, tpu_mesh at tpu_mesh_floor=0),
    checked against the reference; print the card's busy share."""
    d = os.path.join(tmp, f"trace_{policy}")
    knob = ("experimental.tpu_device_floor=1" if policy == "tpu_batch"
            else "experimental.tpu_mesh_floor=0")
    label = f"{policy} {knob.split('.')[1]}"
    t0 = time.perf_counter()
    s, device = profiled(torch, lambda: run_cli(cli, [
        str(EXAMPLES / "tgen_100host.yaml"), "--scheduler-policy", policy,
        "--device", "cuda", "--set", knob, "--data-directory", d]))
    wall = time.perf_counter() - t0
    check_run(s, d, digest, TGEN100_COUNTS, TGEN100_TREE_DIGEST,
              f"tgen_100host ({label}, profiled)")
    windows = (s["device"]["windows_dispatched"] if policy == "tpu_batch"
               else s["phase_wall"]["mesh_windows"])
    if windows <= 0:
        fail(f"tgen_100host ({label}) sent no window to the card")
    if device is None:
        print(f"trace ({label}): torch.profiler could not trace the card; "
              f"busy share not measured", flush=True)
        return
    by_name: dict = {}
    for name, us in device:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"trace: tgen_100host {label} under the profiler: counts and "
          f"tree match the reference; wall {wall:.3f} s, "
          f"{windows} windows, device busy "
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
        from shadow_tpu_torch.network import devtransport as dt
        from shadow_tpu_torch.ops import propagate as prop
        from shadow_tpu_torch.ops import transport_kernels as tk
        from shadow_tpu_torch.parallel import mesh
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
    stems = ("draw", "mesh", "transport")
    built = [st for st in stems
             if not devcfg._lib_path(devcfg.CSRC / f"{st}.cu").exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(stems)) as pool:
        list(pool.map(devcfg.kernel_lib, stems))  # one nvcc each, at once
    print(f"kernel libraries {stems} ready in {time.perf_counter() - t0:.2f}"
          f" s (built: {built or 'none, all loaded'})", flush=True)

    phase("kernels")
    max_err = check_kernels(torch, np, prop, dev)

    phase("mesh kernels")
    max_err.update(check_mesh_kernels(torch, np, mesh, dev))

    phase("transport kernels")
    max_err["ack_advance"] = check_transport_kernels(torch, np, tk, dev)

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

    phase("mesh path")
    mesh_launches, mesh_windows, barriers = mesh_path(
        cli, mesh, output_tree_digest, tmp)
    launches["mesh_exchange"] = mesh_launches["mesh_exchange"]

    phase("mesh standalone")
    sa = mesh_standalone(torch, np, mesh, barriers, tmp)
    del barriers
    for name in ("mesh_round_step", "mesh_scan"):
        launches[name] = sa["launches"][name]
        max_err[name] = max(max_err[name], sa["err"][name])

    phase("transport path")
    launches["ack_advance"], cohorts = transport_path(
        cli, tk, dt, output_tree_digest, tmp)

    phase("timing")
    timing = time_kernels(torch, prop, windows)
    dispatch_breakdown(torch, prop, max(windows, key=lambda w: w[0].shape[1]),
                       dev)
    del windows
    timing.update(time_mesh_kernels(torch, np, prop, mesh, mesh_windows,
                                    sa["rounds"], sa["scans"], sa["ctx"],
                                    sa["plane"]))
    del mesh_windows, sa
    timing["ack_advance"] = time_transport_kernel(torch, np, tk, cohorts, dev)
    del cohorts

    phase("trace")
    trace_run(torch, cli, output_tree_digest, tmp, "tpu_batch")
    trace_run(torch, cli, output_tree_digest, tmp, "tpu_mesh")
    shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, rows in timing.items():
        head = rows[0]  # the main path's own inputs
        src, replaces, _ = PLAN[name]
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
