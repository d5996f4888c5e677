#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (shadow_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — a CUDA card is visible; prints its name and power limit.
2. build   — builds (or loads) the kernel libraries of shadow_tpu_torch/csrc
             with nvcc and the C engine (csrc/colcore.c) with cc, one
             process per source, all at once; prints the seconds.
3. kernels — each draw kernel against its plain PyTorch version on the same
             inputs on the card, bit for bit (tolerance 0: integer math),
             pads included: buckets of 32 to 65,536 units, real unit
             counts P, P/2 + 1, 1 and 0, lane widths 1, 10, 16, 31, 32,
             33 and 64, npkts 0 and above the width, thresholds 0, units
             hit on lane 0 only and on the last lane only, two seeds; the
             draw plane's page-locked slots (dispatches in flight read in
             reverse, buckets that shrink and grow, a min_draw result
             across its slot's reuse, a dropped handle, warm_shapes and
             calibrate) against a CPU plane; the threefry2x32 device
             function alone against its plain version on both of its
             load paths.
4. mesh kernels — mesh_exchange, mesh_round_step and mesh_scan against
             their plain versions, bit for bit, over N in {1, 2, 8, 16, 32}
             shards (both sides of the cluster limit), m in the exchange
             buckets with w at each, round tables of tgen_1k's size and
             past the shared-memory limit (20,000 hosts; G = 512), C in
             {64, 256, 2048, 257}, K in {1, 8, 32}, rounds whose real prefix
             is 0, 1, 255, 256, 257 and C units, two seeds (one above
             2**32), a destination-skewed window, blackholed (rok = 0)
             units, the uint64 edge of the bucket math, need <= 0 rows and
             saturating rebases; then MeshDataPlane.exchange_rounds over
             windows whose bucket grows and shrinks, against fresh CPU
             planes. Every launch path (cluster or pair,
             shared or device memory) must have been taken.
5. transport kernels — ack_advance against its plain version, bit for
             bit, over a sweep of both congestion controls, slow start and
             congestion avoidance, CUBIC epoch adoption, d < 0 and d > 0,
             now before the epoch, cwnd at or above the CUBIC target,
             w_max above 2**32 and newly up to 2**21, at n in {1, 17, 161,
             4096, 65536, 70000} rows and two seeds; the whole
             DeviceAckKernel.run round trip against the numpy host version;
             and the transport's slot path (page-locked AckSlots read and
             written in place, one launch a cohort) over buckets that grow
             and shrink, a slot reused with fewer rows (its rows past n
             untouched), both sides of the bucket edges, one row and the
             largest cohort, one slot a bucket.
6. apsp kernels — the min-plus squaring kernel against its plain version,
             whole runs of ceil(log2 G) squarings, latency with tolerance
             0 and reliability as exact float32 bits: G in {1, 2, 17}, the
             real topologies of topology_tornet400.gml, tor_1m.yaml and
             tgen_1k.yaml, and seeded graphs at G = 1,000 and 2,048 with
             ties, separate components and subnormal products.
7. echo    — examples/echo.yaml through the port's CLI on the card, on the
             Python columnar plane and on the C engine; its output tree
             must equal the reference's (constant below).
8. main    — examples/tgen_1k.yaml under tpu_batch on the Python columnar
             plane (native_colcore: false), once with tpu_device_floor=1
             (every draw window on the card) and once at the auto floor;
             both must give the reference's counts and output tree. Kernel
             launch counts are reset just before and read just after:
             every kernel must have launched. The floor-1 run keeps a copy
             of every window it hands draw_flags.
9. mesh path — examples/tgen_1k.yaml under tpu_mesh on the Python plane,
             once at tpu_mesh_floor=0 (every causal window through
             mesh_exchange) and once at the default floor; the same counts
             and tree again. Launch counts reset before, read after:
             mesh_exchange must have launched once per window formed.
             Nothing wraps the program in these two runs; a third floor-0
             run, untimed, keeps a copy of every exchange window and the
             columns of every barrier batch.
10. mesh standalone — the standalone round API (MeshDataPlane.round_step
             and scan_rounds) at tgen_1k's size (1,000 hosts, 2,048 unit
             slots, K up to 32) on that run's own barrier batches, in
             order, the bucket state carried through all of them; 64
             round_steps and a sample of scans held against the plain
             versions; launch counts reset before, read after.
11. transport path — experimental.device_transport on, on the Python plane
             (under the C engine it stands down), through the CLI:
             tgen_1k under tpu_batch with the device floor lowered to 1
             in this process (every cohort on the card) and as a user
             runs it (the reference's floor, 4096 rows); web_cdn_100k to
             500 ms at floor 1 and as a user runs it. Each gives the
             reference's counts, tree and (web_cdn_100k) last state digest;
             launch counts are reset before each leg and read after:
             ack_advance launches once per cohort sent to the card plus
             once for the attach's warm-up. The floor-1 web leg keeps a
             copy of every cohort for the timing phase.
12. engine path — the C engine, the user's default: tgen_1k under
             tpu_batch as a user runs it, again with the draw plane attached
             before round 0 (speculation runs from the start) and at
             tpu_device_floor=1; under tpu_mesh at floor 0 and at the
             default floor; web_cdn_100k at full width to 1,500 ms. Each
             gives the reference's counts, tree (and web_cdn_100k's last
             state digest) and reports native_colcore; launch counts are
             reset before each leg and read after: min_draw launches for
             the speculative waves, draw_flags at floor 1, mesh_exchange
             once per window at floor 0.
13. apsp path — apsp_device, the port's device-APSP entry point, on the
             card on the three real topologies: equal to the plain version
             and to graph.py's routing tables; launches reset before, read
             after.
14. timing  — every kernel and its plain version timed on the main paths'
             own inputs (APSP at G = 4,096): card time per launch or call,
             with the bound for the same work; the draw kernels as the
             plane launches them (on page-locked slots, in place) and on
             device memory; the draw plane's staging in place against one
             copy each way at P = 256, 16,384 and 65,536, and the steps
             of a window's dispatch and read on the host; for the mesh
             kernels also the kernels the profiler saw a call;
             mesh_exchange launched
             as the plane launches it, through an ExchangeStage on the
             floor-0 run's windows (reading and writing page-locked
             memory), and MeshDataPlane.exchange_rounds' host time a
             window; ack_advance as the transport launches it (in place
             on a page-locked slot) and on device memory, its staging in
             place against one copy each way at 161, 4,096 and 65,536
             rows, the steps of a cohort's round trip on the host, and the
             cohort size from which the card's round trip beats the numpy
             host version (the floor crossover).
15. trace  — examples/tgen_100host.yaml under torch.profiler on the Python
             plane, at tpu_device_floor=1 under tpu_batch and at
             tpu_mesh_floor=0 under tpu_mesh, and on the C engine at
             tpu_device_floor=1; counts and output tree must
             equal the reference's; under tpu_batch the profiler must see
             one draw kernel a window dispatch (a few dropped launches
             allowed) and no host<->device copy. Then phase 11's first
             transport leg with the draw plane off: one ack_advance_kernel
             a device cohort and no host<->device copy. Prints the card's busy
             share of each run's wall time and device time by kernel/copy
             name (a
             profiler that cannot trace the card is reported; the run's
             own failures are not caught).

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
    "threefry2x32": ("shadow_tpu_torch/csrc/threefry.cuh",
                     "shadow_tpu/ops/prng.py:30", ("threefry_kernel",)),
    "draw_flags": ("shadow_tpu_torch/csrc/draw.cu",
                   "shadow_tpu/ops/propagate.py:85", ("draw_flags_kernel",)),
    "min_draw": ("shadow_tpu_torch/csrc/draw.cu",
                 "shadow_tpu/ops/propagate.py:58", ("min_draw_kernel",)),
    "mesh_exchange": ("shadow_tpu_torch/csrc/mesh.cu",
                      "shadow_tpu/parallel/mesh.py:222",
                      ("mesh_exchange_kernel",)),
    "mesh_round_step": ("shadow_tpu_torch/csrc/mesh.cu",
                        "shadow_tpu/parallel/mesh.py:103",
                        ("mesh_rounds_kernel",)),
    "mesh_scan": ("shadow_tpu_torch/csrc/mesh.cu",
                  "shadow_tpu/parallel/mesh.py:202",
                  ("mesh_rounds_kernel",)),
    "ack_advance": ("shadow_tpu_torch/csrc/transport.cu",
                    "shadow_tpu/ops/transport_kernels.py:112",
                    ("ack_advance_kernel",)),
    "apsp": ("shadow_tpu_torch/csrc/apsp.cu", "shadow_tpu/ops/apsp.py:30",
             ("apsp_square_kernel",)),
}
#: the Python columnar plane: the earlier legs' engine, written out now
#: that the C engine is the default
PY_PLANE = ["--set", "experimental.native_colcore=false"]
#: the kernels whose bodies run the threefry2x32 device function: its
#: launches on the main paths are theirs
THREEFRY_INSIDE = ("draw_flags", "min_draw", "mesh_exchange",
                   "mesh_round_step", "mesh_scan")
#: integer operations of one threefry2x32 evaluation whose counters vary
#: from call to call: 20 rounds x (add, rotate, xor), 5 key injections x 2
#: adds, the two initial adds
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2
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


#: the draw sweep's lane widths (one lane a thread up to 32, two above)
#: and bucket sizes
DRAW_WIDTHS = (1, 10, 16, 31, 32, 33, 64)
DRAW_SIZES = tuple(32 << i for i in range(12))  # 32 .. 65,536


def lane_edges(torch, prop, x, key, width: int):
    """``x`` (4, P) with the thresholds of some units set so that exactly
    one lane drops them: lane 0 where it holds the unit's least draw, else
    the last lane where that one does (units of two lanes or more). Returns
    (the new batch, units hit on lane 0 only, on the last lane only)."""
    draws, valid = prop._packed_draws(x, key, width)
    d = torch.where(valid, draws, torch.full_like(draws, 1 << 24))
    lanes = valid.sum(1)
    least = d.min(1).values
    single = ((d == least[:, None]).sum(1) == 1) & (lanes >= 2)
    last = d.gather(1, (lanes - 1).clamp(min=0)[:, None])[:, 0]
    first_only = single & (d[:, 0] == least)
    last_only = single & ~first_only & (last == least)
    th = x[3].to(torch.int64)
    th = torch.where(first_only | last_only, least + 1, th)
    out = x.clone()
    out[3] = th.to(torch.uint32)
    return out, int(first_only.sum()), int(last_only.sum())


def draw_sweep(torch, np, prop, dev, rng, p: int, width: int, key):
    """The draw sweep's cases at bucket ``p``: (kernel, (rows, P) batch on
    the card, n) with n in {P, P/2 + 1, 1, 0}: sweep_inputs' npkts (0, 1,
    10, 64 and random, so both 0 and above the width) and thresholds (0, 1,
    2**24 and random), with lane_edges' single-lane hits."""
    x, first, last = lane_edges(
        torch, prop, torch.from_numpy(sweep_inputs(rng, p, 4)).to(dev), key,
        width)
    cases = []
    for n in sorted({p, p // 2 + 1, 1, 0}, reverse=True):
        cases.append(("draw_flags", x, n))
        cases.append(("min_draw", x[:3].contiguous(), n))
    return cases, first, last


def check_kernels(torch, np, prop, dev) -> dict:
    """Every bucket from 32 to 65,536 x width x seed x real unit count,
    kernel == plain bit for bit (pads included); then ragged batch lengths
    through DeviceDrawPlane.dispatch on the card, and the slots' hazards
    (check_slots). Returns the largest absolute error per kernel (the
    tolerance is 0)."""
    rng = np.random.default_rng(20261017)
    seeds = (2, (1 << 32) + 0xDEADBEEF)  # one key word, then both
    err = {"draw_flags": 0, "min_draw": 0}
    n_cmp = edges = 0
    for b in DRAW_SIZES:
        for width in DRAW_WIDTHS:
            for seed in seeds:
                key = (seed & 0xFFFFFFFF, seed >> 32)
                cases, first, last = draw_sweep(torch, np, prop, dev, rng,
                                                b, width, key)
                edges += first + last
                for name, x, n in cases:
                    got = getattr(prop, name)(x, key, width, n)
                    want = getattr(prop, f"{name}_plain")(x, key, width, n)
                    torch.cuda.synchronize()
                    e = abs_err(torch, got, want)
                    err[name] = max(err[name], e)
                    if got.dtype != want.dtype or e != 0:
                        fail(f"{name} differs from its plain version at "
                             f"P={b} n={n} width={width} seed={seed} (max "
                             f"abs err {e})")
                    pad = got[(n + 31) // 32 * (4 if name == "draw_flags"
                                                else 32):]
                    fill = 0 if name == "draw_flags" else prop.SENTINEL
                    if not bool((pad.to(torch.int64) == fill).all()):
                        fail(f"{name} P={b} n={n}: a pad is not {fill}")
                    n_cmp += 1
    if edges == 0:
        fail("the sweep built no single-lane hit")
    for n in (1, 255, 257, 700):
        for seed in seeds:
            plane = prop.DeviceDrawPlane(seed, 65536, max_pkts=10,
                                         device="cuda")
            x = sweep_inputs(rng, n, 4)
            got = plane.dispatch(*x).read()
            pad = np.zeros((4, prop._bucket(n, 65536)), np.uint32)
            pad[:, :n] = x
            want = prop.draw_flags_plain(
                torch.from_numpy(pad).to(dev), plane._seed_key(None), 10)
            want = np.unpackbits(want.cpu().numpy(),
                                 bitorder="little")[:n].astype(bool)
            if not np.array_equal(got, want):
                fail(f"dispatch of {n} units differs from the plain version")
            gmin = plane.dispatch_min(*x[:3], min_bucket=plane.SPEC_BUCKET)
            wmin = prop.min_draw_plain(
                torch.from_numpy(x[:3].copy()).to(dev),
                plane._seed_key(None), 10)
            if not np.array_equal(gmin.read(), wmin.cpu().numpy()):
                fail(f"dispatch_min of {n} units differs from the plain "
                     f"version")
            n_cmp += 2
    n_cmp += check_slots(torch, np, prop, rng)
    print(f"{n_cmp} kernel/plain comparisons ({edges} units hit on one "
          f"lane only), all bit-identical", flush=True)
    return err


def check_slots(torch, np, prop, rng) -> int:
    """The page-locked slots' hazards on the card, against a CPU plane:
    five dispatches in flight on one bucket read last first; buckets of
    65,536, 256 and 65,536 units in turn, the second large batch smaller
    than the first (a reused slot: no stale unit, pads rewritten); a
    min_draw result read before its slot is reused, unchanged after; a
    handle dropped unread; warm_shapes and calibrate through the slots.
    Returns the comparisons made."""
    seed = (1 << 32) + 77
    card = prop.DeviceDrawPlane(seed, 65536, device="cuda")
    host = prop.DeviceDrawPlane(seed, 65536, device="cpu")
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"draw slots: {what} differs from the CPU plane")
        n_cmp += 1

    batches = [sweep_inputs(rng, n, 4) for n in (200, 17, 256, 1, 90)]
    handles = [card.dispatch(*b) for b in batches]
    if card.slots("draw_flags", 256):
        fail("draw slots: a slot in flight was handed out twice")
    for b, h in reversed(list(zip(batches, handles))):
        same(h.read(), host.dispatch(*b).read(), f"in flight, n={len(b[0])}")
    for n in (60000, 200, 40000, 256, 65536, 1):
        b = sweep_inputs(rng, n, 4)
        h = card.dispatch(*b)
        slot = h._slot
        same(h.read(), host.dispatch(*b).read(), f"bucket sequence n={n}")
        pad = np.zeros((4, prop._bucket(n, 65536)), np.uint32)
        pad[:, :n] = b
        want = prop.draw_flags_plain(torch.from_numpy(pad),
                                     card._seed_key(None), card.max_pkts)
        same(slot.out, want.numpy(), f"whole slot after n={n}")
    spec = card.SPEC_BUCKET
    a, b = sweep_inputs(rng, 3000, 3), sweep_inputs(rng, 9000, 3)
    first = card.dispatch_min(*a, min_bucket=spec).read()
    kept = first.copy()
    second = card.dispatch_min(*b, min_bucket=spec).read()
    same(first, kept, "a min_draw result after its slot's reuse")
    same(first, host.dispatch_min(*a, min_bucket=spec).read(), "min_draw")
    same(second, host.dispatch_min(*b, min_bucket=spec).read(), "min_draw")
    h = card.dispatch_min(*a, min_bucket=spec)
    free = len(card.slots("min_draw", spec))
    del h
    if len(card.slots("min_draw", spec)) != free + 1:
        fail("draw slots: a dropped handle kept its slot")
    warm = prop.DeviceDrawPlane(seed, 4096, device="cuda")
    warm.warm_shapes()
    warm.calibrate()
    for n in (700, 3, 4096):
        b = sweep_inputs(rng, n, 4)
        same(warm.dispatch(*b).read(), host.dispatch(*b).read(),
             f"after warm_shapes and calibrate, n={n}")
    return n_cmp


def check_threefry(torch, np, prng, dev) -> int:
    """The threefry2x32 device function alone (threefry_kernel) against
    ops/prng.py's plain version on the card, bit for bit, at n in {1, 4,
    33, 4099, 65536, 65537} random counter pairs (its 16-byte path where
    n % 4 == 0, and its scalar path) and two keys (one with the high word
    set), and on counters that start 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(17)
    n_cmp = 0
    for n in (1, 4, 33, 4099, 65536, 65537):
        c = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(
            np.uint32)
        x = torch.from_numpy(c).to(dev)
        # the same counters 4 bytes past a 16-byte boundary: scalar loads
        shifted = torch.empty(2 * n + 1, dtype=torch.uint32, device=dev)
        shifted[1:] = x.view(-1)
        for x, key in ((x, (11, 0)), (x, (0xDEADBEEF, 0x12345678)),
                       (shifted[1:].view(2, n), (0xDEADBEEF, 0x12345678))):
            got = prng.threefry2x32_device(x, key)
            xi = x.to(torch.int64)
            want = torch.stack(prng.threefry2x32_torch(
                key[0], key[1], xi[0], xi[1]))
            if abs_err(torch, got, want):
                fail(f"threefry2x32 n={n} key={key}: kernel != plain")
            n_cmp += 1
    print(f"{n_cmp} threefry2x32 kernel/plain comparisons, all "
          f"bit-identical", flush=True)
    return 0


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
#: cohort sizes in the order the slot check sends them: buckets that grow
#: and shrink, a slot reused with fewer rows than before, each side of the
#: first bucket edges, one row, and the largest cohort (past the
#: reference's top bucket) twice
ACK_SLOT_SIZES = (161, 4096, 17, 1, 255, 256, 257, 70000, 65536, 65537,
                  300, 70000, 3, 161)


def check_ack_slots(torch, np, tk, dev, rng) -> int:
    """The transport's slot path on ``dev`` (a DeviceAckKernel's AckSlots,
    page-locked on a card, filled in place, one launch and one event a
    cohort) against the plain version on ``dev`` and the numpy host
    version, bit for bit, over ACK_SLOT_SIZES; where a slot is reused with
    fewer rows, its output past n must still hold what the earlier
    cohorts wrote there (no thread works on a pad); one slot a bucket must
    have been made. Returns the comparisons made."""
    kern = tk.DeviceAckKernel(dev.type)
    per_cohort = 1 if dev.type == "cuda" else 0  # plain runs do not count
    n_cmp = 0
    held = {}  # bucket -> the (5, m) outputs its slot holds
    for n in ACK_SLOT_SIZES:
        cols = ack_sweep(np, rng, n)
        before = tk.LAUNCHES["ack_advance"]
        slot = kern.slots.take(n)
        for r, c in enumerate(cols):
            slot.inp[r, :n] = c
        got = kern.advance(slot, n).copy()
        if tk.LAUNCHES["ack_advance"] != before + per_cohort:
            fail(f"ack slots: a cohort of {n} rows launched "
                 f"{tk.LAUNCHES['ack_advance'] - before} times")
        x = torch.from_numpy(np.stack(cols)).to(dev)
        plain = torch.stack(tk.ack_advance_torch(*x.unbind(0))).cpu().numpy()
        if got.shape != (5, n) or not np.array_equal(got, plain):
            fail(f"ack slots: n={n} in bucket {slot.p} differs from the "
                 f"plain version")
        if not np.array_equal(got, np.stack(tk.ack_advance(*cols))):
            fail(f"ack slots: n={n} differs from the numpy host version")
        n_cmp += 2
        want = held.get(slot.p)
        if want is not None and want.shape[1] > n:
            if not np.array_equal(slot.out[:, n:want.shape[1]], want[:, n:]):
                fail(f"ack slots: the kernel wrote past n={n} in bucket "
                     f"{slot.p}")
            want[:, :n] = got
            n_cmp += 1
        else:
            held[slot.p] = got
        kern.slots.give(slot)
    buckets = {tk.bucket(n) for n in ACK_SLOT_SIZES}
    if kern.slots.made != len(buckets):
        fail(f"ack slots: {kern.slots.made} slots made for "
             f"{len(buckets)} buckets")
    return n_cmp


def check_transport_kernels(torch, np, tk, dev) -> int:
    """ack_advance against its plain version on the card, bit for bit,
    over the sweep at every size of ACK_SIZES and two seeds; then the
    whole DeviceAckKernel.run round trip (a reused page-locked slot, read
    and written in place) against the numpy host version; then the slot
    path over growing and shrinking buckets (check_ack_slots). Returns the
    largest absolute error (the tolerance is 0)."""
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
    n_cmp += check_ack_slots(torch, np, tk, dev, np.random.default_rng(9))
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


def round_units(np, rng, n: int, hs: int, c: int, t_now: int,
                used: int | None = None):
    """(6, n, c) int64 round input: per shard a random count (or ``used``)
    of src-sorted units (the first ones 60 bytes, the rest up to 15,000),
    padding (src_l == hs) last, one unit in ten blackholed (rok = 0)."""
    u = np.zeros((6, n, c), np.int64)
    u[0] = hs
    for s_ in range(n):
        k = int(rng.integers(0, c + 1)) if used is None else min(used, c)
        u[0, s_, :k] = np.sort(rng.integers(0, hs, k))
        u[0, s_, :min(k, 1)] = 0  # shard 0's host 0 runs at MAX_RATE
    u[1] = rng.integers(0, hs * n, (n, c))
    u[2] = rng.integers(40, 15001, (n, c))
    u[2, :, :2] = 60
    u[3] = t_now + rng.integers(0, 2_000_000, (n, c))
    u[4] = rng.integers(0, 1 << 58, (n, c))
    u[5] = rng.random((n, c)) < 0.9
    return u


#: the mesh sweep's round shapes (N, hosts, G): tgen_1k's 1,000 hosts and
#: 32 nodes on every shard count (N = 16 and 32 on both sides of the
#: cluster limit), and tables past the shared-memory limit (20,000 hosts;
#: G = 512), which read device memory
MESH_ROUND_SHAPES = ((1, 1000, 32), (2, 1000, 32), (8, 1000, 32),
                     (16, 1000, 32), (32, 1000, 32), (1, 20000, 32),
                     (8, 1000, 512), (32, 20000, 32))
#: real prefixes (units a shard) of the rounds of the prefix sweep, each
#: capped at C
MESH_PREFIXES = (0, 1, 255, 256, 257, 1 << 30)
#: successive window sizes for the staged exchange: the bucket grows and
#: shrinks (20,000 units are two slices)
STAGED_WINDOWS = (700, 30, 5000, 200, 20000, 1, 3000, 40)


def check_mesh_kernels(torch, np, mesh, dev) -> dict:
    """Every mesh kernel against its plain version on the card over the
    sweep of the module docstring, every launch path counted; then the
    plane's staged exchange_rounds over windows whose bucket grows and
    shrinks, against fresh CPU planes. Returns the largest
    absolute error per kernel (the tolerance is 0)."""
    from shadow_tpu_torch.parallel.mesh import MeshDataPlane

    rng = np.random.default_rng(20261018)
    seeds = (2, (1 << 32) + 0xDEADBEEF)  # one key word, then both
    err = {k: 0 for k in mesh.LAUNCHES}
    n_cmp = 0
    mesh.reset_launches()
    for n in (1, 2, 8, 16, 32):
        for m in MESH_BUCKETS if n <= 8 else MESH_BUCKETS[:2]:
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
    for n, h, g in MESH_ROUND_SHAPES:
        tabs, hs = round_tables(np, rng, n, h, g)
        tables = tuple(torch.from_numpy(np.asarray(t, np.int64)).to(dev)
                       for t in tabs)
        t0 = 40 * 10 ** 9
        # 64: fewer slots than a block's threads; 257: columns not 16-byte
        # aligned
        for c in (64, 256, 2048, 257):
            state = torch.from_numpy(round_state(np, rng, tabs, n, hs,
                                                 t0)).to(dev)
            what = f"n={n} hosts={h} g={g} c={c}"
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
                            torch, got, want, f"mesh_round_step {what} "
                            f"seed={seed} round={rnd}"))
                    st = got[1]
                    t_now += 3 * 10 ** 9 + 10 ** 9 - 1
                    n_cmp += 1
                for k, used in ((1, None), (8, None), (32, None),
                                (len(MESH_PREFIXES), MESH_PREFIXES)):
                    units = torch.from_numpy(np.stack([round_units(
                        np, rng, n, hs, c, t0 + j * 2_000_000,
                        None if used is None else used[j])
                        for j in range(k)])).to(dev)
                    t_nows = torch.arange(k, device=dev) * 2_000_000 + t0
                    got = mesh.mesh_scan(state, units, tables, t_nows, seed,
                                         10)
                    want = mesh.scan_rounds_plain(state, units, tables,
                                                  t_nows, seed, 10)
                    err["mesh_scan"] = max(err["mesh_scan"], same(
                        torch, got, want, f"mesh_scan {what} k={k} "
                        f"prefixes={used} seed={seed}"))
                    n_cmp += 1
    for n in (1, 8, 32):
        err["mesh_exchange"] = max(err["mesh_exchange"], check_staged(
            np, rng, MeshDataPlane, n))
        n_cmp += len(STAGED_WINDOWS)
    paths = dict(mesh.PATHS)
    print(f"{n_cmp} mesh kernel/plain comparisons, all bit-identical; "
          f"launches {json.dumps(dict(mesh.LAUNCHES))}; paths "
          f"{json.dumps(paths)}", flush=True)
    missed = [k for k, v in paths.items() if v <= 0]
    if missed:
        fail(f"the mesh sweep never took the launch paths {missed}")
    return err


def check_staged(np, rng, plane_cls, n: int) -> int:
    """MeshDataPlane.exchange_rounds on the card over STAGED_WINDOWS in
    turn (one plane: its bucket buffers are reused as the windows grow and
    shrink), each window's tables against a fresh CPU plane's
    (exchange_rounds_plain). Returns the largest absolute error."""
    from shadow_tpu_torch.network.fluid import NetParams

    h, g = 1000, 32
    params = NetParams.build(
        host_node=rng.integers(0, g, h).astype(np.int32),
        rate_up=rng.integers(2_000_000, 50_000_000, h),
        rate_down=rng.integers(2_000_000, 50_000_000, h),
        latency_ns=rng.integers(1_000_000, 60_000_000, (g, g)),
        reliability=np.full((g, g), 0.97, np.float32),
        seed=(1 << 32) + 7, round_ns=2_000_000)
    plane = plane_cls(params, n_shards=n, device="cuda")
    err = 0
    for total in STAGED_WINDOWS:
        win = (rng.integers(0, h, total), rng.integers(0, h, total),
               rng.integers(0, 1 << 40, total),
               rng.integers(0, 1 << 58, total), rng.integers(1, 11, total),
               rng.choice(np.array([0, 1, 16106, 1 << 24]), total))
        want = plane_cls(params, n_shards=n, device="cpu").exchange_rounds(
            *win)
        got = plane.exchange_rounds(*win)
        what = f"MeshDataPlane.exchange_rounds n={n} window of {total}"
        if len(got) != len(want):
            fail(f"{what}: {len(got)} tables, want {len(want)}")
        for a, b in zip(got, want):
            if a.shape != b.shape or not np.array_equal(a, b):
                fail(f"{what}: differs from the plain version")
            err = max(err, int(np.abs(a - b).max(initial=0)))
    return err


# -- phase 8: the main path, with its draw windows kept -----------------------

@contextlib.contextmanager
def recording_draws(prop, kernel: str):
    """Keep every batch DeviceDrawPlane hands ``kernel`` (draw_flags: the
    windows; min_draw: the speculative waves) while the block runs, as
    (packed (rows, P) on the card with the units past the real ones
    zeroed, key, width, real units n). The launch is wrapped, so its count
    is untouched; the batch is copied on the host during the run and moved
    to the card after it."""
    import torch

    kept, records = [], []
    launch = prop.DrawSlot.launch

    def record(slot, n, seed_key, width, stream):
        if slot.kernel == kernel:
            kept.append((slot.inp[:, :n].copy(), slot.p,
                         tuple(int(k) for k in seed_key), int(width), n))
        return launch(slot, n, seed_key, width, stream)

    prop.DrawSlot.launch = record
    try:
        yield records
    finally:
        prop.DrawSlot.launch = launch
        for a, p, key, width, n in kept:
            x = torch.zeros((a.shape[0], p), dtype=torch.uint32)
            x[:, :n] = torch.from_numpy(a)
            records.append((x.to("cuda"), key, width, n))


def window_mix(torch, prop, windows) -> dict:
    """What the recorded windows hold: buckets, units, npkts, thresholds,
    and the lanes the kernel needs (with and without its early exit)."""
    buckets: dict = {}
    for w, *_ in windows:
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
        "max_units": max(n for *_, n in windows),
        "npkts_top": top(units[2]), "thresh_top": top(units[3]),
        "thresh_zero_share": float((units[3] == 0).double().mean()),
        "lanes_all": lanes_needed(torch, prop, units, key, width, False),
        "lanes_early_exit": lanes_needed(torch, prop, units, key, width,
                                         True)}


# -- phases 9 and 10: the mesh path and the standalone round API --------------

@contextlib.contextmanager
def recording_exchanges(mesh):
    """Keep a device copy of every (6, N, m) window MeshDataPlane stages for
    the card (ExchangeStage.dispatch) while the block runs, with its seed,
    width and w. The copy is made before the dispatch, so its launch count
    is untouched."""
    import torch

    windows = []
    dispatch = mesh.ExchangeStage.dispatch

    def record(self, seed, max_pkts, stream):
        windows.append((torch.from_numpy(self.units.copy()).to(
            stream.device), seed, max_pkts, self.shape[2]))
        return dispatch(self, seed, max_pkts, stream)

    mesh.ExchangeStage.dispatch = record
    try:
        yield windows
    finally:
        mesh.ExchangeStage.dispatch = dispatch


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
    """tgen_1k under tpu_mesh on the Python columnar plane at floor 0 and
    at the default floor, checked
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
                "tpu_mesh", "--device", device, "--data-directory", d,
                *PY_PLANE]
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
                          "experimental.tpu_mesh_floor=0", *PY_PLANE])
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


# -- phase 11: the device transport through the CLI ---------------------------

@contextlib.contextmanager
def recording_cohorts(dt):
    """Keep a copy of the nine columns of every cohort the device transport
    hands the device path while the block runs. The copy is made around
    DeviceTransport._kernel, from the slot the gather filled, so no launch
    count moves."""
    cohorts = []
    kernel = dt.DeviceTransport._kernel

    def record(self, slot, n):
        if slot.home is not self._host_slots:
            cohorts.append(tuple(c.copy() for c in slot.inp[:, :n]))
        return kernel(self, slot, n)

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
    cohorts); web_cdn_100k at floor 1 to 500 ms, keeping a copy of every
    cohort; web_cdn_100k as a user runs it (the reference's floor) to
    500 ms. Each leg must give the reference's counts, tree and (for
    web_cdn_100k) last state digest, and launch ack_advance once per cohort
    it sent to the card, plus once for the attach's warm-up. Every leg runs
    the Python columnar plane: under the C engine the device transport
    stands down. Returns the launches of all legs and the recorded
    cohorts."""
    legs = (
        ("tgen_1k floor1", "tgen_1k.yaml", 1, [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("tgen_1k user", "tgen_1k.yaml", None, [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("web_cdn_100k floor1 500ms", "web_cdn_100k.yaml", 1,
         ["--stop-time", "500ms", "--state-digest-every",
          str(WEB500_COUNTS["rounds"])],
         WEB500_COUNTS, WEB500_TREE_DIGEST, WEB500_STATE_DIGEST),
        ("web_cdn_100k user 500ms", "web_cdn_100k.yaml", None,
         ["--stop-time", "500ms", "--state-digest-every",
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
                "experimental.device_transport=true", *PY_PLANE, *extra]
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


# -- phase 14: kernel times on the main paths' inputs -------------------------

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


def profiler_ms(torch, calls: list, kernels: tuple, seen: dict = None):
    """Cross-check of card_ms: device time per call of the CUDA kernels
    named in ``kernels`` (each call launches one of each) as torch.profiler
    saw them, or None (with what it did see) when it saw no launch.
    ``seen``, when given, gets the kernels of every name (copies and sets
    left out) the profiler saw per call."""
    def run():
        for fn in calls:
            fn()

    _, device = profiled(torch, run)
    if device is None:
        return None
    if seen is not None:
        for name, _ in device:
            if not name.startswith(("Memcpy", "Memset")):
                seen[name[:60]] = seen.get(name[:60], 0) + 1 / len(calls)
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


def plane_slots(torch, prop, name: str, inputs: list) -> list:
    """One DrawSlot a distinct batch of ``inputs`` ((packed, key, width, n)
    on the card), filled with it: the plane's launch, in place."""
    slots, made = [], {}
    for x, key, width, n in inputs:
        slot = made.get(id(x))
        if slot is None:
            slot = made[id(x)] = prop.DrawSlot(name, x.shape[1], x.device)
            slot.inp[:] = x.cpu().numpy()
        slots.append((slot, key, width, n))
    return slots


def measure(torch, prop, name: str, inputs: list, rate: float,
            plane) -> dict:
    """One row of the timing table: ``name``'s kernel over ``inputs`` (a
    list of (packed on the card, key, width, real units n)), each launched
    once per rep: as the plane launches it (``ms``: reading and writing
    page-locked memory in place) and on device tensors (``device_ms``);
    its plain version; the plane's dispatch + read; the bound for the same
    work."""
    kern = getattr(prop, name)
    plain = getattr(prop, f"{name}_plain")
    stream = torch.cuda.current_stream()
    staged = [lambda s=s: s[0].launch(s[3], s[1], s[2], stream)
              for s in plane_slots(torch, prop, name, inputs)]
    calls = [lambda a=a: kern(*a) for a in inputs]
    plain_calls = [lambda a=a: plain(*a) for a in inputs]
    trips = []
    for x, key, width, n in inputs:
        a = x[:, :n].cpu().numpy()
        seed = (key[1] << 32) | key[0]
        trips.append(
            (lambda a=a, seed=seed: plane.dispatch(*a, seed=seed).read())
            if name == "draw_flags" else
            (lambda a=a, seed=seed, p=x.shape[1]: plane.dispatch_min(
                *a, min_bucket=p, seed=seed).read()))
    nbytes = ops = 0
    for x, key, width, n in inputs:
        p = x.shape[1]
        nbytes += x.shape[0] * 4 * n + (p // 8 if name == "draw_flags"
                                        else 4 * p)
        ops += OPS_PER_LANE * lanes_needed(torch, prop, x, key, width,
                                           name == "draw_flags")
    t_bytes = nbytes / len(inputs) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / len(inputs) / PEAK_INT32_OPS_PER_S * 1e3
    row = {
        "P": sorted({x.shape[1] for x, *_ in inputs}), "calls": len(inputs),
        "units_a_call": sum(n for *_, n in inputs) / len(inputs),
        "ms": card_ms(torch, staged, rate),
        "profiler_ms": profiler_ms(torch, staged, PLAN[name][2]),
        "device_ms": card_ms(torch, calls, rate),
        "device_profiler_ms": profiler_ms(torch, calls, PLAN[name][2]),
        # the plain version is about 220 small kernels a call
        "plain_ms": card_ms(torch, plain_calls, rate, chunk=2),
        "launch_ms": host_ms(torch, calls),
        "plain_launch_ms": host_ms(torch, plain_calls),
        "dispatch_read_ms": host_ms(torch, trips),
        "bytes": nbytes / len(inputs), "ops": ops / len(inputs),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  {name} P={row['P']} x{row['calls']} "
          f"({row['units_a_call']:.2f} units a call): card {row['ms']:.6f} "
          f"ms in place (profiler {row['profiler_ms']}), "
          f"{row['device_ms']:.6f} ms on device memory (profiler "
          f"{row['device_profiler_ms']}), plain {row['plain_ms']:.6f} ms, "
          f"with host launch {row['launch_ms']:.6f} / plain "
          f"{row['plain_launch_ms']:.6f} ms, dispatch+read "
          f"{row['dispatch_read_ms']:.6f} ms, bound {row['bound_ms']:.9f} "
          f"ms ({row['bound_by']})", flush=True)
    return row


def real_units(torch, windows):
    """(rows, U) int64: the batches' real units (the first n of each; the
    rest is the bucket's padding), in run order. int64, as PyTorch indexes
    no uint32 tensor."""
    return torch.cat([w[:, :n].long() for w, _, _, n in windows], dim=1)


def spread_units(torch, windows, p: int, rows: int) -> tuple:
    """``p`` of the windows' real units, evenly spaced across the run, as
    one full bucket: (packed (rows, p) uint32, key, width, p)."""
    units = real_units(torch, windows)
    idx = torch.linspace(0, units.shape[1] - 1, p,
                         device=units.device).round().to(torch.int64)
    _, key, width, _ = windows[0]
    return (units[:rows, idx].to(torch.uint32).contiguous(), key, width, p)


def time_kernels(torch, prop, windows, waves) -> dict:
    """Per kernel: a headline row on the main path's own inputs, then rows
    at bigger buckets. draw_flags: 64 of the floor-1 run's windows evenly
    spaced across it (the headline; with more than one bucket in the run,
    a row per bucket too), then the 1024 and 65536 buckets filled with the
    run's units. min_draw: the speculative waves the C engine's cached leg
    launched (the headline), then the pinned 16384 bucket filled with the
    floor-1 run's units."""
    rate = spin_rate(torch)
    key, width = windows[0][1], windows[0][2]
    plane = prop.DeviceDrawPlane((key[1] << 32) | key[0], 65536,
                                 max_pkts=width, device="cuda")
    rows = [measure(torch, prop, "draw_flags", evenly(windows, 64), rate,
                    plane)]
    buckets = sorted({w.shape[1] for w, *_ in windows})
    for p in buckets if len(buckets) > 1 else ():
        rows.append(measure(torch, prop, "draw_flags",
                            evenly([w for w in windows if w[0].shape[1] == p],
                                   64), rate, plane))
    for p in (1024, 65536):
        rows.append(measure(torch, prop, "draw_flags",
                            [spread_units(torch, windows, p, 4)] * 16, rate,
                            plane))
    spec = prop.DeviceDrawPlane.SPEC_BUCKET
    mins = [measure(torch, prop, "min_draw", evenly(waves, 64), rate, plane),
            measure(torch, prop, "min_draw",
                    [spread_units(torch, windows, spec, 3)] * 16, rate,
                    plane)]
    return {"draw_flags": rows, "min_draw": mins}


class CopyStaging:
    """The staging the draw plane does not use, for the comparison alone:
    one cudaMemcpyAsync each way between a page-locked DrawSlot and a
    device buffer of the same shape around the kernel."""

    def __init__(self, torch, prop, kernel: str, p: int, dev) -> None:
        self.prop = prop
        self.slot = prop.DrawSlot(kernel, p, dev)
        self.dev_in = torch.empty_like(self.slot.host_in, device=dev)
        self.dev_out = torch.empty_like(self.slot.host_out, device=dev)

    def launch(self, n: int, key, width: int, stream) -> None:
        slot = self.slot
        self.dev_in.copy_(slot.host_in, non_blocking=True)
        self.prop._launch_kernel(slot.kernel, self.dev_in.data_ptr(), slot.p,
                                 n, key, width, self.dev_out.data_ptr(),
                                 stream.cuda_stream)
        slot.host_out.copy_(self.dev_out, non_blocking=True)
        slot.event.record(stream)


def compare_staging(torch, np, prop, windows, waves, dev) -> list:
    """The draw plane's two stagings on the same batches, in turns (in
    place, copied, copied, in place): the kernel reading and writing the
    page-locked slot in place, against one cudaMemcpyAsync each way to a
    device buffer. At P = 256 (64 of the floor-1 run's windows), 16,384
    (the speculative waves) and 65,536 (the run's units filling the
    bucket): host ms of a round trip (fill the slot's real columns, launch,
    wait on the event, copy the result out) and card ms of the launch
    (with its copies). Returns a row per P."""
    rate = spin_rate(torch)
    stream = torch.cuda.current_stream()
    cases = (("draw_flags", evenly(windows, 64)),
             ("min_draw", evenly(waves, 64)),
             ("draw_flags", [spread_units(torch, windows, 65536, 4)] * 4))
    rows = []
    for name, batches in cases:
        p = batches[0][0].shape[1]
        host = [(x[:, :n].cpu().numpy(), key, width) for x, key, width, n
                in batches]
        stages = {"in_place": prop.DrawSlot(name, p, dev),
                  "copied": CopyStaging(torch, prop, name, p, dev)}

        def trips(design):
            stage = stages[design]
            slot = stage if design == "in_place" else stage.slot

            def trip(a, key, width):
                n = a.shape[1]
                slot.inp[:, :n] = a
                stage.launch(n, key, width, stream)
                slot.event.synchronize()
                return slot.out.copy()
            return [lambda h=h: trip(*h) for h in host]

        def launches(design):
            stage = stages[design]
            return [lambda h=h: stage.launch(h[0].shape[1], h[1], h[2],
                                             stream) for h in host]

        row = {"P": p, "kernel": name, "calls": len(batches),
               "units_a_call": sum(n for *_, n in batches) / len(batches)}
        for design in ("in_place", "copied", "copied", "in_place"):
            row.setdefault(f"{design}_trip_ms", []).append(
                host_ms(torch, trips(design)))
            row.setdefault(f"{design}_card_ms", []).append(
                card_ms(torch, launches(design), rate))
        rows.append(row)
        print(f"  staging {name} P={p} ({row['units_a_call']:.1f} units a "
              f"call): round trip ms in place {row['in_place_trip_ms']}, "
              f"copied {row['copied_trip_ms']}; card ms in place "
              f"{row['in_place_card_ms']}, copied {row['copied_card_ms']}",
              flush=True)
    return rows


def time_threefry(torch, prop, prng, windows, rate: float) -> list:
    """threefry2x32 alone on the counters of every packet lane the floor-1
    run's windows name (each unit's first min(npkts, width) lanes): the
    evaluations the draw kernels make on the main path, as one call."""
    units = real_units(torch, windows)
    key, width = windows[0][1], windows[0][2]
    lanes = torch.clamp(units[2], max=width)
    p = torch.arange(width, device=units.device)
    keep = p[None, :] < lanes[:, None]
    c0 = units[0][:, None].expand(-1, width)[keep]
    c1 = (units[1][:, None] | (p[None, :] << 26)).expand(-1, width)[keep]
    x = torch.stack([c0, c1]).to(torch.uint32).contiguous()
    n = x.shape[1]
    xi = x.to(torch.int64)
    calls = [lambda: prng.threefry2x32_device(x, key)]
    plain = [lambda: prng.threefry2x32_torch(key[0], key[1], xi[0], xi[1])]
    nbytes, ops = 16 * n, THREEFRY_OPS * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    row = {"inputs": f"{n} lanes of the floor-1 run's windows",
           "calls": 1, "ms": card_ms(torch, calls, rate),
           "plain_ms": card_ms(torch, plain, rate, chunk=1),
           "profiler_ms": profiler_ms(torch, calls, PLAN["threefry2x32"][2]),
           "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  threefry2x32 on {n} run lanes: card {row['ms']:.6f} ms "
          f"(profiler {row['profiler_ms']}), plain {row['plain_ms']:.6f} "
          f"ms, bound {row['bound_ms']:.9f} ms ({row['bound_by']}); "
          f"{row['bound_ms'] / row['ms']:.3f} of the bound", flush=True)
    return [row]


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
    (queued behind a spin kernel), the profiler's and the kernels it saw a
    call, the plain version's, the host's launch cost, and the bound for
    ``nbytes`` and ``ops`` a call."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    seen: dict = {}
    row = {
        "inputs": what, "calls": len(calls),
        "ms": card_ms(torch, calls, rate),
        # the plain version is hundreds of small kernels a call (thousands
        # for a K-round scan, past the CUDA launch queue), so it is
        # timed back to back with the host's launch cost included
        "plain_ms": host_ms(torch, plain_calls, reps=5),
        "profiler_ms": profiler_ms(torch, calls, PLAN[name][2], seen),
        "kernels_a_call": seen,
        "launch_ms": host_ms(torch, calls),
        "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  {name} {what} x{row['calls']}: card {row['ms']:.6f} ms "
          f"(profiler {row['profiler_ms']}, kernels a call "
          f"{json.dumps(seen)}), plain "
          f"with host launch {row['plain_ms']:.6f} ms, kernel with host "
          f"launch {row['launch_ms']:.6f} ms, bound "
          f"{row['bound_ms']:.9f} ms ({row['bound_by']})", flush=True)
    return row


def time_mesh_kernels(torch, np, prop, mesh, windows, rounds, scans, ctx,
                      plane) -> dict:
    """mesh_exchange on 64 of the floor-0 run's windows spread over the run
    (the headline; a row per bucket when the run used several), launched as
    the plane launches it: each window in an ExchangeStage of its bucket,
    the kernel reading the window from and writing its table to the
    stage's page-locked buffers; the host's whole
    MeshDataPlane.exchange_rounds of the same windows beside it;
    mesh_round_step on the standalone phase's rounds and mesh_scan on its
    K = 32 groups (the run's own barriers)."""
    rate = spin_rate(torch)
    seed, width, tables = ctx
    stream = torch.cuda.current_stream()
    out = {"mesh_exchange": [], "mesh_round_step": [], "mesh_scan": []}
    buckets = sorted({u.shape[2] for u, _, _, _ in windows})
    groups = [("run windows", evenly(windows, 64))] + [
        (f"m={m}", evenly([x for x in windows if x[0].shape[2] == m], 64))
        for m in (buckets if len(buckets) > 1 else ())]
    for what, sel in groups:
        work = [exchange_work(torch, prop, u, s_, mp, w)
                for u, s_, mp, w in sel]
        stages = []
        for u, s_, mp, w in sel:  # each window in a stage of its own
            st = mesh.ExchangeStage(*u.shape[1:], w, u.device)
            st.units[...] = u.cpu().numpy()
            st.dispatch(s_, mp, stream)
            want = torch.cat([t.reshape(-1) for t in
                              mesh.exchange_rounds_plain(u, s_, mp, w)])
            if not torch.equal(torch.from_numpy(st.out), want.cpu()):
                fail(f"mesh_exchange {what}: the staged window differs from "
                     f"the plain version")
            stages.append((st, s_, mp))
        row = measure_mesh(
            torch, "mesh_exchange",
            [lambda x=x: x[0].launch(x[1], x[2], stream) for x in stages],
            [lambda x=x: mesh.exchange_rounds_plain(*x) for x in sel],
            sum(b for b, _ in work) / len(sel),
            sum(o for _, o in work) / len(sel), rate,
            f"{what} m={sorted({u.shape[2] for u, _, _, _ in sel})}, "
            f"through ExchangeStage")
        arrs = []
        for u, _, _, _ in sel:  # N = 1: the shard axis holds every unit
            ok = (u[5, 0] != 0).cpu().numpy()
            a = u[:5, 0].cpu().numpy()[:, ok]
            arrs.append((np.zeros(a.shape[1], np.int64), *a))
        row["plane_window_ms"] = host_ms(
            torch, [lambda a=a: plane.exchange_rounds(*a) for a in arrs],
            reps=5)
        print(f"  MeshDataPlane.exchange_rounds of those windows (pack, "
              f"launch, wait, copy the table out): "
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


def ack_slots_of(tk, dev, sel: list) -> list:
    """(AckSlot, n) a cohort of ``sel``: one slot a distinct cohort,
    filled with it, as the transport's gather leaves it."""
    made, out = {}, []
    for c in sel:
        n = len(c[0])
        slot = made.get(id(c))
        if slot is None:
            slot = made[id(c)] = tk.AckSlot(tk.bucket(n), dev)
            for r, col in enumerate(c):
                slot.inp[r, :n] = col
        out.append((slot, n))
    return out


def read_rows(out, n: int) -> tuple:
    """What the transport reads of a cohort's result: cwnd', w_max' and
    epoch_start' of its n rows, as lists."""
    return out[2][:n].tolist(), out[3][:n].tolist(), out[4][:n].tolist()


def slot_trip(kern, cols) -> None:
    """The transport's round trip of one cohort (nine columns) on a slot of
    ``kern``, up to its five output rows on the host: take a slot, fill
    it, launch and wait on the event, give it back (DeviceAckKernel.run
    also copies the rows out of the slot)."""
    n = len(cols[0])
    slot = kern.slots.take(n)
    for r, c in enumerate(cols):
        slot.inp[r, :n] = c
    kern.advance(slot, n)
    kern.slots.give(slot)


def host_clock_ms(fns: list, reps: int = 5) -> float:
    """Host clock per call of ``fns`` (each synchronous), after a warm-up
    of three; the least of ``reps`` passes over all of them."""
    for fn in fns[:3]:
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / len(fns)


def time_transport_kernel(torch, np, tk, cohorts, dev) -> list:
    """ack_advance on 64 of the web_cdn_100k floor-1 leg's cohorts spread
    over the run (the headline), then on 4,096 and 65,536 of their rows:
    card time per launch (queued behind a spin kernel) as the transport
    launches it (on a page-locked AckSlot, in place) and on device tensors,
    the profiler's, the plain version's on the card, the host's launch
    cost; by the host clock, the transport's round trip (slot_trip), the
    whole DeviceAckKernel.run (the same and a copy of the five rows out)
    and the numpy host version (which serves cohorts below the device
    floor); and the bound."""
    rate = spin_rate(torch)
    stream = torch.cuda.current_stream()
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
        slots = ack_slots_of(tk, dev, sel)
        staged = [lambda s=s, n=n: s.launch(n, stream) for s, n in slots]
        calls = [lambda x=x: tk.ack_advance_device(x) for x in xs]
        plain = [lambda x=x: tk.ack_advance_torch(*x.unbind(0)) for x in xs]
        row = {
            "inputs": what, "calls": len(sel),
            "rows_a_call": sum(len(c[0]) for c in sel) / len(sel),
            "ms": card_ms(torch, staged, rate),
            "profiler_ms": profiler_ms(torch, staged, PLAN["ack_advance"][2]),
            "device_ms": card_ms(torch, calls, rate),
            "device_profiler_ms": profiler_ms(torch, calls,
                                              PLAN["ack_advance"][2]),
            # about 200 small kernels a call
            "plain_ms": card_ms(torch, plain, rate, chunk=2),
            "launch_ms": host_ms(torch, staged),
            "slot_trip_ms": host_clock_ms(
                [lambda c=c: slot_trip(kern, c) for c in sel]),
            "round_trip_ms": host_clock_ms(
                [lambda c=c: kern.run(*c) for c in sel]),
            "numpy_ms": host_clock_ms(
                [lambda c=c: tk.ack_advance(*c) for c in sel]),
            "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"  ack_advance {what} x{row['calls']} "
              f"({row['rows_a_call']:.2f} rows a call): card "
              f"{row['ms']:.6f} ms in place (profiler "
              f"{row['profiler_ms']}), {row['device_ms']:.6f} ms on device "
              f"memory (profiler {row['device_profiler_ms']}), plain "
              f"{row['plain_ms']:.6f} ms, with host launch "
              f"{row['launch_ms']:.6f} ms; host clock: slot round trip "
              f"{row['slot_trip_ms']:.6f} ms, DeviceAckKernel.run "
              f"{row['round_trip_ms']:.6f} ms, numpy host version "
              f"{row['numpy_ms']:.6f} ms; bound {row['bound_ms']:.9f} ms "
              f"({row['bound_by']}); no single PyTorch call computes this "
              f"function", flush=True)
        rows.append(row)
    return rows


class AckCopyStaging:
    """The staging the transport does not use, for the comparison alone:
    one cudaMemcpyAsync each way between a page-locked AckSlot and device
    buffers of the same shape around the kernel."""

    def __init__(self, torch, tk, p: int, dev) -> None:
        self.tk = tk
        self.slot = tk.AckSlot(p, dev)
        self.dev_in = torch.empty_like(self.slot.host_in, device=dev)
        self.dev_out = torch.empty_like(self.slot.host_out, device=dev)

    def launch(self, n: int, stream) -> None:
        slot = self.slot
        self.dev_in.copy_(slot.host_in, non_blocking=True)
        self.tk._launch(self.dev_in.data_ptr(), slot.p, n,
                        self.dev_out.data_ptr(), stream)
        slot.host_out.copy_(self.dev_out, non_blocking=True)
        slot.event.record(stream)


def compare_ack_staging(torch, np, tk, cohorts, dev) -> list:
    """The transport's two possible stagings on the same cohorts, in turns
    (in place, copied, copied, in place): the kernel reading and writing
    the page-locked slot in place, against one cudaMemcpyAsync of the
    whole slot each way to device buffers. On 64 of the web_cdn_100k
    floor-1 leg's cohorts and on 4,096 and 65,536 of their rows: host ms
    of a cohort's round trip (fill the slot's n columns, launch, wait on
    the event, copy the three rows the transport reads; their conversion
    to Python ints, the same for both, is left out) and card ms of the
    launch (with its copies). Returns a row per case."""
    rate = spin_rate(torch)
    stream = torch.cuda.current_stream()
    cases = [("run cohorts", evenly(cohorts, 64))] + [
        (f"{n} rows", [spread_rows(np, cohorts, n)] * 4)
        for n in (4096, 65536)]
    rows = []
    for what, sel in cases:
        stages = {"in_place": {}, "copied": {}}
        for c in sel:
            p = tk.bucket(len(c[0]))
            if p not in stages["in_place"]:
                stages["in_place"][p] = tk.AckSlot(p, dev)
                stages["copied"][p] = AckCopyStaging(torch, tk, p, dev)

        def stage_of(design, n):
            stage = stages[design][tk.bucket(n)]
            return stage, (stage if design == "in_place" else stage.slot)

        def trips(design):
            def trip(c):
                n = len(c[0])
                stage, slot = stage_of(design, n)
                for r, col in enumerate(c):
                    slot.inp[r, :n] = col
                stage.launch(n, stream)
                slot.event.synchronize()
                return slot.out[2:, :n].copy()
            return [lambda c=c: trip(c) for c in sel]

        def launches(design):
            return [lambda c=c: stage_of(design, len(c[0]))[0].launch(
                len(c[0]), stream) for c in sel]

        for c in sel:  # fill the slots once for the card-only times
            for design in stages:
                stage, slot = stage_of(design, len(c[0]))
                for r, col in enumerate(c):
                    slot.inp[r, :len(c[0])] = col
        row = {"inputs": what, "calls": len(sel),
               "rows_a_call": sum(len(c[0]) for c in sel) / len(sel),
               "buckets": sorted(stages["in_place"])}
        for design in ("in_place", "copied", "copied", "in_place"):
            row.setdefault(f"{design}_trip_ms", []).append(
                host_ms(torch, trips(design)))
            row.setdefault(f"{design}_card_ms", []).append(
                card_ms(torch, launches(design), rate))
        rows.append(row)
        print(f"  ack staging {what} ({row['rows_a_call']:.1f} rows a "
              f"call, buckets {row['buckets']}): round trip ms in place "
              f"{row['in_place_trip_ms']}, copied {row['copied_trip_ms']}; "
              f"card ms in place {row['in_place_card_ms']}, copied "
              f"{row['copied_card_ms']}", flush=True)
    return rows


def ack_breakdown(torch, tk, cohort, reps: int = 200) -> dict:
    """Host wall microseconds of each step of one cohort's round trip on
    the card, timed where they run: ``reps`` cohorts, each read before the
    next (as the transport does), through the steps of AckSlots.take,
    the gather's fill, AckSlot.launch, the event's wait, the transport's
    read and the slot's return, with a clock read between steps; then the
    same round trip as the transport makes it (take, fill,
    DeviceAckKernel.advance, read, give) and DeviceAckKernel.run (their sums
    and the steps' may differ by the clock's own cost)."""
    kern = tk.DeviceAckKernel("cuda")
    n = len(cohort[0])
    kern.run(*cohort)  # the bucket's slot
    names = ("bucket", "take_slot", "fill", "current_stream", "launch",
             "event_record", "wait", "read", "give")
    out = dict.fromkeys(names, 0.0)
    clock = time.perf_counter
    for _ in range(reps):
        t = [clock()]
        tk.bucket(n)
        t.append(clock())
        slot = kern.slots.take(n)
        t.append(clock())
        for r, c in enumerate(cohort):
            slot.inp[r, :n] = c
        t.append(clock())
        stream = torch.cuda.current_stream(kern.device)
        t.append(clock())
        tk._launch(slot._ptrs[0], slot.p, n, slot._ptrs[1], stream)
        t.append(clock())
        slot.event.record(stream)
        t.append(clock())
        slot.event.synchronize()
        t.append(clock())
        read_rows(slot.out, n)
        t.append(clock())
        kern.slots.give(slot)
        t.append(clock())
        for name, a, b in zip(names, t, t[1:]):
            out[name] += b - a

    def transport_trip():
        slot = kern.slots.take(n)
        for r, c in enumerate(cohort):
            slot.inp[r, :n] = c
        read_rows(kern.advance(slot, n), n)
        kern.slots.give(slot)

    for name, fn in (("round_trip", transport_trip),
                     ("run", lambda: kern.run(*cohort))):
        t0 = clock()
        for _ in range(reps):
            fn()
        out[name] = clock() - t0
    out = {k: v / reps * 1e6 for k, v in out.items()}
    print(f"  ack cohort host us ({n} rows): "
          f"{json.dumps({k: round(v, 2) for k, v in out.items()})}",
          flush=True)
    return out


#: cohort sizes of the floor crossover: the card's round trip against the
#: numpy host version
ACK_CROSSOVER_SIZES = (8, 16, 32, 64, 128, 161, 256, 512, 1024, 4096,
                       16384, 65536)


def ack_crossover(torch, np, tk, cohorts, floor: int) -> dict:
    """Where the card starts to beat the numpy host version on a cohort:
    at each size of ACK_CROSSOVER_SIZES (the web_cdn_100k floor-1 leg's
    rows, spread over the run), host ms from a filled slot to the three
    rows read, on the card (DeviceAckKernel.advance) and by the numpy host
    version on views of a plain slot's rows (as the transport serves a
    cohort below its floor); the fill is the same on both sides and left
    out. The crossover is the least size from which the card wins at
    every larger size measured (None if it never does)."""
    kern = tk.DeviceAckKernel("cuda")
    host = tk.AckSlots("cpu")
    sizes = {}
    for n in ACK_CROSSOVER_SIZES:
        cols = spread_rows(np, cohorts, n)
        card_slot, host_slot = kern.slots.take(n), host.take(n)
        for r, c in enumerate(cols):
            card_slot.inp[r, :n] = c
            host_slot.inp[r, :n] = c
        reps = max(20, min(400, 200_000 // n))
        card = [lambda: read_rows(kern.advance(card_slot, n), n)] * reps
        numpy = [lambda: read_rows(tk.ack_advance(*host_slot.inp[:, :n]),
                                   n)] * reps
        sizes[n] = {"card_ms": host_clock_ms(card),
                    "numpy_ms": host_clock_ms(numpy)}
        kern.slots.give(card_slot)
        host.give(host_slot)
    cross = None
    for n in reversed(ACK_CROSSOVER_SIZES):
        if sizes[n]["card_ms"] >= sizes[n]["numpy_ms"]:
            break
        cross = n
    print(f"  ack floor crossover: the card's round trip beats the numpy "
          f"host version from {cross} rows up (device floor {floor}); "
          f"ms by rows: "
          f"{json.dumps({n: {k: round(v, 6) for k, v in r.items()} for n, r in sizes.items()})}",
          flush=True)
    return {"crossover_rows": cross, "sizes": sizes}


def dispatch_breakdown(torch, prop, window, n: int = 200) -> dict:
    """Host wall microseconds of each step of a window's dispatch and read,
    timed where they run: n dispatches of ``window``, each read before the
    next (as on the main path), going through the steps of
    DeviceDrawPlane._launch, DrawSlot.launch and the handle's read in
    order with a clock read between steps; then the plane's own dispatch,
    read and round trip (their sum and the steps' may differ by the
    clock's own cost)."""
    w, key, width, units = window
    x = w[:, :units].cpu().numpy()
    plane = prop.DeviceDrawPlane((key[1] << 32) | key[0], 65536,
                                 max_pkts=width, device="cuda")
    plane.dispatch(*x).read()  # the bucket's slot
    names = ("bucket", "take_slot", "fill", "seed_key", "current_stream",
             "launch", "event_record", "handle", "wait", "read")
    out = dict.fromkeys(names, 0.0)
    clock = time.perf_counter
    for _ in range(n):
        t = [clock()]
        p = prop._bucket(units, plane.max_batch)
        t.append(clock())
        slot = plane.slots("draw_flags", p).pop()
        t.append(clock())
        for r in range(4):
            slot.inp[r, :units] = x[r]
        t.append(clock())
        seed_key = plane._seed_key(None)
        t.append(clock())
        stream = torch.cuda.current_stream(plane.device)
        t.append(clock())
        prop._launch_kernel("draw_flags", slot._ptrs[0], p, units, seed_key,
                            width, slot._ptrs[1], stream.cuda_stream)
        t.append(clock())
        slot.event.record(stream)
        t.append(clock())
        h = prop.DrawHandle(plane, slot, units)
        t.append(clock())
        slot.event.synchronize()
        t.append(clock())
        h.read()
        t.append(clock())
        for name, a, b in zip(names, t, t[1:]):
            out[name] += b - a
    for name in ("dispatch", "read_landed", "round_trip"):
        total = 0.0
        for _ in range(n):
            t0 = clock()
            h = plane.dispatch(*x)
            t1 = clock()
            if name == "read_landed":
                h._slot.event.synchronize()
                t1 = clock()
            h.read()
            total += {"dispatch": t1 - t0, "read_landed": clock() - t1,
                      "round_trip": clock() - t0}[name]
        out[name] = total
    out = {k: v / n * 1e6 for k, v in out.items()}
    print(f"  dispatch host us at P={w.shape[1]} ({units} units): "
          f"{json.dumps({k: round(v, 2) for k, v in out.items()})}",
          flush=True)
    return out


# -- phase 6: the APSP kernel against its plain version -----------------------

#: reliabilities of apsp_case's edges: ordinary losses, values whose
#: products go subnormal (1e-20, 2**-63, 2**-64), a subnormal operand
#: (1e-40) and the rounding edge just above 2**-126
APSP_RELS = (1.0, 0.99, 0.5, 1 - 2.0 ** -23, 1e-20, 2.0 ** -63,
             2.0 ** -64, 2.0 ** -126 * (1 + 2.0 ** -23), 2.0 ** -126,
             1e-40)


def apsp_case(np, rng, g: int) -> tuple:
    """A seeded one-hop graph of ``g`` nodes for the APSP checks: about
    four edges a node, half of them 1, 2 or 3 ms (many tied paths), the
    rest distinct; three components that no edge joins and 2 % of the
    nodes isolated (unreachable pairs); reliabilities from APSP_RELS,
    four edges in five from its ordinary first three.
    Returns (int64 latency with INF_I64 and a 0 diagonal, float32
    reliability with a 1.0 diagonal), apsp_device's input."""
    from shadow_tpu_torch.network.graph import INF_I64

    lat = np.full((g, g), INF_I64, dtype=np.int64)
    rel = np.zeros((g, g), dtype=np.float32)
    comp = rng.integers(0, 3, g)
    comp[rng.random(g) < 0.02] = -1
    src = np.repeat(np.arange(g), 4)
    dst = rng.integers(0, g, src.size)
    ok = (comp[src] == comp[dst]) & (comp[src] >= 0) & (src != dst)
    src, dst = src[ok], dst[ok]
    ns = np.where(rng.random(src.size) < 0.5,
                  rng.integers(1, 4, src.size) * 1_000_000,
                  rng.integers(1_000_000, 80_000_000, src.size))
    # one edge in five carries a tiny or edge-case reliability
    pick = np.where(rng.random(src.size) < 0.8,
                    rng.integers(0, 3, src.size),
                    rng.integers(3, len(APSP_RELS), src.size))
    r = np.array(APSP_RELS, dtype=np.float32)[pick]
    lat[src, dst] = lat[dst, src] = ns
    rel[src, dst] = rel[dst, src] = r
    np.fill_diagonal(lat, 0)
    np.fill_diagonal(rel, 1.0)
    return lat, rel


def apsp_topologies(np) -> list:
    """(name, latency, reliability) of the shipped configs' real
    topologies, as graph.py hands them to its APSP solve."""
    import yaml

    from shadow_tpu_torch.network.gml import parse_gml, parse_gml_file
    from shadow_tpu_torch.network.graph import apsp_inputs

    out = [("topology_tornet400 (G=30)", *apsp_inputs(parse_gml_file(
        str(EXAMPLES / "topology_tornet400.gml"))))]
    for name in ("tor_1m", "tgen_1k"):
        doc = yaml.safe_load((EXAMPLES / f"{name}.yaml").read_text())
        lat, rel = apsp_inputs(parse_gml(doc["network"]["graph"]["inline"]))
        out.append((f"{name} (G={lat.shape[0]})", lat, rel))
    return out


def apsp_tables(torch, np, lat, rel, dev) -> tuple:
    """apsp_device's int32 / float32 device tables of one graph."""
    from shadow_tpu_torch.network.graph import INF_I32

    return (torch.from_numpy(np.minimum(lat, int(INF_I32)).astype(
                np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(rel)).to(dev))


def apsp_err(torch, got, want, what: str) -> int:
    """Compare a squaring result with the plain version's: latency with
    tolerance 0, reliability as exact float32 bits; fail on any
    difference. Returns the largest absolute difference (0)."""
    err = max(abs_err(torch, got[0], want[0]),
              abs_err(torch, got[1].view(torch.int32),
                      want[1].view(torch.int32)))
    if err:
        fail(f"apsp {what}: kernel differs from the plain version "
             f"(largest difference {err})")
    return err


def check_apsp_kernels(torch, np, apsp, dev) -> int:
    """The squaring kernel against the plain version on the card, whole
    runs of ceil(log2 G) squarings: G in {1, 2, 17}, the real topologies,
    and seeded graphs at G = 1,000 and 2,048 (ties, separate components,
    subnormal products)."""
    cases = [(f"G={g}", *apsp_case(np, np.random.default_rng(g), g))
             for g in (1, 2, 17)]
    cases += apsp_topologies(np)
    cases += [(f"seeded G={g}", *apsp_case(np, np.random.default_rng(g), g))
              for g in (1000, 2048)]
    err = 0
    for what, lat, rel in cases:
        lat32, rel32 = apsp_tables(torch, np, lat, rel, dev)
        steps = apsp.squaring_steps(lat.shape[0])
        got = apsp.squarings(lat32, rel32, steps)
        want = apsp.squarings_plain(lat32, rel32, steps)
        torch.cuda.synchronize()
        err = max(err, apsp_err(torch, got, want, what))
        unreach = int((got[0] >= int(apsp.INF_I32)).sum())
        sub = int(((got[1] > 0) & (got[1] < 2.0 ** -126)).sum())
        zero = int((got[1] == 0).sum())
        print(f"  apsp {what}: {steps} squarings bit-identical "
              f"({unreach} unreachable pairs, {zero} zero and {sub} "
              f"subnormal reliabilities)", flush=True)
    return err


# -- phase 13: the device-APSP entry point ------------------------------------

def apsp_path(np, apsp) -> int:
    """apsp_device, the port's device-APSP entry point, on the card for
    each real topology, as a caller hands it graph.py's one-hop tables:
    the result equals the plain version's (on the CPU) array for array
    and graph.py's numpy routing table on reachable pairs. Returns the
    kernel's launches."""
    from shadow_tpu_torch.network.graph import INF_I64, _apsp_minplus

    topos = apsp_topologies(np)
    apsp.reset_launches()
    t0 = time.perf_counter()
    results = [apsp.apsp_device(lat, rel) for _, lat, rel in topos]
    wall = time.perf_counter() - t0
    launches = apsp.LAUNCHES["apsp"]
    for (what, lat, rel), (d_lat, d_rel) in zip(topos, results):
        p_lat, p_rel = apsp.apsp_device(lat, rel, device="cpu")
        if not (np.array_equal(d_lat, p_lat)
                and np.array_equal(d_rel.view(np.int32),
                                   p_rel.view(np.int32))):
            fail(f"apsp_device {what}: the card differs from the plain "
                 f"version on the CPU")
        n_lat, n_rel = _apsp_minplus(lat.copy(), rel.copy())
        reach = n_lat < INF_I64
        if not (np.array_equal(d_lat < INF_I64, reach)
                and np.array_equal(d_lat[reach], n_lat[reach])
                and np.array_equal(d_rel[reach], n_rel[reach])):
            fail(f"apsp_device {what}: differs from graph.py's routing "
                 f"table on reachable pairs")
    want = sum(apsp.squaring_steps(lat.shape[0]) for _, lat, _ in topos)
    print(f"apsp_device on {[w for w, _, _ in topos]}: equal to the plain "
          f"version and to graph.py's routing tables; {launches} launches "
          f"({want} squarings), {wall * 1e3:.3f} ms with copies and the "
          f"first call's load", flush=True)
    if launches != want:
        fail(f"apsp launched {launches} times for {want} squarings")
    return launches


def time_apsp(torch, np, apsp, rate: float, dev, g: int = 4096) -> list:
    """The APSP kernel on a seeded graph of ``g`` nodes (full-Tor
    topologies are a few thousand nodes): card time of the whole
    ceil(log2 G) squarings, the profiler's, the plain version's, and the
    bound. Operations: three a candidate (add, compare, select) over G**3
    candidates a squaring; bytes: each squaring reads and writes both
    (G, G) tables once."""
    lat, rel = apsp_case(np, np.random.default_rng(g), g)
    lat32, rel32 = apsp_tables(torch, np, lat, rel, dev)
    steps = apsp.squaring_steps(g)
    call = [lambda: apsp.squarings(lat32, rel32, steps)]
    ms = card_ms(torch, call, rate, reps=3, chunk=1)
    _, device = profiled(torch, call[0])
    prof = None
    if device is not None:
        # the profiler drops a launch now and then: scale its mean
        mine = [us for name, us in device if "apsp_square_kernel" in name]
        if mine:
            prof = sum(mine) / len(mine) * steps / 1e3
        if len(mine) != steps:
            print(f"  torch.profiler saw {len(mine)} of {steps} launches of "
                  f"apsp_square_kernel", flush=True)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = apsp.squarings_plain(lat32, rel32, steps)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    apsp_err(torch, call[0](), want, f"G={g}")
    nbytes = steps * 4 * 4 * g * g
    ops = 3 * g ** 3 * steps
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    row = {"G": g, "squarings": steps, "ms": ms, "profiler_ms": prof,
           "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  apsp G={g} ({steps} squarings): card {ms:.6f} ms (profiler "
          f"{prof}), plain {plain_ms:.3f} ms, bound {row['bound_ms']:.6f} "
          f"ms ({row['bound_by']}); {row['ms'] / row['bound_ms']:.3f}x the "
          f"bound", flush=True)
    return [row]


# -- phase 12: the C engine's legs, the user's default ------------------------

def engine_path(cli, prop, mesh, digest, tmp: str) -> tuple:
    """The C engine (experimental.native_colcore, the default) through the
    port's CLI: tgen_1k under tpu_batch as a user runs it (auto floor, the
    draw plane attaching in the background as in a fresh process), again
    with the plane attached before round 0 (a second auto run in one
    process finds it cached: speculation runs from the start), and at
    tpu_device_floor=1; under tpu_mesh at tpu_mesh_floor=0 and at the
    default floor; web_cdn_100k at full width to 1,500 ms as a user runs
    it. Launch counts are reset just before each leg and read just after.
    Each leg must give the reference's counts and tree (and, for
    web_cdn_100k, last state digest), report that the engine ran, and
    launch what its path launches: min_draw beyond its warm-up on the
    cached leg, draw_flags on the floor-1 leg, mesh_exchange once per
    window at floor 0. Returns the launches summed over the legs, the
    speculative waves the cached leg handed min_draw, and the legs'
    summaries."""
    tgen = str(EXAMPLES / "tgen_1k.yaml")
    legs = (
        ("tgen_1k tpu_batch user", tgen, "tpu_batch", [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("tgen_1k tpu_batch cached", tgen, "tpu_batch", [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("tgen_1k tpu_batch floor1", tgen, "tpu_batch",
         ["--set", "experimental.tpu_device_floor=1"], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("tgen_1k tpu_mesh floor0", tgen, "tpu_mesh",
         ["--set", "experimental.tpu_mesh_floor=0"], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("tgen_1k tpu_mesh default", tgen, "tpu_mesh", [], TGEN1K_COUNTS,
         TGEN1K_TREE_DIGEST, None),
        ("web_cdn_100k user 1500ms", str(EXAMPLES / "web_cdn_100k.yaml"),
         "tpu_batch", ["--stop-time", "1500ms", "--state-digest-every",
                       str(WEB1500_COUNTS["rounds"])], WEB1500_COUNTS,
         WEB1500_TREE_DIGEST, WEB1500_STATE_DIGEST),
    )
    total = {k: 0 for k in ("draw_flags", "min_draw", "mesh_exchange")}
    summaries, waves = {}, []
    for label, cfg, policy, extra, counts, tree, state in legs:
        d = os.path.join(tmp, "engine_" + label.replace(" ", "_"))
        argv = [cfg, "--scheduler-policy", policy, "--device", "cuda",
                "--data-directory", d, *extra]
        if label.endswith("user"):
            # a fresh process has attached no draw plane yet
            prop.DeviceDrawPlane._cache.clear()
        gc.collect()  # the previous leg's hosts, outside this leg's wall
        prop.reset_launches()
        mesh.reset_launches()
        t0 = time.perf_counter()
        if label.endswith("cached"):
            with recording_draws(prop, "min_draw") as waves:
                s = run_cli(cli, argv)
        else:
            s = run_cli(cli, argv)
        wall = time.perf_counter() - t0
        n = {**prop.LAUNCHES, "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
        check_run(s, d, digest, counts, tree, f"{label} (C engine)")
        if state is not None and last_state_digest(d) != state:
            fail(f"{label} (C engine): last state digest "
                 f"{last_state_digest(d)} != reference {state}")
        if s.get("native_colcore") is not True:
            fail(f"{label}: the C engine did not run "
                 f"(native_colcore {s.get('native_colcore')!r})")
        if "device_transport" in s:
            fail(f"{label}: the device transport ran beside the C engine")
        summaries[label] = s
        dv = s["device"]
        print(f"{label} (C engine): counts, tree"
              f"{' and state digest' if state else ''} match the "
              f"reference; wall {wall:.3f} s (controller "
              f"{s['wall_seconds']:.3f} s), {s['sim_sec_per_wall_sec']:.6f}"
              f" sim-s/wall-s, launches {json.dumps(n)}, device "
              f"{json.dumps(dv)}, phase_wall {json.dumps(s['phase_wall'])}",
              flush=True)
        if label.endswith("cached") and n["min_draw"] <= 0:
            fail(f"{label}: no speculative min_draw wave was launched")
        if label.endswith("floor1") and n["draw_flags"] <= 0:
            fail(f"{label}: draw_flags was never launched at floor 1")
        if label.endswith("floor0"):
            formed = s["phase_wall"]["mesh_windows"]
            if formed <= 0 or n["mesh_exchange"] != formed:
                fail(f"{label}: mesh_exchange launched "
                     f"{n['mesh_exchange']} times for {formed} windows")
        for k in total:
            total[k] += n[k]
    print(f"launches on the C engine's legs: {json.dumps(total)}; "
          f"speculative waves recorded: {len(waves)}", flush=True)
    for k, v in total.items():
        if v <= 0:
            fail(f"kernel {k} was never launched on the C engine's legs")
    return total, waves, summaries


# -- phases 7-9, 11, 12 and 15: the port's CLI on the card -------------------

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


def trace_run(torch, cli, digest, tmp: str, policy: str = "tpu_batch",
              engine: bool = False) -> None:
    """Profile one device-heavy run of tgen_100host under ``policy``
    (tpu_batch at tpu_device_floor=1, tpu_mesh at tpu_mesh_floor=0) on the
    Python columnar plane or, with ``engine``, the C engine, checked
    against the reference; print the card's busy share."""
    d = os.path.join(tmp, f"trace_{policy}_{int(engine)}")
    knob = ("experimental.tpu_device_floor=1" if policy == "tpu_batch"
            else "experimental.tpu_mesh_floor=0")
    label = (f"{policy} {knob.split('.')[1]}, "
             f"{'C engine' if engine else 'Python plane'}")
    t0 = time.perf_counter()
    s, device = profiled(torch, lambda: run_cli(cli, [
        str(EXAMPLES / "tgen_100host.yaml"), "--scheduler-policy", policy,
        "--device", "cuda", "--set", knob, "--data-directory", d,
        *([] if engine else PY_PLANE)]))
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
    if policy == "tpu_batch":
        # one kernel a dispatch (windows_dispatched counts the C engine's
        # speculative min_draw waves too) and no copy: the kernels read and
        # write the page-locked slots in place. The profiler drops a
        # launch now and then (PERF.md), so a few may be missing.
        seen = sum(1 for name, _ in device
                   if "draw_flags_kernel" in name
                   or "min_draw_kernel" in name)
        copies = [name for name, _ in device
                  if name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
        print(f"trace ({label}): {seen} draw kernels seen for {windows} "
              f"dispatches, {len(copies)} host<->device copies", flush=True)
        if copies:
            fail(f"tgen_100host ({label}): the draw windows queued "
                 f"{len(copies)} copies ({sorted(set(copies))[:4]})")
        if not windows - max(2, windows // 50) <= seen <= windows:
            fail(f"tgen_100host ({label}): {seen} draw kernels for "
                 f"{windows} dispatches, not one each")
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


def trace_transport(torch, cli, dt, digest, tmp: str) -> None:
    """Profile phase 11's first leg (tgen_1k with the device transport at
    floor 1, every cohort on the card) with the draw plane off
    (tpu_device_floor=-1), so that the card runs the transport alone:
    counts and tree must equal the reference's, and the profiler must see
    one ack_advance_kernel a device cohort plus the attach's warm-up (a
    few dropped launches allowed) and no host<->device copy."""
    d = os.path.join(tmp, "trace_transport")
    floor0 = dt._DEVICE_FLOOR
    dt._DEVICE_FLOOR = 1
    try:
        t0 = time.perf_counter()
        s, device = profiled(torch, lambda: run_cli(cli, [
            str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy",
            "tpu_batch", "--device", "cuda", "--data-directory", d,
            "--set", "experimental.device_transport=true", "--set",
            "experimental.tpu_device_floor=-1", *PY_PLANE]))
        wall = time.perf_counter() - t0
    finally:
        dt._DEVICE_FLOOR = floor0
    check_run(s, d, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
              "tgen_1k (device transport floor 1, profiled)")
    want = s["device_transport"]["device_cohorts"] + 1
    if device is None:
        print("trace (transport): torch.profiler could not trace the card; "
              "launches and copies not seen", flush=True)
        return
    seen = sum(1 for name, _ in device if "ack_advance_kernel" in name)
    copies = [name for name, _ in device
              if name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    busy_s = sum(us for _, us in device) / 1e6
    print(f"trace (transport): tgen_1k device transport floor 1 under the "
          f"profiler: counts and tree match the reference; wall "
          f"{wall:.3f} s, {seen} ack_advance_kernel seen for {want} "
          f"launches (device cohorts + the attach's warm-up), "
          f"{len(copies)} host<->device copies, device busy {busy_s:.6f} s",
          flush=True)
    if copies:
        fail(f"the transport's cohorts queued {len(copies)} copies "
             f"({sorted(set(copies))[:4]})")
    if not want - max(2, want // 50) <= seen <= want:
        fail(f"transport trace: {seen} ack_advance kernels for {want} "
             f"launches, not one a cohort")


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
        from shadow_tpu_torch import cli, native
        from shadow_tpu_torch.ops import apsp, devcfg, prng
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
    stems = ("draw", "mesh", "transport", "apsp")
    built = [st for st in stems
             if not devcfg._lib_path(devcfg.CSRC / f"{st}.cu").exists()]
    engine_built = not native.lib_path().exists()
    done = {}

    def timed(name, fn):
        t = time.perf_counter()
        fn()
        done[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(stems) + 1) as pool:
        # one nvcc for each source and cc for the C engine, all at once
        jobs = [pool.submit(timed, st, lambda st=st: devcfg.kernel_lib(st))
                for st in stems]
        jobs.append(pool.submit(timed, "colcore", native.colcore))
        for job in jobs:
            try:
                job.result()
            except Exception as exc:  # noqa: BLE001 — reported, then fail
                fail(f"build: {exc}")
    print(f"kernel libraries {stems} and the C engine ready in "
          f"{time.perf_counter() - t0:.2f} s (each: "
          f"{json.dumps({k: round(v, 2) for k, v in done.items()})}; built: "
          f"{built + (['colcore'] if engine_built else []) or 'none'})",
          flush=True)

    phase("kernels")
    max_err = check_kernels(torch, np, prop, dev)
    max_err["threefry2x32"] = check_threefry(torch, np, prng, dev)

    phase("mesh kernels")
    max_err.update(check_mesh_kernels(torch, np, mesh, dev))

    phase("transport kernels")
    max_err["ack_advance"] = check_transport_kernels(torch, np, tk, dev)

    phase("apsp kernels")
    max_err["apsp"] = check_apsp_kernels(torch, np, apsp, dev)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    phase("echo")
    for label, extra in (("Python plane", PY_PLANE), ("C engine", [])):
        d = os.path.join(tmp, f"echo_{len(extra)}")
        s = run_cli(cli, [str(EXAMPLES / "echo.yaml"), "--scheduler-policy",
                          "tpu_batch", "--device", "cuda",
                          "--data-directory", d, *extra])
        if s["process_errors"]:
            fail(f"echo ({label}): process errors {s['process_errors']}")
        if s["native_colcore"] is not (label == "C engine"):
            fail(f"echo ({label}): native_colcore {s['native_colcore']}")
        tree = output_tree_digest(d)
        if tree != ECHO_TREE_DIGEST:
            fail(f"echo ({label}) output tree {tree} != reference "
                 f"{ECHO_TREE_DIGEST}")
        print(f"echo ({label}): tree digest matches the reference "
              f"({tree[:16]})", flush=True)

    phase("main path")
    prop.reset_launches()
    runs = {}
    for label, extra in (("floor1", ["--set",
                                     "experimental.tpu_device_floor=1"]),
                         ("auto", [])):
        d = os.path.join(tmp, f"tgen_1k_{label}")
        argv = [str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy",
                "tpu_batch", "--device", "cuda", "--data-directory", d,
                *PY_PLANE]
        t0 = time.perf_counter()
        if label == "floor1":
            with recording_draws(prop, "draw_flags") as windows:
                s = run_cli(cli, argv + extra)
        else:
            s = run_cli(cli, argv + extra)
        wall = time.perf_counter() - t0
        check_run(s, d, output_tree_digest, TGEN1K_COUNTS,
                  TGEN1K_TREE_DIGEST, f"tgen_1k ({label})")
        runs[label] = s
        dv = s["device"]
        print(f"tgen_1k ({label}, Python plane): counts and tree match the "
              f"reference; wall {wall:.3f} s (controller "
              f"{s['wall_seconds']:.3f} s), "
              f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, "
              f"{dv['windows_dispatched']} windows (largest "
              f"{dv['max_window_units']} units), {dv['window_units']} "
              f"window units = "
              f"{dv['window_units'] / s['units_sent']:.4f} of units_sent, "
              f"phase_wall {json.dumps(s['phase_wall'])}", flush=True)
    py_launches = dict(prop.LAUNCHES)
    print(f"launches on the Python plane's main path: "
          f"{json.dumps(py_launches)}", flush=True)
    for name, n in py_launches.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if py_launches["draw_flags"] < runs["floor1"]["device"][
            "windows_dispatched"]:
        fail(f"draw_flags launched {py_launches['draw_flags']} times, fewer "
             f"than the {runs['floor1']['device']['windows_dispatched']} "
             f"windows the floor-1 run dispatched")
    if not windows:
        fail("the floor-1 run handed draw_flags no window")
    mix = window_mix(torch, prop, windows)
    print(f"floor-1 windows: {json.dumps(mix)}", flush=True)

    phase("mesh path")
    mesh_launches, mesh_windows, barriers = mesh_path(
        cli, mesh, output_tree_digest, tmp)
    launches = {"mesh_exchange": mesh_launches["mesh_exchange"]}

    phase("mesh standalone")
    sa = mesh_standalone(torch, np, mesh, barriers, tmp)
    del barriers
    for name in ("mesh_round_step", "mesh_scan"):
        launches[name] = sa["launches"][name]
        max_err[name] = max(max_err[name], sa["err"][name])

    phase("transport path")
    launches["ack_advance"], cohorts = transport_path(
        cli, tk, dt, output_tree_digest, tmp)

    phase("engine path")
    engine, waves, _ = engine_path(cli, prop, mesh, output_tree_digest, tmp)
    for name, n in engine.items():
        launches[name] = launches.get(name, 0) + n

    phase("apsp path")
    launches["apsp"] = apsp_path(np, apsp)

    phase("timing")
    timing = {"threefry2x32": time_threefry(torch, prop, prng, windows,
                                            spin_rate(torch))}
    timing.update(time_kernels(torch, prop, windows, waves))
    compare_staging(torch, np, prop, windows, waves, dev)
    # a window of the run's median size
    dispatch_breakdown(torch, prop,
                       sorted(windows, key=lambda w: w[3])[len(windows) // 2])
    del windows, waves
    timing.update(time_mesh_kernels(torch, np, prop, mesh, mesh_windows,
                                    sa["rounds"], sa["scans"], sa["ctx"],
                                    sa["plane"]))
    del mesh_windows, sa
    timing["ack_advance"] = time_transport_kernel(torch, np, tk, cohorts, dev)
    ack_extra = {
        "staging": compare_ack_staging(torch, np, tk, cohorts, dev),
        # a cohort of the run's median size
        "breakdown_us": ack_breakdown(
            torch, tk, sorted(cohorts, key=lambda c: len(c[0]))[
                len(cohorts) // 2]),
        "floor": ack_crossover(torch, np, tk, cohorts, dt._DEVICE_FLOOR)}
    del cohorts
    timing["apsp"] = time_apsp(torch, np, apsp, spin_rate(torch), dev)

    phase("trace")
    trace_run(torch, cli, output_tree_digest, tmp, "tpu_batch")
    trace_run(torch, cli, output_tree_digest, tmp, "tpu_mesh")
    trace_run(torch, cli, output_tree_digest, tmp, "tpu_batch", engine=True)
    trace_transport(torch, cli, dt, output_tree_digest, tmp)
    shutil.rmtree(tmp, ignore_errors=True)

    # the device function's launches are those of the kernels that run it
    launches["threefry2x32"] = sum(launches[k] for k in THREEFRY_INSIDE)
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
            **({"inside": list(THREEFRY_INSIDE)}
               if name == "threefry2x32" else {}),
            **(ack_extra if name == "ack_advance" else {}),
            "shapes": rows})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
