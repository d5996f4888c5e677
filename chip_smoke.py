#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (shadow_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --phases "fault filter,fleet"

With no argument every phase runs; ``--phases`` runs the named ones (of
PHASES, with the phases whose results they read: NEEDS), after device and
build; the kernel table needs the timing phase. Phases, in order; any
failure exits non-zero:

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
             default floor; web_cdn_100k at full width to 500 ms. Each
             gives the reference's counts, tree (and web_cdn_100k's last
             state digest) and reports native_colcore; launch counts are
             reset before each leg and read after: min_draw launches for
             the speculative waves, draw_flags at floor 1, mesh_exchange
             once per window at floor 0.
13. policies — the thread policies (thread_per_core, the reference's
             default, and thread_per_host: the per-unit plane, the
             reference's CPU baseline, launching no kernel) and the gossip
             and Tor models, at the shipped host counts (POLICY_LEGS):
             tgen_1k under tpu_batch as a user runs it and under both
             thread policies; gossip_10k and tor_400relay under tpu_batch
             as a user runs it (C engine), at tpu_device_floor=1 (full
             depth; draw_flags must launch) and under thread_per_core. The
             thread_per_core legs and the user legs their ratios divide by
             are cut alike: tgen_1k to 5 s, tor_400relay to 7 s,
             gossip_10k to 3.5 s; tor_400relay on the Python plane with the
             device transport at floor 1 (ack_advance must launch once a
             device cohort, plus the warm-up); tgen_100host and
             tor_400relay under thread_per_host. The thread_per_host legs
             (no card, one OS thread a host) run one after another in a
             second process started first, beside the others. Legs cut
             short of the config's stop time say so in their label and
             carry their own reference constants. Each gives the
             reference's counts, tree (and last state digest where named);
             launch counts reset before each leg and read after (the
             second process reads its own). Prints each leg's sim-s/wall-s
             and phase_wall, the thread pool's worker count, and for each
             config the reference's vs_baseline: tpu_batch over
             thread_per_core, in sim-s/wall-s.
14. faults — fault injection, telemetry, packet capture and the ABR
             model (FAULT_LEGS), each shipped config at full width and
             full stop time: abr_1k (1,000 hosts, 45 s) under tpu_batch as
             a user runs it and at tpu_device_floor=1, and under
             thread_per_core cut to 4 s; web_cdn (316 hosts, 40 s) under
             tpu_batch as a user runs it and at floor 1, on the Python
             plane with the device transport at floor 1, under tpu_mesh at
             tpu_mesh_floor=0, and under thread_per_core cut to 10 s (the
             cut legs with their own constants); gossip_churn (122
             hosts, 40 s, 117 fault transitions) under tpu_batch as a user
             runs it, again with the draw plane attached from round 0 (the
             speculative min_draw waves run across the transitions) and at
             floor 1, and under thread_per_host; partition_heal under
             tpu_batch as a user runs it; then echo with packet capture on
             both hosts on the C engine. The three thread-policy legs run
             one after another in a second process started first, beside
             the others. Each gives the reference's
             counts, tree, last state digest, metrics.jsonl and flows.jsonl
             (sha256), fault transitions and telemetry block, and echo its
             .pcap files byte for byte; launch counts reset before each
             leg and read after: draw_flags on the floor-1 legs, min_draw
             on the cached leg, ack_advance once a device cohort plus the
             warm-up, mesh_exchange once a window at floor 0, nothing on
             the thread policies. Prints each leg's controller wall,
             sim-s/wall-s, phase_wall with its telemetry share, and
             launches.
15. checkpoint — checkpoint and resume (CKPT_LEGS), each shipped config
             at full width and full stop time, through the CLI's
             --checkpoint-every and --resume-from: tgen_1k under tpu_batch
             as a user runs it and at tpu_device_floor=1 (C engine, a
             checkpoint every 10 s, resumed from 10 s and 20 s: its last
             event falls before 40 s), tor_400relay as a user runs it
             (resumed mid-circuit at 30 s), gossip_churn at floor 1
             (resumed mid-churn at 20 s), web_cdn with the Python plane's
             device transport at floor 1 (resumed at 20 s, its telemetry
             streams continued) and tgen_1k under tpu_mesh at floor 0
             (resumed at 10 s); the floor-1 checkpoint written on the card
             and resumed on the CPU, and one written on the CPU and resumed
             on the card; a supervised tgen_1k at floor 1 that recovers
             once from an in-process failure (CKPT_CHAOS). Each checkpointing
             run and each resume gives the reference's results (counts,
             tree; where pinned the last state digest, metrics.jsonl,
             flows.jsonl, fault transitions and telemetry block); launch
             counts reset before, read after: after each boundary
             draw_flags (floor 1), min_draw waves (the user leg),
             ack_advance (once a device cohort plus the reattached
             transport's warm-up) and mesh_exchange (once a window formed
             after it) must launch. Prints each leg's checkpoint bytes and
             phase_wall.checkpoint, each resume's load and reattach
             seconds and its launches after the boundary.
16. shards  — multi-process sharding (--shards): tgen_1k (full width,
             60 s, tpu_batch, C engine) at 1, 2 and 4 shards, printing
             sim-s/wall-s; gossip_churn at 1 and 2 shards with the
             reference CI's flags (CHURN_SHARD_ARGV: its metrics.jsonl,
             flows.jsonl and state digest stream pinned too); the
             supervised chaos leg on 2 shards (SHARD_CHAOS: two worker
             SIGKILLs and a ring-stall wedge), which must recover 3 times,
             each restart's mttr_s under 90 s, to the same bytes. The
             workers launch no kernel (tpu_device_floor -1): every
             worker's counts and this process's are 0.
17. fault filter — the reference's tests/test_colcore.py case on the
             card: tgen_100host to 20 s with ``engine.fault_filter``
             dropping every unit of kind 2 to host 3, through the port's
             Controller under tpu_batch at tpu_device_floor=1 on the C
             engine and on the Python plane, and under tpu_mesh at
             tpu_mesh_floor=0 (FILTER_LEGS). Each gives FILTER_RESULTS:
             the reference's counts, tree, last state digest and process
             errors, and as many filter calls and drops; launch counts
             reset before each leg, read after: draw_flags at floor 1,
             mesh_exchange once a window at floor 0.
18. fleet   — fleet mode: the reference CI's fleet smoke (a 3-seed
             gossip_churn sweep at jobs=2 through ``python -m
             shadow_tpu_torch.fleet``: every seed's tree and streams the
             reference's standalone run's, t-based CIs over 3 seeds) and
             its chaos leg (a wedged member killed by the watchdog and
             retried to ok); then a full-width tgen_1k sweep (seeds 2-4,
             jobs=2, C engine) through FleetRunner behind one DrawServer
             attach on the card, whose members (spawned) create no CUDA
             context: every tree the reference's, at least one batch
             served, launch counts reset before and read after equal to
             the batches served plus the attach's calibration and warm-up;
             then the server's draw op, which those members never reach
             (served_draws: 3 members a seed on threads replay phase 8's
             floor-1 windows under two seeds against fluid.loss_flags,
             launches = served + the attach's; needs phase 8); then each
             seed standalone. Prints the attach wall, batches
             and units served, launches, the sweep's wall against the
             standalone walls and each member's sim-s/wall-s.
19. live    — the live operations plane: tgen_1k at full width on the C
             engine under tpu_batch at tpu_device_floor=1 with
             --live-endpoint, a follower on ``python -m
             shadow_tpu_torch.live tail`` in a subprocess and a timing
             follower on a thread; once the first heartbeat (2 s of sim
             time) reaches it, pause, a 5 s link_degrade, resume and
             checkpoint_now are sent: every ack, fault_transitions_applied
             >= 2, draw_flags launched once a window, the follower saw
             hello, hb, command, stream, flows_snapshot, checkpoint and
             end. The run's commands.jsonl replayed at floor 1, under
             tpu_batch auto with the draw plane attached before round 0
             (speculative min_draw waves in flight when the degrade lands)
             and under tpu_mesh at tpu_mesh_floor=0: each run's tree, state
             digests, metrics, flows and sim-visible commands are the live
             run's; ``live jump`` on the card to the first recorded digest
             after the checkpoint reproduces it. tgen_1k as a user runs it
             with an endpoint and a follower and without: the reference's
             tree either way. Then the reference CI's live-ops leg
             (gossip_churn, 25 s) through the port's CLI: a link_down by
             ``live send``, >= 3 heartbeats, a sample, the applied command
             and the end record at the follower, the replay identical.
             Prints send-to-ack and ack-to-applied wall, the jump's wall
             and the user pair's sim-s/wall-s.
20. fork    — checkpoint-forked what-if trees: the reference CI's fork leg
             through ``python -m shadow_tpu_torch fork`` (gossip_churn to
             25 s, forked at 10 s into baseline and lossy, restored, and
             seed9, cold) and ``fleet report --compare``: the baseline is
             the trunk byte for byte, tools/bisect_divergence.py agrees on
             it and names lossy's first divergent round after the fork at
             t >= 15 s; then a tgen_1k fork (C engine, tpu_batch auto,
             forked at 30 s into baseline, a link_degrade at 31 s and seed
             3) at jobs=2 behind one DrawServer attach: the baseline is the
             trunk, seed 3 the reference's tree, no member created a CUDA
             context, launches reset before and read after equal the
             batches served plus the attach's. Prints the served min_draw
             batches, the fork's wall against the trunk's remainder
             resumed alone, and the branches' walls.
21. managed — real binaries under the port's CLI (native/managed.py, the
             shim built from csrc/shim/shim.c): the guests tgen_srv,
             tgen_cli, ring_probe and sleep_clock built by native/Makefile's
             targets of those names. Where the machine lacks a kernel
             feature the guests need (memfd, process_vm_readv, seccomp
             RET_TRAP) it prints ``managed: not run: kernel capabilities
             missing: ...`` and is skipped; else every leg must pass.
             managed_smoke with the shim's fast plane on and off and under
             thread_per_core: equal summaries (less shim_fast_*), hosts
             trees (less *.clock) and state digests, a majority of the fast
             leg's syscalls in-shim, none of the slow leg's ring reads,
             ring_probe's bytes=300000 and eof=1; managed_lossy
             (packet_loss 0.01 on edge 0-1) at tpu_device_floor=1 on the C
             engine and the Python plane, at the auto floor and under
             tpu_mesh at tpu_mesh_floor=0: equal runs, the reference's
             counts and guests' stdout (MANAGED_RESULTS), draw_flags
             launched once a window and mesh_exchange once a mesh window,
             the C-engine run's windows held against the plain version;
             fifty_lossy (50 processes, 4 MB, floor 1): the reference's
             results, launches = windows; managed_smoke checkpointed every
             500 ms (re-execution snapshots) and resumed from the first:
             equal to the uninterrupted run; proctree.yaml and bench.py's
             real_curl_1k with every transfer validated (not run without
             /usr/bin/curl). Prints sim-s/wall-s, controller wall,
             phase_wall and the syscalls completed in-shim.
22. apsp path — apsp_device, the port's device-APSP entry point, on the
             card on the three real topologies: equal to the plain version
             and to graph.py's routing tables; launches reset before, read
             after.
23. timing  — every kernel and its plain version timed on the main paths'
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
24. trace  — examples/tgen_100host.yaml under torch.profiler on the Python
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
25. multi device — the multi-device layout (one shard, or one draw
             piece, per device entry; ``--device`` lists): the per-entry
             kernels (mesh_exchange_entry on the local route and on the
             host route forced through its plan, at N in {2, 4, 8} and
             once at 17 entries, the cooperative launch; then one window
             kept over several windows on each route, rising epochs and
             fresh units, as the plane drives it; mesh_rounds_entry on
             both routes at N in {2, 4, 8, 17}, then one RoundStage a
             route kept through calls that shrink and grow) against
             their plain versions bit for bit on entries of card 0; a
             source that never publishes ends in the raised timeout, for
             each of the two kernels; MeshDataPlane and DeviceDrawPlane
             over entries against CPU planes; tgen_1k on the C engine
             over cuda:0 x 4
             under tpu_mesh at tpu_mesh_floor=0 and under tpu_batch at
             tpu_mesh_shards=4 and tpu_device_floor=1, each with the
             counts, tree and state digest stream of phase 9's and phase
             8's one-entry floor-0 and floor-1 runs (which write digests
             every 500 rounds), the tpu_mesh leg followed by its twin on
             the one entry cuda:0 with the same engine, floor and digests
             (the same streams; both walls side by side); launch counts
             reset before each leg and read after: mesh_exchange_entry
             once a window a card, every entry's block once a window, no
             mesh_exchange; draw_flags once a window a piece; the
             standalone round API over four entries on phase 9's barriers
             against CPU entries and the one-entry twin,
             mesh_rounds_entry once a card a call, each call's host wall
             beside the twin's; where two cards are visible the same
             legs over cuda:0,cuda:1 with the route of each pair, else a
             line saying that leg did not run (not a failure); then the
             four per-entry kernels timed on those runs' inputs.

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
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
#: the digest of an empty hosts/ tree (no host wrote a log)
EMPTY_TREE_DIGEST = (
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855")
#: examples/gossip_10k.yaml (10,000 nodes, 30 s) and tor_400relay.yaml
#: (1,010 hosts, 60 s): identical under every policy, on either plane and
#: with the C engine on or off, from
#:   python -m shadow_tpu examples/<config>.yaml \
#:     [--state-digest-every <last round>]
#: No gossip node logs before its stop, so gossip_10k's tree is empty and
#: the state digest of its last round holds the run to the reference.
GOSSIP10K_COUNTS = {"rounds": 2265, "events": 1341556,
                    "units_sent": 1331546, "units_dropped": 4349,
                    "bytes_sent": 228165232}
GOSSIP10K_STATE_DIGEST = (
    "a9910bdd673aa56091be5ee9f0197170370dfb4801477537be4b764caba82891")
TOR400_COUNTS = {"rounds": 11848, "events": 256536, "units_sent": 252730,
                 "units_dropped": 1393, "bytes_sent": 1240607816}
TOR400_TREE_DIGEST = (
    "cb920bf1489754cbd2757111701eac27c0197c94c5a5b00348c91f0cede64419")
#: thread_per_host wakes one OS thread per active host every round (30-55
#: ms a round at 1,000 hosts on an H100 machine's host CPU), so its
#: 1,000-host legs are cut to 2 s of simulated time, the least that
#: carries traffic: the reference's results there, from
#:   python -m shadow_tpu examples/<config>.yaml --stop-time 2s \
#:     --state-digest-every <last round>
TGEN1K_2S_COUNTS = {"rounds": 490, "events": 5184, "units_sent": 5370,
                    "units_dropped": 17, "bytes_sent": 44806220}
TGEN1K_2S_TREE_DIGEST = (
    "e2327cbc4f74b4ba399d7e23d570ad8169b6901329f1157b18e15cc035a9f211")
TGEN1K_2S_STATE_DIGEST = (
    "c968f6e0ccc8d0f2d090842a32e9907c2bbfe25c8314dfc74ff6d2a1c6a597f5")
TOR400_2S_COUNTS = {"rounds": 391, "events": 1060, "units_sent": 696,
                    "units_dropped": 3, "bytes_sent": 46361}
TOR400_2S_TREE_DIGEST = (
    "6f88810780fb3397979ba832439019a741b902db514a5f60fab5b18a9df38080")
TOR400_2S_STATE_DIGEST = (
    "9bfd41e925fb1466d7e8c9198f85cd3da4324ceb8e591083baea9ff1c51980bd")
#: the clients and servers still running at 2 s are process errors there
#: ("expected exit 0, got None" / "still running"): errors_digest of the
#: reference's list
TGEN1K_2S_ERRORS = (
    949, "5b0c99999e9cabbb6261d1073c17d05aec626254493d3fa6d584b37eaac80101")
TOR400_2S_ERRORS = (
    600, "bcb1ed3862c35879144c580f73e8140747a2bb530afd043b0ef76dd8f5f8885e")

#: the policies phase's thread_per_core legs, and the tpu_batch legs their
#: vs_baseline ratios divide by, are cut short of the stop time (the
#: thread_per_core legs are host-bound Python and took 33-64 s each on the
#: card's host at full depth): tgen_1k to 5 s (34 % of its events),
#: gossip_10k to 3.5 s (8 %; all of them fall before 10 s of its 30 s, and
#: only 5 % before 3 s) and tor_400relay to 7 s (25 %). tgen_1k and
#: tor_400relay were cut to 10 s before the live and fork phases joined
#: the script, which passed 1,050 s on a slow host; gossip_10k was cut
#: from 4 s when the managed phase joined it. The reference's results
#: there, from
#:   python -m shadow_tpu examples/<config>.yaml --stop-time <cut> \
#:     --scheduler-policy tpu_batch --state-digest-every <last round>
TGEN1K_5S_COUNTS = {"rounds": 1990, "events": 75065, "units_sent": 76517,
                    "units_dropped": 425, "bytes_sent": 676370056}
TGEN1K_5S_TREE_DIGEST = (
    "7be8edeb358c5123f7b2cc4c20fdc2b00c3be2ad7a56309ee67c59ead1de93e2")
TGEN1K_5S_STATE_DIGEST = (
    "c6256d1e36ccd66371e1dfde531c9dea4ee27e05f8d92b9ee8e7aeb2e80320fc")
TGEN1K_5S_ERRORS = (
    848, "47eb6d82e58bdf3f7c8a05b64ef8fefa8fba3128584bce1b843c8a89e292c12c")
GOSSIP10K_35S_COUNTS = {"rounds": 780, "events": 107896,
                        "units_sent": 170486, "units_dropped": 555,
                        "bytes_sent": 26268976}
GOSSIP10K_35S_TREE_DIGEST = EMPTY_TREE_DIGEST
GOSSIP10K_35S_STATE_DIGEST = (
    "390da8093484f0b57b697c6d324e6a79a7ee8ed4293796594396a6eb172ad46d")
TOR400_7S_COUNTS = {"rounds": 2883, "events": 68979, "units_sent": 70479,
                    "units_dropped": 336, "bytes_sent": 325810607}
TOR400_7S_TREE_DIGEST = (
    "d9e721fd6cb33df3ad7bf682c92a7e25c73b0c2d4b7aa281e447a85b0daddb31")
TOR400_7S_STATE_DIGEST = (
    "6a0de3b599697bd26a1f431dff7c148466c485578f36a28281d6c4f66abf608f")
TOR400_7S_ERRORS = (
    541, "a8dee4b7614d6014b0849798fee1e4410adaa686c65236390feca5a34df38183")

#: the faults phase: the shipped configs with a faults: or telemetry:
#: section, at full width and full stop time. The reference's results,
#: identical under every policy, on either plane and with the C engine on
#: or off, from
#:   python -m shadow_tpu examples/<config>.yaml --scheduler-policy \
#:     tpu_batch --state-digest-every <last round>
#: "state": the digest on the last line of state_digests.jsonl; "metrics"
#: and "flows": sha256 of metrics.jsonl and flows.jsonl (None: the config
#: has no telemetry: section, and the run must write neither file);
#: "faults": the summary's fault_transitions_applied; "telemetry": its
#: telemetry block
FAULT_RESULTS = {
    "abr_1k": {
        "counts": {"rounds": 12433, "events": 629286, "units_sent": 610281,
                   "units_dropped": 5158, "bytes_sent": 3874135578},
        "tree": "04fd8813e7e7ac817928e607a81473fc"
                "65869ecb958864a0644f8e18a9abcfe7",
        "state": "2c8ea87c7fdfc81e7875999a07971148"
                 "98c75fdcc714b2b3308a22f384e4a4b7",
        "metrics": "a4c4df74706822303636bb4fcb5ad026"
                   "ace6a092acfc48bee2d09ecd3ab7d7fc",
        "flows": "91dbf1d1f4c5a131debaa69eec99ca7c"
                 "5942a524ca7970dd068f481ec9f10164",
        "faults": 4,
        "telemetry": {"samples": 3, "flows_recorded": 11910, "flows": {
            "abr.segment": {"count": 11880, "ok": 11880, "failed": 0,
                            "x_mean": 1277533, "p50_ms": 788.529,
                            "p90_ms": 1409.286, "p99_ms": 5771.362,
                            "p99_9_ms": 11274.289},
            "abr.stall": {"count": 30, "ok": 30, "failed": 0,
                          "p50_ms": 1442.841, "p90_ms": 4429.185,
                          "p99_ms": 6174.015, "p99_9_ms": 6174.015}}},
    },
    "web_cdn": {
        "counts": {"rounds": 14158, "events": 91369, "units_sent": 83516,
                   "units_dropped": 688, "bytes_sent": 358908449},
        "tree": "a5102526b48c1f13a627e424e5580b4a"
                "6e660026c4328b6732027df882f51f25",
        "state": "c52267dd99a8af79a60fc89ff3baa80b"
                 "15c9e7c727ab2509ac77c72806567e01",
        "metrics": "4a0d60672d4d5f30835a2c815f2d3375"
                   "169ec8aad4309a9f4a76321d3a261ab2",
        "flows": "70b48f67bf648056c6944b5882bbb181"
                 "2b0c2e66f3ad5ef020c7fd75558ca20f",
        "faults": 4,
        "telemetry": {"samples": 4, "flows_recorded": 6205, "flows": {
            "dns.resolve": {"count": 1072, "ok": 1043, "failed": 29,
                            "p50_ms": 96.469, "p90_ms": 427.819,
                            "p99_ms": 3154.117, "p99_9_ms": 3154.117},
            "web.fetch": {"count": 3923, "ok": 3923, "failed": 0,
                          "p50_ms": 503.316, "p90_ms": 1409.286,
                          "p99_ms": 8321.499, "p99_9_ms": 14227.079},
            "web.origin": {"count": 1210, "ok": 1210, "failed": 0,
                           "p50_ms": 536.871, "p90_ms": 1140.851,
                           "p99_ms": 7650.41, "p99_9_ms": 9663.676}}},
    },
    "gossip_churn": {
        "counts": {"rounds": 3114, "events": 13653, "units_sent": 13400,
                   "units_dropped": 25, "bytes_sent": 4258344},
        "tree": "f91504bd003215486ab6fb4503d47800"
                "e21d7e2d3a7f654939f1919eceba3475",
        "state": "86a960be70232f1e3c657179bdfb2b7a"
                 "bc37e2db7059213939ecb66a9c300154",
        "metrics": None, "flows": None, "faults": 117, "telemetry": None,
    },
    "partition_heal": {
        "counts": {"rounds": 862, "events": 725, "units_sent": 714,
                   "units_dropped": 0, "bytes_sent": 5043528},
        "tree": "1cda198efaac2f7e23158f80e3f1bace"
                "fd96da3555251833acdbf4a091813038",
        "state": "1a849bacb7cbedbd454d8366e066ff95"
                 "490a07190fa35fd32baa08810d1ea873",
        "metrics": None, "flows": None, "faults": 2, "telemetry": None,
    },
    # the thread_per_core legs, cut short of the stop time (the name after
    # "@"): host-bound Python, 46 and 24 s at full depth on the card's host
    # (abr_1k was cut to 8 s until the managed phase joined the script)
    "abr_1k@4s": {
        "counts": {"rounds": 1586, "events": 100954, "units_sent": 100594,
                   "units_dropped": 771, "bytes_sent": 647730137},
        "tree": "e3b0c44298fc1c149afbf4c8996fb924"
                "27ae41e4649b934ca495991b7852b855",
        "state": "62e2845dc1a61affb3e53c91523ebd27"
                 "c5336a97834561382b478ebd7a4ed1fa",
        "metrics": "e54c5f8caf91b2467d2c19f91424ec67"
                   "04d12d00112472a98f8299a92811cb65",
        "flows": "68bb564b6a5b5b10bfa1bf51e13b852d"
                 "f8ef4e25fa23e89d35f2d0f8029e208e",
        "faults": 0,
        "telemetry": {"samples": 0, "flows_recorded": 1703, "flows": {
            "abr.segment": {"count": 1703, "ok": 1703, "failed": 0,
                            "x_mean": 1285437, "p50_ms": 570.425,
                            "p90_ms": 939.524, "p99_ms": 1912.603,
                            "p99_9_ms": 2080.375}}},
    },
    "web_cdn@10s": {
        "counts": {"rounds": 4392, "events": 53841, "units_sent": 49403,
                   "units_dropped": 331, "bytes_sent": 212319622},
        "tree": "f1a76a2d147fe8086565901b0ed0f92f"
                "dbe0fdafeb2662a1d1908d8243202ba8",
        "state": "66b5e916c1ff9fe3a5d7fc4a6293768d"
                 "c8d64b57e7006d56ea1063e261acc000",
        "metrics": "edfeb7e2dd4571fe5b93ff2e6af01924"
                   "cc2c015ce24269e8301b847ac56e757f",
        "flows": "829bc44aca31580cc224b1507c590c57"
                 "d7513511aa2fce4a754ccc9db94d2f92",
        "faults": 1,
        "telemetry": {"samples": 1, "flows_recorded": 3682, "flows": {
            "dns.resolve": {"count": 718, "ok": 718, "failed": 0,
                            "p50_ms": 90.178, "p90_ms": 377.487,
                            "p99_ms": 654.311, "p99_9_ms": 1174.405},
            "web.fetch": {"count": 2314, "ok": 2314, "failed": 0,
                          "p50_ms": 461.373, "p90_ms": 1174.405,
                          "p99_ms": 2415.919, "p99_9_ms": 3623.879},
            "web.origin": {"count": 650, "ok": 650, "failed": 0,
                           "p50_ms": 536.871, "p90_ms": 1107.296,
                           "p99_ms": 1610.613, "p99_9_ms": 2617.246}}},
    },
}
#: examples/echo.yaml with packet capture on both hosts, from
#:   python -m shadow_tpu examples/echo.yaml --scheduler-policy tpu_batch \
#:     --set hosts.server.pcap_enabled=true \
#:     --set hosts.client.pcap_enabled=true
#: the tree (which holds the two .pcap files) and each file's sha256
PCAP_ARGV = ["--set", "hosts.server.pcap_enabled=true",
             "--set", "hosts.client.pcap_enabled=true"]
ECHO_PCAP_TREE_DIGEST = (
    "2e9a73bdd2cf4941ebcd00263bb434b5ffef654ceab9a94c6a156f23903af240")
ECHO_PCAPS = {
    "hosts/client/client.pcap":
        "df35a1df8324ffdd5c041ecedc20b921813e2efd25d8b735010e10322d6caea7",
    "hosts/server/server.pcap":
        "4cc7ba66c40dd5fafb7b95ec9cd6748c332a64ab8dc004a27802a592ff3a4e04",
}

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

#: the policies phase: (label, config, policy, extra argv, counts, tree,
#: last state digest or None, process errors as errors_digest gives them
#: or None for none). A label ending "floor1" must launch draw_flags; one
#: ending "transport floor1" runs the device transport with every cohort
#: on the card; a "user" leg runs with no draw plane attached yet, as a
#: fresh process does; "cut <s>" legs stop early. A config's vs_baseline
#: divides its "user" leg's sim-s/wall-s by its thread_per_core leg's,
#: both cut alike.
_DIG_GOSSIP = ["--state-digest-every", str(GOSSIP10K_COUNTS["rounds"])]
_CUT_2S = ["--stop-time", "2s", "--state-digest-every"]
_FLOOR1 = ["--set", "experimental.tpu_device_floor=1"]


def _cut(stop: str, counts: dict) -> list:
    return ["--stop-time", stop, "--state-digest-every",
            str(counts["rounds"])]


POLICY_LEGS = (
    ("tgen_1k tpu_batch user cut 5s", "tgen_1k.yaml", "tpu_batch",
     _cut("5s", TGEN1K_5S_COUNTS), TGEN1K_5S_COUNTS,
     TGEN1K_5S_TREE_DIGEST, TGEN1K_5S_STATE_DIGEST, TGEN1K_5S_ERRORS),
    ("tgen_1k thread_per_core cut 5s", "tgen_1k.yaml", "thread_per_core",
     _cut("5s", TGEN1K_5S_COUNTS), TGEN1K_5S_COUNTS,
     TGEN1K_5S_TREE_DIGEST, TGEN1K_5S_STATE_DIGEST, TGEN1K_5S_ERRORS),
    ("tgen_1k thread_per_host cut 2s", "tgen_1k.yaml", "thread_per_host",
     _CUT_2S + [str(TGEN1K_2S_COUNTS["rounds"])], TGEN1K_2S_COUNTS,
     TGEN1K_2S_TREE_DIGEST, TGEN1K_2S_STATE_DIGEST, TGEN1K_2S_ERRORS),
    ("gossip_10k tpu_batch user cut 3.5s", "gossip_10k.yaml", "tpu_batch",
     _cut("3500ms", GOSSIP10K_35S_COUNTS), GOSSIP10K_35S_COUNTS,
     GOSSIP10K_35S_TREE_DIGEST, GOSSIP10K_35S_STATE_DIGEST, None),
    ("gossip_10k tpu_batch floor1", "gossip_10k.yaml", "tpu_batch",
     _DIG_GOSSIP + _FLOOR1, GOSSIP10K_COUNTS, EMPTY_TREE_DIGEST,
     GOSSIP10K_STATE_DIGEST, None),
    ("gossip_10k thread_per_core cut 3.5s", "gossip_10k.yaml",
     "thread_per_core", _cut("3500ms", GOSSIP10K_35S_COUNTS),
     GOSSIP10K_35S_COUNTS, GOSSIP10K_35S_TREE_DIGEST,
     GOSSIP10K_35S_STATE_DIGEST, None),
    ("tor_400relay tpu_batch user cut 7s", "tor_400relay.yaml", "tpu_batch",
     _cut("7s", TOR400_7S_COUNTS), TOR400_7S_COUNTS,
     TOR400_7S_TREE_DIGEST, TOR400_7S_STATE_DIGEST, TOR400_7S_ERRORS),
    ("tor_400relay tpu_batch floor1", "tor_400relay.yaml", "tpu_batch",
     _FLOOR1, TOR400_COUNTS, TOR400_TREE_DIGEST, None, None),
    ("tor_400relay thread_per_core cut 7s", "tor_400relay.yaml",
     "thread_per_core", _cut("7s", TOR400_7S_COUNTS), TOR400_7S_COUNTS,
     TOR400_7S_TREE_DIGEST, TOR400_7S_STATE_DIGEST, TOR400_7S_ERRORS),
    ("tor_400relay device transport floor1", "tor_400relay.yaml",
     "tpu_batch", ["--set", "experimental.device_transport=true",
                   "--set", "experimental.native_colcore=false"],
     TOR400_COUNTS, TOR400_TREE_DIGEST, None, None),
    ("tgen_100host thread_per_host", "tgen_100host.yaml", "thread_per_host",
     [], TGEN100_COUNTS, TGEN100_TREE_DIGEST, None, None),
    ("tor_400relay thread_per_host cut 2s", "tor_400relay.yaml",
     "thread_per_host", _CUT_2S + [str(TOR400_2S_COUNTS["rounds"])],
     TOR400_2S_COUNTS, TOR400_2S_TREE_DIGEST, TOR400_2S_STATE_DIGEST,
     TOR400_2S_ERRORS),
)

#: the faults phase: (label, FAULT_RESULTS key: the config, and after "@"
#: the stop time of a leg cut short, policy, extra argv). A label ending
#: "floor1" must launch draw_flags; "transport floor1" runs the device
#: transport on the Python plane with every cohort on the card (ack_advance
#: once a device cohort, plus the attach's warm-up); "floor0" sends every
#: causal window through mesh_exchange; a "user" leg runs with no draw plane
#: attached yet, as a fresh process does, and the "cached" leg after it
#: finds the plane attached from round 0, so the C engine's speculative
#: min_draw waves run across the config's fault transitions
FAULT_LEGS = (
    ("abr_1k tpu_batch user", "abr_1k", "tpu_batch", []),
    ("abr_1k tpu_batch floor1", "abr_1k", "tpu_batch", _FLOOR1),
    ("abr_1k thread_per_core cut 4s", "abr_1k@4s", "thread_per_core", []),
    ("web_cdn tpu_batch user", "web_cdn", "tpu_batch", []),
    ("web_cdn tpu_batch floor1", "web_cdn", "tpu_batch", _FLOOR1),
    ("web_cdn device transport floor1", "web_cdn", "tpu_batch",
     ["--set", "experimental.device_transport=true",
      "--set", "experimental.native_colcore=false"]),
    ("web_cdn tpu_mesh floor0", "web_cdn", "tpu_mesh",
     ["--set", "experimental.tpu_mesh_floor=0"]),
    ("web_cdn thread_per_core cut 10s", "web_cdn@10s", "thread_per_core",
     []),
    ("gossip_churn tpu_batch user", "gossip_churn", "tpu_batch", []),
    ("gossip_churn tpu_batch cached", "gossip_churn", "tpu_batch", []),
    ("gossip_churn tpu_batch floor1", "gossip_churn", "tpu_batch", _FLOOR1),
    ("gossip_churn thread_per_host", "gossip_churn", "thread_per_host", []),
    ("partition_heal tpu_batch user", "partition_heal", "tpu_batch", []),
)

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
    "mesh_exchange_entry": ("shadow_tpu_torch/csrc/mesh.cu",
                            "shadow_tpu/parallel/mesh.py:222",
                            ("mesh_exchange_entry_kernel",)),
    "mesh_rounds_entry": ("shadow_tpu_torch/csrc/mesh.cu",
                          "shadow_tpu/parallel/mesh.py:202",
                          ("mesh_rounds_entry_kernel",)),
    "draw_flags_entry": ("shadow_tpu_torch/csrc/draw.cu",
                         "shadow_tpu/ops/propagate.py:85",
                         ("draw_flags_entry_kernel",)),
    "min_draw_entry": ("shadow_tpu_torch/csrc/draw.cu",
                       "shadow_tpu/ops/propagate.py:58",
                       ("min_draw_entry_kernel",)),
}
#: the Python columnar plane: the earlier legs' engine, written out now
#: that the C engine is the default
PY_PLANE = ["--set", "experimental.native_colcore=false"]
#: the kernels whose bodies run the threefry2x32 device function: its
#: launches on the main paths are theirs
THREEFRY_INSIDE = ("draw_flags", "min_draw", "mesh_exchange",
                   "mesh_round_step", "mesh_scan", "mesh_exchange_entry",
                   "mesh_rounds_entry", "draw_flags_entry", "min_draw_entry")
#: integer operations of one threefry2x32 evaluation whose counters vary
#: from call to call: 20 rounds x (add, rotate, xor), 5 key injections x 2
#: adds, the two initial adds
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2
#: the exchange buckets (MeshDataPlane.EXCHANGE_BUCKETS)
MESH_BUCKETS = (256, 1024, 4096, 16384)
#: MAX_RATE of network/fluid.py: the uint64 edge of the bucket math
MAX_RATE = 16_000_000_000


#: the script's start, for the phases' elapsed seconds
_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} ({time.perf_counter() - _START:.1f} s in)", flush=True)


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
    # the entry kernels' paths are phase multi device's
    missed = [k for k, v in paths.items()
              if v <= 0 and not k.startswith("entry_")]
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
def recording_draws(prop, kernel: str, slot_cls=None):
    """Keep every batch DeviceDrawPlane hands ``kernel`` (draw_flags: the
    windows; min_draw: the speculative waves) while the block runs, as
    (packed (rows, P) on the card with the units past the real ones
    zeroed, key, width, real units n): batches on one entry (DrawSlot), or
    with ``slot_cls`` prop.SplitSlot the batches split over entries (P the
    whole padded batch). The launch is wrapped, so its count is untouched;
    the batch is copied on the host during the run and moved to the card
    after it."""
    import torch

    cls = slot_cls or prop.DrawSlot
    kept, records = [], []
    launch = cls.launch

    def record(slot, n, seed_key, width, *stream):
        if slot.kernel == kernel:
            kept.append((slot.inp[:, :n].copy(), slot.inp.shape[1],
                         tuple(int(k) for k in seed_key), int(width), n))
        return launch(slot, n, seed_key, width, *stream)

    cls.launch = record
    try:
        yield records
    finally:
        cls.launch = launch
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
                *PY_PLANE, *MD_DIGEST]
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
                          "experimental.tpu_mesh_floor=0", *PY_PLANE,
                          *MD_DIGEST])
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


# -- phase 23: kernel times on the main paths' inputs -------------------------

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
                 nbytes: float, ops: float, rate: float, what: str,
                 plain_reps: int = 5) -> dict:
    """One row of the timing table for a mesh kernel: card time per call
    (queued behind a spin kernel), the profiler's and the kernels it saw a
    call, the plain version's (median of ``plain_reps`` runs), the host's
    launch cost, and the bound for ``nbytes`` and ``ops`` a call."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    seen: dict = {}
    row = {
        "inputs": what, "calls": len(calls),
        "ms": card_ms(torch, calls, rate),
        # the plain version is hundreds of small kernels a call (thousands
        # for a K-round scan, past the CUDA launch queue), so it is
        # timed back to back with the host's launch cost included
        "plain_ms": host_ms(torch, plain_calls, reps=plain_reps),
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


def split_dispatch_breakdown(torch, prop, window, k: int = 4,
                             n: int = 200) -> dict:
    """Host wall microseconds of each step of a window's dispatch and read
    split over k entries of card 0, as dispatch_breakdown times the one
    entry's: n dispatches of ``window`` ((packed (4, P) on the card, key,
    width, real units)), each read before the next, through the steps of
    DeviceDrawPlane._launch, SplitSlot.launch and the handle's read with a
    clock read between steps; then the split plane's and a one-entry
    plane's dispatch and round trip on the same window, in turns."""
    w, key, width, units = window
    x = w[:, :units].cpu().numpy()
    seed = (key[1] << 32) | key[0]
    plane = prop.DeviceDrawPlane(seed, 65536, max_pkts=width,
                                 device=",".join(["cuda:0"] * k),
                                 n_shards=k)
    one = prop.DeviceDrawPlane(seed, 65536, max_pkts=width, device="cuda:0")
    plane.dispatch(*x).read()  # the bucket's slots
    one.dispatch(*x).read()
    names = ("bucket", "take_slot", "fill", "seed_key", "table",
             "current_stream", "launch", "event_record", "handle", "wait",
             "read")
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
        dev, ix, table, table_ptr, cols, in_ptr, event = slot._launches[0]
        for j, col in enumerate(cols):
            table[j, 1] = min(max(units - col, 0), slot.piece)
        t.append(clock())
        stream = torch.cuda.current_stream(dev)
        t.append(clock())
        prop._launch_entry_kernel("draw_flags_entry", in_ptr,
                                  slot.inp.shape[1], table_ptr, len(ix),
                                  slot.region, seed_key, width,
                                  stream.cuda_stream, ix)
        t.append(clock())
        event.record(stream)
        t.append(clock())
        h = prop.DrawHandle(plane, slot, units)
        t.append(clock())
        slot.wait()
        t.append(clock())
        h.read()
        t.append(clock())
        for name, a, b in zip(names, t, t[1:]):
            out[name] += b - a
    for label, pl in (("split", plane), ("one", one), ("one", one),
                      ("split", plane)):
        for name in ("dispatch", "round_trip"):
            total = 0.0
            for _ in range(n):
                t0 = clock()
                h = pl.dispatch(*x)
                t1 = clock()
                h.read()
                total += t1 - t0 if name == "dispatch" else clock() - t0
            key_ = f"{label}_{name}"
            out[key_] = out.get(key_, 0.0) + total / 2
    out = {k_: v / n * 1e6 for k_, v in out.items()}
    print(f"  split dispatch host us at P={w.shape[1]} ({units} units, "
          f"{k} entries of cuda:0) against one entry: "
          f"{json.dumps({k_: round(v, 2) for k_, v in out.items()})}",
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


# -- phase 22: the device-APSP entry point ------------------------------------

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
    default floor; web_cdn_100k at full width to 500 ms as a user runs
    it (1,000 ms until the managed phase joined the script). Launch
    counts are reset just before each leg and read just after. Each leg
    must give the reference's counts and tree (and, for
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
        ("web_cdn_100k user 500ms", str(EXAMPLES / "web_cdn_100k.yaml"),
         "tpu_batch", ["--stop-time", "500ms", "--state-digest-every",
                       str(WEB500_COUNTS["rounds"])], WEB500_COUNTS,
         WEB500_TREE_DIGEST, WEB500_STATE_DIGEST),
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


# -- phase 13: the thread policies and the gossip and Tor models ------------

#: thread-policy legs in a process of their own, one after another: for
#: each (output file, argv), the port's CLI with the launch counts reset,
#: then the file holds its stdout (the summary last) and a line with its
#: exit code, wall and the launch counts it read (thread policies must
#: launch nothing)
_LEG_CHILD = """import contextlib, gc, io, json, sys, time
from shadow_tpu_torch import cli
from shadow_tpu_torch.ops import propagate as prop
from shadow_tpu_torch.ops import transport_kernels as tk
from shadow_tpu_torch.parallel import mesh
for out, argv in json.loads(sys.argv[1]):
    gc.collect()
    prop.reset_launches()
    tk.reset_launches()
    mesh.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--json-summary", "--quiet"])
    wall = time.perf_counter() - t0
    n = {**prop.LAUNCHES, "ack_advance": tk.LAUNCHES["ack_advance"],
         "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
    with open(out, "w") as f:
        f.write(buf.getvalue().rstrip("\\n") + "\\n" + json.dumps(
            {"rc": rc, "wall": wall, "launches": n}) + "\\n")
"""


def start_apart(argvs: list, tmp: str, tag: str):
    """Run the port's CLI on each argv of ``argvs`` one after another in
    a second process (_LEG_CHILD), leg i's output into ``tmp``/``tag``i;
    returns the process. The caller waits for it or kills it."""
    spec = [[os.path.join(tmp, f"{tag}{i}.out"), argv]
            for i, argv in enumerate(argvs)]
    return subprocess.Popen([sys.executable, "-c", _LEG_CHILD,
                             json.dumps(spec)], cwd=str(ROOT))


def wait_apart(child, what: str) -> None:
    """Wait for start_apart's process; fails unless it exited 0."""
    t0 = time.perf_counter()
    if child.wait() != 0:
        fail(f"the {what}' process exited {child.returncode}")
    print(f"{what} in their own process: waited "
          f"{time.perf_counter() - t0:.3f} s for it after the other legs",
          flush=True)


def read_apart(tmp: str, tag: str, i: int, label: str,
               cut: bool = False) -> tuple:
    """Leg i of start_apart's process: (summary, wall, launches); fails
    on an exit code other than 0 (or 1 for a leg ``cut`` short)."""
    lines = Path(tmp, f"{tag}{i}.out").read_text().splitlines()
    got = json.loads(lines[-1])
    if got["rc"] not in ((0, 1) if cut else (0,)):
        fail(f"{label}: shadow_tpu_torch exited {got['rc']}")
    return json.loads(lines[-2]), got["wall"], got["launches"]


def policies_path(cli, prop, tk, dt, digest, tmp: str):
    """The thread policies (the per-unit plane, the reference's CPU
    baseline, which launches no kernel) and the gossip and Tor models
    through the port's CLI, at the shipped host counts: POLICY_LEGS. The
    thread_per_host legs (host-bound: one OS thread a host, no card) run
    one after another in a second process started first, beside the other
    legs, which run here in order; their walls are not solo walls. Launch
    counts are reset just before each leg and read just after (the second
    process's own). Each leg must give the reference's counts and tree
    (and, where it names one, the last state digest); the thread-policy
    legs must launch nothing and the tpu_batch legs at floor 1 must launch
    draw_flags; the device-transport leg must send cohorts to the card and
    launch ack_advance once for each, plus once for the attach's warm-up.
    Prints each leg's sim-s/wall-s and phase_wall, the thread pool's
    worker count and, for each config, the reference's vs_baseline: the
    tpu_batch user leg's sim-s/wall-s (C engine, as a user runs it) over
    thread_per_core's, the two cut alike. Returns the launches summed
    over the legs."""
    print(f"thread_per_core workers: os.cpu_count() = {os.cpu_count()}",
          flush=True)
    total = {"draw_flags": 0, "min_draw": 0, "ack_advance": 0}
    rates: dict = {}
    floor0 = dt._DEVICE_FLOOR

    def leg_argv(label, cfg, policy, extra):
        d = os.path.join(tmp, "policies_" + label.replace(" ", "_"))
        return d, [str(EXAMPLES / cfg), "--scheduler-policy", policy,
                   "--device", "cuda", "--data-directory", d, *extra]

    apart = [leg for leg in POLICY_LEGS if leg[2] == "thread_per_host"]
    child = start_apart([leg_argv(*leg[:4])[1] for leg in apart], tmp,
                        "policies_apart")
    try:
        for leg in POLICY_LEGS:
            if leg in apart:
                continue
            label, cfg, policy, extra = leg[:4]
            d, argv = leg_argv(label, cfg, policy, extra)
            user = "user" in label.split()
            if user:
                # a fresh process has attached no draw plane yet
                prop.DeviceDrawPlane._cache.clear()
            devt = label.endswith("transport floor1")
            gc.collect()  # the previous leg's hosts, outside this wall
            prop.reset_launches()
            tk.reset_launches()
            dt._DEVICE_FLOOR = 1 if devt else floor0
            try:
                t0 = time.perf_counter()
                s = run_cli(cli, argv, cut=leg[7] is not None)
                wall = time.perf_counter() - t0
            finally:
                dt._DEVICE_FLOOR = floor0
            n = {**prop.LAUNCHES, "ack_advance": tk.LAUNCHES["ack_advance"]}
            policy_leg(leg, d, s, wall, n, digest, total, rates)
        wait_apart(child, "thread_per_host legs")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    for i, leg in enumerate(apart):
        s, wall, n = read_apart(tmp, "policies_apart", i, leg[0],
                                leg[7] is not None)
        policy_leg(leg, leg_argv(*leg[:4])[0], s, wall, n, digest, total,
                   rates)
    for name, r in rates.items():
        fast, base = r["tpu_batch"], r["thread_per_core"]
        print(f"vs_baseline {name}: tpu_batch {fast:.6f} / thread_per_core "
              f"{base:.6f} sim-s/wall-s = {fast / base:.4f}", flush=True)
    print(f"launches on the policies legs: {json.dumps(total)}", flush=True)
    return total


def policy_leg(leg, d: str, s: dict, wall: float, n: dict, digest,
               total: dict, rates: dict) -> None:
    """Hold one POLICY_LEGS run (summary ``s``, output ``d``, launches
    ``n``) to the reference and print it; adds its launches to ``total``
    and its rate to ``rates``."""
    label, cfg, policy, _extra, counts, tree, state, errors = leg
    devt = label.endswith("transport floor1")
    user = "user" in label.split()
    check_run(s, d, digest, counts, tree, label, errors)
    if state is not None and last_state_digest(d) != state:
        fail(f"{label}: last state digest {last_state_digest(d)} != "
             f"reference {state}")
    rate = s["sim_sec_per_wall_sec"]
    print(f"{label}: counts, tree{' and state digest' if state else ''}"
          f" match the reference; wall {wall:.3f} s (controller "
          f"{s['wall_seconds']:.3f} s), {rate:.6f} sim-s/wall-s, "
          f"native_colcore {s['native_colcore']}, launches "
          f"{json.dumps(n)}, windows {s['device_windows_dispatched']}, "
          f"phase_wall {json.dumps(s['phase_wall'])}"
          + (f", device_transport {json.dumps(s['device_transport'])}"
             if devt else ""), flush=True)
    if policy.startswith("thread"):
        if any(n.values()) or s["native_colcore"]:
            fail(f"{label}: a thread policy ran the C engine or "
                 f"launched a kernel ({json.dumps(n)})")
    elif not devt and s.get("native_colcore") is not True:
        fail(f"{label}: the C engine did not run")
    if label.endswith("floor1") and not devt and n["draw_flags"] <= 0:
        fail(f"{label}: draw_flags was never launched at floor 1")
    if devt:
        dtr = s["device_transport"]
        if dtr["device_cohorts"] <= 0:
            fail(f"{label}: no cohort went to the card at floor 1")
        if n["ack_advance"] != dtr["device_cohorts"] + 1:
            fail(f"{label}: ack_advance launched {n['ack_advance']} "
                 f"times, not once per device cohort "
                 f"({dtr['device_cohorts']}) plus the attach's warm-up")
    for k in total:
        total[k] += n[k]
    if user or policy == "thread_per_core":
        rates.setdefault(cfg.split(".")[0], {})[
            "tpu_batch" if user else policy] = rate


# -- phase 14: fault injection, telemetry, packet capture and ABR -----------

def fault_result(summary: dict, data_dir: str, digest) -> dict:
    """A run's results in FAULT_RESULTS' form: counts, output tree, last
    state digest, the sha256 of metrics.jsonl and flows.jsonl (each None
    where the run wrote none), fault_transitions_applied and the telemetry
    block (None where the summary has none)."""
    import hashlib

    def sha(name):
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    state = (last_state_digest(data_dir) if os.path.exists(
        os.path.join(data_dir, "state_digests.jsonl")) else None)
    return {"counts": {k: summary[k] for k in TGEN1K_COUNTS},
            "tree": digest(data_dir), "state": state,
            "metrics": sha("metrics.jsonl"), "flows": sha("flows.jsonl"),
            "faults": summary.get("fault_transitions_applied"),
            "telemetry": summary.get("telemetry")}


def pcap_result(data_dir: str, digest) -> tuple:
    """(output tree, {path in the data directory: sha256}) of a run's
    .pcap files."""
    import hashlib

    out = {}
    for p in sorted(Path(data_dir).rglob("*.pcap")):
        out[str(p.relative_to(data_dir))] = hashlib.sha256(
            p.read_bytes()).hexdigest()
    return digest(data_dir), out


def fault_leg(leg, d: str, s: dict, n: dict, digest, total: dict) -> None:
    """Hold one FAULT_LEGS run (summary ``s``, output ``d``, launches
    ``n``) to FAULT_RESULTS and print it; adds its launches to
    ``total``."""
    label, name, policy, _extra = leg
    want = FAULT_RESULTS[name]
    devt = label.endswith("transport floor1")
    if s["process_errors"]:
        fail(f"{label}: process errors {s['process_errors'][:3]}")
    got = fault_result(s, d, digest)
    for key, v in want.items():
        if got[key] != v:
            fail(f"{label}: {key} {got[key]!r} != reference {v!r}")
    pw = s["phase_wall"]
    tel = pw.get("telemetry")
    print(f"{label}: counts, tree, state digest, metrics.jsonl, "
          f"flows.jsonl, {got['faults']} fault transitions and the "
          f"telemetry block match the reference; controller "
          f"{s['wall_seconds']:.3f} s, {s['sim_sec_per_wall_sec']:.6f} "
          f"sim-s/wall-s, native_colcore {s['native_colcore']}, "
          f"launches {json.dumps(n)}, windows "
          f"{s['device_windows_dispatched']}, phase_wall "
          f"{json.dumps(pw)}"
          + ("" if tel is None else
             f", telemetry {tel / s['wall_seconds']:.6f} of the "
             f"controller wall")
          + (f", device_transport {json.dumps(s['device_transport'])}"
             if devt else ""), flush=True)
    if policy.startswith("thread"):
        if any(n.values()) or s["native_colcore"]:
            fail(f"{label}: a thread policy ran the C engine or "
                 f"launched a kernel ({json.dumps(n)})")
    elif s["native_colcore"] is devt:
        fail(f"{label}: native_colcore {s['native_colcore']}")
    if label.endswith("floor1") and not devt and n["draw_flags"] <= 0:
        fail(f"{label}: draw_flags was never launched at floor 1")
    if label.endswith("cached") and n["min_draw"] <= 0:
        fail(f"{label}: no speculative min_draw wave was launched")
    if devt:
        dtr = s["device_transport"]
        if dtr["device_cohorts"] <= 0:
            fail(f"{label}: no cohort went to the card at floor 1")
        if n["ack_advance"] != dtr["device_cohorts"] + 1:
            fail(f"{label}: ack_advance launched {n['ack_advance']} "
                 f"times, not once per device cohort "
                 f"({dtr['device_cohorts']}) plus the attach's warm-up")
    if label.endswith("floor0"):
        formed = pw["mesh_windows"]
        if formed <= 0 or n["mesh_exchange"] != formed:
            fail(f"{label}: mesh_exchange launched "
                 f"{n['mesh_exchange']} times for {formed} windows")
    for k in total:
        total[k] += n[k]


def faults_path(cli, prop, tk, dt, mesh, digest, tmp: str) -> dict:
    """The shipped fault and telemetry configs through the port's CLI, at
    full width and full stop time: FAULT_LEGS, then echo with packet
    capture on both hosts under tpu_batch on the C engine. The
    thread-policy legs (host-bound, no card) run one after another in a
    second process started first, beside the other legs, which run here
    in order. Launch counts are reset just before each leg and read just
    after (the second process's own). Each leg
    must give the reference's counts, tree, last state digest,
    metrics.jsonl, flows.jsonl, fault transitions and telemetry block
    (FAULT_RESULTS), the echo leg its .pcap files byte for byte; the
    thread-policy legs launch nothing, the floor-1 legs launch
    draw_flags, the cached leg min_draw, the transport leg ack_advance
    once a device cohort plus the warm-up, the floor-0 leg mesh_exchange
    once a window. Prints each leg's controller wall, sim-s/wall-s,
    phase_wall (its telemetry share beside it) and launches. Returns the
    launches summed over the legs."""
    total = {"draw_flags": 0, "min_draw": 0, "ack_advance": 0,
             "mesh_exchange": 0}
    floor0 = dt._DEVICE_FLOOR

    def launches():
        return {**prop.LAUNCHES, "ack_advance": tk.LAUNCHES["ack_advance"],
                "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}

    def reset():
        gc.collect()  # the previous leg's hosts, outside this leg's wall
        prop.reset_launches()
        tk.reset_launches()
        mesh.reset_launches()

    def leg_argv(label, name, policy, extra):
        config, _, stop = name.partition("@")
        d = os.path.join(tmp, "faults_" + label.replace(" ", "_"))
        return d, [str(EXAMPLES / f"{config}.yaml"), "--scheduler-policy",
                   policy, "--device", "cuda", "--data-directory", d,
                   "--state-digest-every",
                   str(FAULT_RESULTS[name]["counts"]["rounds"]),
                   *(["--stop-time", stop] if stop else []), *extra]

    apart = [leg for leg in FAULT_LEGS if leg[2].startswith("thread")]
    child = start_apart([leg_argv(*leg)[1] for leg in apart], tmp,
                        "faults_apart")
    try:
        for leg in FAULT_LEGS:
            if leg in apart:
                continue
            label = leg[0]
            d, argv = leg_argv(*leg)
            if label.endswith("user"):
                # a fresh process has attached no draw plane yet
                prop.DeviceDrawPlane._cache.clear()
            devt = label.endswith("transport floor1")
            reset()
            dt._DEVICE_FLOOR = 1 if devt else floor0
            try:
                s = run_cli(cli, argv)
            finally:
                dt._DEVICE_FLOOR = floor0
            fault_leg(leg, d, s, launches(), digest, total)
        wait_apart(child, "thread-policy fault legs")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    for i, leg in enumerate(apart):
        s, _wall, n = read_apart(tmp, "faults_apart", i, leg[0])
        fault_leg(leg, leg_argv(*leg)[0], s, n, digest, total)

    d = os.path.join(tmp, "faults_echo_pcap")
    reset()
    s = run_cli(cli, [str(EXAMPLES / "echo.yaml"), "--scheduler-policy",
                      "tpu_batch", "--device", "cuda", "--data-directory", d,
                      *PCAP_ARGV])
    n = launches()
    tree, pcaps = pcap_result(d, digest)
    if s["process_errors"] or not s["native_colcore"]:
        fail(f"echo pcap: process errors {s['process_errors']}, "
             f"native_colcore {s['native_colcore']}")
    if tree != ECHO_PCAP_TREE_DIGEST or pcaps != ECHO_PCAPS:
        fail(f"echo pcap: tree {tree}, pcaps {pcaps} != reference "
             f"{ECHO_PCAP_TREE_DIGEST}, {ECHO_PCAPS}")
    print(f"echo pcap (C engine): tree and both .pcap files match the "
          f"reference byte for byte; launches {json.dumps(n)}", flush=True)
    for k in total:
        total[k] += n[k]
    print(f"launches on the faults legs: {json.dumps(total)}", flush=True)
    return total


# -- phase 15: checkpoint and resume ------------------------------------------

#: the checkpoint phase: (label, config, policy, extra argv, checkpoint
#: cadence, the sim seconds whose checkpoints are resumed, the kernel that
#: must launch after each boundary on the card). Each source run writes
#: its checkpoints while it runs and must itself give the reference's
#: results; each resume continues the source's data directory (a copy with
#: its streams rolled back to the boundary, supervise.rollback_streams, and
#: its hosts/ tree removed) through the CLI's --resume-from and must give
#: them again. After the boundary: draw_flags one a window (the C engine's
#: speculative waves aside); min_draw waves on the user leg, as a fresh
#: process runs it (the draw plane attached in the source run, so
#: speculation runs from the boundary on); ack_advance once a device cohort
#: plus the reattached transport's warm-up (the transport's floor lowered
#: to 1 in this process); mesh_exchange once a window formed after the
#: boundary.
CKPT_LEGS = (
    ("tgen_1k tpu_batch user", "tgen_1k", "tpu_batch", [], "10s", (10, 20),
     "min_draw"),
    ("tgen_1k tpu_batch floor1", "tgen_1k", "tpu_batch", _FLOOR1, "10s",
     (10, 20), "draw_flags"),
    ("tor_400relay tpu_batch user", "tor_400relay", "tpu_batch", [], "30s",
     (30,), None),
    ("gossip_churn tpu_batch floor1", "gossip_churn", "tpu_batch", _FLOOR1,
     "20s", (20,), "draw_flags"),
    ("web_cdn device transport floor1", "web_cdn", "tpu_batch",
     ["--set", "experimental.device_transport=true",
      "--set", "experimental.native_colcore=false"], "20s", (20,),
     "ack_advance"),
    ("tgen_1k tpu_mesh floor0", "tgen_1k", "tpu_mesh",
     ["--set", "experimental.tpu_mesh_floor=0"], "10s", (10,),
     "mesh_exchange"),
)
#: the supervised leg's in-process failure. tgen_1k runs 10,238 rounds,
#: 8,809 of them in its first 20 s of simulated time; its last event falls
#: before 40 s, so it has checkpoints at 10 s and 20 s of a 10 s cadence
#: and none at 40 s. Round 9,000 falls after the 20 s checkpoint.
CKPT_CHAOS = "fail@r9000"


def ckpt_want(name: str) -> dict:
    """The reference's results for a config in fault_result's form (the
    keys a config has constants for) and the argv that makes the run emit
    its last state digest."""
    if name in FAULT_RESULTS:
        want = FAULT_RESULTS[name]
        return want, ["--state-digest-every", str(want["counts"]["rounds"])]
    counts, tree = {"tgen_1k": (TGEN1K_COUNTS, TGEN1K_TREE_DIGEST),
                    "tor_400relay": (TOR400_COUNTS, TOR400_TREE_DIGEST)}[name]
    return {"counts": counts, "tree": tree}, []


def check_result(summary: dict, data_dir: str, digest, want: dict,
                 what: str) -> None:
    """The run's results (fault_result's form) are ``want``'s, key by
    key, and it has no process errors."""
    if summary["process_errors"]:
        fail(f"{what}: process errors {summary['process_errors'][:3]}")
    got = fault_result(summary, data_dir, digest)
    for key, v in want.items():
        if got[key] != v:
            fail(f"{what}: {key} {got[key]!r} != reference {v!r}")


@contextlib.contextmanager
def resume_timing(ck, ctl_cls, counters):
    """Time every checkpoint load while the block runs: the whole
    load_checkpoint call and its _reattach_runtime (the rest is reading
    and unpickling), with the launch counters as of the load. Wraps, and
    changes nothing."""
    loads = []
    load, reattach = ck.load_checkpoint, ctl_cls._reattach_runtime

    def timed_reattach(self, *a, **k):
        t = time.perf_counter()
        reattach(self, *a, **k)
        loads[-1]["reattach_s"] = time.perf_counter() - t

    def timed_load(*a, **k):
        loads.append({"launches": counters()})
        t = time.perf_counter()
        ctl, at = load(*a, **k)
        rec = loads[-1]
        rec["load_s"] = time.perf_counter() - t - rec["reattach_s"]
        return ctl, at

    ck.load_checkpoint, ctl_cls._reattach_runtime = timed_load, \
        timed_reattach
    try:
        yield loads
    finally:
        ck.load_checkpoint, ctl_cls._reattach_runtime = load, reattach


def ckpt_files(data_dir: str) -> list:
    """(sim seconds, path, bytes) of a run's checkpoints, in time order."""
    out = []
    for p in sorted(Path(data_dir, "checkpoints").glob("ckpt_t*.ckpt")):
        t_ns = int(p.name[len("ckpt_t"):].split(".")[0])
        out.append((t_ns / 1e9, p, p.stat().st_size))
    return out


def resume_copy(sup, load_cfg, src: str, dst: str, path) -> None:
    """``dst``: ``src`` as it stood at the checkpoint ``path`` — its
    append-mode streams rolled back to the boundary (the supervisor's
    rollback), its hosts/ tree and checkpoints removed."""
    from shadow_tpu_torch import checkpoint as ck

    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "hosts"), ignore_errors=True)
    shutil.rmtree(os.path.join(dst, "checkpoints"), ignore_errors=True)
    head = ck.read_header(path)
    sup.rollback_streams(load_cfg(dst), int(head["rounds"]),
                         int(head["sim_time_ns"]))


def checkpoint_path(cli, prop, tk, dt, mesh, digest, tmp: str,
                    device: str = "cuda") -> dict:
    """Checkpoint and resume through the port's CLI at full width and full
    stop time: CKPT_LEGS, then one resume across devices each way and a
    supervised run that recovers from an in-process failure. Launch counts
    are reset just before each run and read just after; on the card every
    resumed leg must launch its kernels after the boundary (CKPT_LEGS).
    Prints for each leg the checkpoint files' bytes, phase_wall.checkpoint,
    each resume's load and reattach seconds and the launches after its
    boundary. Returns the launches summed over the runs."""
    from shadow_tpu_torch import checkpoint as ck
    from shadow_tpu_torch import supervise as sup
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    card = device == "cuda"
    total = {"draw_flags": 0, "min_draw": 0, "ack_advance": 0,
             "mesh_exchange": 0}
    floor0 = dt._DEVICE_FLOOR

    def launches():
        return {**prop.LAUNCHES, "ack_advance": tk.LAUNCHES["ack_advance"],
                "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}

    def reset():
        gc.collect()
        prop.reset_launches()
        tk.reset_launches()
        mesh.reset_launches()

    def run(label, argv, devt=False):
        reset()
        dt._DEVICE_FLOOR = 1 if devt else floor0
        try:
            with resume_timing(ck, Controller, launches) as loads:
                s = run_cli(cli, argv)
        finally:
            dt._DEVICE_FLOOR = floor0
        n = launches()
        for k in total:
            total[k] += n[k]
        return s, n, loads

    def after(label, s, n, rec, kernel):
        """The launches since the load (the supervisor's restart or the
        CLI's resume), checked against what the leg must launch."""
        got = {k: n[k] - rec["launches"][k] for k in n}
        if not card or kernel is None:
            return got
        win = s["device_windows_dispatched"]
        if kernel == "draw_flags" and not (got["draw_flags"] > 0 and got[
                "draw_flags"] + got["min_draw"] >= win > 0):
            fail(f"{label}: {got['draw_flags']} draw_flags after the "
                 f"boundary for {win} windows")
        if kernel == "min_draw" and got["min_draw"] <= 0:
            fail(f"{label}: no speculative min_draw wave after the boundary")
        if kernel == "ack_advance":
            dtr = s["device_transport"]
            if dtr["device_cohorts"] <= 0 or \
                    got["ack_advance"] != dtr["device_cohorts"] + 1:
                fail(f"{label}: ack_advance launched {got['ack_advance']} "
                     f"times after the boundary for "
                     f"{dtr['device_cohorts']} device cohorts (+ warm-up)")
        if kernel == "mesh_exchange":
            # the reattached mesh plane counts the windows it formed
            formed = s["phase_wall"]["mesh_windows"]
            if formed <= 0 or got["mesh_exchange"] != formed:
                fail(f"{label}: mesh_exchange launched "
                     f"{got['mesh_exchange']} times after the boundary for "
                     f"{formed} windows")
        return got

    def cfg_of(name):
        return lambda d: load_config(str(EXAMPLES / f"{name}.yaml"),
                                     {"general.data_directory": d})

    sources = {}
    for label, name, policy, extra, every, resume_s, kernel in CKPT_LEGS:
        want, dig = ckpt_want(name)
        src = os.path.join(tmp, "ckpt_" + label.replace(" ", "_"))
        base = [str(EXAMPLES / f"{name}.yaml"), "--scheduler-policy", policy,
                *dig, *extra]
        if label.endswith("user"):
            prop.DeviceDrawPlane._cache.clear()  # a fresh process
        devt = "transport" in label
        s, n, _ = run(label, base + ["--device", device, "--data-directory",
                                     src, "--checkpoint-every", every], devt)
        check_result(s, src, digest, want, f"{label} (checkpointing)")
        files = ckpt_files(src)
        sources[label] = (base, src, files)
        print(f"{label}: checkpointing run matches the reference; "
              f"controller {s['wall_seconds']:.3f} s, phase_wall.checkpoint "
              f"{s['phase_wall'].get('checkpoint', 0.0):.4f} s for "
              f"{len(files)} checkpoints of "
              f"{[b for _, _, b in files]} bytes, launches {json.dumps(n)}",
              flush=True)
        for t in resume_s:
            path = next(p for ts, p, _ in files if ts >= t)
            d = os.path.join(tmp, f"ckpt_resume_{t}_" + label.replace(" ", "_"))
            resume_copy(sup, cfg_of(name), src, d, path)
            s, n, loads = run(label, base + [
                "--device", device, "--data-directory", d,
                "--resume-from", str(path)], devt)
            what = f"{label} resumed at {path.name}"
            check_result(s, d, digest, want, what)
            got = after(what, s, n, loads[0], kernel)
            print(f"{what}: matches the reference; load "
                  f"{loads[0]['load_s']:.4f} s, reattach "
                  f"{loads[0]['reattach_s']:.4f} s, controller "
                  f"{s['wall_seconds']:.3f} s, launches after the boundary "
                  f"{json.dumps(got)}, windows "
                  f"{s['device_windows_dispatched']}", flush=True)

    # across devices: the floor-1 checkpoint written on one device resumes
    # on the other (the device is the resuming invocation's choice)
    legs = [(f"written on {device}, resumed on cpu",
             sources["tgen_1k tpu_batch floor1"], "cpu")]
    base = sources["tgen_1k tpu_batch floor1"][0]
    if card:
        src = os.path.join(tmp, "ckpt_tgen_1k_floor1_cpu")
        s, n, _ = run("cpu source", base + ["--device", "cpu",
                                            "--data-directory", src,
                                            "--checkpoint-every", "10s"])
        check_result(s, src, digest, ckpt_want("tgen_1k")[0],
                     "tgen_1k floor1 on cpu (checkpointing)")
        legs.append(("written on cpu, resumed on cuda",
                     (base, src, ckpt_files(src)), "cuda"))
    for what, (base, src, files), dev in legs:
        path = next(p for ts, p, _ in files if ts >= 20)
        d = os.path.join(tmp, "ckpt_cross_" + dev)
        resume_copy(sup, cfg_of("tgen_1k"), src, d, path)
        s, n, loads = run(what, base + ["--device", dev, "--data-directory",
                                        d, "--resume-from", str(path)])
        check_result(s, d, digest, ckpt_want("tgen_1k")[0], what)
        got = after(what, s, n, loads[0], "draw_flags" if dev == "cuda"
                    else None)
        if dev == "cpu" and any(n.values()):
            fail(f"{what}: a cpu resume launched {json.dumps(n)}")
        print(f"tgen_1k floor1 {what}: matches the reference; load "
              f"{loads[0]['load_s']:.4f} s, reattach "
              f"{loads[0]['reattach_s']:.4f} s, launches after the boundary "
              f"{json.dumps(got)}", flush=True)

    # supervised: an in-process failure, recovered from the newest
    # checkpoint, the kernels relaunched after the restart
    d = os.path.join(tmp, "ckpt_supervised")
    os.environ["SHADOW_TPU_CHAOS"] = CKPT_CHAOS
    try:
        s, n, loads = run("supervised", base + [
            "--device", device, "--data-directory", d,
            "--checkpoint-every", "10s",
            "--set", "general.supervise={max_restarts: 1, backoff: 0}"])
    finally:
        del os.environ["SHADOW_TPU_CHAOS"]
    check_result(s, d, digest, ckpt_want("tgen_1k")[0],
                 f"tgen_1k floor1 supervised {CKPT_CHAOS}")
    rs = s["supervisor"]["restarts"]
    if len(rs) != 1 or "ChaosFailure" not in rs[0]["reason"] or \
            not rs[0]["resume"].endswith(".ckpt") or len(loads) != 1:
        fail(f"supervised {CKPT_CHAOS}: restarts {rs}")
    got = after(f"supervised {CKPT_CHAOS}", s, n, loads[0], "draw_flags")
    print(f"tgen_1k floor1 supervised ({CKPT_CHAOS}): recovered once from "
          f"{Path(rs[0]['resume']).name} to the reference's results, mttr "
          f"{rs[0]['mttr_s']} s, load {loads[0]['load_s']:.4f} s, reattach "
          f"{loads[0]['reattach_s']:.4f} s, launches after the restart "
          f"{json.dumps(got)}", flush=True)
    print(f"launches on the checkpoint legs: {json.dumps(total)}", flush=True)
    return total


# -- phase 16: multi-process sharding and the supervised chaos leg ------------

#: examples/gossip_churn.yaml with the multi-shard leg's flags, the
#: reference's results from
#:   python -m shadow_tpu examples/gossip_churn.yaml --scheduler-policy \
#:     tpu_batch --stop-time 40s --state-digest-every 100 --sample-every 5s
#: ("digests": sha256 of the whole state_digests.jsonl stream; the counts,
#: tree and fault transitions are FAULT_RESULTS' gossip_churn)
CHURN_SHARD_ARGV = ["--scheduler-policy", "tpu_batch", "--stop-time", "40s",
                    "--state-digest-every", "100", "--sample-every", "5s"]
CHURN_SHARD_RESULTS = {
    "counts": FAULT_RESULTS["gossip_churn"]["counts"],
    "tree": FAULT_RESULTS["gossip_churn"]["tree"],
    "state": "27b8f27d2710db8bb30ab3230c40803e"
             "087161eca320410baa3739cc4b6db444",
    "metrics": "b933f30ac5c3d951eddab1878947dc86"
               "a09e18ce4690cc0de39b374e05e4c8a6",
    "flows": "f1a6926cda12fbc9f947cf04a4e272d8"
             "43165cbb8686abf784bbf56633194819",
    "faults": 117,
    "telemetry": {"samples": 7, "flows_recorded": 1428, "flows": {
        "gossip_fetch": {"count": 1427, "ok": 1427, "failed": 0,
                         "p50_ms": 55.575, "p90_ms": 130.023,
                         "p99_ms": 159.384, "p99_9_ms": 310.378},
        "tgen_fetch": {"count": 1, "ok": 1, "failed": 0,
                       "p50_ms": 22548.578, "p90_ms": 22548.578,
                       "p99_ms": 22548.578, "p99_9_ms": 22548.578}}},
}
CHURN_SHARD_DIGESTS = (
    "7106759ded618e080244a80d25f9822bcef089ce84bea368149f09452a6a605b")
#: the supervised chaos leg: two worker SIGKILLs and a ring-stall wedge
#: (the reference's CI leg), its deadlines and restart budget
SHARD_CHAOS = "s0:kill@r700,s1:kill@r1400,s0:wedge@r2000"
SHARD_CHAOS_ENV = {"SHADOW_TPU_CHAOS": SHARD_CHAOS,
                   "SHADOW_TPU_STALL_FLOOR_S": "3",
                   "SHADOW_TPU_STALL_MULT": "20"}
SHARD_CHAOS_ARGV = ["--shards", "2", "--checkpoint-every", "2s", "--set",
                    "general.supervise={max_restarts: 4, backoff: 0.2}"]
MTTR_BOUND_S = 90


def stream_sha(data_dir: str, name: str) -> str:
    import hashlib

    with open(os.path.join(data_dir, name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def shards_path(cli, prop, tk, mesh, digest, tmp: str,
                device: str = "cuda") -> dict:
    """Multi-process sharding through the port's CLI: tgen_1k (full width,
    60 s, tpu_batch, C engine) at 1, 2 and 4 shards; gossip_churn with
    the reference CI's multi-shard flags at 1 and 2 shards; the supervised
    chaos leg (SHARD_CHAOS on 2 shards), which must recover 3 times, each
    failure named and each restart's mttr_s under MTTR_BOUND_S, and end on
    the reference's bytes. Every leg gives the reference's results
    (gossip_churn's metrics.jsonl, flows.jsonl and state digest stream
    too). The sharded legs launch no kernel: each worker's counts and
    this process's (reset before, read after) are 0. Prints each leg's
    sim-s/wall-s, the call's wall (worker start included) and the
    restarts' mttr_s. Returns the launches summed over the legs."""
    total = {"draw_flags": 0, "min_draw": 0, "ack_advance": 0,
             "mesh_exchange": 0}

    def launches():
        return {**prop.LAUNCHES, "ack_advance": tk.LAUNCHES["ack_advance"],
                "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}

    def leg(label, argv, n_shards, env=None):
        d = os.path.join(tmp, "shards_" + label.replace(" ", "_"))
        gc.collect()
        prop.reset_launches()
        tk.reset_launches()
        mesh.reset_launches()
        if label.endswith("user"):
            prop.DeviceDrawPlane._cache.clear()  # a fresh process
        os.environ.update(env or {})
        try:
            t0 = time.perf_counter()
            s = run_cli(cli, argv + ["--device", device, "--data-directory",
                                     d, "--shards", str(n_shards)])
            wall = time.perf_counter() - t0
        finally:
            for k in env or {}:
                del os.environ[k]
        n = launches()
        for k in total:
            total[k] += n[k]
        workers = [p["launches"] for p in s.get("shards", {}).get(
            "per_shard", [])]
        if n_shards > 1 and (any(n.values()) or any(
                any(w.values()) for w in workers)
                or s["device_windows_dispatched"] != 0):
            fail(f"{label}: a sharded run launched a kernel: parent "
                 f"{json.dumps(n)}, workers {json.dumps(workers)}")
        print(f"{label}: {s['sim_sec_per_wall_sec']:.6f} sim-s/wall-s "
              f"(controller {s['wall_seconds']:.3f} s, call {wall:.3f} s "
              f"with the workers' start), native_colcore "
              f"{s.get('native_colcore')}, launches {json.dumps(n)}"
              + (f", workers' launches {json.dumps(workers)}, per-shard "
                 f"phase_wall {json.dumps([p['phase_wall'] for p in s['shards']['per_shard']])}"
                 if n_shards > 1 else ""), flush=True)
        return s, d

    tgen = [str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy", "tpu_batch"]
    for k in (1, 2, 4):
        s, d = leg(f"tgen_1k {k} shard{'s' if k > 1 else ''} user", tgen, k)
        check_run(s, d, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
                  f"tgen_1k at {k} shards")
    churn = [str(EXAMPLES / "gossip_churn.yaml"), *CHURN_SHARD_ARGV]

    def check_churn(s, d, what):
        check_result(s, d, digest, CHURN_SHARD_RESULTS, what)
        if stream_sha(d, "state_digests.jsonl") != CHURN_SHARD_DIGESTS:
            fail(f"{what}: state_digests.jsonl differs from the reference's")

    for k in (1, 2):
        s, d = leg(f"gossip_churn {k} shard{'s' if k > 1 else ''}", churn, k)
        check_churn(s, d, f"gossip_churn at {k} shards")
    s, d = leg("gossip_churn supervised chaos", churn + SHARD_CHAOS_ARGV[2:],
               2, SHARD_CHAOS_ENV)
    check_churn(s, d, f"gossip_churn supervised ({SHARD_CHAOS})")
    rs = s["supervisor"]["restarts"]
    reasons = " | ".join(r["reason"] for r in rs)
    if len(rs) != 3 or "died" not in reasons \
            or "dead or wedged" not in reasons:
        fail(f"chaos leg: restarts {rs}")
    for r in rs:
        if r["mttr_s"] >= MTTR_BOUND_S or r["resume"] == "scratch":
            fail(f"chaos leg: restart {r}")
    print(f"gossip_churn supervised ({SHARD_CHAOS}): recovered "
          f"{len(rs)} times to the reference's bytes, mttr_s "
          f"{[r['mttr_s'] for r in rs]}, reasons "
          f"{[r['reason'][:60] for r in rs]}", flush=True)
    print(f"launches on the shards legs: {json.dumps(total)}", flush=True)
    return total


# -- phase 17: the columnar plane's fault_filter ------------------------------

#: the reference's tests/test_colcore.py case: tgen_100host to 20 s with a
#: fault filter that drops every unit of kind 2 to host 3 (a state digest
#: every 50 rounds). The reference's results (its Python plane), through
#: shadow_tpu.core.controller.Controller with FILTER_OVERRIDES and
#: ``engine.fault_filter`` set: counts, tree, last state digest, process
#: errors (errors_digest; clients still run at 20 s), the filter's calls
#: and the units it dropped
FILTER_OVERRIDES = {"general.stop_time": "20s",
                    "general.state_digest_every": 50}
FILTER_RESULTS = {
    "counts": {"rounds": 1183, "events": 28077, "units_sent": 27153,
               "units_dropped": 718, "bytes_sent": 271088280},
    "tree": "8e447f8b810a6ef28c591d3ac87214e4"
            "16cfb355059fbf047890c735a4ed2af4",
    "state": "24519dea48c38342d3583860326f9226"
             "940db401e6b44e06d5cc855b056ec603",
    "errors": (90, "489a99e95895f00fd27fe04e5cf55b86"
                "50d06d4646abef33e33a9bb7a8a4c2de"),
    "calls": 27871, "dropped": 630,
}
#: the legs: (label, policy, C engine, floor key and value)
FILTER_LEGS = (
    ("tpu_batch floor1 (C engine)", "tpu_batch", True,
     {"experimental.tpu_device_floor": 1}),
    ("tpu_batch floor1 (Python plane)", "tpu_batch", False,
     {"experimental.tpu_device_floor": 1}),
    ("tpu_mesh floor0 (C engine)", "tpu_mesh", True,
     {"experimental.tpu_mesh_floor": 0}),
)


class DstKindFilter:
    """The reference test's filter (``u.dst == 3 and u.kind == 2``), with
    its calls and hits counted."""

    def __init__(self) -> None:
        self.calls = 0
        self.dropped = 0

    def __call__(self, u) -> bool:
        self.calls += 1
        hit = u.dst == 3 and u.kind == 2
        self.dropped += hit
        return hit


def fault_filter_path(prop, mesh, digest, tmp: str,
                      device: str = "cuda") -> dict:
    """FILTER_LEGS through the port's Controller on ``device`` with the
    filter set on its columnar plane: each must give FILTER_RESULTS
    (counts, tree, last state digest, process errors, the filter's calls
    and drops); launch counts reset before each leg and read after:
    draw_flags at floor 1, mesh_exchange once a window at floor 0.
    Returns the launches summed over the legs."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    total = {"draw_flags": 0, "min_draw": 0, "mesh_exchange": 0}
    want = FILTER_RESULTS
    for label, policy, engine, floor in FILTER_LEGS:
        d = os.path.join(tmp, "filter_" + label.split()[0] + str(engine))
        cfg = load_config(str(EXAMPLES / "tgen_100host.yaml"), {
            **FILTER_OVERRIDES, **floor, "general.data_directory": d,
            "experimental.scheduler_policy": policy,
            "experimental.native_colcore": engine})
        gc.collect()
        prop.reset_launches()
        mesh.reset_launches()
        ctl = Controller(cfg, mirror_log=False, device=device)
        ctl.engine.fault_filter = f = DstKindFilter()
        s = ctl.run()
        n = {**prop.LAUNCHES, "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
        check_run(s, d, digest, want["counts"], want["tree"],
                  f"fault filter {label}", tuple(want["errors"]))
        if last_state_digest(d) != want["state"]:
            fail(f"fault filter {label}: last state digest "
                 f"{last_state_digest(d)} != reference {want['state']}")
        if (f.calls, f.dropped) != (want["calls"], want["dropped"]):
            fail(f"fault filter {label}: the filter ran {f.calls} times and "
                 f"dropped {f.dropped} units, the reference's "
                 f"{want['calls']} and {want['dropped']}")
        if s["native_colcore"] is not engine:
            fail(f"fault filter {label}: native_colcore {s['native_colcore']}")
        kernel = "mesh_exchange" if policy == "tpu_mesh" else "draw_flags"
        if device == "cuda" and n[kernel] <= 0:
            fail(f"fault filter {label}: {kernel} was never launched")
        if device == "cuda" and policy == "tpu_mesh" and n[kernel] != s[
                "phase_wall"]["mesh_windows"]:
            fail(f"fault filter {label}: mesh_exchange launched "
                 f"{n[kernel]} times for {s['phase_wall']['mesh_windows']} "
                 f"windows")
        print(f"fault filter {label}: counts, tree, last state digest and "
              f"process errors match the reference; the filter ran "
              f"{f.calls} times and dropped {f.dropped} units, as the "
              f"reference's; controller {s['wall_seconds']:.3f} s, "
              f"launches {json.dumps(n)}, windows "
              f"{s['device_windows_dispatched']}", flush=True)
        for k in total:
            total[k] += n[k]
    print(f"launches on the fault-filter legs: {json.dumps(total)}",
          flush=True)
    return total


# -- phase 18: the fleet and its shared draw server ---------------------------

#: the reference CI's fleet smoke (tools/ci.sh): a 3-seed gossip_churn
#: sweep at jobs=2, pointed at the port. Each seed's tree and streams
#: (fleet._stream_digests: the sha256 of flows.jsonl and metrics.jsonl)
#: are the reference's standalone run of that seed, from
#:   python -m shadow_tpu examples/gossip_churn.yaml --seed <s> \
#:     --set general.stop_time=25s --sample-every 10s
FLEET_SMOKE_ARGV = ["sweep", "examples/gossip_churn.yaml", "--seeds", "3",
                    "--seed-base", "120", "--jobs", "2", "--set",
                    "general.stop_time=25s", "--quiet", "--json"]
FLEET_SMOKE_TREES = {
    120: "c1f0a36df9a2a302c85062904b87750e"
         "0aeb7509fb936ad08eeafb824f4e3dbb",
    121: "89c23b274292e5e00f7a578f102becbd"
         "c5176a6183e406ca3ea72b45d6599fcc",
    122: "4584e5ba1234a7e52855f8c511077b2e"
         "5333df4954cc4a253ab9cd638a8ba7c0",
}
FLEET_SMOKE_STREAMS = {
    120: {"flows.jsonl": "542d6ebcea6626d36b7083aace739778"
          "f751ff16d92cfa0360b5fc7ac63b23e2",
          "metrics.jsonl": "4919a09276ce675d9e2ca17b5b1f9324"
          "8d8cc1dfcbfe1a9cd1d0eabf7c8bb344"},
    121: {"flows.jsonl": "cb2a6320639b033353e5c8c48674a4b8"
          "6c01ab54456431abbd4f2d1a7c029aa2",
          "metrics.jsonl": "354616b629264d0d4f729f297c389756"
          "44f6fc5d9c8e07fe09d8b16db1958d82"},
    122: {"flows.jsonl": "0df71a0270af02960e5884c168cfe48c"
          "c0e8f8ec5954fa9d874e71eac25e7e7e",
          "metrics.jsonl": "14a7b158291c1ac7259ec7501ea3a349"
          "49a64923b9c8ad493d115d1800ae2ff9"},
}
#: its chaos leg: seed 131's worker wedges once; the fleet's watchdog (an
#: 8 s stall deadline) kills it and the retry runs to ok
FLEET_CHAOS_ARGV = ["sweep", "examples/gossip_churn.yaml", "--seeds", "2",
                    "--seed-base", "130", "--jobs", "2", "--set",
                    "general.stop_time=10s", "--no-device-service",
                    "--quiet", "--json"]
FLEET_CHAOS_ENV = {"SHADOW_TPU_FLEET_CHAOS_WEDGE_SEEDS": "131",
                   "SHADOW_TPU_FLEET_STALL_S": "8"}
#: the full-width sweep: tgen_1k (1,000 hosts, 60 s) under tpu_batch on the
#: C engine, seeds 2, 3 and 4 at jobs=2 behind the shared draw server. The
#: reference's standalone trees (its Python plane), from
#:   python -m shadow_tpu examples/tgen_1k.yaml --seed <s> \
#:     --scheduler-policy tpu_batch
FLEET_TGEN1K_SEEDS = (2, 3, 4)
FLEET_TGEN1K_TREES = {
    2: TGEN1K_TREE_DIGEST,
    3: "de6f228b4680c4679fd830473f527f04"
       "d1955995ae3bbccf1cf7cb1a76188814",
    4: "4930a548b8f3e7cbc8a6928362ce0862"
       "a829458638af7266fe95a7e71fed0702",
}
#: the served-draws check: the recorded windows are replayed under the
#: run's own seed (None) and a seed whose key has a high word, by this
#: many members a seed, each keeping up to SERVED_INFLIGHT requests in
#: flight; then the windows' units again in batches of these sizes
SERVED_SEEDS = (None, (1 << 40) + 7)
SERVED_MEMBERS = 3
SERVED_INFLIGHT = 3
SERVED_BATCHES = (1000, 65536)


def served_draws(np, prop, windows, device: str = "cuda") -> dict:
    """The DrawServer's ``draw`` op on ``device``, which the sweeps do not
    reach (their members run tpu_batch auto, whose windows stay on the
    host until the attach publishes, and serve min_draw waves): one
    DrawServer, and SERVED_MEMBERS FleetDrawClients a seed of
    SERVED_SEEDS, each on its own thread of this process, all at once.
    The members replay the main path's recorded floor-1 windows (dealt
    round robin) and then their units in SERVED_BATCHES batches (buckets
    1,024 and 65,536), keeping up to SERVED_INFLIGHT requests in flight,
    so the serving threads reuse the plane's slots concurrently. Every
    result must equal fluid.loss_flags on the same inputs; every batch
    must be served once; and on the card the launches, counted from 0
    before the server is built, must equal the batches served plus the
    attach's own. These launches check the service and are not the main
    path's. Returns the server's counts."""
    import threading
    from collections import deque

    from shadow_tpu_torch.fleet import FleetDrawClient
    from shadow_tpu_torch.network.fluid import loss_flags

    _, key, width, _ = windows[0]
    run_seed = key[0] | key[1] << 32
    units = np.concatenate([x.cpu()[:4, :n].numpy() for x, _, _, n
                            in windows], axis=1)
    spans, at = [], 0
    for *_, n in windows:
        spans.append((at, at + n))
        at += n
    for size in SERVED_BATCHES:
        spans += [(a, min(a + size, at)) for a in range(0, at, size)]
    seeds = [run_seed if s is None else s for s in SERVED_SEEDS]
    want = {seed: loss_flags(seed, *units) for seed in seeds}
    errors: list = []

    def member(cl, mine):
        inflight: deque = deque()

        def check():
            h, a, b = inflight.popleft()
            if not (h.read() == want[cl.seed][a:b]).all():
                errors.append(f"seed {cl.seed}: units {a}:{b} differ "
                              f"from fluid.loss_flags")

        try:
            for a, b in mine:
                inflight.append((cl.dispatch(*units[:, a:b]), a, b))
                if len(inflight) == SERVED_INFLIGHT:
                    check()
            while inflight:
                check()
        except Exception as exc:  # noqa: BLE001 — reported, then fail
            errors.append(f"seed {cl.seed}: {exc!r}")
        finally:
            cl.close_client()

    address = prop.draw_service_address()
    prop.reset_launches()
    srv = prop.DrawServer(run_seed, 65536, width, address=address,
                          device=device)
    t0 = time.perf_counter()
    try:
        threads = []
        for seed in seeds:
            for k in range(SERVED_MEMBERS):
                cl = FleetDrawClient.connect(address, seed, 65536, width,
                                             timeout=300)
                threads.append(threading.Thread(
                    target=member, args=(cl, spans[k::SERVED_MEMBERS])))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail("served draws: a member did not finish")
    finally:
        srv.close()
        shutil.rmtree(os.path.dirname(address), ignore_errors=True)
    wall = time.perf_counter() - t0
    n = dict(prop.LAUNCHES)
    if errors or srv.errors:
        fail(f"served draws: {(errors + srv.errors)[:5]}")
    sent = len(spans) * len(seeds)
    if srv.served != {"draw_flags": sent, "min_draw": 0} or \
            srv.served_units != (1 + len(SERVED_BATCHES)) * at * len(seeds):
        fail(f"served draws: served {srv.served} ({srv.served_units} "
             f"units), want {sent} draw_flags batches")
    attach = srv.attach_launches
    if device == "cuda" and n != {k: srv.served.get(k, 0) + attach[k]
                                  for k in n}:
        fail(f"served draws: launches {n} != served {srv.served} + the "
             f"attach's {attach}")
    print(f"served draws ({len(seeds)} seeds x {SERVED_MEMBERS} members, "
          f"one DrawServer on {device}): {sent} draw_flags batches "
          f"({srv.served_units} units; {len(windows)} recorded windows and "
          f"their units in batches of {SERVED_BATCHES}) in {wall:.3f} s, "
          f"every result equal to fluid.loss_flags; launches "
          f"{json.dumps(n)} = served + the attach's {json.dumps(attach)}",
          flush=True)
    return {"served": dict(srv.served), "served_units": srv.served_units,
            "attach_launches": dict(attach), "launches": n, "wall": wall}


def fleet_ci_legs(tmp: str, device: str = "cuda") -> dict:
    """The reference CI's two fleet legs through ``python -m
    shadow_tpu_torch.fleet`` on ``device``: the smoke (every seed's tree
    and streams the reference's, t-based CIs over 3 seeds in
    sweep_summary.json) and the chaos leg (the wedged member killed and
    retried to ok). Returns {"smoke": summary, "chaos": summary}."""
    from shadow_tpu_torch.fleet import _stream_digests
    from shadow_tpu_torch.utils.digest import output_tree_digest

    out = {}
    for name, argv, env in (("smoke", FLEET_SMOKE_ARGV, {}),
                            ("chaos", FLEET_CHAOS_ARGV, FLEET_CHAOS_ENV)):
        d = os.path.join(tmp, f"fleet_{name}")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "shadow_tpu_torch.fleet", *argv,
             "--sweep-dir", d, "--device", device],
            capture_output=True, text=True, cwd=str(ROOT), timeout=600,
            env={**os.environ, **env})
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"fleet {name}: exited {r.returncode}: {r.stderr[-2000:]}")
        s = json.loads(r.stdout)
        out[name] = s
        if s["failed"] or s["exit_reason"] != "completed":
            fail(f"fleet {name}: failed seeds {s['failed']}")
        print(f"fleet {name}: {len(s['completed'])} seeds ok in "
              f"{s['sweep_wall_seconds']} s of sweep ({wall:.3f} s with "
              f"the interpreter), respawns {s['respawns']}, draw service "
              f"{json.dumps(s.get('draw_service'))}", flush=True)
    smoke = out["smoke"]
    if smoke["completed"] != sorted(FLEET_SMOKE_TREES):
        fail(f"fleet smoke: completed {smoke['completed']}")
    for seed, tree in FLEET_SMOKE_TREES.items():
        sd = Path(tmp) / "fleet_smoke" / f"seed_{seed}"
        if output_tree_digest(sd) != tree or \
                _stream_digests(sd) != FLEET_SMOKE_STREAMS[seed]:
            fail(f"fleet smoke: seed {seed}'s tree or streams differ from "
                 f"the reference's standalone run")
    if not smoke["flows"]:
        fail("fleet smoke: the sweep summary has no flow groups")
    for kind, row in smoke["flows"].items():
        ci = row["ci95"]["p50_ms"]
        if not (ci["n"] == 3 and ci["lo"] <= ci["mean"] <= ci["hi"]):
            fail(f"fleet smoke: {kind} CI95 {ci}")
    print(f"fleet smoke: every seed's tree and streams are the reference's "
          f"standalone run's; {len(smoke['flows'])} flow groups with "
          f"t-based CI95 over 3 seeds", flush=True)
    chaos = out["chaos"]
    if chaos["completed"] != [130, 131] or chaos["respawns"] < 1:
        fail(f"fleet chaos: completed {chaos['completed']}, respawns "
             f"{chaos['respawns']}: the wedged member was not retried")
    print("fleet chaos: the wedged member was detected, killed and retried "
          "to ok", flush=True)
    return out


def fleet_path(cli, np, prop, digest, tmp: str, windows,
               device: str = "cuda") -> dict:
    """Phase 18: the CI's fleet legs (fleet_ci_legs), then the full-width
    tgen_1k sweep through FleetRunner in this process, on the card: one
    DrawServer attach (from cold) serves every member's draw windows while
    the members, spawned (this process's CUDA is up), create no CUDA
    context (each checks at exit; a breach fails its seed). Every seed's
    tree must be the reference's; launch counts reset before the sweep and
    read after must equal the batches served plus the attach's own
    calibration and warm-up launches, and at least one batch must be
    served. Then the server's draw op on the main path's recorded
    ``windows`` (served_draws), and each seed standalone in this process
    (the draw plane uncached, as in a fresh process), for the walls.
    Prints the attach wall, the batches and units served, the launches,
    the sweep's wall against the standalone walls' sum and each member's
    sim-s/wall-s. Returns the sweep's launches."""
    from shadow_tpu_torch.fleet import FleetRunner, seed_dir

    fleet_ci_legs(tmp, device)
    sweep = os.path.join(tmp, "fleet_tgen_1k")
    over = {"experimental.scheduler_policy": "tpu_batch"}
    prop.DeviceDrawPlane._cache.clear()  # the server attaches from cold
    gc.collect()
    prop.reset_launches()
    runner = FleetRunner(str(EXAMPLES / "tgen_1k.yaml"),
                         list(FLEET_TGEN1K_SEEDS), jobs=2, sweep_dir=sweep,
                         overrides=over, quiet=True, device=device)
    s = runner.run()
    n = dict(prop.LAUNCHES)
    svc = s.get("draw_service")
    if s["failed"] or s["completed"] != list(FLEET_TGEN1K_SEEDS):
        fail(f"fleet tgen_1k: failed {s['failed']}")
    if svc is None or svc["errors"]:
        fail(f"fleet tgen_1k: draw service {svc}")
    want = {k: svc["served"].get(k, 0) + svc["attach_launches"][k]
            for k in n}
    if device == "cuda" and n != want:
        fail(f"fleet tgen_1k: launches {n} != served {svc['served']} + the "
             f"attach's {svc['attach_launches']}")
    if device == "cuda" and svc["served_batches"] <= 0:
        fail("fleet tgen_1k: the draw server served no batch")
    members = {}
    for seed, tree in FLEET_TGEN1K_TREES.items():
        sd = seed_dir(sweep, seed)
        man = json.loads((sd / "fleet_manifest.json").read_text())
        if digest(sd) != tree or man["tree_sha256"] != tree:
            fail(f"fleet tgen_1k: seed {seed}'s tree differs from the "
                 f"reference's")
        members[seed] = man
    served_draws(np, prop, windows, device)
    solo = {}
    for seed in FLEET_TGEN1K_SEEDS:
        d = os.path.join(tmp, f"fleet_solo_{seed}")
        prop.DeviceDrawPlane._cache.clear()  # as a fresh process
        gc.collect()
        t0 = time.perf_counter()
        r = run_cli(cli, [str(EXAMPLES / "tgen_1k.yaml"), "--seed",
                          str(seed), "--scheduler-policy", "tpu_batch",
                          "--device", device, "--data-directory", d])
        solo[seed] = time.perf_counter() - t0
        if digest(d) != FLEET_TGEN1K_TREES[seed] or r["process_errors"]:
            fail(f"fleet tgen_1k: seed {seed} standalone differs from the "
                 f"reference")
    solo_ms = {k: round(v, 3) for k, v in solo.items()}
    member_wall = {k: m["wall_seconds"] for k, m in members.items()}
    member_rate = {k: round(m["summary"]["sim_seconds"]
                            / m["loop_wall_seconds"], 3)
                   for k, m in members.items()}
    print(f"fleet tgen_1k (3 seeds, jobs=2, C engine, shared draw server): "
          f"every seed's tree is the reference's; server attach "
          f"{svc['attach_wall_seconds']} s, served {json.dumps(svc['served'])}"
          f" batches ({svc['served_units']} units), launches "
          f"{json.dumps(n)} = served + the attach's "
          f"{json.dumps(svc['attach_launches'])}; sweep wall "
          f"{s['sweep_wall_seconds']} s against {sum(solo.values()):.3f} s "
          f"for the seeds standalone ({json.dumps(solo_ms)}); members' wall "
          f"(config load + run) {json.dumps(member_wall)} s, sim-s/wall-s "
          f"{json.dumps(member_rate)}",
          flush=True)
    return n


# -- phase 19: the live operations plane ---------------------------------------

#: the live leg's commands, sent once the run's first heartbeat (2 s of sim
#: time) reached the follower: the pause holds the round loop at a boundary
#: while the degrade (5 s on eight of tgen_1k's 32 graph nodes towards eight
#: others) and the resume land on it; checkpoint_now lands on the next one
LIVE_DEGRADE = {"cmd": "link_degrade", "src_nodes": list(range(8)),
                "dst_nodes": list(range(8, 16)), "latency_factor": 2.0,
                "loss_add": 0.02, "bandwidth_scale": 0.5, "duration": "5s"}
LIVE_CMDS = ({"cmd": "pause"}, LIVE_DEGRADE, {"cmd": "resume"},
             {"cmd": "checkpoint_now"})
#: the live leg's streams: a digest every 500 rounds, samples every 5 s,
#: heartbeats every 2 s
LIVE_STREAMS = ["--state-digest-every", "500", "--sample-every", "5s",
                "--set", "general.heartbeat_interval=2s"]
#: what the live leg's follower must see
LIVE_KINDS = {"hello", "hb", "command", "stream", "flows_snapshot",
              "checkpoint", "end"}
#: the reference CI's live-ops leg (tools/ci.sh): gossip_churn, 25 s
LIVE_CI_ARGV = ["--quiet", "--json-summary", "--scheduler-policy",
                "tpu_batch", "--set", "general.stop_time=25s",
                "--state-digest-every", "100", "--sample-every", "5s"]
LIVE_CI_LINK_DOWN = ('{"cmd":"link_down","src_nodes":[0],"dst_nodes":[1],'
                     '"duration":"3s"}')
#: the files two runs must share byte for byte (and hosts/)
RUN_STREAMS = ("state_digests.jsonl", "metrics.jsonl", "flows.jsonl")


def live_yaml(tmp: str) -> str:
    """tgen_1k.yaml with the live leg's policy in its experimental section
    (tpu_batch, tpu_device_floor 1), so that ``live jump`` restores its
    checkpoint under the same config."""
    import yaml

    doc = yaml.safe_load((EXAMPLES / "tgen_1k.yaml").read_text())
    doc["experimental"] = {"scheduler_policy": "tpu_batch",
                           "tpu_device_floor": 1}
    path = os.path.join(tmp, "tgen_1k_live.yaml")
    Path(path).write_text(yaml.safe_dump(doc))
    return path


def short_socket(tmp_root: str = "/tmp") -> str:
    """A socket path well inside the AF_UNIX limit."""
    return os.path.join(tempfile.mkdtemp(dir=tmp_root, prefix="stl"),
                        "live.sock")


def tail_process(sock: str, out_path: str):
    """``python -m shadow_tpu_torch.live tail`` on ``sock``, writing to a
    file (a pipe nobody drains would stall the follower)."""
    fh = open(out_path, "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.live", "tail", sock,
         "--timeout", "300"], stdout=fh, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    fh.close()
    return p


def records_of(path: str) -> list:
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()
            if ln.strip()]


def sim_commands(path) -> list:
    """A command log's sim-visible lines (replay skips wall_only ones)."""
    p = Path(path)
    if not p.exists():
        return []
    return [ln for ln in p.read_text().splitlines()
            if not json.loads(ln).get("wall_only")]


def same_run(digest, a: str, b: str, what: str) -> None:
    """Two runs' trees, state digests, metrics, flows and sim-visible
    commands are the same bytes."""
    if digest(a) != digest(b):
        fail(f"{what}: output tree differs")
    for name in RUN_STREAMS:
        pa, pb = Path(a) / name, Path(b) / name
        if pa.exists() != pb.exists() or (
                pa.exists() and pa.read_bytes() != pb.read_bytes()):
            fail(f"{what}: {name} differs")
    if sim_commands(Path(a) / "commands.jsonl") != \
            sim_commands(Path(b) / "commands.jsonl"):
        fail(f"{what}: the sim-visible command log differs")


def live_leg(cli, prop, mesh, digest, tmp: str, device: str) -> dict:
    """The live tgen_1k leg: C engine, tpu_batch at tpu_device_floor 1, a
    follower on ``live tail`` in a subprocess and a timing follower on a
    thread; LIVE_CMDS sent mid-run. Returns what the later steps read."""
    from shadow_tpu_torch import live as lv

    cfg = live_yaml(tmp)
    d = os.path.join(tmp, "live_tgen_1k")
    sock = short_socket()
    tail_path = os.path.join(tmp, "live_tail.jsonl")
    tail = tail_process(sock, tail_path)
    stamped, acks = [], []

    def follow():
        for rec in lv.stream_records(sock, timeout=300):
            stamped.append((time.monotonic(), rec))

    def drive():
        for _ in range(30000):  # the first heartbeat: 2 s of sim time
            if any(r["type"] == "hb" for _t, r in list(stamped)):
                break
            time.sleep(0.01)
        for c in LIVE_CMDS:
            t0 = time.monotonic()
            ack = lv.send_command(sock, c, timeout=120)
            acks.append((t0, time.monotonic(), ack))

    threads = [threading.Thread(target=follow, daemon=True),
               threading.Thread(target=drive, daemon=True)]
    for t in threads:
        t.start()
    prop.reset_launches()
    mesh.reset_launches()
    t0 = time.perf_counter()
    s = run_cli(cli, [cfg, "--device", device, "--data-directory", d,
                      "--live-endpoint", sock, *LIVE_STREAMS])
    wall = time.perf_counter() - t0
    n = {**prop.LAUNCHES, "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
    for t in threads:
        t.join(timeout=120)
    try:
        tail.wait(timeout=120)
    except subprocess.TimeoutExpired:
        tail.kill()
        fail("live: the tail follower did not end with the run")
    if tail.returncode != 0:
        fail(f"live: the tail follower exited {tail.returncode}: "
             f"{tail.stderr.read()[-2000:]}")
    shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    if [a[2].get("type") for a in acks] != ["ack"] * len(LIVE_CMDS):
        fail(f"live: acks {[a[2] for a in acks]}")
    if s.get("fault_transitions_applied", 0) < 2:
        fail(f"live: fault_transitions_applied "
             f"{s.get('fault_transitions_applied')} < 2")
    if s["native_colcore"] is not True:
        fail("live: the C engine did not run")
    windows = s["device"]["windows_dispatched"]
    if device == "cuda" and (windows <= 0 or n["draw_flags"] != windows):
        fail(f"live: draw_flags launched {n['draw_flags']} times for "
             f"{windows} windows")
    recs = records_of(tail_path)
    kinds = {r["type"] for r in recs}
    if not LIVE_KINDS <= kinds or recs[-1]["type"] != "end":
        fail(f"live: the follower saw {sorted(kinds)}, not "
             f"{sorted(LIVE_KINDS)} ending in end")
    log = [json.loads(ln) for ln in
           Path(d, "commands.jsonl").read_text().splitlines()]
    if [r["cmd"]["cmd"] for r in log] != [c["cmd"] for c in LIVE_CMDS]:
        fail(f"live: command log {log}")
    ck = [r for r in recs if r["type"] == "checkpoint"]
    if len(ck) != 1 or not Path(ck[0]["path"]).is_file():
        fail(f"live: checkpoint records {ck}")
    # send -> ack, and ack -> the record of the command applied at its
    # boundary (the timing follower's arrival clock)
    applied = {r["seq"]: t for t, r in stamped if r["type"] == "command"}
    send_ack = [round((a[1] - a[0]) * 1e3, 3) for a in acks]
    ack_applied = [round((applied[r["seq"]] - a[1]) * 1e3, 3)
                   for a, r in zip(acks, log) if r["seq"] in applied]
    print(f"live tgen_1k (C engine, tpu_batch floor 1, endpoint + 2 "
          f"followers): wall {wall:.3f} s (controller "
          f"{s['wall_seconds']:.3f} s, paused time included), "
          f"{s['sim_sec_per_wall_sec']:.6f} sim-s/wall-s; commands applied "
          f"at t={[r['t'] for r in log]} (rounds "
          f"{[r['round'] for r in log]}); fault transitions "
          f"{s['fault_transitions_applied']}; draw_flags {n['draw_flags']} "
          f"= windows {windows}; send->ack ms {send_ack}; ack->applied ms "
          f"{ack_applied}; the follower saw {len(recs)} records of "
          f"{sorted(kinds)}; checkpoint {ck[0]['path']} at round "
          f"{ck[0]['round']}", flush=True)
    return {"cfg": cfg, "dir": d, "summary": s, "launches": n,
            "ckpt": ck[0]}


def live_replays(cli, prop, mesh, digest, tmp: str, device: str,
                 live: dict) -> dict:
    """The live leg's commands.jsonl replayed on ``device`` at floor 1 (the
    same policy), under tpu_batch auto with the draw plane attached before
    round 0 (speculative min_draw waves in flight when the degrade lands)
    and under tpu_mesh at tpu_mesh_floor 0: each run's trees and streams
    must be the live run's. Returns the launches summed."""
    from shadow_tpu_torch.config import load_config

    log = os.path.join(live["dir"], "commands.jsonl")
    c = load_config(live["cfg"])
    total = {k: 0 for k in ("draw_flags", "min_draw", "mesh_exchange")}
    for label, extra in (
            ("floor1", []),
            ("auto cached", ["--set", "experimental.tpu_device_floor=0"]),
            ("tpu_mesh floor0", ["--scheduler-policy", "tpu_mesh", "--set",
                                 "experimental.tpu_mesh_floor=0"])):
        d = os.path.join(tmp, "live_replay_" + label.replace(" ", "_"))
        if label == "auto cached":
            prop.DeviceDrawPlane.attach_cached(
                c.general.seed, c.experimental.tpu_max_batch,
                c.experimental.unit_mtus, device)
        gc.collect()
        prop.reset_launches()
        mesh.reset_launches()
        t0 = time.perf_counter()
        s = run_cli(cli, [live["cfg"], "--device", device,
                          "--data-directory", d, "--replay-commands", log,
                          *LIVE_STREAMS, *extra])
        wall = time.perf_counter() - t0
        n = {**prop.LAUNCHES, "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
        same_run(digest, d, live["dir"], f"live replay ({label})")
        if s["fault_transitions_applied"] != \
                live["summary"]["fault_transitions_applied"]:
            fail(f"live replay ({label}): fault transitions differ")
        if device == "cuda":
            if label == "floor1" and \
                    n["draw_flags"] != s["device"]["windows_dispatched"]:
                fail(f"live replay (floor1): draw_flags {n['draw_flags']}")
            if label == "auto cached" and n["min_draw"] <= 0:
                fail("live replay (auto cached): no speculative min_draw "
                     "wave was in flight")
            if label == "tpu_mesh floor0":
                formed = s["phase_wall"]["mesh_windows"]
                if formed <= 0 or n["mesh_exchange"] != formed:
                    fail(f"live replay (tpu_mesh floor0): mesh_exchange "
                         f"{n['mesh_exchange']} for {formed} windows")
        for k in total:
            total[k] += n[k]
        print(f"live replay ({label}): trees, state digests, metrics, "
              f"flows and sim-visible commands are the live run's; wall "
              f"{wall:.3f} s, {s['sim_sec_per_wall_sec']:.6f} sim-s/wall-s,"
              f" launches {json.dumps(n)}", flush=True)
    return total


def live_jump(prop, mesh, tmp: str, device: str, live: dict) -> dict:
    """``live jump`` on ``device`` to the first recorded digest round after
    the checkpoint_now boundary: restore plus re-execution must reproduce
    the recorded digest."""
    from shadow_tpu_torch import live as lv

    digs = [json.loads(ln) for ln in Path(
        live["dir"], "state_digests.jsonl").read_text().splitlines()]
    after = [r["round"] for r in digs if r["round"] > live["ckpt"]["round"]]
    if not after:
        fail("live jump: no recorded digest after the checkpoint")
    out = []
    prop.reset_launches()
    mesh.reset_launches()
    t0 = time.perf_counter()
    rc = lv.jump(live["dir"], after[0], live["cfg"], out=out.append,
                 inspect_dir=os.path.join(tmp, "live_jump"), device=device)
    wall = time.perf_counter() - t0
    n = {**prop.LAUNCHES, "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
    if rc != 0 or not any("[MATCH]" in ln for ln in out) or \
            not any("restored" in ln for ln in out):
        fail("live jump: " + " | ".join(out[:4]))
    print(f"live jump to round {after[0]} (checkpoint at round "
          f"{live['ckpt']['round']}): the recorded digest matches; wall "
          f"{wall:.3f} s (restore + re-execution), launches {json.dumps(n)}",
          flush=True)
    return n


def live_user_pair(cli, prop, digest, tmp: str, device: str) -> None:
    """tgen_1k as a user runs it (C engine, tpu_batch auto, the draw plane
    uncached as in a fresh process) without an endpoint and with one and a
    follower: the same tree (the reference's) either way."""
    rates = {}
    for label in ("without", "with"):
        d = os.path.join(tmp, f"live_user_{label}")
        extra, tail, sock = [], None, None
        if label == "with":
            sock = short_socket()
            tail = tail_process(sock, os.path.join(tmp, "user_tail.jsonl"))
            extra = ["--live-endpoint", sock]
        prop.DeviceDrawPlane._cache.clear()
        gc.collect()
        s = run_cli(cli, [str(EXAMPLES / "tgen_1k.yaml"),
                          "--scheduler-policy", "tpu_batch", "--device",
                          device, "--data-directory", d, *extra])
        if tail is not None:
            tail.wait(timeout=120)
            shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
        check_run(s, d, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
                  f"live user ({label} endpoint)")
        rates[label] = (s["wall_seconds"], s["sim_sec_per_wall_sec"])
    print(f"tgen_1k user (C engine): controller wall / sim-s/wall-s "
          f"without an endpoint {rates['without'][0]:.3f} s / "
          f"{rates['without'][1]:.6f}, with an endpoint and a follower "
          f"{rates['with'][0]:.3f} s / {rates['with'][1]:.6f}; the same "
          f"tree (the reference's)", flush=True)


@contextlib.contextmanager
def held_for_first_command(timeout: float = 300.0):
    """Runs started inside hold at their first round boundary until a
    live command has arrived (``LiveServer.poll_commands`` with a
    timeout, as a paused run waits). gossip_churn's 25 s take well under
    a second of wall on the C engine, less than a ``live send`` process
    needs to start, so without the hold the run may end before the
    command lands. The hold is wall time only: the command applies at
    the boundary the run records in commands.jsonl, which the replay
    repeats."""
    from shadow_tpu_torch import live as lv

    poll = lv.LiveServer.poll_commands
    first = [True]

    def poll_held(self, timeout_=0.0):
        if first[0]:
            first[0] = False
            return poll(self, timeout=timeout)
        return poll(self, timeout_)

    lv.LiveServer.poll_commands = poll_held
    try:
        yield
    finally:
        lv.LiveServer.poll_commands = poll


def live_ci_leg(cli, digest, tmp: str, device: str) -> None:
    """The reference CI's live-ops leg (tools/ci.sh) through the port's
    CLI on ``device`` (the runs in this process, the follower and the
    sender as the CI's own processes): a follower on ``live tail``,
    gossip_churn (25 s, tpu_batch) with an endpoint, held at its first
    boundary until a link_down sent through ``live send`` once the
    follower is attached has arrived, then a replay of its commands.jsonl:
    the same hashes (hosts/, commands, flows, metrics, digests), three
    heartbeats or more, a sample, the applied command and the end record
    at the follower."""
    run, rep = os.path.join(tmp, "ci_live"), os.path.join(tmp, "ci_replay")
    sock = short_socket()
    tail_path = os.path.join(tmp, "ci_live_tail.jsonl")
    tail = tail_process(sock, tail_path)
    sent = {}

    def send():
        for _ in range(30000):  # the follower's hello: it is attached
            if Path(tail_path).read_text().strip():
                break
            time.sleep(0.01)
        sent["r"] = subprocess.run(
            [sys.executable, "-m", "shadow_tpu_torch.live", "send", sock,
             LIVE_CI_LINK_DOWN, "--timeout", "300"], capture_output=True,
            text=True, cwd=str(ROOT), timeout=600)

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    # at 25 s gossip members may end with process errors (exit 1), as in
    # the CI, which takes the hashes as its gate
    with held_for_first_command():
        live = run_cli(cli, ["examples/gossip_churn.yaml",
                             "--data-directory", run, "--device", device,
                             "--live-endpoint", sock, "--set",
                             "general.heartbeat_interval=2s", *LIVE_CI_ARGV],
                       cut=True)
    sender.join(timeout=600)
    tail.wait(timeout=120)
    shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    r = sent.get("r")
    if r is None or r.returncode != 0 or \
            json.loads(r.stdout).get("type") != "ack":
        fail(f"live CI leg: send {r and (r.returncode, r.stdout, r.stderr)}")
    if not Path(run, "commands.jsonl").is_file():
        fail("live CI leg: the acked link_down was never applied (no "
             "commands.jsonl)")
    replay = run_cli(cli, ["examples/gossip_churn.yaml", "--data-directory",
                           rep, "--device", device, "--replay-commands",
                           os.path.join(run, "commands.jsonl"),
                           *LIVE_CI_ARGV], cut=True)
    same_run(digest, rep, run, "live CI leg replay")
    if Path(rep, "commands.jsonl").read_bytes() != \
            Path(run, "commands.jsonl").read_bytes() or \
            replay["process_errors"] != live["process_errors"]:
        fail("live CI leg: the replay's commands.jsonl or errors differ")
    recs = records_of(tail_path)
    hbs = sum(rec["type"] == "hb" for rec in recs)
    samples = sum(rec["type"] == "stream" and '"kind":"sample"' in rec["line"]
                  for rec in recs)
    applied = any(rec["type"] == "command"
                  and rec["cmd"]["cmd"] == "link_down" for rec in recs)
    if hbs < 3 or not samples or not applied or recs[-1]["type"] != "end":
        fail(f"live CI leg: follower saw {hbs} heartbeats, {samples} "
             f"samples, link_down applied {applied}, last "
             f"{recs[-1]['type'] if recs else None}")
    if live["exit_reason"] != "completed" or \
            live.get("fault_transitions_applied", 0) < 2 or \
            replay["exit_reason"] != "completed":
        fail(f"live CI leg: exit {live['exit_reason']}, transitions "
             f"{live.get('fault_transitions_applied')}")
    print(f"live CI leg (gossip_churn 25 s): {hbs} heartbeats and "
          f"{samples} samples followed, link_down acked and applied, the "
          f"replay byte-identical (hosts/, commands, flows, metrics, "
          f"digests)", flush=True)


def live_path(cli, prop, mesh, digest, tmp: str,
              device: str = "cuda") -> dict:
    """Phase 19, the live operations plane on ``device``: live_leg,
    live_replays, live_jump, live_user_pair, live_ci_leg. Returns the
    launches of its legs summed."""
    total = {k: 0 for k in ("draw_flags", "min_draw", "mesh_exchange")}
    live = live_leg(cli, prop, mesh, digest, tmp, device)
    for part in (live["launches"],
                 live_replays(cli, prop, mesh, digest, tmp, device, live),
                 live_jump(prop, mesh, tmp, device, live)):
        for k in total:
            total[k] += part[k]
    live_user_pair(cli, prop, digest, tmp, device)
    live_ci_leg(cli, digest, tmp, device)
    return total


# -- phase 20: checkpoint-forked what-if trees --------------------------------

#: the reference CI's fork leg (tools/ci.sh): gossip_churn to 25 s, a
#: checkpoint every 10 s, the 10 s one forked into three branches
FORK_CI_SETS = ["--set", "general.stop_time=25s", "--set",
                "general.checkpoint_every=10s", "--set",
                "general.state_digest_every=100", "--set",
                "telemetry.sample_every=5s"]
FORK_CI_SCRIPT = {"cmd": {"cmd": "link_degrade", "src_nodes": [0],
                          "dst_nodes": [1], "latency_factor": 3.0,
                          "loss_add": 0.05, "bandwidth_scale": 0.5,
                          "duration": "3000000000 ns"},
                  "round": 0, "seq": 1, "t": 15000000000}
#: the tgen_1k fork: the trunk (C engine, tpu_batch auto, 60 s) with a
#: checkpoint every 30 s; baseline, a link_degrade at 31 s and seed 3.
#: tgen_1k's last flow closes at 32.19 s and the run then skips to its end,
#: so a command at 40 s would meet no round boundary and never apply
FORK_TGEN_OVER = {"experimental.scheduler_policy": "tpu_batch",
                  "general.checkpoint_every": "30s",
                  "general.state_digest_every": 500,
                  "telemetry.sample_every": "10s"}
FORK_TGEN_BRANCHES = [
    {"name": "baseline"},
    {"name": "degrade", "commands": [
        {"t": "31s", "cmd": "link_degrade", "src_nodes": list(range(8)),
         "dst_nodes": list(range(8, 16)), "latency_factor": 2.0,
         "loss_add": 0.02, "bandwidth_scale": 0.5, "duration": "5s"}]},
    {"name": "seed3", "seed": 3},
]


def fork_ci_leg(cli, digest, tmp: str, device: str) -> None:
    """The reference CI's fork leg through ``python -m shadow_tpu_torch
    fork`` and ``fleet report --compare`` on ``device``."""
    import yaml

    from shadow_tpu_torch import checkpoint as ckpt
    from shadow_tpu_torch import forks
    from shadow_tpu_torch.fleet import _stream_digests
    from shadow_tpu_torch.fleet import main as fleet_main

    trunk, fork_dir = os.path.join(tmp, "ci_trunk"), os.path.join(
        tmp, "ci_fork")
    run_cli(cli, ["examples/gossip_churn.yaml", "--data-directory", trunk,
                  "--device", device, *FORK_CI_SETS], cut=True)
    ck = sorted(Path(trunk, "checkpoints").glob("ckpt_*.ckpt"))[0]
    script = Path(tmp, "ci_fork_cmds.jsonl")
    script.write_text(json.dumps(FORK_CI_SCRIPT) + "\n")
    branches = Path(tmp, "ci_fork_branches.yaml")
    branches.write_text(yaml.safe_dump({"branches": [
        {"name": "baseline"},
        {"name": "lossy", "command_script": str(script)},
        {"name": "seed9", "seed": 9}]}))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", "fork",
         "examples/gossip_churn.yaml", "--from", str(ck), "--branches",
         str(branches), "--fork-dir", fork_dir, "--jobs", "3", "--quiet",
         "--device", device, *FORK_CI_SETS], capture_output=True,
        text=True, cwd=str(ROOT), timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or "Δp50" not in r.stdout or \
            "CI95" not in r.stdout:
        fail(f"fork CI leg: exited {r.returncode}: {r.stderr[-2000:]}")
    outs = {}
    for flag in ("--json", "--compare"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fleet_main(["report", fork_dir, flag])
        if rc != 0:
            fail(f"fork CI leg: fleet report {flag} exited {rc}")
        outs[flag] = buf.getvalue()
    if "Δp50" not in outs["--compare"] or "CI95" not in outs["--compare"]:
        fail("fork CI leg: fleet report --compare has no Δp50 and CI95")
    s = json.loads(outs["--json"])
    b = s["branches"]
    seed9 = json.loads(Path(forks.branch_dir(fork_dir, "seed9"),
                            forks.FORK_MANIFEST).read_text())
    if s["completed"] != ["baseline", "lossy", "seed9"] or \
            b["baseline"]["mode"] != "restore" or \
            b["lossy"]["mode"] != "restore" or \
            b["seed9"]["mode"] != "cold" or \
            "seed" not in seed9["cold_reason"] or not s["trunk_flows"]:
        fail(f"fork CI leg: summary {json.dumps(s)[:1500]}")
    base = forks.branch_dir(fork_dir, "baseline")
    if digest(base) != digest(trunk) or \
            _stream_digests(base) != _stream_digests(trunk):
        fail("fork CI leg: the baseline branch is not the trunk")
    tool = str(ROOT / "tools" / "bisect_divergence.py")
    same = subprocess.run([sys.executable, tool, "--a", trunk, "--b",
                           str(base)], capture_output=True, text=True,
                          timeout=300)
    div = subprocess.run([sys.executable, tool, "--json", "--a", trunk,
                          "--b", str(forks.branch_dir(fork_dir, "lossy"))],
                         capture_output=True, text=True, timeout=300)
    if same.returncode != 0 or div.returncode != 1:
        fail(f"fork CI leg: bisect exited {same.returncode} and "
             f"{div.returncode}")
    d = json.loads(div.stdout)
    rounds = ckpt.read_header(ck)["rounds"]
    if d["kind"] != "digest" or d["round"] <= rounds or \
            d["t"] < 15_000_000_000:
        fail(f"fork CI leg: bisect {d} (fork round {rounds})")
    print(f"fork CI leg (gossip_churn): baseline and lossy restored, seed9 "
          f"cold; baseline byte-identical to the trunk; lossy first "
          f"diverges at round {d['round']} (t={d['t']} ns, fork round "
          f"{rounds}); fork wall {s['fork_wall_seconds']} s ({wall:.3f} s "
          f"with the interpreter), draw service "
          f"{json.dumps(s.get('draw_service', {}).get('served'))}",
          flush=True)


def fork_tgen_leg(cli, prop, digest, tmp: str, device: str) -> dict:
    """The tgen_1k fork behind one DrawServer: FORK_TGEN_BRANCHES at
    jobs=2 through FleetRunner in this process (the members spawned, none
    creating a CUDA context: a breach fails its branch). The baseline must
    be the trunk, seed 3 the reference's standalone tree; the server's
    launches equal the batches it served plus its attach's. Then the
    trunk's remainder resumed standalone, for the walls. Returns the
    launches."""
    from shadow_tpu_torch import forks
    from shadow_tpu_torch.fleet import FleetRunner, _stream_digests

    cfg = str(EXAMPLES / "tgen_1k.yaml")
    trunk = os.path.join(tmp, "fork_trunk")
    sets = []
    for k, v in FORK_TGEN_OVER.items():
        sets += ["--set", f"{k}={v}"]
    prop.DeviceDrawPlane._cache.clear()
    t0 = time.perf_counter()
    s = run_cli(cli, [cfg, "--device", device, "--data-directory", trunk,
                      *sets])
    trunk_wall = time.perf_counter() - t0
    check_run(s, trunk, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
              "fork trunk (tgen_1k)")
    # the first boundary at or past 30 s (the round grid skips idle time)
    cks = sorted(Path(trunk, "checkpoints").glob("ckpt_t*.ckpt"))
    if not cks:
        fail("fork trunk: no checkpoint at 30 s")
    ck = cks[0]
    fork_dir = os.path.join(tmp, "fork_tgen_1k")
    plan = forks.plan_fork(cfg, ck, FORK_TGEN_BRANCHES, fork_dir,
                           overrides=dict(FORK_TGEN_OVER))
    prop.DeviceDrawPlane._cache.clear()  # the server attaches from cold
    gc.collect()
    prop.reset_launches()
    fs = FleetRunner(cfg, plan["order"], jobs=2, sweep_dir=fork_dir,
                     overrides=dict(FORK_TGEN_OVER), fork=plan, quiet=True,
                     device=device).run()
    n = dict(prop.LAUNCHES)
    svc = fs.get("draw_service")
    if fs["failed"] or sorted(fs["completed"]) != sorted(plan["order"]):
        fail(f"fork tgen_1k: failed {fs['failed']}")
    if svc is None or svc["errors"]:
        fail(f"fork tgen_1k: draw service {svc}")
    want = {k: svc["served"].get(k, 0) + svc["attach_launches"][k]
            for k in n}
    if device == "cuda" and n != want:
        fail(f"fork tgen_1k: launches {n} != served {svc['served']} + the "
             f"attach's {svc['attach_launches']}")
    man = {b: json.loads(Path(forks.branch_dir(fork_dir, b),
                              forks.FORK_MANIFEST).read_text())
           for b in plan["order"]}
    base = forks.branch_dir(fork_dir, "baseline")
    if man["baseline"]["mode"] != "restore" or digest(base) != \
            TGEN1K_TREE_DIGEST or _stream_digests(base) != \
            _stream_digests(trunk):
        fail("fork tgen_1k: the baseline branch is not the trunk")
    if man["seed3"]["mode"] != "cold" or \
            man["seed3"]["tree_sha256"] != FLEET_TGEN1K_TREES[3]:
        fail("fork tgen_1k: seed 3 is not the reference's standalone run")
    if man["degrade"]["mode"] != "restore" or \
            "commands.jsonl" not in man["degrade"]["streams_sha256"]:
        fail(f"fork tgen_1k: degrade branch {man['degrade']}")
    prop.DeviceDrawPlane._cache.clear()  # as a fresh process
    gc.collect()
    t0 = time.perf_counter()
    run_cli(cli, [cfg, "--device", device, "--data-directory",
                  os.path.join(tmp, "fork_trunk_rest"), "--resume-from",
                  str(ck), *sets])
    rest_wall = time.perf_counter() - t0
    walls = {b: m["wall_seconds"] for b, m in man.items()}
    degrade = ("the trunk's" if man["degrade"]["tree_sha256"]
               == TGEN1K_TREE_DIGEST else "diverged")
    print(f"fork tgen_1k (C engine, tpu_batch auto, jobs=2, one "
          f"DrawServer): baseline byte-identical to the trunk, seed3 the "
          f"reference's tree, degrade's tree {degrade}; served {json.dumps(svc['served'])} batches "
          f"({svc['served_units']} units; min_draw batches served: "
          f"{svc['served'].get('min_draw', 0)}), launches {json.dumps(n)} "
          f"= served + the attach's {json.dumps(svc['attach_launches'])}; "
          f"no member created a CUDA context; fork wall "
          f"{fs['fork_wall_seconds']} s against {rest_wall:.3f} s for the "
          f"trunk's remainder resumed standalone (trunk {trunk_wall:.3f} s "
          f"whole); branch walls {json.dumps(walls)} (restore baseline and "
          f"degrade, cold seed3)", flush=True)
    return n


def fork_path(cli, prop, digest, tmp: str, device: str = "cuda") -> dict:
    """Phase 20, checkpoint-forked what-if trees on ``device``: the CI's
    fork leg (fork_ci_leg) and the tgen_1k fork behind one DrawServer
    (fork_tgen_leg). Returns the launches."""
    fork_ci_leg(cli, digest, tmp, device)
    return fork_tgen_leg(cli, prop, digest, tmp, device)


# -- phase 21: managed processes ----------------------------------------------

#: the guest programs the managed phase runs, built by native/Makefile's
#: targets of these names (never its ``all``, which builds the
#: reference's C engine into shadow_tpu/)
MANAGED_GUESTS = ("tgen_srv", "tgen_cli", "ring_probe", "sleep_clock")
#: edge 0-1 of managed_smoke and fifty_lossy, and the same with loss: the
#: lossy documents send the guests' packets through the draw plane
_EDGE01 = 'edge [ source 0 target 1 latency "20 ms" ]'
_EDGE01_LOSSY = 'edge [ source 0 target 1 latency "20 ms" packet_loss 0.01 ]'
#: the reference's results on the managed documents (``python -m
#: shadow_tpu <doc> --scheduler-policy tpu_batch``, the guests' stdout
#: hashed by guest_stdout_digest; identical under tpu_mesh, at every floor
#: and with the shim's fast plane on or off). Not ``syscalls``: the count
#: of a guest's syscalls depends on the machine's libc.
MANAGED_RESULTS = {
    "managed_smoke": {
        "counts": {"rounds": 46, "events": 44, "units_sent": 41,
                   "units_dropped": 0, "bytes_sent": 301648},
        "stdout": "9265bbeef1c2a3c8d40003dd7bf3a970"
                  "e7cc2bf2cdddf553db5c7ae174a04778"},
    "managed_lossy": {
        "counts": {"rounds": 46, "events": 44, "units_sent": 41,
                   "units_dropped": 0, "bytes_sent": 301648},
        "stdout": "9265bbeef1c2a3c8d40003dd7bf3a970"
                  "e7cc2bf2cdddf553db5c7ae174a04778"},
    "fifty_lossy": {
        "counts": {"rounds": 842, "events": 920, "units_sent": 806,
                   "units_dropped": 27, "bytes_sent": 4082560},
        "stdout": "b59066083f1e38bfb8a598e0efddfde8"
                  "b84155db10c550fca75af52be21cbc2a"},
}
#: the port's draw windows on the lossy documents at tpu_device_floor 1
#: with no state digest (its forced floor never moves; the reference's,
#: 21 and 207 on an unloaded host, backs off after slow window reads)
MANAGED_FLOOR1_WINDOWS = {"managed_lossy": 21, "fifty_lossy": 207}
#: real_curl_1k (bench.py): 50 CPython http.server hosts, 200 distro curl
#: clients, 5 fetches of 50 kB each, 60 s on a 64-node random graph
CURL_1K = {"servers": 50, "clients": 200, "fetches": 5, "bytes": 50_000}
CURL = Path("/usr/bin/curl")


def managed_doc(name: str, build) -> dict:
    """A managed document, its guests from ``build``: managed_smoke
    (examples/managed_smoke.yaml), managed_lossy (the same with
    packet_loss 0.01 on edge 0-1), fifty_lossy (the reference's 50-process
    scale config of tests/test_native_shim.py, 10 tgen_srv x 4 connections
    and 40 tgen_cli x 100 kB, with the same loss on edge 0-1) and proctree
    (examples/proctree.yaml: httpd, curl, a shell pipeline)."""
    import yaml

    build = Path(build)
    if name in ("managed_smoke", "managed_lossy"):
        text = (EXAMPLES / "managed_smoke.yaml").read_text().replace(
            "path: native/build/", f"path: {build}/")
        if name == "managed_lossy":
            text = text.replace(_EDGE01, _EDGE01_LOSSY)
        return yaml.safe_load(text)
    if name == "proctree":
        # The example names its helper binaries by an absolute path
        # ending in native/build/; point that prefix at this build.
        text = re.sub(r"/\S*?/native/build/", lambda _m: f"{build}/",
                      (EXAMPLES / "proctree.yaml").read_text())
        return yaml.safe_load(text)
    if name != "fifty_lossy":
        raise ValueError(f"unknown managed document {name!r}")
    hosts = {}
    for i in range(10):
        hosts[f"srv{i}"] = {
            "network_node_id": 0, "ip_addr": f"11.0.0.{i + 1}",
            "processes": [{"path": str(build / "tgen_srv"),
                           "args": ["8080", "4"],
                           "expected_final_state": {"exited": 0}}]}
    for i in range(40):
        hosts[f"cli{i}"] = {
            "network_node_id": 1,
            "processes": [{"path": str(build / "tgen_cli"),
                           "args": [f"11.0.0.{(i % 10) + 1}", "8080",
                                    "100000"],
                           "start_time": f"{1000 + i * 37} ms",
                           "expected_final_state": {"exited": 0}}]}
    return {
        "general": {"stop_time": "30s", "seed": 11},
        "network": {"graph": {"type": "gml", "inline": f"""graph [
  directed 0
  node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
  node [ id 1 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
  edge [ source 0 target 1 latency "20 ms" packet_loss 0.01 ]
  edge [ source 0 target 0 latency "2 ms" ]
  edge [ source 1 target 1 latency "2 ms" ]
]"""}},
        "hosts": hosts,
    }


def curl_1k_doc(docroot) -> dict:
    """bench.py's real_curl_1k document (CURL_1K), its body in
    ``docroot``: the same graph (tools/gen_benchmarks.random_gml from seed
    17), hosts, start times and seed."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    from gen_benchmarks import random_gml

    n_servers, n_clients = CURL_1K["servers"], CURL_1K["clients"]
    rng = np.random.default_rng(17)
    g = 64
    gml = random_gml(rng, g, min_lat_ms=5, max_lat_ms=60, max_loss=0.0,
                     bw_choices=("50 Mbit", "100 Mbit", "1 Gbit"))
    Path(docroot).mkdir(parents=True, exist_ok=True)
    (Path(docroot) / "data.bin").write_bytes(b"x" * CURL_1K["bytes"])
    hosts = {}
    for i in range(n_servers):
        hosts[f"web{i}"] = {
            "network_node_id": int(rng.integers(0, g)),
            "ip_addr": f"12.0.0.{i + 1}",
            "processes": [{
                "path": sys.executable,
                "args": ["-u", "-m", "http.server", "--directory",
                         str(docroot), "--bind", "0.0.0.0", "8080"],
                "expected_final_state": "running"}]}
    for i in range(n_clients):
        urls = [f"http://12.0.0.{(i + k) % n_servers + 1}:8080/data.bin"
                for k in range(CURL_1K["fetches"])]
        hosts[f"cli{i}"] = {
            "network_node_id": int(rng.integers(0, g)),
            "processes": [{
                "path": str(CURL),
                "args": (["-s", "-o", "/dev/null", "-w",
                          "code=%{http_code} bytes=%{size_download}\\n"]
                         + urls),
                "start_time": f"{2000 + i * 97} ms",
                "expected_final_state": {"exited": 0}}]}
    return {"general": {"stop_time": "60s", "seed": 23},
            "network": {"graph": {"type": "gml", "inline": gml}},
            "hosts": hosts}


def build_guests(build=None) -> Path:
    """Build MANAGED_GUESTS with native/Makefile (into native/build/, or
    ``build``); returns the directory. Raises with make's output."""
    out = Path(build if build is not None else ROOT / "native" / "build")
    # BUILD spelled as the targets are: make matches a target by its name
    cmd = ["make", "-C", str(ROOT / "native"), f"BUILD={out}"]
    r = subprocess.run(cmd + [str(out / g) for g in MANAGED_GUESTS],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building the guests failed: {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    return out


def write_doc(doc: dict, path) -> str:
    """Write ``doc`` as YAML in its own key order (the hosts' order is
    their ids'), returning the path."""
    import yaml

    Path(path).write_text(yaml.safe_dump(doc, sort_keys=False))
    return str(path)


def hosts_digest(data_dir, suffix: str = None) -> str:
    """sha256 over the hosts/ tree (relative path and content, sorted),
    less the guests' ``*.clock`` pages (the shim's live scratch page, as
    the reference's tools/ci.sh leaves them out); only the files ending in
    ``suffix`` when given."""
    import hashlib

    base = Path(data_dir)
    h = hashlib.sha256()
    for p in sorted((base / "hosts").rglob("*")):
        if not p.is_file() or p.name.endswith(".clock"):
            continue
        if suffix is not None and not p.name.endswith(suffix):
            continue
        h.update(str(p.relative_to(base)).encode() + b"\0")
        h.update(hashlib.sha256(p.read_bytes()).digest())
    return h.hexdigest()


def guest_stdout_digest(data_dir) -> str:
    """The guests' stdout, as hosts_digest hashes it."""
    return hosts_digest(data_dir, ".stdout")


def managed_stable(summary: dict, volatile) -> dict:
    """A managed run's summary less wall-clock telemetry and the
    ``shim_fast_*`` counters (where a syscall completed, which the shim's
    fast plane decides, not what the simulation did)."""
    out = {k: v for k, v in summary.items() if k not in volatile}
    out["counters"] = {k: v for k, v in summary["counters"].items()
                       if not k.startswith("shim_fast_")}
    return out


@contextlib.contextmanager
def shim_fast_plane(on: bool):
    """Switch the shim's fast plane for the runs in the block
    (SHADOW_TPU_SHIM_FASTPATH, which native/managed.py reads at import)."""
    from shadow_tpu_torch.native import managed

    was = managed._FASTPATH_ON
    managed._FASTPATH_ON = on
    try:
        yield
    finally:
        managed._FASTPATH_ON = was


def managed_run(cli, doc_path: str, d: str, device: str, extra=()) -> dict:
    s = run_cli(cli, [doc_path, "--device", device, "--data-directory", d,
                      *extra])
    if s["process_errors"]:
        fail(f"managed {doc_path} {list(extra)}: process errors "
             f"{s['process_errors'][:3]}")
    return s


def managed_identity(a: dict, b: dict, da: str, db: str, what: str,
                     volatile) -> None:
    """Two managed runs gave the same summary (less volatile keys and
    shim_fast_*), hosts tree (less *.clock) and state digest stream."""
    if managed_stable(a, volatile) != managed_stable(b, volatile):
        fail(f"{what}: summaries differ: "
             f"{managed_stable(a, volatile)} != {managed_stable(b, volatile)}")
    if hosts_digest(da) != hosts_digest(db):
        fail(f"{what}: hosts trees differ")
    sa, sb = (Path(x, "state_digests.jsonl") for x in (da, db))
    if sa.exists() != sb.exists() or (
            sa.exists() and sa.read_bytes() != sb.read_bytes()):
        fail(f"{what}: state digest streams differ")


def check_managed_result(s: dict, d: str, name: str) -> None:
    want = MANAGED_RESULTS[name]
    got = {k: s[k] for k in want["counts"]}
    if got != want["counts"]:
        fail(f"{name}: counts {got} != reference {want['counts']}")
    if guest_stdout_digest(d) != want["stdout"]:
        fail(f"{name}: the guests' stdout {guest_stdout_digest(d)} != "
             f"reference {want['stdout']}")


def check_windows_against_plain(torch, prop, windows) -> int:
    """The draws of recorded floor-1 windows: draw_flags on the card
    against its plain version on the same inputs, bit for bit. Returns the
    largest absolute error."""
    err = 0
    for x, key, width, n in windows:
        got = prop.draw_flags(x, key, width, n)
        want = prop.draw_flags_plain(x.cpu(), key, width, n)
        err = max(err, abs_err(torch, got.cpu(), want))
    return err


def managed_path(cli, prop, mesh, tmp: str, device: str = "cuda",
                 curl: bool = True) -> tuple:
    """Phase 21: real binaries under the port's CLI on ``device``. Returns
    (launches, the largest error of the recorded windows' draws), or
    (None, None) where the machine lacks a kernel feature the guests need
    (printed by name). ``curl``: run real_curl_1k too."""
    import torch

    from shadow_tpu_torch import native
    from shadow_tpu_torch.core.controller import VOLATILE_SUMMARY_KEYS as vol
    from shadow_tpu_torch.native import managed

    missing = managed.missing_kernel_features()
    if missing:
        print(f"managed: not run: kernel capabilities missing: "
              f"{', '.join(missing)}", flush=True)
        return None, None
    t0 = time.perf_counter()
    build = build_guests()
    shim = native.shim_lib()
    print(f"managed: guests {list(MANAGED_GUESTS)} and the shim ({shim.name}"
          f") ready in {time.perf_counter() - t0:.2f} s; fds 932-995 free "
          f"in this process: {managed_fds_free()}", flush=True)
    docs = {n: write_doc(managed_doc(n, build),
                         os.path.join(tmp, f"{n}.yaml"))
            for n in ("managed_smoke", "managed_lossy", "fifty_lossy",
                      "proctree")}
    total = {"draw_flags": 0, "min_draw": 0, "mesh_exchange": 0}
    tb = ["--scheduler-policy", "tpu_batch"]

    def counted(fn):
        gc.collect()
        prop.reset_launches()
        mesh.reset_launches()
        out = fn()
        n = {**prop.LAUNCHES, "mesh_exchange": mesh.LAUNCHES["mesh_exchange"]}
        for k in total:
            total[k] += n[k]
        return out, n

    # leg 1: managed_smoke with the fast plane on and off, and under
    # thread_per_core
    runs = {}
    for label, on, pol in (("fast", True, "tpu_batch"),
                           ("slow", False, "tpu_batch"),
                           ("thread_per_core", True, "thread_per_core")):
        d = os.path.join(tmp, f"msmoke_{label}")
        with shim_fast_plane(on):
            runs[label] = (managed_run(
                cli, docs["managed_smoke"], d, device,
                ["--scheduler-policy", pol, "--state-digest-every", "5"]), d)
    (fast, df), (slow, ds), (tpc, dt) = (runs[k] for k in (
        "fast", "slow", "thread_per_core"))
    managed_identity(fast, slow, df, ds, "managed_smoke fast/slow", vol)
    managed_identity(fast, tpc, df, dt, "managed_smoke tpu_batch/"
                     "thread_per_core", vol)
    c = fast["counters"]
    if not c.get("shim_fast_syscalls", 0) * 2 > c["syscalls"]:
        fail(f"managed_smoke: {c.get('shim_fast_syscalls', 0)} of "
             f"{c['syscalls']} syscalls in-shim on the fast leg")
    if slow["counters"].get("shim_fast_ring_read", 0) != 0:
        fail(f"managed_smoke: the slow leg read {slow['counters']} in-shim")
    out = Path(df, "hosts", "client", "ring_probe.0.stdout").read_text()
    if "bytes=300000" not in out or "eof=1" not in out:
        fail(f"managed_smoke: ring_probe printed {out!r}")
    check_managed_result(fast, df, "managed_smoke")
    print(f"managed_smoke: fast plane on = off = thread_per_core (summary "
          f"less shim_fast_*, hosts tree less *.clock, state digests); "
          f"{c['shim_fast_syscalls']}/{c['syscalls']} syscalls in-shim on "
          f"the fast leg; ring_probe {out.strip()!r}; controller "
          f"{fast['wall_seconds']:.3f} s fast, {slow['wall_seconds']:.3f} s "
          f"slow", flush=True)

    # leg 2: managed_lossy on both engines at floor 1, auto, tpu_mesh
    lossy = {}
    windows = []
    for label, extra in (
            ("tpu_batch floor 1 C engine", tb + _FLOOR1),
            ("tpu_batch floor 1 Python plane", tb + _FLOOR1 + PY_PLANE),
            ("tpu_batch auto", tb),
            ("tpu_mesh floor 0", ["--scheduler-policy", "tpu_mesh", "--set",
                                  "experimental.tpu_mesh_floor=0"])):
        d = os.path.join(tmp, "mlossy_" + label.replace(" ", "_"))
        argv = extra  # no state digest: its flushes would split windows
        if label.endswith("C engine") and device == "cuda":
            with recording_draws(prop, "draw_flags") as windows:
                s, n = counted(lambda: managed_run(
                    cli, docs["managed_lossy"], d, device, argv))
        else:
            s, n = counted(lambda: managed_run(
                cli, docs["managed_lossy"], d, device, argv))
        check_managed_result(s, d, "managed_lossy")
        lossy[label] = (s, d)
        if device == "cuda" and "floor 1" in label and not (
                n["draw_flags"] == s["device_windows_dispatched"] > 0):
            fail(f"managed_lossy {label}: draw_flags launched "
                 f"{n['draw_flags']} times for "
                 f"{s['device_windows_dispatched']} windows")
        if device == "cuda" and "tpu_mesh" in label and not (
                n["mesh_exchange"] == s["phase_wall"]["mesh_windows"] > 0):
            fail(f"managed_lossy {label}: mesh_exchange launched "
                 f"{n['mesh_exchange']} times for "
                 f"{s['phase_wall']['mesh_windows']} windows")
        if "floor 1" in label and s["device_windows_dispatched"] != \
                MANAGED_FLOOR1_WINDOWS["managed_lossy"]:
            fail(f"managed_lossy {label}: {s['device_windows_dispatched']} "
                 f"windows, not {MANAGED_FLOOR1_WINDOWS['managed_lossy']}")
        print(f"managed_lossy ({label}): counts and guests' stdout match "
              f"the reference; windows {s['device_windows_dispatched']}, "
              f"mesh windows {s['phase_wall'].get('mesh_windows', 0)}, "
              f"launches {json.dumps(n)}, controller "
              f"{s['wall_seconds']:.3f} s, "
              f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s", flush=True)
    (s0, d0), *rest = lossy.values()
    for (s1, d1), label in zip(rest, list(lossy)[1:]):
        managed_identity(s0, s1, d0, d1, f"managed_lossy {label}", vol)
    err = None
    if device == "cuda":
        if not windows:
            fail("managed_lossy: the floor-1 run handed draw_flags no window")
        err = check_windows_against_plain(torch, prop, windows)
        if err:
            fail(f"managed_lossy: draw_flags differs from its plain version "
                 f"by {err} on the run's windows")
        print(f"managed_lossy: the {len(windows)} floor-1 windows' draws "
              f"equal the plain version's (max abs err 0)", flush=True)

    # leg 3: fifty_lossy, 50 real processes at floor 1
    d = os.path.join(tmp, "fifty_lossy")
    t0 = time.perf_counter()
    s, n = counted(lambda: managed_run(cli, docs["fifty_lossy"], d, device,
                                       tb + _FLOOR1))
    wall = time.perf_counter() - t0
    check_managed_result(s, d, "fifty_lossy")
    if s["device_windows_dispatched"] != MANAGED_FLOOR1_WINDOWS[
            "fifty_lossy"]:
        fail(f"fifty_lossy: {s['device_windows_dispatched']} windows, not "
             f"{MANAGED_FLOOR1_WINDOWS['fifty_lossy']}")
    if device == "cuda" and not (
            n["draw_flags"] == s["device_windows_dispatched"] > 0):
        fail(f"fifty_lossy: draw_flags launched {n['draw_flags']} times for "
             f"{s['device_windows_dispatched']} windows")
    c = s["counters"]
    print(f"fifty_lossy (50 processes, tpu_batch floor 1): counts and "
          f"guests' stdout match the reference; windows "
          f"{s['device_windows_dispatched']}, launches {json.dumps(n)}; "
          f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, controller "
          f"{s['wall_seconds']:.3f} s of {wall:.3f} s; syscalls "
          f"{c['syscalls']} ({c.get('shim_fast_syscalls', 0)} in-shim); "
          f"phase_wall {json.dumps(s['phase_wall'])}", flush=True)

    # the observation journal's cost: fifty_lossy again with every guest
    # journaled (SHADOW_TPU_GUEST_JOURNAL=1; off by default without a
    # checkpoint cadence), the same results
    dj = os.path.join(tmp, "fifty_lossy_journal")
    os.environ["SHADOW_TPU_GUEST_JOURNAL"] = "1"
    try:
        sj, _ = counted(lambda: managed_run(cli, docs["fifty_lossy"], dj,
                                            device, tb + _FLOOR1))
    finally:
        del os.environ["SHADOW_TPU_GUEST_JOURNAL"]
    managed_identity(s, sj, d, dj, "fifty_lossy journaled", vol)
    if not list(Path(dj, "guest_oplogs").glob("*.jsonl")):
        fail("fifty_lossy journaled: no guest journal written")
    print(f"fifty_lossy with every guest journaled: the same results; "
          f"controller {sj['wall_seconds']:.3f} s against "
          f"{s['wall_seconds']:.3f} s without", flush=True)

    # leg 4: a re-execution checkpoint of managed_smoke, resumed
    ck_runs = {}
    ck_dir = os.path.join(tmp, "mckpt_src")
    for label, extra in (("full", []), ("src", ["--checkpoint-every",
                                                "500ms"])):
        dd = os.path.join(tmp, f"mckpt_{label}")
        ck_runs[label] = (managed_run(
            cli, docs["managed_smoke"], dd, device,
            tb + ["--state-digest-every", "5", *extra]), dd)
    cks = sorted(Path(ck_dir, "checkpoints").glob("ckpt_*.ckpt"))
    if not cks:
        fail("managed checkpoint: the source run wrote no checkpoint")
    header = json.loads(cks[0].read_text().splitlines()[0])
    payload = json.loads(cks[0].read_text().splitlines()[1])
    from shadow_tpu_torch import checkpoint as _ckpt

    if (header.get("mode"), header.get("managed"), header.get("format"),
            header.get("version")) != ("reexec", True, _ckpt.FORMAT,
                                       _ckpt.VERSION) or not payload.get(
                                           "cursors"):
        fail(f"managed checkpoint: header {header}, cursors "
             f"{payload.get('cursors')}")
    (sf, dfull) = ck_runs["full"]
    managed_identity(sf, ck_runs["src"][0], dfull, ck_runs["src"][1],
                     "managed checkpoint: the checkpointing run", vol)
    walls = []
    for i, ck in enumerate(cks):
        dd = os.path.join(tmp, f"mckpt_resume{i}")
        t0 = time.perf_counter()
        s = managed_run(cli, docs["managed_smoke"], dd, device,
                        tb + ["--state-digest-every", "5", "--resume-from",
                              str(ck)])
        walls.append(round(time.perf_counter() - t0, 3))
        managed_identity(sf, s, dfull, dd, f"managed checkpoint: the "
                         f"resume from {ck.name}", vol)
    print(f"managed checkpoint: {len(cks)} re-execution snapshots "
          f"(format {header['format']} version {header['version']}, "
          f"{len(payload['cursors'])} guest cursors in the first); each "
          f"resume equals the uninterrupted run (summary, hosts tree, "
          f"state digests), walls {walls} s", flush=True)

    # leg 5: proctree and real_curl_1k
    if not CURL.exists():
        print("managed proctree: not run: no /usr/bin/curl", flush=True)
        print("managed real_curl_1k: not run: no /usr/bin/curl", flush=True)
        return total, err
    d = os.path.join(tmp, "proctree")
    s = managed_run(cli, docs["proctree"], d, device, tb)
    got = Path(d, "hosts", "curlbox", "curl.0.stdout").read_text()
    sh = Path(d, "hosts", "shellbox", "sh.0.stdout").read_text()
    if "code=200 bytes=250000" not in got or "pipeline-done" not in sh:
        fail(f"proctree: curl printed {got!r}, the shell {sh!r}")
    c = s["counters"]
    print(f"proctree: curl {got.strip()!r}, the pipeline done; "
          f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, syscalls "
          f"{c['syscalls']} ({c.get('shim_fast_syscalls', 0)} in-shim)",
          flush=True)
    if not curl:
        return total, err
    d = os.path.join(tmp, "real_curl_1k")
    doc = write_doc(curl_1k_doc(os.path.join(tmp, "curl_docroot")),
                    os.path.join(tmp, "real_curl_1k.yaml"))
    t0 = time.perf_counter()
    s, n = counted(lambda: managed_run(cli, doc, d, device, tb))
    wall = time.perf_counter() - t0
    want = f"code=200 bytes={CURL_1K['bytes']}"
    ok = sum(Path(d, "hosts", f"cli{i}", "curl.0.stdout").read_text().count(
        want) for i in range(CURL_1K["clients"]))
    if ok != CURL_1K["clients"] * CURL_1K["fetches"]:
        fail(f"real_curl_1k: {ok} of "
             f"{CURL_1K['clients'] * CURL_1K['fetches']} transfers "
             f"validated")
    c = s["counters"]
    print(f"real_curl_1k ({CURL_1K['servers']} http.server x "
          f"{CURL_1K['clients']} curl x {CURL_1K['fetches']} fetches): all "
          f"{ok} transfers code 200 with {CURL_1K['bytes']} bytes; "
          f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, controller "
          f"{s['wall_seconds']:.3f} s of {wall:.3f} s; syscalls "
          f"{c['syscalls']}, {c.get('shim_fast_syscalls', 0)} in-shim; "
          f"launches {json.dumps(n)}; phase_wall "
          f"{json.dumps(s['phase_wall'])}", flush=True)
    return total, err


def managed_fds_free() -> bool:
    """The shim's fixed channel fds (932-995) are not held by anything in
    this process (the CUDA context included), but for the reserved 995."""
    from shadow_tpu_torch.native import managed

    held = []
    for fd in range(managed.IPC_LOW, managed.SHIM_IPC_FD):
        try:
            os.fstat(fd)
            held.append(fd)
        except OSError:
            pass
    if held:
        fail(f"managed: fds {held} of the shim's channel window are held "
             f"in the simulator process")
    return True


# -- phases 7-9, 11-21 and 24: the port's CLI on the card -------------------

def run_cli(cli, argv: list, cut: bool = False) -> dict:
    """Run the port's CLI in this process; returns its JSON summary. A run
    ``cut`` short of its config's stop time may exit 1: processes that
    had not finished are process errors there, held by check_run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--json-summary", "--quiet"])
    if rc not in ((0, 1) if cut else (0,)):
        fail(f"shadow_tpu_torch {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def errors_digest(errors: list) -> tuple:
    """(count, sha256 of the lines) of a run's process errors."""
    import hashlib

    return len(errors), hashlib.sha256(
        "\n".join(errors).encode()).hexdigest()


def check_run(summary: dict, data_dir: str, digest, counts, tree,
              what: str, errors: tuple = None) -> None:
    """The run's process errors (none, unless ``errors`` gives the
    reference's as errors_digest does), counts and output tree are the
    reference's."""
    got = errors_digest(summary["process_errors"])
    if got != (errors or errors_digest([])):
        fail(f"{what}: process errors {got} != reference {errors} "
             f"({summary['process_errors'][:3]})")
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


#: every phase after device and build, in order; --phases picks some (and
#: what they need). The kernel table needs the timing phase.
# -- phase 25: the multi-device layout ----------------------------------------

#: entries the per-entry kernel sweep runs on (all entries of cuda:0)
ENTRY_COUNTS = (2, 4, 8)
#: the multi-entry legs' device list: four entries of card 0
FOUR_ENTRIES = ",".join(["cuda:0"] * 4)
#: state digest cadence of the one-entry runs (phases main path and mesh
#: path) and of the multi-entry legs that hold their streams
MD_DIGEST = ["--state-digest-every", "500"]


#: entries of the sweep's one cooperative launch (past mesh.CLUSTER_MAX)
ENTRY_COOPERATIVE = 17
#: the timeout check's limit: long past a window, short for the script
ENTRY_TIMEOUT_CHECK_NS = 50_000_000
#: windows driven through one kept EntryWindow a route (flags never reset)
ENTRY_EPOCHS = 6


def check_entry_exchange(torch, np, mesh, dev, rng, seeds) -> tuple:
    """mesh_exchange_entry against its plain version on ``dev``, bit for
    bit: N in ENTRY_COUNTS entries of the card on mixed and
    destination-skewed windows at m = 256 and a mixed one at 1,024, and N =
    ENTRY_COOPERATIVE (one cooperative launch) on a mixed window at 256;
    every w of {the smallest bucket, m, N m}, the two seeds in turn; each
    once on the local route and once with every pair forced through host
    memory by the plan. The plain version is held to exchange_rounds_plain
    too. Then, at N in ENTRY_COUNTS and on each route, one EntryWindow
    kept through ENTRY_EPOCHS windows as the plane drives it: epochs 1, 2,
    ..., fresh units each window (mixed and skewed in turn), the inboxes
    and flags reused and never reset; every window against the plain
    version. Then a window whose plan launches only two of four entries: the
    two blocks wait for sources that never publish and the wrapper must
    raise mesh.ExchangeTimeout naming source 2 and epoch 1, within a
    second. Returns (largest absolute error, comparisons)."""
    err, n_cmp = 0, 0
    access = torch.cuda.can_device_access_peer
    cases = [(n, m, skew) for n in ENTRY_COUNTS
             for m, skew in ((256, False), (256, True), (1024, False))]
    cases.append((ENTRY_COOPERATIVE, 256, False))
    for i, (n, m, skew) in enumerate(cases):
        x = torch.from_numpy(exchange_inputs(np, rng, n, m, skew)).to(dev)
        seed = seeds[i % 2]
        entries = (dev,) * n
        plans = [mesh.entry_plan(entries, access, h) for h in (False, True)]
        for w in sorted({MESH_BUCKETS[0], m, n * m}):
            want = mesh.exchange_entry_plain(x, seed, 10, w)
            whole = mesh.exchange_rounds_plain(x, seed, 10, w)
            same(torch, (want[0], want[1]),
                 (whole[0], whole[1].expand(n)),
                 f"exchange_entry_plain n={n} m={m} w={w}")
            for plan in plans:
                mesh.reset_launches()
                got = mesh.mesh_exchange_entry(x, seed, 10, w, plan=plan)
                err = max(err, same(
                    torch, got, want,
                    f"mesh_exchange_entry n={n} m={m} w={w} skew={skew} "
                    f"route={plan.routes[0][-1]}"))
                if (mesh.LAUNCHES["mesh_exchange_entry"] != 1
                        or mesh.ENTRY_LAUNCHES != dict.fromkeys(range(n), 1)):
                    fail(f"mesh_exchange_entry n={n}: launches "
                         f"{dict(mesh.LAUNCHES)}, blocks "
                         f"{mesh.ENTRY_LAUNCHES} (want one launch, one "
                         f"block an entry)")
                n_cmp += 2
    stream = [torch.cuda.current_stream(dev)]
    for n in ENTRY_COUNTS:
        for host_only in (False, True):
            plan = mesh.entry_plan((dev,) * n, access, host_only)
            st = mesh.EntryWindow((dev,) * n, n, 256, 256, plan)
            for epoch in range(1, ENTRY_EPOCHS + 1):
                u = exchange_inputs(np, rng, n, 256, epoch % 2 == 0)
                seed = seeds[epoch % 2]
                st.units[:] = u
                st.launch(seed, 10, epoch, stream)
                st.finish(epoch, stream)
                got = (torch.from_numpy(np.stack(
                    [e.out[:4 * 256] for e in st.stages])).view(n, 256, 4),
                       torch.from_numpy(np.array(
                           [e.out[4 * 256] for e in st.stages])))
                err = max(err, same(
                    torch, got, mesh.exchange_entry_plain(
                        torch.from_numpy(u), seed, 10, 256),
                    f"kept EntryWindow n={n} route={plan.routes[0][-1]} "
                    f"epoch={epoch}"))
                n_cmp += 1
    x = torch.from_numpy(exchange_inputs(np, rng, 4, 256, False)).to(dev)
    full = mesh.entry_plan((dev,) * 4, access)
    half = mesh.EntryPlan(((dev.index, (0, 1)),), full.routes)
    t0 = time.perf_counter()
    try:
        mesh.mesh_exchange_entry(x, seeds[0], 10, 256, plan=half,
                                 timeout_ns=ENTRY_TIMEOUT_CHECK_NS)
    except mesh.ExchangeTimeout as exc:
        took = time.perf_counter() - t0
        if "source 2's rows of window epoch 1" not in str(exc) or took > 1:
            fail(f"the timeout check raised after {took:.3f} s: {exc}")
        print(f"a source that never publishes: raised after {took:.3f} s "
              f"(limit {ENTRY_TIMEOUT_CHECK_NS} ns): {exc}", flush=True)
    else:
        fail("mesh_exchange_entry returned though two of its four sources "
             "never published")
    return err, n_cmp


#: the entry counts and batch sizes draw_flags_entry and min_draw_entry are
#: held at (sizes 1 and 7 leave every piece but the first empty)
DRAW_ENTRY_COUNTS = (2, 3, 4, 8)
DRAW_ENTRY_SIZES = (1, 7, 8, 33, 4096, 65536)


def check_draw_entry(torch, np, prop, dev, rng) -> tuple:
    """draw_flags_entry and min_draw_entry against their plain versions on
    ``dev``, bit for bit, pads included: k entries in DRAW_ENTRY_COUNTS
    over batches of DRAW_ENTRY_SIZES units, padded and split as
    DeviceDrawPlane splits them (pieces past a small batch's end have no
    real unit; k = 3 starts pieces off a 32-unit row), widths 10 and 33
    (two lanes a thread), with the table of every piece (k entries on one
    card) and of the even pieces (card 0 of an interleaved list
    cuda:0,cuda:1,cuda:0,...). Returns (the largest absolute error per
    kernel, the comparisons)."""
    err = {"draw_flags_entry": 0, "min_draw_entry": 0}
    n_cmp = 0
    seed = (1 << 32) + 0x5EED
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for k in DRAW_ENTRY_COUNTS:
        for n in DRAW_ENTRY_SIZES:
            piece = prop.piece_width(prop._bucket(n, 65536), k)
            region = prop.region_width(piece)
            x = np.zeros((4, k * piece), np.uint32)
            x[:, :n] = sweep_inputs(rng, n, 4)
            x = torch.from_numpy(x).to(dev)
            inputs = {"draw_flags_entry": x,
                      "min_draw_entry": x[:3].contiguous()}
            for pieces in (range(k), range(0, k, 2)):
                table = prop.piece_table(n, piece, pieces)
                for width in (10, 33):
                    for name, inp in inputs.items():
                        got = getattr(prop, name)(inp, key, width, table,
                                                  region)
                        want = getattr(prop, f"{name}_plain")(
                            inp, key, width, table, region)
                        e = abs_err(torch, got.reshape(-1),
                                    want.reshape(-1))
                        err[name] = max(err[name], e)
                        if not torch.equal(got, want):
                            fail(f"{name}: k={k} n={n} pieces "
                                 f"{list(pieces)} width={width} differs "
                                 f"from the plain version (max abs err "
                                 f"{e})")
                        n_cmp += 1
    return err, n_cmp


#: real units a shard a round in the calls of one kept RoundStage, in
#: turn (None: a random count up to C): a large call, smaller ones over its
#: rows, an empty one, then larger again
ROUND_STAGE_CALLS = (None, 200, 3, 0, None, 1)


def rounds_plain(torch, mesh, states, units, tables, t_nows, seed):
    """mesh_rounds_entry's plain version on the same inputs (on their
    device), its inboxes read as the wrapper reads them: ((received,
    g_min, counters) on the CPU, the N new states)."""
    rows, counts, new, g_min, counters = mesh.rounds_entries_plain(
        states, units, tables, t_nows, seed, 10)
    recv = mesh.read_rounds(rows.cpu().numpy(), counts.cpu().numpy())
    return (torch.from_numpy(recv), g_min.cpu(), counters.cpu()), new


def check_entry_rounds(torch, np, mesh, dev, rng, seeds) -> tuple:
    """mesh_rounds_entry against its plain version (rounds_plain) on
    ``dev``, bit for bit, the states included: N in ENTRY_COUNTS and
    ENTRY_COOPERATIVE entries of the card (one cooperative launch); C = 64
    over K = 8 and C = 2,048 over one round at 1,000 hosts (tables and
    state in shared memory), C = 257 at 20,000 hosts (device memory); each
    on the local route and with every pair forced through host memory by
    the plan; one launch a call, one block an entry. Then, at N = 4 and on
    each route, one RoundStage (N, 8, 256) kept through the calls of
    ROUND_STAGE_CALLS with epochs 1, 2, ...: the inboxes
    reused and never cleared, the flags never reset, the states advanced
    in place. Then a call whose plan launches two of four entries: the two
    blocks wait for sources that never publish and the wrapper must raise
    mesh.ExchangeTimeout naming source 2 and epoch 1, within a second.
    Returns (largest absolute error, comparisons)."""
    err, n_cmp = 0, 0
    access = torch.cuda.can_device_access_peer
    t0 = 40 * 10 ** 9

    def inputs(n, h, c, k, used=None):
        tabs, hs = round_tables(np, rng, n, h, 32)
        tables = tuple(torch.from_numpy(np.asarray(t, np.int64)).to(dev)
                       for t in tabs)
        state = torch.from_numpy(round_state(np, rng, tabs, n, hs,
                                             t0)).to(dev)
        return (tabs, hs, tables,
                [state[:, s:s + 1].clone() for s in range(n)],
                torch.from_numpy(np.stack([round_units(
                    np, rng, n, hs, c, t0 + j * 2_000_000, used)
                    for j in range(k)])).to(dev),
                torch.arange(k, device=dev) * 2_000_000 + t0)

    for n in ENTRY_COUNTS + (ENTRY_COOPERATIVE,):
        for h, c, k in ((1000, 64, 8), (1000, 2048, 1), (20000, 257, 1)):
            _tabs, _hs, tables, states, units, t_nows = inputs(n, h, c, k)
            seed = seeds[k == 8]
            want, after = rounds_plain(torch, mesh, states, units, tables,
                                       t_nows, seed)
            for host_only in (False, True):
                plan = mesh.entry_plan((dev,) * n, access, host_only)
                on_card = [x.clone() for x in states]
                mesh.reset_launches()
                got = mesh.mesh_rounds_entry(on_card, units, [tables] * n,
                                             t_nows, seed, 10, plan=plan)
                what = (f"mesh_rounds_entry n={n} hosts={h} c={c} k={k} "
                        f"route={plan.routes[0][-1]}")
                err = max(err, same(torch, got, want, what),
                          same(torch, on_card, after, f"{what}, state"))
                if (mesh.LAUNCHES["mesh_rounds_entry"] != 1
                        or mesh.ENTRY_LAUNCHES != dict.fromkeys(range(n),
                                                                1)):
                    fail(f"{what}: launches {dict(mesh.LAUNCHES)}, blocks "
                         f"{mesh.ENTRY_LAUNCHES} (want one launch, one "
                         f"block an entry)")
                n_cmp += 1
    stream = [torch.cuda.current_stream(dev)]
    for n in (4,):
        for host_only in (False, True):
            tabs, hs, tables, states, _u, _t = inputs(n, 1000, 256, 1)
            plan = mesh.entry_plan((dev,) * n, access, host_only)
            st = mesh.RoundStage((dev,) * n, n, 8, 256, states,
                                 [tables] * n, plan)
            t = t0
            for epoch, used in enumerate(ROUND_STAGE_CALLS, start=1):
                u = np.stack([round_units(np, rng, n, hs, 256,
                                          t + j * 2_000_000, used)
                              for j in range(8)])
                t_nows = np.arange(8, dtype=np.int64) * 2_000_000 + t
                seed = seeds[epoch % 2]
                want, after = rounds_plain(
                    torch, mesh, states, torch.from_numpy(u).to(dev),
                    tables, torch.from_numpy(t_nows).to(dev), seed)
                st.units[...] = u
                st.t_now[...] = t_nows
                st.run(seed, 10, epoch, stream)
                what = (f"kept RoundStage n={n} route={plan.routes[0][-1]} "
                        f"epoch={epoch} units={used}")
                err = max(err, same(torch, tuple(
                    torch.from_numpy(x) for x in st.read()), want, what),
                          same(torch, states, after, f"{what}, state"))
                t += 8 * 2_000_000
                n_cmp += 1
    _tabs, _hs, tables, states, units, t_nows = inputs(4, 1000, 256, 8)
    full = mesh.entry_plan((dev,) * 4, access)
    half = mesh.EntryPlan(((dev.index, (0, 1)),), full.routes)
    t1 = time.perf_counter()
    try:
        mesh.mesh_rounds_entry(states, units, [tables] * 4, t_nows,
                               seeds[0], 10, plan=half,
                               timeout_ns=ENTRY_TIMEOUT_CHECK_NS)
    except mesh.ExchangeTimeout as exc:
        took = time.perf_counter() - t1
        if "source 2's rows of call epoch 1" not in str(exc) or took > 1:
            fail(f"the rounds' timeout check raised after {took:.3f} s: "
                 f"{exc}")
        print(f"a source of the rounds that never publishes: raised after "
              f"{took:.3f} s (limit {ENTRY_TIMEOUT_CHECK_NS} ns): {exc}",
              flush=True)
    else:
        fail("mesh_rounds_entry returned though two of its four sources "
             "never published")
    return err, n_cmp


def check_entry_kernels(torch, np, mesh, prop, dev) -> dict:
    """The per-entry kernels against their plain versions on ``dev``, bit
    for bit: mesh_exchange_entry (check_entry_exchange), mesh_rounds_entry
    (check_entry_rounds; both launch paths must be taken); then
    MeshDataPlane over 2 and 8 entries of the card (exchange_rounds over
    windows whose bucket grows and shrinks, round_step, scan_rounds)
    against CPU planes; draw_flags_entry and min_draw_entry
    (check_draw_entry), and DeviceDrawPlane split over three and four
    entries of the card against a CPU plane, its handles read last first.
    Returns the largest absolute error per kernel (the tolerance is 0)."""
    from shadow_tpu_torch.network.fluid import NetParams

    rng = np.random.default_rng(20261019)
    seeds = (2, (1 << 32) + 0xDEADBEEF)
    err = {}
    err["mesh_exchange_entry"], n_cmp = check_entry_exchange(
        torch, np, mesh, dev, rng, seeds)
    paths = dict(mesh.PATHS)
    err["mesh_rounds_entry"], n_rounds = check_entry_rounds(
        torch, np, mesh, dev, rng, seeds)
    n_cmp += n_rounds
    taken = {k: mesh.PATHS[k] - paths[k] for k in
             ("entry_rounds_cluster", "entry_rounds_cooperative")}
    if min(taken.values()) <= 0:
        fail(f"mesh_rounds_entry never took a launch path: {taken}")
    h, g = 1000, 32
    params = NetParams.build(
        host_node=rng.integers(0, g, h).astype(np.int32),
        rate_up=rng.integers(2_000_000, 50_000_000, h),
        rate_down=rng.integers(2_000_000, 50_000_000, h),
        latency_ns=rng.integers(1_000_000, 60_000_000, (g, g)),
        reliability=np.full((g, g), 0.97, np.float32),
        seed=(1 << 32) + 7, round_ns=2_000_000)
    cpu = torch.device("cpu")
    for n in (2, 8):
        card = mesh.MeshDataPlane(params, n_shards=n, units_per_shard=512,
                                  devices=(dev,) * n)
        host = mesh.MeshDataPlane(params, n_shards=n, units_per_shard=512,
                                  devices=(cpu,) * n)
        for total in STAGED_WINDOWS if n == 2 else (700, 30, 3000, 40):
            win = (rng.integers(0, h, total), rng.integers(0, h, total),
                   rng.integers(0, 1 << 40, total),
                   rng.integers(0, 1 << 58, total),
                   rng.integers(1, 11, total),
                   rng.choice(np.array([0, 1, 16106, 1 << 24]), total))
            got, want = card.exchange_rounds(*win), host.exchange_rounds(*win)
            if len(got) != len(want) or not all(
                    np.array_equal(a, b) for a, b in zip(got, want)):
                fail(f"MeshDataPlane over {n} entries: the window of {total}"
                     f" differs from the CPU entries'")
            n_cmp += 1
        t = 10 ** 9
        for k in (1, 3, 40):
            chunks = []
            for _ in range(k):
                src = np.sort(rng.integers(0, h, 60))
                chunks.append((card.shard_units_np(
                    src, rng.integers(0, h, 60), rng.integers(60, 15000, 60),
                    t + np.sort(rng.integers(0, 2_000_000, 60)),
                    rng.integers(0, 1 << 50, 60)), t))
                t += 2_000_000
            if k == 1:
                got = [card.round_step(chunks[0][0], chunks[0][1])]
                want = [host.round_step(chunks[0][0], chunks[0][1])]
                same_step = all(np.array_equal(np.asarray(a), np.asarray(b))
                                for a, b in zip(got[0], want[0]))
            else:
                got, want = card.scan_rounds(chunks), host.scan_rounds(chunks)
                same_step = all(np.array_equal(a, b)
                                for a, b in zip(got, want))
            if not same_step or not torch.equal(card.state, host.state):
                fail(f"MeshDataPlane over {n} entries: {k} rounds differ "
                     f"from the CPU entries'")
            n_cmp += 1
    draw_err, n_draw = check_draw_entry(torch, np, prop, dev, rng)
    err.update(draw_err)
    n_cmp += n_draw
    seed = (1 << 32) + 77
    host = prop.DeviceDrawPlane(seed, 65536, device="cpu")
    for k in (3, 4):
        card = prop.DeviceDrawPlane(seed, 65536,
                                    device=",".join(["cuda:0"] * k),
                                    n_shards=k)
        before = dict(prop.LAUNCHES)
        pending = []
        for n in DRAW_ENTRY_SIZES:
            b = sweep_inputs(rng, n, 4)
            pending.append((n, "flags", card.dispatch(*b),
                            host.dispatch(*b).read()))
            for mb in (0, card.SPEC_BUCKET):
                pending.append((n, f"min_draw (bucket {mb})",
                                card.dispatch_min(*b[:3], min_bucket=mb),
                                host.dispatch_min(*b[:3],
                                                  min_bucket=mb).read()))
        for n, what, h, want in reversed(pending):
            if not np.array_equal(h.read(), want):
                fail(f"DeviceDrawPlane over {k} entries: {what} differs at "
                     f"n={n}")
            n_cmp += 1
        moved = {name: prop.LAUNCHES[name] - before[name]
                 for name in prop.LAUNCHES}
        want = {"draw_flags": 0, "min_draw": 0,
                "draw_flags_entry": len(DRAW_ENTRY_SIZES),
                "min_draw_entry": 2 * len(DRAW_ENTRY_SIZES)}
        if moved != want:
            fail(f"DeviceDrawPlane over {k} entries of one card launched "
                 f"{moved}, want {want} (one entry launch a dispatch)")
    print(f"{n_cmp} per-entry kernel/plain and plane comparisons over "
          f"{ENTRY_COUNTS} entries of {dev} (the draws over "
          f"{DRAW_ENTRY_COUNTS}: {n_draw} kernel/plain), all bit-identical; "
          f"launches {json.dumps(dict(mesh.LAUNCHES))}, draws "
          f"{json.dumps(dict(prop.LAUNCHES))}", flush=True)
    return err


@contextlib.contextmanager
def recording_entry_windows(mesh, every: int = 180):
    """Keep every ``every``-th window MeshDataPlane exchanges over its
    entries while the block runs: a copy of the packed (6, N, m) units,
    seed, width and w (a host copy, so no launch count moves)."""
    kept, seen = [], [0]
    fn = mesh.MeshDataPlane._exchange_entries

    def record(self, st, w):
        if seen[0] % every == 0:
            kept.append((st.units.copy(), self._seed, self._max_pkts, w))
        seen[0] += 1
        return fn(self, st, w)

    mesh.MeshDataPlane._exchange_entries = record
    try:
        yield kept
    finally:
        mesh.MeshDataPlane._exchange_entries = fn


def multi_device_legs(cli, mesh, prop, digest, tmp: str, devices: str,
                      one_entry: dict, label: str, twin: bool = False) -> dict:
    """tgen_1k on the C engine under tpu_mesh at tpu_mesh_floor 0 (shards:
    one per entry of ``devices``) and under tpu_batch with tpu_mesh_shards
    = the entries at tpu_device_floor 1, then at the auto floor twice (the
    "user" leg attaches the split plane in the background, warming the
    entry kernels at every bucket; the "cached" leg finds it attached, so
    speculative min_draw_entry waves run from round 0): each must have the
    counts, tree and state digest stream of the one-entry run named in
    ``one_entry``. Launch counts reset before each leg and read after:
    under tpu_mesh mesh_exchange_entry once a window a card, every entry's
    block once a window and no other mesh kernel; under tpu_batch at floor
    1 draw_flags_entry once a window a card, every entry's piece once a
    window and no other draw kernel; at the auto floor only entry kernels,
    every entry's pieces once a launch of its card. ``twin``: the tpu_mesh
    and the floor-1 tpu_batch legs are each followed by the same command
    on the one entry ``cuda:0`` (one_leg), and the walls and dispatch ms a
    window are printed side by side. Returns the launches and the recorded
    windows of both policies."""
    from shadow_tpu_torch.ops import devcfg

    n = len(devices.split(","))
    cards = len({d.index for d in devcfg.select_devices(devices)})
    out = {"draws": dict.fromkeys(prop.LAUNCHES, 0)}
    batch = ["--set", f"experimental.tpu_mesh_shards={n}"]
    for policy, leg, extra in (
            ("tpu_mesh", "floor0", ["--set", "experimental.tpu_mesh_floor=0"]),
            ("tpu_batch", "floor1",
             batch + ["--set", "experimental.tpu_device_floor=1"]),
            ("tpu_batch", "user", batch), ("tpu_batch", "cached", batch)):
        d = os.path.join(tmp, f"md_{label}_{policy}_{leg}")
        argv = [str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy",
                policy, "--device", devices, "--data-directory", d,
                *MD_DIGEST, *extra]
        mesh.reset_launches()
        prop.reset_launches()
        t0 = time.perf_counter()
        if policy == "tpu_mesh":
            with recording_entry_windows(mesh) as windows:
                s = run_cli(cli, argv)
            out["windows"] = windows
        elif leg == "floor1":
            with recording_draws(prop, "draw_flags",
                                 prop.SplitSlot) as draws:
                s = run_cli(cli, argv)
            out["draw_windows"] = draws
        else:
            s = run_cli(cli, argv)
        wall = time.perf_counter() - t0
        what = f"tgen_1k {policy} {leg} over {devices} ({label})"
        check_run(s, d, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST, what)
        want = open(os.path.join(one_entry[policy],
                                 "state_digests.jsonl")).read()
        if open(os.path.join(d, "state_digests.jsonl")).read() != want:
            fail(f"{what}: state digest stream differs from the one-entry "
                 f"run's ({one_entry[policy]})")
        if not s["native_colcore"]:
            fail(f"{what}: the C engine did not run")
        if policy == "tpu_mesh":
            formed = s["phase_wall"]["mesh_windows"]
            counts = {k: v for k, v in mesh.LAUNCHES.items() if v}
            entries = dict(mesh.ENTRY_LAUNCHES)
            if (formed <= 0
                    or counts != {"mesh_exchange_entry": cards * formed}
                    or entries != dict.fromkeys(range(n), formed)):
                fail(f"{what}: launches {counts}, blocks by entry {entries} "
                     f"for {formed} windows over {n} entries on {cards} "
                     f"card(s) (want mesh_exchange_entry once a window a "
                     f"card, every entry's block once a window, nothing "
                     f"else)")
            out["mesh"] = counts
            print(f"{what}: mesh_dispatch "
                  f"{s['phase_wall']['mesh_dispatch'] / formed * 1e3:.6f} "
                  f"ms a window", flush=True)
        else:
            formed = s["device"]["windows_dispatched"]
            counts = {k: v for k, v in prop.LAUNCHES.items() if v}
            entries = dict(prop.ENTRY_LAUNCHES)
            split = sum(counts.get(k, 0) for k in ("draw_flags_entry",
                                                   "min_draw_entry"))
            if leg == "floor1" and (
                    formed <= 0
                    or counts != {"draw_flags_entry": cards * formed}
                    or entries != dict.fromkeys(range(n), formed)):
                fail(f"{what}: launches {counts}, pieces by entry "
                     f"{entries} for {formed} windows over {n} entries on "
                     f"{cards} card(s) (want draw_flags_entry once a window "
                     f"a card, every entry's piece once a window, nothing "
                     f"else)")
            if leg != "floor1" and (
                    set(counts) - {"draw_flags_entry", "min_draw_entry"}
                    or split % cards
                    or entries != dict.fromkeys(range(n), split // cards)):
                fail(f"{what}: launches {counts}, pieces by entry "
                     f"{entries} (want entry kernels only, every entry's "
                     f"piece once a launch of its card)")
            if leg == "cached" and not counts.get("min_draw_entry"):
                fail(f"{what}: no speculative min_draw_entry wave was "
                     f"launched")
            for k, v in counts.items():
                out["draws"][k] += v
            print(f"{what}: window_dispatch "
                  f"{s['phase_wall']['window_dispatch'] / max(formed, 1) * 1e3:.6f} "
                  f"ms a window", flush=True)
        print(f"{what}: counts, tree and digest stream match the one-entry "
              f"run; wall {wall:.3f} s (controller {s['wall_seconds']:.3f} "
              f"s), {s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, {formed} "
              f"windows; launches {json.dumps(counts)}, by entry "
              f"{json.dumps(entries)}; device {json.dumps(s['device'])}; "
              f"phase_wall {json.dumps(s['phase_wall'])}", flush=True)
        if twin and leg in ("floor0", "floor1"):
            one_leg(cli, prop, digest, argv, d, s, what)
    return out


def one_leg(cli, prop, digest, argv: list, d: str, s: dict,
            what: str) -> None:
    """The multi-entry leg ``argv`` (its summary ``s``, its data directory
    ``d``) run again on the one entry cuda:0: the same counts, tree and
    digest stream (a tpu_batch twin launching draw_flags once a window and
    no entry kernel), and both legs' controller wall, sim-s/wall-s and
    host dispatch ms a window."""
    d1 = d + "_one"
    argv1 = list(argv)
    argv1[argv1.index("--device") + 1] = "cuda:0"
    argv1[argv1.index("--data-directory") + 1] = d1
    prop.reset_launches()
    s1 = run_cli(cli, argv1)
    check_run(s1, d1, digest, TGEN1K_COUNTS, TGEN1K_TREE_DIGEST,
              f"{what}, one entry")
    if (open(os.path.join(d1, "state_digests.jsonl")).read()
            != open(os.path.join(d, "state_digests.jsonl")).read()):
        fail(f"{what}: the one-entry twin's digest stream differs")
    counts = {k: v for k, v in prop.LAUNCHES.items() if v}
    formed = s1["device"]["windows_dispatched"]
    if "tpu_batch" in argv1 and counts != {"draw_flags": formed}:
        fail(f"{what}, one entry: launches {counts} for {formed} windows "
             f"(want draw_flags once a window, nothing else)")

    def per_window(x):
        pw = x["phase_wall"]
        if pw.get("mesh_windows"):
            return pw["mesh_dispatch"] / pw["mesh_windows"] * 1e3
        return pw["window_dispatch"] / x["device"]["windows_dispatched"] * 1e3

    print(f"{what} against one entry (cuda:0, same flags): controller "
          f"{s['wall_seconds']:.3f} s vs {s1['wall_seconds']:.3f} s "
          f"({s['wall_seconds'] / s1['wall_seconds']:.3f}x), "
          f"{s['sim_sec_per_wall_sec']:.3f} vs "
          f"{s1['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, dispatch "
          f"{per_window(s):.6f} vs {per_window(s1):.6f} ms a window; one "
          f"entry's launches {json.dumps(counts)}, phase_wall "
          f"{json.dumps(s1['phase_wall'])}", flush=True)


def entry_standalone(torch, np, mesh, barriers, tmp: str, devices: str,
                     steps: int = 16, groups: int = 4) -> dict:
    """The standalone round API over the entries of ``devices`` at tgen_1k's
    size (its params, one shard an entry): the floor-0 run's first
    ``steps`` barriers through round_step, then ``groups`` runs of 32
    through scan_rounds (K = 32), in order, the state carried, against the
    same plane over CPU entries (the plain halves) and the one-entry twin
    (the same shards on cuda:0 in one launch: mesh_round_step,
    mesh_scan). Fails unless mesh_rounds_entry launched once a card a
    call, every entry's block once a call, and no other mesh kernel ran
    (no reduction launch, no copy between entries: the module has neither
    any more). Prints each call's host wall beside the twin's. Returns the
    launches and each call's inputs (for timing)."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.ops import devcfg

    entries = devcfg.select_devices(devices)
    cfg = load_config(str(EXAMPLES / "tgen_1k.yaml"), {
        "experimental.scheduler_policy": "tpu_mesh",
        "experimental.tpu_mesh_shards": len(entries),
        "general.data_directory": os.path.join(tmp, "md_standalone")})
    ctrl = Controller(cfg, mirror_log=False, device=devices)
    card = ctrl.engine.mesh_plane
    n = card.n_shards

    def plane(**kw):
        return mesh.MeshDataPlane(card.params, n_shards=n,
                                  units_per_shard=card.units_per_shard,
                                  max_pkts=card._max_pkts, **kw)

    host = plane(devices=(torch.device("cpu"),) * n)
    twin = plane(device="cuda:0")
    calls = []
    run = mesh.RoundStage.run

    def keep_run(stage, seed, max_pkts, epoch, streams=None,
                 timeout_ns=mesh.ENTRY_TIMEOUT_NS):
        if stage.cuda:
            calls.append(([x.clone() for x in stage.states], stage.tables,
                          stage.units.copy(), stage.t_now.copy(), seed,
                          max_pkts))
        return run(stage, seed, max_pkts, epoch, streams, timeout_ns)

    walls = {"entries": {}, "twin": {}}

    def timed(who, k, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[who].setdefault(k, []).append(time.perf_counter() - t0)
        return out

    mesh.reset_launches()
    mesh.RoundStage.run = keep_run
    try:
        i = 0
        for j in range(steps + groups):
            if j < steps:
                t_now, *cols = barriers[i]
                units = card.shard_units_np(*cols)
                got = timed("entries", 1,
                            lambda: card.round_step(units, t_now))
                want = host.round_step(units, t_now)
                one = timed("twin", 1, lambda: twin.round_step(units, t_now))
                ok = all(np.array_equal(np.asarray(a), np.asarray(b))
                         and np.array_equal(np.asarray(a), np.asarray(c))
                         for a, b, c in zip(got, want, one))
                i += 1
            else:
                part = [(card.shard_units_np(*cols), t) for t, *cols in
                        barriers[i:i + card.SCAN_KMAX]]
                got = timed("entries", 32, lambda: card.scan_rounds(part))
                want = host.scan_rounds(part)
                one = timed("twin", 32, lambda: twin.scan_rounds(part))
                ok = all(np.array_equal(a, b) and np.array_equal(a, c)
                         for a, b, c in zip(got, want, one))
                i += len(part)
            if not ok or not (torch.equal(card.state, host.state)
                              and torch.equal(twin.state.cpu(), host.state)):
                fail(f"the standalone round API over {devices} differs from "
                     f"the CPU entries' or the one-entry twin's at barrier "
                     f"{i}")
    finally:
        mesh.RoundStage.run = run
    cards = len(card._plan.groups)
    launches = {"mesh_rounds_entry": mesh.LAUNCHES["mesh_rounds_entry"]}
    twin_launches = {k: mesh.LAUNCHES[k]
                     for k in ("mesh_round_step", "mesh_scan")}
    others = {k: v for k, v in mesh.LAUNCHES.items()
              if v and k not in (*launches, *twin_launches)}
    if (launches["mesh_rounds_entry"] != cards * len(calls)
            or len(calls) != steps + groups or others
            or mesh.ENTRY_LAUNCHES != dict.fromkeys(range(n), len(calls))
            or hasattr(mesh, "mesh_reduce") or hasattr(mesh, "gather")):
        fail(f"the standalone round API over {devices}: {len(calls)} calls "
             f"on {cards} card(s) launched {json.dumps(launches)}, other "
             f"mesh kernels {json.dumps(others)}, blocks by entry "
             f"{json.dumps(mesh.ENTRY_LAUNCHES)} (want one "
             f"mesh_rounds_entry launch a card a call, one block an entry "
             f"a call, nothing else)")
    ratio = {}
    for k in sorted(walls["entries"]):
        a = statistics.median(walls["entries"][k]) * 1e3
        b = statistics.median(walls["twin"][k]) * 1e3
        ratio[k] = a / b
        print(f"standalone API host wall a call, K={k} "
              f"({len(walls['entries'][k])} calls): {n} entries {a:.4f} ms "
              f"vs the one-entry twin {b:.4f} ms (median; {a / b:.3f}x)",
              flush=True)
    print(f"standalone round API over {devices}: {steps} round_steps and "
          f"{groups} K=32 scans on the first {i} barriers, equal to the CPU "
          f"entries' and the one-entry twin's (state included); launches "
          f"{json.dumps(launches)} ({len(calls)} calls, {cards} card(s)), "
          f"the twin's {json.dumps(twin_launches)}, by entry "
          f"{json.dumps(dict(mesh.ENTRY_LAUNCHES))}", flush=True)
    return {"launches": launches, "calls": calls, "wall_ratio": ratio}


def entry_work(torch, prop, units, seed: int, width: int, w: int) -> tuple:
    """(bytes, operations) of one mesh_exchange_entry window, counted as
    exchange_work counts the one-device exchange, with one g_min an entry:
    the inboxes and flags are the kernel's own traffic between its
    blocks, not inputs or outputs."""
    nbytes, ops = exchange_work(torch, prop, units, seed, width, w)
    return nbytes + 8 * (units.shape[1] - 1), ops


def round_entry_work(torch, prop, state, units_k, tables, t_now_k, s: int,
                     n: int, seed: int, width: int) -> tuple:
    """(bytes, operations) of shard s of n's K rounds alone, counted as
    round_work counts the whole mesh's: the shard's state, rate and cap
    read once and its state written once; its slots' src_l column and the
    other fields of its units in use; the distinct table entries its routed
    units gather; its (N, K, C, 4) rows and K partials written once; 75 per
    threefry lane its routed units need."""
    host_node, _lat, thresh = tables[:3]
    k, _, _, c = units_k.shape
    hs = state.shape[2]
    h_pad = host_node.shape[0]
    src_l, dst_g, size, _te, uid, rok = units_k[:, :, 0].unbind(1)
    used = src_l < hs
    route = used & (rok != 0)
    src_g = (torch.clamp(src_l, max=hs - 1) * n + s)[route]
    dst_g = torch.clamp(dst_g[route], max=h_pad - 1)
    sn, dn = host_node[src_g], host_node[dst_g]
    g = thresh.shape[0]
    nbytes = (2 * state.numel() + 2 * hs) * 8 + k * c * 8 \
        + 5 * 8 * int(used.sum()) \
        + 8 * int(torch.unique(torch.cat([src_g, dst_g])).numel()) \
        + 16 * int(torch.unique(sn * g + dn).numel()) \
        + k * (n * c * 32 + 24)
    npk = torch.clamp(-((-size) // 1500), min=1, max=width)
    return nbytes, OPS_PER_LANE * mesh_lanes(
        torch, prop, uid[route], npk[route], thresh[sn, dn] & 0xFFFFFFFF,
        seed, width)


def rounds_entry_work(torch, prop, states, units_k, tables, t_now_k,
                      seed: int, width: int) -> tuple:
    """(bytes, operations) of one mesh_rounds_entry call over N entries:
    round_entry_work summed over the shards, plus the trailers (N N K rows
    of 32 bytes) and the reduction's outputs (every entry's g_min and
    counters, N K 24 bytes). The same work whatever implements it."""
    n, k = len(states), units_k.shape[0]
    nbytes = ops = 0
    for s in range(n):
        b, o = round_entry_work(torch, prop, states[s],
                                units_k[:, :, s:s + 1], tables, t_now_k, s,
                                n, seed, width)
        nbytes += b
        ops += o
    return nbytes + n * n * k * 32 + n * k * 24, ops


def split_slots(torch, prop, name: str, inputs: list, k: int) -> list:
    """One SplitSlot a batch of ``inputs`` ((packed (rows, k * piece) on
    the card, key, width, real units n)) over k entries of card 0, filled
    with it: the plane's launch, one a card, in place."""
    dev = torch.device("cuda", 0)
    groups = ((dev, tuple(range(k))),)
    calls = []
    for x, key, width, n in inputs:
        slot = prop.SplitSlot(name, x.shape[1], x.shape[1] // k, groups)
        slot.inp[:] = x.cpu().numpy()
        calls.append(lambda s=slot, n=n, key=key, w=width: s.launch(n, key,
                                                                    w))
    return calls


def time_draw_entry(torch, prop, name: str, inputs: list, k: int,
                    rate: float, what: str) -> dict:
    """One row of the timing table for draw_flags_entry / min_draw_entry on
    ``inputs`` split over k entries of card 0: the kernel as the plane
    launches it (split_slots), its plain version on the same batches and
    tables on the card, and the bound: each real unit's columns read once,
    every region written once, 75 operations a lane the data needs (up to
    the first hit for the flags)."""
    base = name[:-len("_entry")]
    plain = getattr(prop, f"{name}_plain")
    nbytes = ops = 0
    plain_calls = []
    for x, key, width, n in inputs:
        piece = x.shape[1] // k
        region = prop.region_width(piece)
        table = prop.piece_table(n, piece, range(k))
        plain_calls.append(lambda x=x, key=key, w=width, t=table, r=region:
                           plain(x, key, w, t, r))
        nbytes += x.shape[0] * 4 * n + k * (region // 8 if
                                            base == "draw_flags"
                                            else 4 * region)
        ops += OPS_PER_LANE * lanes_needed(torch, prop, x, key, width,
                                           base == "draw_flags")
    return measure_mesh(torch, name, split_slots(torch, prop, base, inputs, k),
                        plain_calls, nbytes / len(inputs), ops / len(inputs),
                        rate, what)


def time_entry_kernels(torch, np, prop, mesh, windows, sa, draw_windows,
                       rate) -> dict:
    """The per-entry kernels timed on the multi-entry runs' own inputs:
    mesh_exchange_entry on the tpu_mesh leg's recorded windows, launched as
    the plane launches it (each window in an EntryWindow over its N
    entries of card 0, read and written in place in page-locked memory,
    one launch a window, a fresh epoch each), mesh_rounds_entry on the
    standalone calls over the entries (a row for K = 1, the head, and for
    K = 32), launched as the plane launches them; draw_flags_entry
    on 64 of the four-entry tpu_batch floor-1 leg's windows, min_draw_entry
    on a 16,384-unit batch of that leg's units split four ways (the pinned
    speculative bucket), each launched as the plane launches it; each
    beside its plain version and its bound."""
    import itertools

    out = {}
    dev = torch.device("cuda", 0)
    epochs = itertools.count(1)
    stages, plain, work = [], [], []
    for u, seed, mp, w in windows:
        n, m = u.shape[1:]
        st = mesh.EntryWindow((dev,) * n, n, m, w)
        st.units[:] = u
        stages.append((st, seed, mp))
        x = torch.from_numpy(u).to(dev)
        plain.append((x, seed, mp, w))
        work.append(entry_work(torch, prop, x, seed, mp, w))

    def launch(st, seed, mp):
        st.launch(seed, mp, next(epochs), [torch.cuda.current_stream(dev)])

    shape = sorted({tuple(x[0].shape[1:]) for x in plain})
    out["mesh_exchange_entry"] = [measure_mesh(
        torch, "mesh_exchange_entry",
        [lambda a=a: launch(*a) for a in stages],
        [lambda a=a: mesh.exchange_entry_plain(*a) for a in plain[:8]],
        sum(b for b, _ in work) / len(work),
        sum(o for _, o in work) / len(work), rate,
        f"{len(stages)} run windows, (N, m) {shape}, one launch a window")]
    # each standalone call in a RoundStage of its own over fresh copies of
    # the states it started from, launched as the plane launches it (one
    # launch a card, a fresh epoch each); beside it the one-entry twin's
    # launch on the same inputs (mesh_round_step at K = 1, else mesh_scan)
    rounds = {}
    for states, tables, units, t_now, seed, mp in sa["calls"]:
        n, k = len(states), units.shape[0]
        st = mesh.RoundStage((dev,) * n, n, k, units.shape[3],
                             [x.clone() for x in states], tables)
        st.units[...] = units
        st.t_now[...] = t_now
        args = (states, torch.from_numpy(units).to(dev), tables[0],
                torch.from_numpy(t_now).to(dev), seed, mp)
        whole = torch.cat(states, dim=1)
        twin = ((lambda a=(whole, args[1][0], tables[0], int(t_now[0]),
                           seed, mp): mesh.mesh_round_step(*a)) if k == 1
                else (lambda a=(whole, *args[1:]): mesh.mesh_scan(*a)))
        rounds.setdefault(k, []).append((
            lambda st=st, seed=seed, mp=mp: launch(st, seed, mp),
            lambda a=args: mesh.rounds_entries_plain(*a),
            rounds_entry_work(torch, prop, *args), twin))
    out["mesh_rounds_entry"] = []
    for k, got in sorted(rounds.items()):
        plain = [c[1] for c in got]
        if k > 1:  # the plain version of a K = 32 call takes most of a second
            plain = plain[:1]
        row = measure_mesh(
            torch, "mesh_rounds_entry", [c[0] for c in got], plain,
            sum(c[2][0] for c in got) / len(got),
            sum(c[2][1] for c in got) / len(got), rate,
            f"{len(got)} standalone calls over four entries, K={k}, one "
            f"launch a call (plain: {len(plain)} of them)",
            plain_reps=1)
        row["twin_ms"] = card_ms(torch, [c[3] for c in got], rate)
        print(f"  the one-entry twin on the same {len(got)} calls "
              f"({'mesh_round_step' if k == 1 else 'mesh_scan'}, one launch "
              f"of the four shards): card {row['twin_ms']:.6f} ms",
              flush=True)
        out["mesh_rounds_entry"].append(row)
    k = 4
    sel = evenly(draw_windows, 64)
    buckets = sorted({x.shape[1] for x, *_ in sel})
    out["draw_flags_entry"] = [time_draw_entry(
        torch, prop, "draw_flags_entry", sel, k, rate,
        f"{len(sel)} of the leg's {len(draw_windows)} windows, batch "
        f"{buckets} split over {k} entries, one launch a window")]
    # a window of the leg's median size
    split_dispatch_breakdown(torch, prop, sorted(
        draw_windows, key=lambda w: w[3])[len(draw_windows) // 2], k)
    spec = prop.DeviceDrawPlane.SPEC_BUCKET
    wave = spread_units(torch, draw_windows, spec, 3)
    out["min_draw_entry"] = [time_draw_entry(
        torch, prop, "min_draw_entry", [wave] * 16, k, rate,
        f"a {spec}-unit batch of the leg's units split over {k} entries")]
    return out


def multi_device_path(cli, torch, np, prop, mesh, digest, tmp: str,
                      one_entry: dict, barriers) -> dict:
    """Phase ``multi device``: the per-entry kernels against their plain
    versions; tgen_1k over four entries of card 0 under tpu_mesh and
    tpu_batch against the one-entry runs; the standalone round API over
    four entries; the distinct-card leg where the machine has two cards.
    Returns the launches, errors and the inputs kept for timing."""
    from shadow_tpu_torch.ops import devcfg

    dev = torch.device("cuda", 0)
    err = check_entry_kernels(torch, np, mesh, prop, dev)
    legs = multi_device_legs(cli, mesh, prop, digest, tmp, FOUR_ENTRIES,
                             one_entry, "one card", twin=True)
    sa = entry_standalone(torch, np, mesh, barriers, tmp, FOUR_ENTRIES)
    k = torch.cuda.device_count()
    if k >= 2:
        two = "cuda:0,cuda:1"
        plan = mesh.entry_plan(devcfg.select_devices(two),
                               torch.cuda.can_device_access_peer)
        routes = {f"{i}->{d}": r for i, row in enumerate(plan.routes)
                  for d, r in enumerate(row)}
        print(f"multi device: the distinct-card leg runs over {two} ({k} "
              f"cards visible); mesh_exchange_entry's route of each (source, "
              f"destination) pair: {json.dumps(routes)}", flush=True)
        multi_device_legs(cli, mesh, prop, digest, tmp, two, one_entry,
                          "two cards")
    else:
        print(f"multi device: the distinct-card leg did not run: "
              f"torch.cuda.device_count() = {k} (not a failure; it runs "
              f"where two cards are visible)", flush=True)
    launches = {"mesh_exchange_entry": legs["mesh"]["mesh_exchange_entry"],
                **sa["launches"]}
    draws = {k: v for k, v in legs["draws"].items() if v}
    print(f"per-entry launches on the multi-entry paths: "
          f"{json.dumps(launches)}; draws split over four entries "
          f"{json.dumps(draws)}", flush=True)
    return {"err": err, "launches": launches, "windows": legs["windows"],
            "sa": sa, "draws": draws, "draw_windows": legs["draw_windows"]}


PHASES = ("kernels", "mesh kernels", "transport kernels", "apsp kernels",
          "echo", "main path", "mesh path", "mesh standalone",
          "transport path", "engine path", "policies", "faults",
          "checkpoint", "shards", "fault filter", "fleet", "live", "fork",
          "managed", "apsp path", "timing", "trace", "multi device")
#: phase -> the phases whose results it reads
NEEDS = {
    "mesh standalone": ("mesh path",),
    "multi device": ("main path", "mesh path"),
    "fleet": ("main path",),
    "timing": ("kernels", "mesh kernels", "transport kernels",
               "apsp kernels", "main path", "mesh path", "mesh standalone",
               "transport path", "engine path"),
}


def parse_phases(argv) -> list:
    """The phases to run: all of them with no argument (as the script is
    run to check the port), else those named by ``--phases a,b,...`` and
    the phases they need, in PHASES order."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all): "
                    + ", ".join(PHASES))
    names = [n.strip() for n in ap.parse_args(argv).phases.split(",")
             if n.strip()]
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    want = set(names)
    for name in reversed(PHASES):
        if name in want:
            want.update(NEEDS.get(name, ()))
    return [n for n in PHASES if n in want]


def main(argv=None) -> int:
    run = parse_phases(sys.argv[1:] if argv is None else argv)
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"phases: {', '.join(run)}", flush=True)
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

    max_err: dict = {}
    launches = {name: 0 for name in PLAN}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    def add(counts: dict) -> None:
        for name, n in counts.items():
            launches[name] += n

    def do(name: str) -> bool:
        if name in run:
            phase(name)
            return True
        return False

    if do("kernels"):
        max_err.update(check_kernels(torch, np, prop, dev))
        max_err["threefry2x32"] = check_threefry(torch, np, prng, dev)

    if do("mesh kernels"):
        max_err.update(check_mesh_kernels(torch, np, mesh, dev))

    if do("transport kernels"):
        max_err["ack_advance"] = check_transport_kernels(torch, np, tk, dev)

    if do("apsp kernels"):
        max_err["apsp"] = check_apsp_kernels(torch, np, apsp, dev)

    if do("echo"):
        for label, extra in (("Python plane", PY_PLANE), ("C engine", [])):
            d = os.path.join(tmp, f"echo_{len(extra)}")
            s = run_cli(cli, [str(EXAMPLES / "echo.yaml"),
                              "--scheduler-policy", "tpu_batch", "--device",
                              "cuda", "--data-directory", d, *extra])
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

    if do("main path"):
        prop.reset_launches()
        runs = {}
        for label, extra in (("floor1", _FLOOR1), ("auto", [])):
            d = os.path.join(tmp, f"tgen_1k_{label}")
            argv = [str(EXAMPLES / "tgen_1k.yaml"), "--scheduler-policy",
                    "tpu_batch", "--device", "cuda", "--data-directory", d,
                    *PY_PLANE, *MD_DIGEST]
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
            print(f"tgen_1k ({label}, Python plane): counts and tree match "
                  f"the reference; wall {wall:.3f} s (controller "
                  f"{s['wall_seconds']:.3f} s), "
                  f"{s['sim_sec_per_wall_sec']:.3f} sim-s/wall-s, "
                  f"{dv['windows_dispatched']} windows (largest "
                  f"{dv['max_window_units']} units), {dv['window_units']} "
                  f"window units = "
                  f"{dv['window_units'] / s['units_sent']:.4f} of "
                  f"units_sent, phase_wall {json.dumps(s['phase_wall'])}",
                  flush=True)
        py_launches = dict(prop.LAUNCHES)
        print(f"launches on the Python plane's main path: "
              f"{json.dumps(py_launches)}", flush=True)
        for name in ("draw_flags", "min_draw"):
            if py_launches[name] <= 0:
                fail(f"kernel {name} was never launched on the main path")
        if py_launches["draw_flags_entry"] or py_launches["min_draw_entry"]:
            fail(f"the one-entry main path launched an entry kernel: "
                 f"{json.dumps(py_launches)}")
        floor1_windows = runs["floor1"]["device"]["windows_dispatched"]
        if py_launches["draw_flags"] < floor1_windows:
            fail(f"draw_flags launched {py_launches['draw_flags']} times, "
                 f"fewer than the {floor1_windows} windows the floor-1 run "
                 f"dispatched")
        if not windows:
            fail("the floor-1 run handed draw_flags no window")
        mix = window_mix(torch, prop, windows)
        print(f"floor-1 windows: {json.dumps(mix)}", flush=True)

    if do("mesh path"):
        mesh_launches, mesh_windows, barriers = mesh_path(
            cli, mesh, output_tree_digest, tmp)
        launches["mesh_exchange"] += mesh_launches["mesh_exchange"]

    if do("mesh standalone"):
        sa = mesh_standalone(torch, np, mesh, barriers, tmp)
        if "multi device" not in run:
            del barriers
        for name in ("mesh_round_step", "mesh_scan"):
            launches[name] += sa["launches"][name]
            max_err[name] = max(max_err.get(name, 0), sa["err"][name])

    if do("transport path"):
        n, cohorts = transport_path(cli, tk, dt, output_tree_digest, tmp)
        launches["ack_advance"] += n

    if do("engine path"):
        engine, waves, _ = engine_path(cli, prop, mesh, output_tree_digest,
                                       tmp)
        add(engine)

    if do("policies"):
        add(policies_path(cli, prop, tk, dt, output_tree_digest, tmp))

    if do("faults"):
        add(faults_path(cli, prop, tk, dt, mesh, output_tree_digest, tmp))

    if do("checkpoint"):
        add(checkpoint_path(cli, prop, tk, dt, mesh, output_tree_digest,
                            tmp))

    if do("shards"):
        add(shards_path(cli, prop, tk, mesh, output_tree_digest, tmp))

    if do("fault filter"):
        add(fault_filter_path(prop, mesh, output_tree_digest, tmp))

    if do("fleet"):
        add(fleet_path(cli, np, prop, output_tree_digest, tmp, windows))

    if do("live"):
        add(live_path(cli, prop, mesh, output_tree_digest, tmp))

    if do("fork"):
        add(fork_path(cli, prop, output_tree_digest, tmp))

    if do("managed"):
        n, err = managed_path(cli, prop, mesh, tmp)
        if n is not None:
            add(n)
            max_err["draw_flags"] = max(max_err.get("draw_flags", 0), err)

    if do("apsp path"):
        launches["apsp"] += apsp_path(np, apsp)

    timing = {}
    if do("timing"):
        timing["threefry2x32"] = time_threefry(torch, prop, prng, windows,
                                               spin_rate(torch))
        timing.update(time_kernels(torch, prop, windows, waves))
        compare_staging(torch, np, prop, windows, waves, dev)
        # a window of the run's median size
        dispatch_breakdown(torch, prop, sorted(
            windows, key=lambda w: w[3])[len(windows) // 2])
        del windows, waves
        timing.update(time_mesh_kernels(torch, np, prop, mesh, mesh_windows,
                                        sa["rounds"], sa["scans"],
                                        sa["ctx"], sa["plane"]))
        del mesh_windows, sa
        timing["ack_advance"] = time_transport_kernel(torch, np, tk,
                                                      cohorts, dev)
        ack_extra = {
            "staging": compare_ack_staging(torch, np, tk, cohorts, dev),
            # a cohort of the run's median size
            "breakdown_us": ack_breakdown(
                torch, tk, sorted(cohorts, key=lambda c: len(c[0]))[
                    len(cohorts) // 2]),
            "floor": ack_crossover(torch, np, tk, cohorts,
                                   dt._DEVICE_FLOOR)}
        del cohorts
        timing["apsp"] = time_apsp(torch, np, apsp, spin_rate(torch), dev)

    if do("trace"):
        trace_run(torch, cli, output_tree_digest, tmp, "tpu_batch")
        trace_run(torch, cli, output_tree_digest, tmp, "tpu_mesh")
        trace_run(torch, cli, output_tree_digest, tmp, "tpu_batch",
                  engine=True)
        trace_transport(torch, cli, dt, output_tree_digest, tmp)

    if do("multi device"):
        md = multi_device_path(
            cli, torch, np, prop, mesh, output_tree_digest, tmp,
            {"tpu_batch": os.path.join(tmp, "tgen_1k_floor1"),
             "tpu_mesh": os.path.join(tmp, "tgen_1k_mesh_floor0")},
            barriers)
        del barriers
        add(md["launches"])
        add(md["draws"])
        for name, e in md["err"].items():
            max_err[name] = max(max_err.get(name, 0), e)
        timing.update(time_entry_kernels(torch, np, prop, mesh,
                                         md["windows"], md["sa"],
                                         md["draw_windows"],
                                         spin_rate(torch)))
        del md
    shutil.rmtree(tmp, ignore_errors=True)

    # the device function's launches are those of the kernels that run it
    launches["threefry2x32"] = sum(launches[k] for k in THREEFRY_INSIDE)
    phase("end")
    print(card, flush=True)
    if timing:
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
        print(json.dumps({"kernels": kernels}), flush=True)
    else:
        print(f"launches of the phases run (no kernel table without the "
              f"timing phase): {json.dumps(launches)}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
