#!/usr/bin/env python3
"""Time the device transport's ack path of two or more checkouts of this
repository on one CUDA card, in turns, for a before/after comparison inside
one machine.

    python3 tools/transport_ab.py CHECKOUT_0 CHECKOUT_1 [...] [--order 0110]

Each leg runs in a subprocess from its checkout (its own shadow_tpu_torch,
its own kernels built there, its own chip_smoke.py for the reference
constants, the cohort recorder and the card timer); ``--order`` lists the
checkouts' indices leg by leg (default 0110: old, new, new, old). A leg
measures:

- the two floor-1 transport legs of chip_smoke.py's phase 11 through the
  port's CLI, on the Python columnar plane with
  experimental.device_transport on and the module's device floor lowered
  to 1 (every cohort on the card): tgen_1k under tpu_batch, and
  web_cdn_100k to 500 ms (recording every cohort): controller wall,
  phase_wall.transport_tick, cohorts, device cohorts and rows, with the
  counts, tree and (web_cdn_100k) last state digest held to the
  reference;
- DeviceAckKernel.run on the recorded cohorts and on 4,096 and 65,536 of
  their rows (chip_smoke.spread_rows): host ms a cohort, the least of five
  passes; where the checkout has slots, also the transport's own round
  trip on a slot (chip_smoke.slot_trip: take, fill, launch and wait, give),
  which ends, as run did before the slots, with the five output rows on
  the host (run now also copies them out of the slot);
- ack_advance on device tensors of the recorded cohorts, card ms a call
  (chip_smoke.card_ms: calls queued behind a spin kernel), and where the
  checkout has slots, as the transport launches it, in place.

Prints the card's name and power limit, one JSON line a leg, and a JSON
summary of every metric by checkout. Needs a CUDA card; exits non-zero
without one or when a run differs from the reference.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

PASSES = 5


def _load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _host_ms(fns: list) -> float:
    """Host clock per call of ``fns`` (each synchronous), after three
    warm-up calls: the least of PASSES passes over all of them."""
    for fn in fns[:3]:
        fn()
    best = float("inf")
    for _ in range(PASSES):
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / len(fns)


def leg(root: str) -> dict:
    """One checkout's measurements (run with ``root`` as the working
    directory and first on sys.path)."""
    import numpy as np
    import torch

    cs = _load_smoke(root)
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.network import devtransport as dt
    from shadow_tpu_torch.ops import transport_kernels as tk
    from shadow_tpu_torch.utils.digest import output_tree_digest

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    out = {"checkout": root}
    legs = (("tgen_1k_floor1", "tgen_1k.yaml", [], cs.TGEN1K_COUNTS,
             cs.TGEN1K_TREE_DIGEST, None),
            ("web_cdn_100k_floor1_500ms", "web_cdn_100k.yaml",
             ["--stop-time", "500ms", "--state-digest-every",
              str(cs.WEB500_COUNTS["rounds"])], cs.WEB500_COUNTS,
             cs.WEB500_TREE_DIGEST, cs.WEB500_STATE_DIGEST))
    floor0 = dt._DEVICE_FLOOR
    cohorts = []
    with tempfile.TemporaryDirectory(prefix="transport_ab_") as tmp:
        for label, cfg, extra, counts, tree, state in legs:
            d = os.path.join(tmp, label)
            argv = [os.path.join(root, "examples", cfg),
                    "--scheduler-policy", "tpu_batch", "--device", "cuda",
                    "--data-directory", d, "--set",
                    "experimental.device_transport=true", *cs.PY_PLANE,
                    *extra]
            dt._DEVICE_FLOOR = 1
            try:
                if label.startswith("web"):
                    with cs.recording_cohorts(dt) as cohorts:
                        s = cs.run_cli(cli, argv)
                else:
                    s = cs.run_cli(cli, argv)
            finally:
                dt._DEVICE_FLOOR = floor0
            cs.check_run(s, d, output_tree_digest, counts, tree,
                         f"{label} (device transport)")
            if state is not None and cs.last_state_digest(d) != state:
                cs.fail(f"{label}: last state digest differs from the "
                        f"reference")
            dtr = s["device_transport"]
            out[label] = {
                "controller_s": s["wall_seconds"],
                "transport_tick_s": s["phase_wall"]["transport_tick"],
                "cohorts": dtr["cohorts"],
                "device_cohorts": dtr["device_cohorts"],
                "acks_batched": dtr["acks_batched"]}
    if not cohorts:
        cs.fail("the web_cdn_100k floor-1 leg recorded no cohort")
    out["recorded_cohorts"] = len(cohorts)
    out["recorded_rows_a_cohort"] = (sum(len(c[0]) for c in cohorts)
                                     / len(cohorts))
    kern = tk.DeviceAckKernel("cuda")
    slotted = hasattr(cs, "slot_trip")
    groups = [("run", cohorts * max(1, 64 // len(cohorts)))] + [
        (str(n), [cs.spread_rows(np, cohorts, n)] * (8 if n > 4096 else 32))
        for n in (4096, 65536)]
    dev = torch.device("cuda")
    rate = cs.spin_rate(torch)
    stream = torch.cuda.current_stream()
    for what, sel in groups:
        row = {"run_ms": _host_ms([lambda c=c: kern.run(*c) for c in sel])}
        if slotted:
            row["slot_trip_ms"] = _host_ms(
                [lambda c=c: cs.slot_trip(kern, c) for c in sel])
        xs = [torch.from_numpy(np.stack(c)).to(dev) for c in sel]
        row["device_card_ms"] = cs.card_ms(
            torch, [lambda x=x: tk.ack_advance_device(x) for x in xs], rate)
        if slotted:
            slots = cs.ack_slots_of(tk, dev, sel)
            row["in_place_card_ms"] = cs.card_ms(
                torch, [lambda s=s, n=n: s.launch(n, stream)
                        for s, n in slots], rate)
        out[f"cohort_{what}"] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--order", default="0110")
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.leg:
        root = os.path.abspath(args.leg)
        os.chdir(root)
        sys.path.insert(0, root)
        print(json.dumps(leg(root)), flush=True)
        return 0
    if len(args.checkouts) < 2:
        ap.error("name two checkouts or more")
    roots = [os.path.abspath(c) for c in args.checkouts]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    legs = []
    for i in args.order:
        root = roots[int(i)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--leg", root],
            capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        legs.append(row)
    summary = {}
    for row in legs:
        for key, val in row.items():
            if key == "checkout":
                continue
            flat = val.items() if isinstance(val, dict) else [(None, val)]
            for sub, v in flat:
                name = key if sub is None else f"{key}.{sub}"
                summary.setdefault(name, {}).setdefault(
                    row["checkout"], []).append(v)
    print(json.dumps({"card": card, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
