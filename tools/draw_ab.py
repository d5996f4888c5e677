#!/usr/bin/env python3
"""Time the loss-draw path of two or more checkouts of this repository on
one CUDA card, in turns, for a before/after comparison inside one machine.

    python3 tools/draw_ab.py CHECKOUT_0 CHECKOUT_1 [...] [--order 0110]

Each leg runs in a subprocess from its checkout (its own shadow_tpu_torch,
its own kernels built there, its own chip_smoke.py for the reference
constants, the window recorder and the card timer); ``--order`` lists the
checkouts' indices leg by leg (default 0110: old, new, new, old). A leg
measures:

- tgen_1k under tpu_batch through the port's CLI: the C engine as a user
  runs it (auto floor, the draw plane attaching in the background, as in
  a fresh process), the C engine at tpu_device_floor=1 and the Python
  columnar plane at floor 1: controller wall, draw_flush, window_build,
  window_dispatch, window_readback and the windows sent to the card, with
  counts and output tree held to the reference; then an untimed floor-1
  run on the C engine that records every draw window;
- DeviceDrawPlane.dispatch(...).read() on 512 of those windows spread over
  the run: host ms of the dispatch, of the read and of both;
- the kernels on device tensors, card ms a call (chip_smoke.card_ms:
  calls queued behind a spin kernel): draw_flags on 64 of those windows
  (with their real unit count where the wrapper takes one), min_draw on a
  16,384-unit bucket of the run's units, threefry2x32 alone on every lane
  the run's windows draw.

Prints the card's name and power limit, one JSON line a leg, and a JSON
summary of every metric by checkout. Needs a CUDA card; exits non-zero
without one or when a run differs from the reference.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

TRIPS, KERNEL_WINDOWS, SPEC = 512, 64, 16384


def _load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _recorded(cs, prop):
    """The checkout's draw-window recorder, and a function that turns one
    record into (packed (4, P) on the card, key, width, real units n):
    ``recording_draws`` gives that; the recorder of the trees before the
    page-locked slots (``recording_windows``) gives (packed, key, width)
    with zero padding after the real units."""
    if hasattr(cs, "recording_draws"):
        return cs.recording_draws(prop, "draw_flags"), tuple
    return cs.recording_windows(prop), (
        lambda r: (*r, int((r[0][2].long() > 0).sum())))


def leg(root: str) -> dict:
    """One checkout's measurements (run with ``root`` as the working
    directory and first on sys.path)."""
    import numpy as np
    import torch

    cs = _load_smoke(root)
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.ops import prng
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.utils.digest import output_tree_digest

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    out = {"checkout": root}
    argv = [os.path.join(root, "examples", "tgen_1k.yaml"),
            "--scheduler-policy", "tpu_batch", "--device", "cuda"]
    floor1 = ["--set", "experimental.tpu_device_floor=1"]
    with tempfile.TemporaryDirectory(prefix="draw_ab_") as tmp:
        for label, extra in (("c_engine_user", []),
                             ("c_engine_floor1", floor1),
                             ("python_plane_floor1", floor1 + cs.PY_PLANE)):
            d = os.path.join(tmp, label)
            s = cs.run_cli(cli, [*argv, "--data-directory", d, *extra])
            cs.check_run(s, d, output_tree_digest, cs.TGEN1K_COUNTS,
                         cs.TGEN1K_TREE_DIGEST, f"tgen_1k tpu_batch {label}")
            pw = s["phase_wall"]
            out[label] = {
                "controller_s": s["wall_seconds"],
                **{k: pw.get(k, 0.0) for k in (
                    "draw_flush", "window_build", "window_dispatch",
                    "window_readback")},
                "windows": s["device"]["windows_dispatched"]}
        d = os.path.join(tmp, "recorded")
        recorder, norm = _recorded(cs, prop)
        with recorder as records:
            s = cs.run_cli(cli, [*argv, "--data-directory", d, *floor1])
        cs.check_run(s, d, output_tree_digest, cs.TGEN1K_COUNTS,
                     cs.TGEN1K_TREE_DIGEST, "tgen_1k tpu_batch floor 1 "
                     "(recorded)")
    windows = [norm(r) for r in records]
    out["windows"] = len(windows)
    _, key, width, _ = windows[0]
    seed = (key[1] << 32) | key[0]
    plane = prop.DeviceDrawPlane(seed, 65536, max_pkts=width, device="cuda")
    batches = [x[:, :n].cpu().numpy()
               for x, _, _, n in cs.evenly(windows, TRIPS)]
    for a in batches[:16]:
        plane.dispatch(*a).read()
    spent = {"dispatch_ms": 0.0, "read_ms": 0.0}
    for a in batches:
        t0 = time.perf_counter()
        h = plane.dispatch(*a)
        t1 = time.perf_counter()
        h.read()
        spent["dispatch_ms"] += t1 - t0
        spent["read_ms"] += time.perf_counter() - t1
    out["plane"] = {k: v * 1e3 / len(batches) for k, v in spent.items()}
    out["plane"]["trip_ms"] = sum(out["plane"].values())

    rate = cs.spin_rate(torch)
    takes_n = "n" in inspect.signature(prop.draw_flags).parameters
    kernel_windows = cs.evenly(windows, KERNEL_WINDOWS)
    out["draw_flags_card_ms"] = cs.card_ms(torch, [
        (lambda x=x, n=n: prop.draw_flags(x, key, width, n=n)) if takes_n
        else (lambda x=x: prop.draw_flags(x, key, width))
        for x, _, _, n in kernel_windows], rate)
    units = torch.cat([x[:, :n].long() for x, _, _, n in windows], dim=1)
    idx = torch.linspace(0, units.shape[1] - 1, SPEC,
                         device=units.device).round().long()
    spec = units[:3, idx].to(torch.uint32).contiguous()
    out["min_draw_card_ms"] = cs.card_ms(
        torch, [lambda: prop.min_draw(spec, key, width)] * 16, rate)
    lanes = torch.clamp(units[2], max=width)
    p = torch.arange(width, device=units.device)
    keep = p[None, :] < lanes[:, None]
    c0 = units[0][:, None].expand(-1, width)[keep]
    c1 = (units[1][:, None] | (p[None, :] << 26)).expand(-1, width)[keep]
    counters = torch.stack([c0, c1]).to(torch.uint32).contiguous()
    out["threefry_lanes"] = counters.shape[1]
    out["threefry_card_ms"] = cs.card_ms(
        torch, [lambda: prng.threefry2x32_device(counters, key)], rate)
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
