#!/usr/bin/env python3
"""Time the mesh plane of two or more checkouts of this repository on one
CUDA card, in turns, for a before/after comparison inside one machine.

    python3 tools/mesh_ab.py CHECKOUT_0 CHECKOUT_1 [...] [--order 0110]

Each leg runs in a subprocess from its checkout (its own shadow_tpu_torch,
its own kernels built there, its own chip_smoke.py for the reference
constants, the window recorder and the card timer); ``--order`` lists the
checkouts' indices leg by leg (default 0110: old, new, new, old). A leg
measures:

- tgen_1k under tpu_mesh at tpu_mesh_floor=0 through the port's CLI, on
  the C engine and on the Python columnar plane: controller wall,
  draw_flush and the plane's mesh_* phases (counts and output tree held
  to the reference); then a third, untimed run on the Python plane that
  records every exchange window;
- MeshDataPlane.exchange_rounds on 512 of those windows spread over the
  run (N = 1): host ms a window, the window's whole round trip;
- the kernels: the mesh_exchange wrapper on 64 of those windows (device
  tensors in and out), mesh_round_step and mesh_scan (K = 32) on seeded
  rounds of 24 units in 2,048 slots at tgen_1k's size: card ms a call
  (chip_smoke.card_ms: calls queued behind a spin kernel).

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

HOSTS, NODES, SLOTS, ROUND_UNITS, K = 1000, 32, 2048, 24, 32


def _load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _params(np, rng):
    from shadow_tpu_torch.network.fluid import NetParams

    return NetParams.build(
        host_node=rng.integers(0, NODES, HOSTS).astype(np.int32),
        rate_up=rng.integers(2_000_000, 50_000_000, HOSTS),
        rate_down=rng.integers(2_000_000, 50_000_000, HOSTS),
        latency_ns=rng.integers(1_000_000, 60_000_000, (NODES, NODES)),
        reliability=np.full((NODES, NODES), 0.97, np.float32),
        seed=2, round_ns=2_000_000)


def _rounds(np, rng, plane, count: int, t0: int) -> list:
    """(units (6, 1, SLOTS) on the card, t_now) of ROUND_UNITS units each."""
    out = []
    for j in range(count):
        t_now = t0 + j * 2_000_000
        src = np.sort(rng.integers(0, HOSTS, ROUND_UNITS))
        out.append((plane.shard_units(
            src, rng.integers(0, HOSTS, ROUND_UNITS),
            rng.choice(np.array([60, 1500, 15000]), ROUND_UNITS),
            t_now + np.sort(rng.integers(0, 2_000_000, ROUND_UNITS)),
            rng.integers(0, 1 << 58, ROUND_UNITS)), t_now))
    return out


def leg(root: str) -> dict:
    """One checkout's measurements (run with ``root`` as the working
    directory and first on sys.path)."""
    import numpy as np
    import torch

    cs = _load_smoke(root)
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.parallel import mesh
    from shadow_tpu_torch.parallel.mesh import MeshDataPlane
    from shadow_tpu_torch.utils.digest import output_tree_digest

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    out = {"checkout": root}
    argv = [os.path.join(root, "examples", "tgen_1k.yaml"),
            "--scheduler-policy", "tpu_mesh", "--device", "cuda",
            "--set", "experimental.tpu_mesh_floor=0"]
    with tempfile.TemporaryDirectory(prefix="mesh_ab_") as tmp:
        for label, extra in (("c_engine", []),
                             ("python_plane", cs.PY_PLANE)):
            d = os.path.join(tmp, label)
            s = cs.run_cli(cli, [*argv, "--data-directory", d, *extra])
            cs.check_run(s, d, output_tree_digest, cs.TGEN1K_COUNTS,
                         cs.TGEN1K_TREE_DIGEST, f"tgen_1k tpu_mesh floor 0 "
                         f"({label})")
            pw = s["phase_wall"]
            out[label] = {"controller_s": s["wall_seconds"],
                          "draw_flush_s": pw["draw_flush"],
                          **{k: pw[k] for k in pw if k.startswith("mesh_")}}
        d = os.path.join(tmp, "recorded")
        with cs.recording_exchanges(mesh) as windows:
            s = cs.run_cli(cli, [*argv, "--data-directory", d, *cs.PY_PLANE])
        cs.check_run(s, d, output_tree_digest, cs.TGEN1K_COUNTS,
                     cs.TGEN1K_TREE_DIGEST, "tgen_1k tpu_mesh floor 0 "
                     "(recorded)")
    out["windows"] = len(windows)
    wins = []
    for u, _, _, _ in cs.evenly(windows, 512):  # N = 1: one shard's slots
        ok = (u[5, 0] != 0).cpu().numpy()
        a = u[:5, 0].cpu().numpy()[:, ok]
        wins.append((np.zeros(a.shape[1], np.int64), *a))
    rng = np.random.default_rng(20261017)
    params = _params(np, rng)
    plane = MeshDataPlane(params, n_shards=1, device="cuda")
    for w in wins[:16]:
        plane.exchange_rounds(*w)
    t0 = time.perf_counter()
    for w in wins:
        plane.exchange_rounds(*w)
    out["plane_window_ms"] = (time.perf_counter() - t0) * 1e3 / len(wins)
    seed = int(params.seed)
    rate = cs.spin_rate(torch)
    out["exchange_card_ms"] = cs.card_ms(torch, [
        lambda x=x: mesh.mesh_exchange(*x) for x in cs.evenly(windows, 64)],
        rate)
    rplane = MeshDataPlane(params, n_shards=1, units_per_shard=SLOTS,
                           device="cuda")
    state, tables = rplane.state, rplane._tables
    rounds = _rounds(np, rng, rplane, 64, 40 * 10 ** 9)
    out["round_step_card_ms"] = cs.card_ms(torch, [
        lambda r=r: mesh.mesh_round_step(state, r[0], tables, r[1], seed, 10)
        for r in rounds], rate)
    groups = []
    for g in range(8):
        part = _rounds(np, rng, rplane, K, 40 * 10 ** 9 + g * 10 ** 9)
        groups.append((torch.stack([u for u, _ in part]),
                       torch.tensor([t for _, t in part], device="cuda")))
    out["scan_card_ms"] = cs.card_ms(torch, [
        lambda g=g: mesh.mesh_scan(state, g[0], tables, g[1], seed, 10)
        for g in groups], rate)
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
