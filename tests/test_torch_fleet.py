"""The fleet (shadow_tpu_torch/fleet.py) and its shared DrawServer against
the reference (shadow_tpu/fleet.py, shadow_tpu/ops/propagate.py).

Everything runs on ``--device cpu`` (the draw server attaches the kernels'
plain versions) and under ``tmp_path``, tolerance 0:

- the statistics (t_ci95, the histogram merge) equal the reference's,
  and the ``min_draw`` kernel's plain version equals the reference's
  host twin;
- the DrawServer serves any member seed from one attach with the
  reference's flags and min-draws, threads sharing its plane never share
  a slot, and a failed attach, a closed server or an unreachable service
  makes the member raise DrawServiceError — the deliberate difference
  from the reference, whose member falls back to its host twin;
- a served member gives the reference's run;
- a 3-seed gossip_churn sweep at jobs=2 (the reference CI's fleet smoke at
  a 10 s stop) gives, for every seed, the reference's standalone tree and
  streams, and a sweep summary equal to the reference fleet's apart from
  its wall-clock fields (``sweep_wall_seconds``, ``per_seed_wall_seconds``
  and the ``draw_service`` block, whose counts are routing: wall-clock
  policy);
- ``--resume``, member failure, crash and wedge retries, an interrupt and
  the refused flags behave as the reference's tests/test_fleet.py says
  (the wedge deadline is 15 s against seeds of well under a second, so
  load cannot trip it).

No test waits on a tight wall-clock deadline.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from shadow_tpu import fleet as ref_fleet
from shadow_tpu.network.fluid import MAX_PKTS
from shadow_tpu.network.fluid import loss_flags as ref_loss_flags
from shadow_tpu.telemetry.histogram import LogHistogram as RefHistogram
from shadow_tpu_torch import fleet
from shadow_tpu_torch.ops import devcfg
from shadow_tpu_torch.ops.devcfg import DrawServiceError
from shadow_tpu_torch.ops.propagate import (DeviceDrawPlane, DrawServer,
                                            draw_service_address,
                                            min_draw_plain)
from shadow_tpu_torch.telemetry.histogram import LogHistogram

ROOT = Path(__file__).resolve().parent.parent
CHURN_YAML = ROOT / "examples" / "gossip_churn.yaml"
#: the reference CI's fleet smoke (tools/ci.sh), at a 10 s stop
SMOKE_SEEDS = (120, 121, 122)
SMOKE_ARGS = ["sweep", "examples/gossip_churn.yaml", "--seeds", "3",
              "--seed-base", "120", "--jobs", "2", "--set",
              "general.stop_time=10s", "--quiet", "--json"]
#: what a sweep summary may differ in from the reference's: wall clock,
#: and the draw service's block (served counts are routing)
WALL_KEYS = ("sweep_wall_seconds", "per_seed_wall_seconds", "draw_service")
#: the reference's tests/test_fleet.py legs: short stop, every stream
COMMON = {
    "general.stop_time": "5s",
    "general.state_digest_every": 50,
    "telemetry.sample_every": "10s",
    "experimental.scheduler_policy": "tpu_batch",
}


def _cli(module, args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=str(cwd),
                          env=env, timeout=600)


def _sweep(sweep_dir, base, n, *extra, jobs=2, env=None, common=COMMON,
           rc=0):
    """One port sweep through its CLI (a fresh process: its workers fork
    from a parent with no other thread); its summary."""
    args = ["sweep", str(CHURN_YAML), "--seeds", str(n), "--seed-base",
            str(base), "--jobs", str(jobs), "--sweep-dir", str(sweep_dir),
            "--device", "cpu", "--quiet", "--json", *extra]
    for k, v in common.items():
        args += ["--set", f"{k}={v}"]
    out = _cli("shadow_tpu_torch.fleet", args,
               env=None if env is None else {**os.environ, **env})
    assert out.returncode == rc, out.stderr
    return json.loads(out.stdout)


def _manifest(sweep_dir, seed):
    return json.loads((fleet.seed_dir(sweep_dir, seed)
                       / fleet.SEED_MANIFEST).read_text())


# -- statistics and the min-draw twin ----------------------------------------

@pytest.mark.parametrize("vals", [
    [], [5.0], [10.0, 12.0, 14.0], [1.5, 2.25, 0.75, 9.0, 3.125],
    [float(v) for v in range(1, 40)]])
def test_t_ci95_matches_reference(vals):
    assert fleet.t_ci95(vals) == ref_fleet.t_ci95(vals)


def test_histogram_merge_order_matches_reference():
    """Shuffled merge orders give one state, and it is the reference's:
    what makes the cross-seed reducer sound."""
    rng = random.Random(7)
    states = []
    for i in range(6):
        h = LogHistogram()
        for _ in range(500 + 97 * i):
            h.add(rng.randrange(0, 1 << 40))
        states.append(h.state())
    base = LogHistogram.merged(states).state()
    assert base == RefHistogram.merged(states).state()
    for _trial in range(5):
        order = list(range(len(states)))
        rng.shuffle(order)
        shuffled = [states[i] for i in order]
        assert LogHistogram.merged(shuffled).state() == base
        assert RefHistogram.merged(shuffled).state() == base


def _draw_inputs(seed, n=777):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    npk = rng.integers(0, MAX_PKTS + 1, n).astype(np.uint32)
    th = rng.integers(0, 1 << 20, n).astype(np.uint32)
    return lo, hi, npk, th


def test_min_draw_plain_matches_the_reference_twin():
    """The port keeps no host twin of ``min_draw`` (the reference's serves
    only its fallback handles): the kernel's plain version is held to the
    reference's ``_min_draw_np``."""
    lo, hi, npk, th = _draw_inputs(11, 512)
    packed = torch.from_numpy(np.stack([lo, hi, npk]))
    mins = min_draw_plain(packed, [9, 0]).numpy()
    assert (mins == ref_fleet._min_draw_np(9, lo, hi, npk, MAX_PKTS)).all()
    # dropped == min_draw < thresh, the identity the C engine's consult uses
    assert ((mins < th) == ref_loss_flags(9, lo, hi, npk, th)).all()


# -- the DrawServer -----------------------------------------------------------

@contextlib.contextmanager
def _draw_server(seed, max_batch):
    """A DrawServer on the CPU at a fresh socket path, closed and its
    directory removed on exit."""
    address = draw_service_address()
    srv = DrawServer(seed, max_batch, MAX_PKTS, address=address,
                     device="cpu")
    try:
        yield srv
    finally:
        srv.close()
        shutil.rmtree(os.path.dirname(address), ignore_errors=True)


@pytest.fixture
def server():
    with _draw_server(123, 4096) as srv:
        yield srv


@pytest.mark.parametrize("member_seed", [123, 9999])
def test_draw_server_round_trip(server, member_seed):
    """The attach's seed and another: one attach serves both, with the
    reference's flags and min-draws."""
    lo, hi, npk, th = _draw_inputs(2)
    cl = fleet.FleetDrawClient.connect(server.address, member_seed, 4096,
                                       MAX_PKTS, timeout=120)
    h_flags = cl.dispatch(lo, hi, npk, th)
    h_min = cl.dispatch_min(lo, hi, npk, min_bucket=cl.SPEC_BUCKET)
    # read out of order: responses are demuxed by request id
    assert (h_min.read() == ref_fleet._min_draw_np(
        member_seed, lo, hi, npk, MAX_PKTS)).all()
    assert (h_flags.read() == ref_loss_flags(member_seed, lo, hi, npk,
                                             th)).all()
    h = cl.dispatch(lo, hi, npk, th)
    while not h.is_ready():  # polls without blocking, as the windows do
        time.sleep(0.001)
    assert (h.read() == ref_loss_flags(member_seed, lo, hi, npk, th)).all()
    cl.close_client()
    server.close()  # every request already sent is served and counted
    assert server.served == {"draw_flags": 2, "min_draw": 1}
    assert server.served_units == 3 * len(lo)
    assert server.errors == []
    assert (cl.max_batch, cl.SPEC_BUCKET) == (4096,
                                              DeviceDrawPlane.SPEC_BUCKET)


def test_draw_server_threads_never_share_a_slot(server):
    """More members than cores at once on the one plane, with a short
    switch interval, each keeping up to three requests in flight: every
    result is its own seed's, no DrawSlot is ever held by two in-flight
    handles, and every request is counted once."""
    while not server._ready.wait(0.1):
        pass
    plane = server.plane
    held: dict = {}
    lock = threading.Lock()
    errors: list = []
    orig = plane._launch

    def launch(*a):
        slot = orig(*a)
        with lock:
            if id(slot) in held:
                errors.append("slot handed out twice")
            held[id(slot)] = slot
        return slot

    give = plane._give

    def give_back(slot):
        with lock:
            held.pop(id(slot), None)
        give(slot)

    plane._launch, plane._give = launch, give_back
    seeds = range(5, 5 + 2 * (os.cpu_count() or 4))

    def member(seed):
        cl = fleet.FleetDrawClient.connect(server.address, seed, 4096,
                                           MAX_PKTS, timeout=120)
        rng = np.random.default_rng(seed)
        inflight = []
        for i in range(12):
            n = int(rng.integers(1, 3000))
            lo, hi, npk, th = (a[:n] for a in _draw_inputs(seed * 100 + i,
                                                           3000))
            inflight.append((cl.dispatch(lo, hi, npk, th),
                             ref_loss_flags(seed, lo, hi, npk, th)))
            if len(inflight) == 3:
                for h, want in inflight:
                    if not (h.read() == want).all():
                        errors.append(f"seed {seed}: wrong flags")
                inflight = []
        cl.close_client()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=member, args=(s,)) for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    server.close()
    assert server.served["draw_flags"] == 12 * len(seeds)
    assert server.errors == []


def test_launch_count_is_exact_across_threads(monkeypatch):
    """The draw kernels' launch count is a read-modify-write shared by the
    server's member threads: under a short switch interval, N threads
    launching K times each count N * K launches (the launch itself is a
    stand-in here; the card's is held by chip_smoke.py's fleet phase)."""
    from shadow_tpu_torch.ops import propagate as prop

    class Lib:
        def shadow_draw_flags(self, *a):
            return 0

    monkeypatch.setattr(devcfg, "kernel_lib", lambda stem: Lib())
    monkeypatch.setattr(devcfg, "check_launch", lambda *a: None)
    monkeypatch.setitem(prop.LAUNCHES, "draw_flags", 0)
    n, k = 2 * (os.cpu_count() or 4), 3000

    def launcher():
        for _ in range(k):
            prop._launch_kernel("draw_flags", 0, 256, 256, (1, 0), 10, 0, 0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launcher) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert prop.LAUNCHES["draw_flags"] == n * k


def test_closed_server_makes_the_member_raise(server):
    """The reference's member falls back to its host twin when the server
    dies (its test_draw_service_round_trip_and_fallback, second half);
    the port's raises by name, for a request in flight, every later one
    and a new connection alike."""
    lo, hi, npk, th = _draw_inputs(3)
    cl = fleet.FleetDrawClient.connect(server.address, 42, 4096, MAX_PKTS,
                                       timeout=120)
    h = cl.dispatch(lo, hi, npk, th)
    assert (h.read() == ref_loss_flags(42, lo, hi, npk, th)).all()
    h2 = cl.dispatch(lo, hi, npk, th)
    h2.read()
    server.close()
    with pytest.raises(DrawServiceError, match="fleet draw service"):
        cl.dispatch(lo, hi, npk, th).read()
    with pytest.raises(DrawServiceError):
        cl.dispatch_min(lo, hi, npk)
    with pytest.raises(DrawServiceError, match="not reachable"):
        fleet.FleetDrawClient.connect(server.address, 42, 4096, MAX_PKTS,
                                      timeout=5, abort=lambda: True)


def test_failed_attach_is_sent_to_the_member(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("kernel build failed: no nvcc")

    monkeypatch.setattr(DeviceDrawPlane, "attach_cached", broken)
    with _draw_server(1, 4096) as srv:
        with pytest.raises(DrawServiceError, match="no nvcc"):
            fleet.FleetDrawClient.connect(srv.address, 1, 4096, MAX_PKTS,
                                          timeout=60)
        assert len(srv.errors) == 1 and "attach" in srv.errors[0]


def test_server_close_never_waits_on_its_own_accept_loop(monkeypatch):
    """close() wakes the accept loop with a bare connection: a handshake
    there would wait forever whenever the loop had already seen the close
    (the race hung about one close in 300 before the fix). Each close runs
    on a thread bounded by a timeout."""
    def broken(*a, **k):
        raise RuntimeError("no card")

    monkeypatch.setattr(DeviceDrawPlane, "attach_cached", broken)
    address = draw_service_address()
    try:
        for _ in range(300):
            srv = DrawServer(1, 4096, MAX_PKTS, address=address,
                             device="cpu")
            with pytest.raises(DrawServiceError):
                fleet.FleetDrawClient.connect(address, 1, 4096, MAX_PKTS,
                                              timeout=60)
            t = threading.Thread(target=srv.close, daemon=True)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive(), "DrawServer.close() hung"
    finally:
        shutil.rmtree(os.path.dirname(address), ignore_errors=True)


def test_unreachable_service_fails_the_member_run(tmp_path, monkeypatch):
    """A member whose service cannot be reached raises DrawServiceError
    through raise_attach_error, even when its run ends first; it never
    runs as if unserved."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    monkeypatch.setenv(fleet.SERVICE_ENV, str(tmp_path / "no" / "sock"))
    cfg = load_config(str(ROOT / "examples" / "echo.yaml"), {
        "experimental.scheduler_policy": "tpu_batch",
        "general.data_directory": str(tmp_path / "run")})
    with pytest.raises(DrawServiceError, match="not reachable"):
        Controller(cfg, mirror_log=False, device="cpu").run()


def test_served_member_gives_the_reference_run(tmp_path, monkeypatch):
    """tgen_100host under tpu_batch (C engine, auto) as a fleet member
    served by an attached server: its speculative waves go to the server,
    one request a wave (the proxy collects the responses it never read
    before it says bye), and the run equals the reference's."""
    from shadow_tpu import cli as ref_cli
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller
    from tests.test_torch_e2e import COUNTS, _run

    with _draw_server(1, 65536) as srv:
        while not srv._ready.wait(0.1):
            pass
        monkeypatch.setenv(fleet.SERVICE_ENV, srv.address)
        cfg = load_config(str(ROOT / "examples" / "tgen_100host.yaml"), {
            "experimental.scheduler_policy": "tpu_batch",
            "general.data_directory": str(tmp_path / "port")})
        ctl = Controller(cfg, mirror_log=False, device="cpu")
        # the proxy publishes from round 0, as a cached plane does, so the
        # waves engage whatever this host's speed
        ctl.engine._bg_thread.join()
        assert isinstance(ctl.engine.device, fleet.FleetDrawClient)
        port = ctl.run()
    assert port["native_colcore"] is True
    assert srv.errors == []
    assert srv.served_batches == port["device"]["windows_dispatched"] > 0
    ref = _run(ref_cli.main, ROOT / "examples" / "tgen_100host.yaml",
               tmp_path / "ref",
               ["--set", "experimental.native_colcore=false"])
    assert {k: port[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    assert fleet.output_tree_digest(tmp_path / "port") == \
        ref_fleet.output_tree_digest(tmp_path / "ref")


def test_served_member_that_creates_cuda_fails_its_seed(tmp_path,
                                                        monkeypatch,
                                                        server):
    """A served member must launch nothing: if CUDA came up in it, the
    seed fails by name (the check runs before the ok manifest)."""
    monkeypatch.setenv(fleet.SERVICE_ENV, server.address)
    monkeypatch.setattr(fleet, "_cuda_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="created a CUDA context"):
        fleet._run_one_seed(str(CHURN_YAML), dict(COMMON), tmp_path, 3,
                            "cpu")
    assert _manifest(tmp_path, 3)["status"] == "running"


def test_workers_fork_only_without_cuda_server_or_threads(tmp_path,
                                                        monkeypatch):
    r = fleet.FleetRunner(str(CHURN_YAML), [1], jobs=1, sweep_dir=tmp_path,
                          device="cpu")
    monkeypatch.setattr(fleet, "_cuda_initialized", lambda: False)
    monkeypatch.setattr(threading, "active_count", lambda: 1)
    assert r._mp_ctx().get_start_method() == "fork"
    monkeypatch.setattr(threading, "active_count", lambda: 2)
    assert r._mp_ctx().get_start_method() == "spawn"
    monkeypatch.setattr(threading, "active_count", lambda: 1)
    monkeypatch.setattr(fleet, "_cuda_initialized", lambda: True)
    assert r._mp_ctx().get_start_method() == "spawn"
    monkeypatch.setattr(fleet, "_cuda_initialized", lambda: False)
    r._server = object()  # a worker respawned once the server exists
    assert r._mp_ctx().get_start_method() == "spawn"


# -- the sweep ----------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The reference CI's fleet smoke at 10 s through both packages' CLIs,
    and each seed run standalone by the reference with the same stop and
    telemetry."""
    from shadow_tpu import cli as ref_cli

    base = tmp_path_factory.mktemp("fleet_smoke")
    port = _cli("shadow_tpu_torch.fleet", [*SMOKE_ARGS, "--sweep-dir",
                                           str(base / "port"),
                                           "--device", "cpu"])
    assert port.returncode == 0, port.stderr
    ref = _cli("shadow_tpu.fleet", [*SMOKE_ARGS, "--sweep-dir",
                                    str(base / "ref")],
               env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr
    solo = {}
    for s in SMOKE_SEEDS:
        d = base / f"solo_{s}"
        ref_cli.main(["examples/gossip_churn.yaml", "--quiet", "--seed",
                      str(s), "--data-directory", str(d), "--set",
                      "general.stop_time=10s", "--sample-every", "10s"])
        solo[s] = d
    return (base, json.loads(port.stdout), json.loads(ref.stdout), solo)


def test_sweep_seeds_equal_the_reference_standalone(smoke):
    base, summary, _ref, solo = smoke
    assert summary["completed"] == list(SMOKE_SEEDS)
    assert summary["failed"] == {}
    for s in SMOKE_SEEDS:
        d = fleet.seed_dir(base / "port", s)
        man = _manifest(base / "port", s)
        assert man["status"] == "ok"
        assert man["format"] == fleet.MANIFEST_FORMAT
        tree = ref_fleet.output_tree_digest(solo[s])
        assert fleet.output_tree_digest(d) == tree == man["tree_sha256"]
        assert fleet._stream_digests(d) == ref_fleet._stream_digests(
            solo[s]) == man["streams_sha256"]
        ref_man = json.loads((ref_fleet.seed_dir(base / "ref", s)
                              / ref_fleet.SEED_MANIFEST).read_text())
        for k in ("config_digest", "summary", "events", "rounds",
                  "exit_reason", "process_errors", "tree_sha256",
                  "streams_sha256"):
            assert man[k] == ref_man[k], k


def test_sweep_summary_equals_the_reference_fleet(smoke):
    base, summary, ref, _solo = smoke
    strip = {k: v for k, v in ref.items() if k not in WALL_KEYS}
    assert {k: v for k, v in summary.items() if k not in WALL_KEYS} == strip
    assert summary["flows"]
    for kind, row in summary["flows"].items():
        ci = row["ci95"]["p50_ms"]
        assert ci["n"] == 3 and ci["lo"] <= ci["mean"] <= ci["hi"], kind
    svc = summary["draw_service"]
    assert svc["errors"] == []
    # the config's thread_per_core members draw on the host: nothing to
    # serve (as in the reference's run)
    assert svc["served_batches"] == 0 == ref["draw_service"][
        "served_batches"]
    on_disk = json.loads((base / "port" / fleet.SWEEP_SUMMARY).read_text())
    assert on_disk == summary
    # the reduction is a pure function of the on-disk artifacts
    assert fleet.reduce_sweep(base / "port")["flows"] == summary["flows"]


def _report_lines(text):
    """A report less its wall-clock numbers (the first line's wall and the
    draw service's attach wall)."""
    out = []
    for line in text.splitlines():
        if line.startswith("sweep:"):
            line = line.split(", wall")[0]
        if "shared draw service" in line:
            line = line.split(", one attach")[0]
        out.append(line)
    return out


def test_report_equals_the_reference(smoke):
    base, summary, _ref, _solo = smoke
    assert fleet.render_report(summary) == ref_fleet.render_report(summary)
    port = _cli("shadow_tpu_torch.fleet", ["report", str(base / "port")])
    ref = _cli("shadow_tpu.fleet", ["report", str(base / "ref")],
               env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert port.returncode == 0 == ref.returncode, port.stderr + ref.stderr
    assert _report_lines(port.stdout) == _report_lines(ref.stdout)
    assert "CI95" in port.stdout


def test_resume_skips_completed_seeds(tmp_path):
    s1 = _sweep(tmp_path, 60, 2)
    assert s1["completed"] == [60, 61]
    stamp = {s: (fleet.seed_dir(tmp_path, s) / fleet.SEED_MANIFEST)
             .stat().st_mtime_ns for s in (60, 61)}
    s2 = _sweep(tmp_path, 60, 3, "--resume")
    assert s2["completed"] == [60, 61, 62]
    assert s2["skipped_resume"] == [60, 61]
    for s in (60, 61):  # completed seeds were not re-run
        assert (fleet.seed_dir(tmp_path, s) / fleet.SEED_MANIFEST
                ).stat().st_mtime_ns == stamp[s]
    # a changed config invalidates completion
    s3 = _sweep(tmp_path, 60, 1, "--resume", jobs=1,
                common={**COMMON, "general.stop_time": "4s"})
    assert s3["skipped_resume"] == []
    # a seed whose worker died mid-run ("running") re-runs, and so does a
    # seed whose manifest is the reference package's
    for s, key, val in ((61, "status", "running"),
                        (62, "format", ref_fleet.MANIFEST_FORMAT)):
        man = _manifest(tmp_path, s)
        man[key] = val
        (fleet.seed_dir(tmp_path, s) / fleet.SEED_MANIFEST).write_text(
            json.dumps(man))
    s4 = _sweep(tmp_path, 61, 2, "--resume")
    assert s4["skipped_resume"] == [] and s4["completed"] == [61, 62]


def test_member_failure_contained(tmp_path):
    summary = _sweep(tmp_path, 70, 2, env={fleet.CHAOS_ENV: "70"}, rc=1)
    assert summary["completed"] == [71]
    assert "chaos hook" in summary["failed"]["70"]
    assert _manifest(tmp_path, 70)["status"] == "failed"
    s2 = _sweep(tmp_path, 70, 2, "--resume")
    assert s2["completed"] == [70, 71]
    assert s2["skipped_resume"] == [71]


def test_crashed_seed_retried(tmp_path):
    summary = _sweep(tmp_path, 80, 2, "--no-device-service",
                     env={fleet.CHAOS_KILL_ENV: "80"})
    assert summary["completed"] == [80, 81]
    assert summary["failed"] == {}
    assert summary["respawns"] == 1
    assert (tmp_path / "chaos" / "kill.s80.fired").is_file()
    assert _manifest(tmp_path, 80)["status"] == "ok"


def test_wedged_member_detected_and_retried(tmp_path):
    summary = _sweep(tmp_path, 90, 1, "--no-device-service", jobs=1,
                     env={fleet.CHAOS_WEDGE_ENV: "90",
                          fleet.FLEET_STALL_ENV: "15"})
    assert summary["completed"] == [90]
    assert summary["failed"] == {}
    assert summary["respawns"] == 1
    assert (tmp_path / "chaos" / "wedge.s90.fired").is_file()


def test_interrupt_leaves_a_partial_summary(tmp_path):
    """SIGINT mid-sweep: in-flight members killed, their seeds recorded
    ``interrupted``, a valid partial summary, exit 130."""
    sweep = tmp_path / "sweep"
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.fleet", "sweep",
         str(CHURN_YAML), "--seeds", "2", "--seed-base", "7", "--jobs", "2",
         "--stop-time", "600s", "--sweep-dir", str(sweep),
         "--no-device-service", "--quiet", "--json", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(ROOT))
    try:
        # both seeds dispatched ("running" manifests) means the parent sits
        # in its dispatch loop, and a 600 s stop keeps them running
        while len(list(sweep.glob("seed_*/" + fleet.SEED_MANIFEST))) < 2:
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 130, (out.decode(), err.decode())
    summary = json.loads((sweep / fleet.SWEEP_SUMMARY).read_text())
    assert summary["exit_reason"] == "interrupted"
    assert sorted(summary["failed"]) == ["7", "8"]
    for s, why in summary["failed"].items():
        assert why == "interrupted"
        man = _manifest(sweep, int(s))
        assert (man["status"], man["error"]) == ("failed", "interrupted")
    assert json.loads(out)["exit_reason"] == "interrupted"


@pytest.mark.parametrize("argv, feature", [
    (["sweep", "c.yaml", "--fork-from", "x.ckpt"], "--fork-from"),
    (["sweep", "c.yaml", "--branches", "b.yaml"], "--branches"),
    (["sweep", "c.yaml", "--trunk-dir", "t"], "--trunk-dir"),
    (["sweep", "CHURN", "--live-endpoint",
      "/tmp/" + "x" * 120 + "/live.sock"], "--live-endpoint"),
    (["report", "SWEEP", "--compare"], "--compare"),
    (["report", "FORK"], "report of a fork directory"),
])
def test_unported_flags_refused_by_name(tmp_path, capsys, argv, feature):
    """Fork mode and the sweep's live endpoint are ported; what the fleet
    CLI still refuses by name (exit 2) is their misuse: half a fork's
    flags, a socket path past the AF_UNIX limit, --compare of a seed
    sweep. A fork directory's report renders (exit 0)."""
    fork = tmp_path / "fork"
    (fork / "branch_a").mkdir(parents=True)
    (fork / "branch_a" / fleet.FORK_MANIFEST).write_text("{}")
    argv = [str(fork) if a == "FORK" else str(tmp_path) if a == "SWEEP"
            else str(CHURN_YAML) if a == "CHURN" else a for a in argv]
    rc = fleet.main(argv)
    out, err = capsys.readouterr()
    if feature == "report of a fork directory":
        assert rc == 0, err
        assert out.startswith("fork: 0 branch(es), 0 ok, 0 failed")
        return
    assert rc == 2
    want = {"--live-endpoint": "exceeds the AF_UNIX limit",
            "--compare": "is a seed sweep, not a fork"}.get(
                feature, "--fork-from and --branches go together")
    assert err.startswith("fleet: ") and want in err, err
    assert feature in err or feature == "--live-endpoint"


def test_cuda_sweep_without_a_card_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert fleet.main(["sweep", str(CHURN_YAML), "--seeds", "1",
                       "--sweep-dir", str(tmp_path), "--quiet"]) == 2
    assert "device cuda" in capsys.readouterr().err
    with pytest.raises(devcfg.DeviceUnavailable):
        devcfg.require_device("cuda")


def test_chip_smoke_served_draws_on_cpu():
    """chip_smoke.py's served-draws check (the DrawServer's draw op, which
    the sweeps' members do not reach) on the CPU, on 40 windows made from
    a seed: six members on threads, every result against
    fluid.loss_flags, every batch served once."""
    from shadow_tpu_torch.ops import propagate as prop
    from tests.test_torch_e2e import _chip_smoke

    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    windows = []
    for i in range(40):
        n = int(rng.integers(1, 257))
        x = torch.zeros((4, 256), dtype=torch.uint32)
        x[:, :n] = torch.from_numpy(np.stack(_draw_inputs(100 + i, n)))
        windows.append((x, (77, 0), MAX_PKTS, n))
    units = sum(w[3] for w in windows)
    batches = 40 + sum(-(-units // size) for size in cs.SERVED_BATCHES)
    out = cs.served_draws(np, prop, windows, device="cpu")
    assert out["served"] == {"draw_flags": 2 * batches, "min_draw": 0}
    assert out["served_units"] == 2 * (1 + len(cs.SERVED_BATCHES)) * units


# -- the CI-scale legs (chip_smoke.py's fleet phase, on the CPU) --------------

@pytest.mark.slow
def test_chip_smoke_fleet_ci_legs_on_cpu(tmp_path):
    """chip_smoke.py's fleet phase legs on ``--device cpu``: the CI smoke
    at its 25 s stop against the pinned per-seed constants (which the
    reference computes here), and the chaos leg."""
    from shadow_tpu import cli as ref_cli
    from tests.test_torch_e2e import _chip_smoke

    cs = _chip_smoke()
    for s in SMOKE_SEEDS:
        d = tmp_path / f"solo_{s}"
        ref_cli.main(["examples/gossip_churn.yaml", "--quiet", "--seed",
                      str(s), "--data-directory", str(d), "--set",
                      "general.stop_time=25s", "--sample-every", "10s"])
        assert ref_fleet.output_tree_digest(d) == cs.FLEET_SMOKE_TREES[s]
        assert ref_fleet._stream_digests(d) == cs.FLEET_SMOKE_STREAMS[s]
    out = cs.fleet_ci_legs(tmp_path / "legs", device="cpu")
    assert out["smoke"]["completed"] == list(SMOKE_SEEDS)
    assert out["chaos"]["respawns"] >= 1


@pytest.mark.slow
def test_chip_smoke_tgen1k_trees_pinned(tmp_path):
    """chip_smoke.py's tgen_1k sweep constants: the reference's standalone
    trees of its seeds (C engine is the port's; the reference runs its
    Python plane)."""
    from shadow_tpu import cli as ref_cli
    from tests.test_torch_e2e import _chip_smoke

    cs = _chip_smoke()
    for s, want in cs.FLEET_TGEN1K_TREES.items():
        d = tmp_path / f"tgen_{s}"
        ref_cli.main(["examples/tgen_1k.yaml", "--quiet", "--seed", str(s),
                      "--data-directory", str(d), "--scheduler-policy",
                      "tpu_batch", "--set", "experimental.native_colcore="
                      "false"])
        assert ref_fleet.output_tree_digest(d) == want, s


# -- a managed sweep ----------------------------------------------------------

def test_managed_sweep_and_partial_run_resume(tmp_path):
    """A 2-seed sweep of real binaries (managed_smoke) through both
    packages' fleet CLIs: every seed's hosts tree (less *.clock) and
    state digest stream is the reference's. Then --resume treats a seed
    left mid-run by a dead worker (status "running", a stale guest in its
    guest_pids.jsonl) as failed: the stale guest is reaped (its clock-page
    path found in its environment) and the seed re-runs to ok."""
    from shadow_tpu_torch.native.managed import missing_kernel_features
    from tests.test_torch_e2e import _chip_smoke
    from tests.test_torch_managed import build_ref_shim

    if missing_kernel_features():
        pytest.skip(f"kernel features missing: {missing_kernel_features()}")
    cs = _chip_smoke()
    guests = cs.build_guests(tmp_path / "g")
    cfg = cs.write_doc(cs.managed_doc("managed_smoke", guests),
                       tmp_path / "m.yaml")
    common = ["--seeds", "2", "--seed-base", "11", "--jobs", "2",
              "--quiet", "--json", "--set", "general.state_digest_every=10"]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    out = _cli("shadow_tpu_torch.fleet", ["sweep", cfg, "--sweep-dir",
                                          str(port_dir), "--device", "cpu",
                                          *common])
    assert out.returncode == 0, out.stderr
    s1 = json.loads(out.stdout)
    ref = _cli("shadow_tpu.fleet", ["sweep", cfg, "--sweep-dir",
                                    str(ref_dir), *common],
               env={**os.environ, "JAX_PLATFORMS": "cpu",
                    "SHADOW_SHIM_LIB": str(build_ref_shim(guests)
                                           / "libshadow_shim.so")})
    assert ref.returncode == 0, ref.stderr
    assert s1["completed"] == json.loads(ref.stdout)["completed"] == [11, 12]
    for s in (11, 12):
        man = _manifest(port_dir, s)
        assert man["status"] == "ok" and man["process_errors"] == []
        d, rd = fleet.seed_dir(port_dir, s), ref_fleet.seed_dir(ref_dir, s)
        assert cs.hosts_digest(d) == cs.hosts_digest(rd)
        assert ((d / "state_digests.jsonl").read_bytes()
                == (rd / "state_digests.jsonl").read_bytes())
    # the state a SIGKILLed worker leaves behind
    d = fleet.seed_dir(port_dir, 12)
    man = _manifest(port_dir, 12)
    (d / fleet.SEED_MANIFEST).write_text(json.dumps(
        {"format": man["format"], "seed": 12, "status": "running",
         "config_digest": man["config_digest"]}))
    shm = str(d / "hosts" / "server" / "tgen_srv.0.clock")
    stale = subprocess.Popen(["sleep", "300"], env={"SHADOW_TIME_SHM": shm})
    try:
        (d / "guest_pids.jsonl").write_text(json.dumps(
            {"pid": stale.pid, "host": "server", "proc": "tgen_srv.0",
             "shm": shm}) + "\n")
        out = _cli("shadow_tpu_torch.fleet", ["sweep", cfg, "--sweep-dir",
                                              str(port_dir), "--device",
                                              "cpu", "--resume", *common])
        assert out.returncode == 0, out.stderr
        s2 = json.loads(out.stdout)
        assert s2["skipped_resume"] == [11]
        assert s2["completed"] == [11, 12]
        assert stale.wait(timeout=10) == -9, "stale guest not reaped"
    finally:
        if stale.poll() is None:
            stale.kill()
            stale.wait()
    man = _manifest(port_dir, 12)
    assert man["status"] == "ok" and man["process_errors"] == []
    assert cs.hosts_digest(d) == cs.hosts_digest(
        ref_fleet.seed_dir(ref_dir, 12))
