"""Managed processes (real, unmodified Linux binaries under the preload
shim) through both packages: shadow_tpu (the reference) and
shadow_tpu_torch (the port, on ``--device cpu``), same config and seed.

The bar is the reference's: the same hosts/ tree (less the guests'
``*.clock`` scratch pages, which the reference's tools/ci.sh leaves out
too), the same summary but for wall-clock telemetry and the
``shim_fast_*`` counters (where a syscall completed, not what the
simulation did), and the same state digest stream. Covered: the port's
copy of the shim (byte-identical to native/shim/shim.c) and its build;
managed_smoke with the shim's fast plane on and off and under
thread_per_core; the lossy documents of chip_smoke.py's managed phase at
tpu_device_floor 1 on both engines, at the auto floor and under tpu_mesh
at floor 0 (their counts pinned there); proctree.yaml; and the managed
phase itself on the CPU. The reference's guest programs are in
tests/test_torch_guests.py and test_torch_vfs.py.

The guests are built with native/Makefile's targets into a directory of
this module's own (``make BUILD=...``), never into native/build/, so that
the reference's own test modules, which build there, never race with it.
The reference runs that build of the shim (SHADOW_SHIM_LIB), the port its
own build of csrc/shim/shim.c.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import itertools
import json
import os
import shutil
import sys
import types
from pathlib import Path

import pytest
import yaml

from shadow_tpu import cli as ref_cli
from shadow_tpu.core.controller import VOLATILE_SUMMARY_KEYS as REF_VOLATILE
from shadow_tpu.native import managed as ref_managed
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch import native
from shadow_tpu_torch.core.controller import VOLATILE_SUMMARY_KEYS
from shadow_tpu_torch.native import managed as port_managed

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
GUEST_DIR = ROOT / "native" / "tests" / "guest"
#: the reference runs its Python plane (its C engine needs its own build)
REF_PLANE = ["--set", "experimental.native_colcore=false"]
#: every guest target of native/Makefile these tests run, and the shim
TARGETS = ("libshadow_shim.so", "sleep_clock", "tgen_cli", "tgen_srv",
           "ring_probe", "iov_msg", "tsc_clock", "segv_mix", "crash_null",
           "mt_workers", "fork_pipe", "exec_chain", "sel_pipe",
           "kill_child", "spair_echo", "peek_test", "halfclose",
           "dgram_peek", "udp_conn", "ftool", "thread_exec",
           "sysbreadth", "spair_pump", "pump", "mux_srv", "udp_echo",
           "timer_tick")
CURL = Path("/usr/bin/curl")
MISSING = port_managed.missing_kernel_features()
pytestmark = pytest.mark.skipif(
    bool(MISSING), reason="managed-process kernel capabilities missing: "
    + ", ".join(MISSING))
PY = sys.executable
PY_NAME = Path(PY).name


def chip_smoke():
    from tests.test_torch_e2e import _chip_smoke

    return _chip_smoke()


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """The guests and the reference's shim, built by native/Makefile into
    a directory of this module's own."""
    out = tmp_path_factory.mktemp("guests")
    import subprocess

    r = subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={out}",
                        *(str(out / t) for t in TARGETS)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    return out


def build_ref_shim(out) -> Path:
    """The reference's shim (native/shim/shim.c) built by native/Makefile
    into ``out``; returns ``out``."""
    import subprocess

    r = subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={out}",
                        str(Path(out) / "libshadow_shim.so")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    return Path(out)


def _release_ipc_slot(mod) -> None:
    """Both packages pin fd 995 (SHIM_IPC_FD) to /dev/null for their spawn
    window and refuse to start while another holder has it: hand the
    reservation over between the two packages' runs in one process."""
    if mod._reserved_ipc_slot:
        os.close(mod.SHIM_IPC_FD)
        mod._reserved_ipc_slot = False


def _free_both_slots() -> None:
    for mod in (ref_managed, port_managed):
        _release_ipc_slot(mod)


@pytest.fixture
def ipc_slots():
    """Free fd 995 before and after a test that runs guests in this
    process: a reference test module that runs next in the same worker
    process reserves it anew and refuses to start while it is held."""
    _free_both_slots()
    yield
    _free_both_slots()


@pytest.fixture(autouse=True)
def _ipc_slots_free(ipc_slots):
    """Every test of this module (and of the modules that import this
    fixture) runs with fd 995 handed back afterwards."""
    yield


def _cli(main, mod, cfg, data_dir, argv, rc=0) -> dict:
    """One CLI run in this process; its summary. ``rc``: the exit code it
    must give (1 where a process error is the expected result)."""
    _release_ipc_slot(ref_managed if mod is port_managed else port_managed)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = main([str(cfg), "--data-directory", str(data_dir),
                    "--json-summary", "--quiet", *argv])
    assert got == rc, f"{main.__module__} {argv} exited {got}"
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_ref(cfg, data_dir, build, argv=(), policy="tpu_batch",
            rc=0) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHADOW_SHIM_LIB", str(build / "libshadow_shim.so"))
        return _cli(ref_cli.main, ref_managed, cfg, data_dir,
                    ["--scheduler-policy", policy, *argv, *REF_PLANE], rc)


def run_port(cfg, data_dir, argv=(), policy="tpu_batch", rc=0) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SHADOW_SHIM_LIB", raising=False)
        return _cli(port_cli.main, port_managed, cfg, data_dir,
                    ["--scheduler-policy", policy, "--device", "cpu",
                     *argv], rc)


def stable(summary: dict, volatile) -> dict:
    return chip_smoke().managed_stable(summary, volatile)


def assert_identical(ref, port, ref_dir, port_dir) -> None:
    """The managed identity bar: no process error, the same summary (less
    volatile keys and shim_fast_*), hosts tree (less *.clock) and state
    digest stream."""
    cs = chip_smoke()
    assert ref["process_errors"] == [], ref["process_errors"]
    assert port["process_errors"] == [], port["process_errors"]
    assert stable(port, VOLATILE_SUMMARY_KEYS) == stable(ref, REF_VOLATILE)
    assert cs.hosts_digest(port_dir) == cs.hosts_digest(ref_dir)
    sd = "state_digests.jsonl"
    assert (Path(port_dir, sd).read_bytes() == Path(ref_dir, sd).read_bytes())
    assert Path(ref_dir, sd).stat().st_size > 0


def write_cfg(tmp_path, doc, name="cfg.yaml") -> Path:
    p = tmp_path / name
    p.write_text(doc if isinstance(doc, str)
                 else yaml.safe_dump(doc, sort_keys=False))
    return p


def dual(tmp_path, build, doc, argv=(), policy="tpu_batch",
         digest_every=1, setup=None):
    """Run ``doc`` through both packages; returns (ref, port, ref_dir,
    port_dir) once assert_identical holds. ``setup(host_dir_of)`` places
    files a guest reads before each run."""
    cfg = write_cfg(tmp_path, doc)
    argv = [*argv, "--state-digest-every", str(digest_every)]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for d in (ref_dir, port_dir):
        if setup is not None:
            setup(d)
    ref = run_ref(cfg, ref_dir, build, argv, policy)
    port = run_port(cfg, port_dir, argv, policy)
    assert_identical(ref, port, ref_dir, port_dir)
    return ref, port, ref_dir, port_dir


# -- the shim: the port's copy and its build ----------------------------------

def test_shim_copy_identical_and_builds():
    """csrc/shim/shim.c and csrc/shring.h are native/'s byte for byte; the
    port's build loads with ctypes and is named by its source's hash."""
    assert native.SHIM_SOURCE.read_bytes() == (
        ROOT / "native" / "shim" / "shim.c").read_bytes()
    assert native.SHIM_HEADER.read_bytes() == (
        ROOT / "native" / "shring.h").read_bytes()
    path = native.shim_lib()
    assert path == native.shim_path() and path.parent == native.BUILD
    ctypes.CDLL(str(path))
    assert port_managed._shim_lib() == path


def test_shim_override_and_failed_build_raise(tmp_path, monkeypatch):
    """SHADOW_SHIM_LIB names the library, as in the reference; a shim that
    does not compile raises with the compiler's output (nothing falls back
    to another build)."""
    monkeypatch.setenv("SHADOW_SHIM_LIB", str(tmp_path / "x.so"))
    assert native.shim_lib() == tmp_path / "x.so"
    monkeypatch.delenv("SHADOW_SHIM_LIB")
    bad = tmp_path / "shim" / "shim.c"
    bad.parent.mkdir()
    bad.write_text("#include \"../shring.h\"\nint f( {\n")
    (tmp_path / "shring.h").write_text("")
    monkeypatch.setattr(native, "SHIM_SOURCE", bad)
    monkeypatch.setattr(native, "SHIM_HEADER", tmp_path / "shring.h")
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError) as exc:
        native.build_shim()
    msg = str(exc.value)
    assert "building the preload shim failed" in msg and "error" in msg
    assert not list((tmp_path / "_build").glob("*.so"))


def test_missing_executable_refused_by_name(tmp_path, capsys):
    doc = yaml.safe_load((EX / "echo.yaml").read_text())
    doc["hosts"]["server"]["processes"][0]["path"] = str(tmp_path / "nope")
    rc = port_cli.main([str(write_cfg(tmp_path, doc)), "--device", "cpu",
                        "--data-directory", str(tmp_path / "d"), "--quiet"])
    err = capsys.readouterr().err
    assert rc == 2 and "managed executable" in err, err


# -- managed_smoke: the fast plane on and off, and the thread policy ----------

@pytest.fixture(params=["fast_on", "fast_off"])
def fast_plane(request, monkeypatch):
    """Both sides of the shim's fast plane, in both packages (their module
    globals: SHADOW_TPU_SHIM_FASTPATH is read at import)."""
    on = request.param == "fast_on"
    monkeypatch.setattr(ref_managed, "_FASTPATH_ON", on)
    monkeypatch.setattr(port_managed, "_FASTPATH_ON", on)
    return on


def test_managed_smoke_identical(tmp_path, build, fast_plane):
    """The reference CI's managed smoke: ring_probe drains 300 kB from
    tgen_srv mostly in-shim on the fast leg and through the worker on the
    slow one, with the same results either way and in both packages."""
    cs = chip_smoke()
    doc = cs.managed_doc("managed_smoke", build)
    ref, port, _, d = dual(tmp_path, build, doc, digest_every=5)
    out = (d / "hosts" / "client" / "ring_probe.0.stdout").read_text()
    assert "bytes=300000" in out and "eof=1" in out
    c = port["counters"]
    if fast_plane:
        assert c["shim_fast_syscalls"] * 2 > c["syscalls"]
    else:
        assert c.get("shim_fast_ring_read", 0) == 0
    want = cs.MANAGED_RESULTS["managed_smoke"]
    assert {k: ref[k] for k in want["counts"]} == want["counts"]
    assert cs.guest_stdout_digest(d) == want["stdout"]


def test_managed_smoke_fast_on_equals_off_and_thread_per_core(
        tmp_path, build, monkeypatch):
    """Within the port: fast plane on = off (less shim_fast_*), and
    thread_per_core (the per-unit plane) = tpu_batch."""
    cs = chip_smoke()
    cfg = write_cfg(tmp_path, cs.managed_doc("managed_smoke", build))
    argv = ["--state-digest-every", "5"]
    runs = {}
    for label, on, policy in (("on", True, "tpu_batch"),
                              ("off", False, "tpu_batch"),
                              ("tpc", True, "thread_per_core")):
        monkeypatch.setattr(port_managed, "_FASTPATH_ON", on)
        d = tmp_path / label
        runs[label] = (run_port(cfg, d, argv, policy), d)
    (a, da) = runs["on"]
    for label in ("off", "tpc"):
        b, db = runs[label]
        assert (stable(a, VOLATILE_SUMMARY_KEYS)
                == stable(b, VOLATILE_SUMMARY_KEYS))
        assert cs.hosts_digest(da) == cs.hosts_digest(db)
        assert ((da / "state_digests.jsonl").read_bytes()
                == (db / "state_digests.jsonl").read_bytes())


# -- the lossy documents: managed traffic through the draw and mesh planes ----

def _set_plane_clock(monkeypatch, colplane, step: float) -> None:
    ticks = itertools.count()
    monkeypatch.setattr(colplane, "_walltime", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * step))


#: leg -> (policy, port argv)
LOSSY_LEGS = {
    "floor1_c_engine": ("tpu_batch", ["--set",
                                      "experimental.tpu_device_floor=1"]),
    "floor1_python_plane": ("tpu_batch", [
        "--set", "experimental.tpu_device_floor=1", *REF_PLANE]),
    "auto": ("tpu_batch", []),
    "mesh_floor0": ("tpu_mesh", ["--set", "experimental.tpu_mesh_floor=0"]),
}


@pytest.mark.parametrize("leg", sorted(LOSSY_LEGS))
def test_managed_lossy_identical(tmp_path, build, monkeypatch, leg):
    """managed_smoke with packet_loss 0.01 on edge 0-1: the guests'
    packets go through the draw plane at floor 1 (every window; the port's
    count pinned in chip_smoke.py and equal to the reference's on a clock
    under which no window read stalls) and through the mesh exchange at
    tpu_mesh_floor 0; the reference's results on every leg."""
    from shadow_tpu.network import colplane as ref_colplane

    cs = chip_smoke()
    _set_plane_clock(monkeypatch, ref_colplane, 0.0)
    policy, argv = LOSSY_LEGS[leg]
    cfg = write_cfg(tmp_path, cs.managed_doc("managed_lossy", build))
    digest = ["--state-digest-every", "5"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = run_ref(cfg, ref_dir, build, [*argv, *digest], policy)
    port = run_port(cfg, port_dir, [*argv, *digest], policy)
    assert_identical(ref, port, ref_dir, port_dir)
    want = cs.MANAGED_RESULTS["managed_lossy"]
    assert {k: ref[k] for k in want["counts"]} == want["counts"]
    assert cs.guest_stdout_digest(ref_dir) == want["stdout"]
    assert port["native_colcore"] is (leg != "floor1_python_plane")
    if leg.startswith("floor1"):
        # (a state digest flushes the windows in flight: this count is not
        # the digest-free run's that chip_smoke.py pins)
        assert (port["device"]["windows_dispatched"]
                == ref["device"]["windows_dispatched"] > 0)
    if leg == "mesh_floor0":
        assert port["phase_wall"]["mesh_windows"] > 0
        assert (port["phase_wall"]["mesh_windows"]
                == ref["phase_wall"]["mesh_windows"])


def test_fifty_lossy_identical(tmp_path, build, monkeypatch):
    """The reference's 50-process scale config (10 tgen_srv x 4
    connections, 40 tgen_cli x 100 kB) with loss on edge 0-1, at floor 1:
    the reference's results and windows."""
    from shadow_tpu.network import colplane as ref_colplane

    cs = chip_smoke()
    _set_plane_clock(monkeypatch, ref_colplane, 0.0)
    ref, port, ref_dir, _ = dual(
        tmp_path, build, cs.managed_doc("fifty_lossy", build),
        ["--set", "experimental.tpu_device_floor=1"], digest_every=100)
    want = cs.MANAGED_RESULTS["fifty_lossy"]
    assert {k: ref[k] for k in want["counts"]} == want["counts"]
    assert cs.guest_stdout_digest(ref_dir) == want["stdout"]
    # (a state digest flushes the windows in flight, so this run's count
    # is not the digest-free run's that chip_smoke.py pins)
    assert (port["device"]["windows_dispatched"]
            == ref["device"]["windows_dispatched"] > 0)


@pytest.mark.skipif(not CURL.exists(), reason="no /usr/bin/curl")
def test_proctree_identical(tmp_path, build):
    """examples/proctree.yaml: the httpd model, distro curl by host name
    and a shell pipeline of forked and exec'd guests."""
    cs = chip_smoke()
    _, _, _, d = dual(tmp_path, build, cs.managed_doc("proctree", build))
    assert "code=200 bytes=250000" in (
        d / "hosts" / "curlbox" / "curl.0.stdout").read_text()
    assert "pipeline-done" in (d / "hosts" / "shellbox" /
                               "sh.0.stdout").read_text()


# -- chip_smoke.py's managed phase on the CPU ---------------------------------

def test_chip_smoke_managed_phase_on_cpu(tmp_path):
    """chip_smoke.py's managed phase with its kernels' plain versions: the
    legs that need no curl (and proctree where curl is here), with the
    constants the phase holds the card to."""
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.parallel import mesh

    cs = chip_smoke()
    n, err = cs.managed_path(port_cli, prop, mesh, str(tmp_path),
                             device="cpu", curl=False)
    assert n is not None and err is None


@pytest.mark.slow
@pytest.mark.skipif(not CURL.exists(), reason="no /usr/bin/curl")
def test_chip_smoke_managed_phase_with_real_curl_1k(tmp_path):
    """The whole managed phase on the CPU, bench.py's real_curl_1k
    included (250 real processes, 1,000 validated transfers)."""
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.parallel import mesh

    n, err = chip_smoke().managed_path(port_cli, prop, mesh, str(tmp_path),
                                       device="cpu", curl=True)
    assert n is not None


def test_build_guests_into_a_directory(tmp_path):
    """chip_smoke.build_guests builds only MANAGED_GUESTS, into the
    directory asked for."""
    cs = chip_smoke()
    out = cs.build_guests(tmp_path / "g")
    assert sorted(p.name for p in out.iterdir()) == sorted(cs.MANAGED_GUESTS)
    shutil.rmtree(out)
