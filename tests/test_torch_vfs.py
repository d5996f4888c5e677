"""The virtual file surface of managed processes (native/vfs.py) in the
port against the reference.

The synthesized files (/etc/hosts, /etc/resolv.conf, the /proc and /sys
identity) come out of both packages' HostVFS byte for byte on the same
host list and clock; then the reference's tests/test_vfs.py guests run
through both packages' CLIs (tests/test_torch_managed.py's dual run):
ftool reading its config through the vfs and writing its transfer log,
/bin/cat of the synthesized /etc/hosts, CPython's file work and mmap over
virtual files, the /proc identity and the native-passthrough report. The
same tree, summary and state digests, and the text the reference's tests
look for.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

from shadow_tpu.native import vfs as ref_vfs
from shadow_tpu_torch.native import identity
from shadow_tpu_torch.native import vfs
from tests.test_torch_managed import (GUEST_DIR, MISSING, PY_NAME,
                                      _ipc_slots_free, build, dual,
                                      ipc_slots)

pytestmark = pytest.mark.skipif(
    bool(MISSING), reason="managed-process kernel capabilities missing: "
    + ", ".join(MISSING))
#: fixtures shared with test_torch_managed: the guests' build, and fd 995
#: handed back after every test
__all__ = ["build", "ipc_slots", "_ipc_slots_free"]

SYNTH_PATHS = ("/etc/hosts", "/etc/resolv.conf", "/proc/cpuinfo",
               "/proc/meminfo", "/proc/uptime", "/proc/self/stat",
               "/proc/self/status", "/proc/self/maps", "/proc/41/stat",
               "/proc/42/status", "/sys/devices/system/cpu/online",
               "/sys/devices/system/cpu/possible",
               "/sys/devices/system/cpu/present", "/etc/passwd",
               "/proc/self/environ")


def _fake_proc(tmp_path):
    """The parts of a managed process HostVFS reads: its host (name, clock,
    the controller's host list and data directory), its vpid, executable
    and threads."""
    hosts = [types.SimpleNamespace(name=n, ip=f"11.0.0.{i + 1}")
             for i, n in enumerate(("alpha", "beta", "relay7"))]
    ctl = types.SimpleNamespace(hosts=hosts, data_dir=tmp_path)
    host = types.SimpleNamespace(name="beta", controller=ctl,
                                 now=3_141_592_653)
    thread = types.SimpleNamespace(dead=False)
    return types.SimpleNamespace(
        host=host, vpid=42, opts=types.SimpleNamespace(path="/bin/cat"),
        threads={0: thread, 1: thread,
                 2: types.SimpleNamespace(dead=True)})


@pytest.mark.parametrize("path", SYNTH_PATHS)
def test_synthesized_files_match_reference(tmp_path, path):
    """Every synthesized file (and every path left to the real kernel,
    None) is the reference's, byte for byte."""
    proc = _fake_proc(tmp_path)
    got = vfs.HostVFS(proc)._synth(path)
    assert got == ref_vfs.HostVFS(proc)._synth(path)
    if path in ("/etc/passwd", "/proc/self/environ"):
        assert got is None


def test_identity_and_inodes_match_reference():
    from shadow_tpu.native import identity as ref_identity

    assert (identity.SIM_CPUS, identity.SIM_RAM) == (
        ref_identity.SIM_CPUS, ref_identity.SIM_RAM)
    for p in ("/bin/cat", "/usr/bin/python3", "", "/x" * 100):
        assert vfs._det_ino(p) == ref_vfs._det_ino(p)


ETC = """
general:
  stop_time: 10s
  seed: 7
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        edge [ source 0 target 0 latency "5 ms" ]
      ]
hosts:
  alpha:
    network_node_id: 0
    ip_addr: 11.0.0.1
    processes: []
  beta:
    network_node_id: 0
    ip_addr: 11.0.0.2
    processes:
      - path: {path}
        args: {args}
        start_time: 1s
        expected_final_state: {{exited: 0}}
"""

FTOOL = """
general:
  stop_time: 30s
  seed: 5
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        node [ id 1 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        edge [ source 0 target 1 latency "20 ms" ]
      ]
hosts:
  server:
    network_node_id: 0
    ip_addr: 11.0.0.1
    processes:
      - path: {build}/tgen_srv
        args: ["8080", "3"]
        expected_final_state: {{exited: 0}}
  client:
    network_node_id: 1
    processes:
      - path: {build}/ftool
        args: ["ftool.conf"]
        start_time: 1s
        expected_final_state: {{exited: 0}}
"""

FTOOL_LOG = ("transfer 0 bytes=40000\ntransfer 1 bytes=40000\n"
             "transfer 2 bytes=40000\ndone transfers=3 total=120000\n")


def _ftool_conf(data_dir) -> None:
    """ftool's config file in the client's host directory (its cwd)."""
    cdir = Path(data_dir) / "hosts" / "client"
    cdir.mkdir(parents=True, exist_ok=True)
    (cdir / "ftool.conf").write_text("11.0.0.1 8080 40000 3\n")


def test_ftool_identical(tmp_path, build):
    """The config file read through the vfs, the transfers over the
    simulated network, the log written and renamed into place."""
    _, _, _, d = dual(tmp_path, build, FTOOL.format(build=build),
                      setup=_ftool_conf)
    cdir = d / "hosts" / "client"
    assert "ftool-ok transfers=3" in (cdir / "ftool.0.stdout").read_text()
    assert (cdir / "transfer.log").read_text() == FTOOL_LOG
    assert not (cdir / "transfer.log.tmp").exists()


#: name -> (path, args, {file under hosts/beta: text it must hold})
ETC_CASES = {
    "etc_hosts": ("/bin/cat", ["/etc/hosts"], {
        "cat.0.stdout": "11.0.0.1 alpha\n11.0.0.2 beta\n"}),
    "python_file_io": (sys.executable, [str(GUEST_DIR / "py_files.py")],
                       {}),
    "python_mmap": (sys.executable, [str(GUEST_DIR / "py_mmap.py")], {
        "rw.bin": "HELLO"}),
    "proc_identity": (sys.executable, [str(GUEST_DIR / "py_proc.py")], {
        f"{PY_NAME}.0.stdout": "MemTotal:       2097152 kB"}),
}


@pytest.mark.parametrize("case", sorted(ETC_CASES))
def test_vfs_guests_identical(tmp_path, build, case):
    """tests/test_vfs.py's guests on ETC_CFG's two hosts through both
    packages; the same output as the real kernel gives where the reference
    holds it to the kernel (file work, mmap)."""
    import json
    import subprocess

    path, args, want = ETC_CASES[case]
    ref, port, _, d = dual(tmp_path, build, ETC.format(
        path=path, args=json.dumps(args)))
    beta = d / "hosts" / "beta"
    for rel, text in want.items():
        assert text in (beta / rel).read_text(errors="replace"), rel
    if case in ("python_file_io", "python_mmap"):
        work = tmp_path / "native_cwd"
        work.mkdir()
        native = subprocess.run([path, *args], cwd=work, capture_output=True,
                                text=True, timeout=60)
        assert native.returncode == 0, native.stderr
        assert (beta / f"{PY_NAME}.0.stdout").read_text() == native.stdout
    assert port["counters"].get("native_passthrough_syscalls", 0) > 0
    log = (beta / "beta.log").read_text()
    assert "native-passthrough syscalls" in log


def test_native_passthrough_report_stable(tmp_path, build):
    """The native-passthrough report (host log and counter) of /bin/cat
    twice through the port: the same lines both times."""
    from tests.test_torch_managed import run_port, write_cfg

    cfg = write_cfg(tmp_path, ETC.format(path="/bin/cat",
                                         args='["/etc/hosts"]'))
    lines = []
    for tag in ("a", "b"):
        s = run_port(cfg, tmp_path / tag)
        assert s["counters"]["native_passthrough_syscalls"] > 0
        log = (tmp_path / tag / "hosts" / "beta" / "beta.log").read_text()
        lines.append([ln for ln in log.splitlines()
                      if "native-passthrough syscalls" in ln])
    assert lines[0] and lines[0] == lines[1]
