"""Multi-process sharding in the port (shadow_tpu_torch/parallel/shards.py)
against the reference.

The reference's shard documents (tests/test_shards.py: gossip_churn cut to
10 s — gossip flood and a bulk stream under partition, degrade and churn —
with telemetry every 5 s and a state digest every 50 rounds) run once
through the reference, single-process. The port then runs them on
``--device cpu`` at 2 and 4 shards with the C engine, 2 (and, ``slow``, 4)
on the Python plane and 2 under thread_per_core. The tolerance is zero:
hosts/ tree, metrics.jsonl, flows.jsonl, state_digests.jsonl and the
summary but for its run-shape keys. Beside that: a shard checkpoint
resumed at the same count and refused at another, signals mid-round, the
configs refused by name, the wire format against the reference's packer,
the pickle fallback, the ring's wrap and spill, a ring that cannot be
made, canonical keys, and no kernel launched by a worker.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml

from shadow_tpu.config.schema import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.core.controller import VOLATILE_SUMMARY_KEYS as REF_VOLATILE
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu.parallel import shards as ref_sh
from shadow_tpu_torch import checkpoint as ckpt
from shadow_tpu_torch.config.schema import parse_config
from shadow_tpu_torch.core.controller import (VOLATILE_SUMMARY_KEYS,
                                              Controller)
from shadow_tpu_torch.parallel import shards as sh
from shadow_tpu_torch.utils.digest import output_tree_digest

ROOT = Path(__file__).resolve().parent.parent
CHURN_YAML = ROOT / "examples" / "gossip_churn.yaml"
STREAMS = ("flows.jsonl", "metrics.jsonl", "state_digests.jsonl")
#: the reference test's cut: the partition (4 s), the degrade window's
#: start and seeded churn from 2 s
STOP = "10s"


def _overrides(data_dir, shards: int, colcore: bool = False,
               extra: dict = None) -> dict:
    over = {
        "general.data_directory": str(data_dir),
        "general.stop_time": STOP,
        "general.sim_shards": shards,
        "general.state_digest_every": 50,
        "telemetry.sample_every": "5s",
        "experimental.scheduler_policy": "tpu_batch",
        "experimental.native_colcore": colcore,
        **(extra or {}),
    }
    # an extra of {key: None} removes the override
    return {k: v for k, v in over.items() if v is not None}


def _cfg(data_dir, shards, colcore=True, extra=None):
    return parse_config(yaml.safe_load(CHURN_YAML.read_text()),
                        _overrides(data_dir, shards, colcore, extra))


def _port(data_dir, shards, colcore=True, extra=None) -> dict:
    cfg = _cfg(data_dir, shards, colcore, extra)
    if shards == 1:
        return Controller(cfg, mirror_log=False, device="cpu").run()
    return sh.run_sharded(cfg, mirror_log=False, device="cpu")


def _streams(data_dir) -> dict:
    out = {}
    for name in STREAMS:
        p = Path(data_dir) / name
        if p.is_file():
            out[name] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def _stable(s: dict, volatile) -> dict:
    return {k: v for k, v in s.items() if k not in volatile}


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's single-process run (its Python plane): with
    telemetry, and without it (the checkpoint legs)."""
    out = {}
    for tel in (True, False):
        d = tmp_path_factory.mktemp(f"ref_{int(tel)}")
        extra = None if tel else {"telemetry.sample_every": None}
        cfg = ref_parse_config(yaml.safe_load(CHURN_YAML.read_text()),
                               _overrides(d, 1, False, extra))
        out[tel] = (RefController(cfg, mirror_log=False).run(), d)
    return out


def _assert_reference(ref, ref_dir, got, got_dir):
    assert _stable(got, VOLATILE_SUMMARY_KEYS) == _stable(ref, REF_VOLATILE)
    assert output_tree_digest(got_dir) == ref_tree_digest(ref_dir)
    assert _streams(got_dir) == _streams(ref_dir)


def _no_launches(summary: dict) -> None:
    for part in summary["shards"]["per_shard"]:
        assert not any(part["launches"].values()), part["launches"]
    assert summary["device_windows_dispatched"] == 0


# -- the identity matrix ---------------------------------------------------------

@pytest.mark.parametrize("leg, shards, colcore, extra", [
    ("c", 2, True, None),
    ("c", 4, True, None),
    ("py", 2, False, None),
    pytest.param("py", 4, False, None, marks=pytest.mark.slow),
    ("thread_per_core", 2, False,
     {"experimental.scheduler_policy": "thread_per_core"}),
])
def test_shard_identity(tmp_path, ref_runs, leg, shards, colcore, extra):
    """N shards on the C engine, the Python plane and the per-unit plane
    give the reference's single-process run, under faults, churn,
    telemetry and the sentinel; the workers launch nothing."""
    ref, ref_dir = ref_runs[True]
    assert ref["counters"].get("host_crashes", 0) > 0  # adversity ran
    assert ref["units_blackholed"] > 0
    got = _port(tmp_path / "run", shards, colcore, extra)
    _assert_reference(ref, ref_dir, got, tmp_path / "run")
    assert got["sim_shards"] == shards
    assert len(got["shards"]["per_shard"]) == shards
    assert got["native_colcore"] is colcore
    _no_launches(got)


def test_one_shard_is_the_controller(tmp_path, ref_runs):
    ref, ref_dir = ref_runs[True]
    got = _port(tmp_path / "run", 1)
    _assert_reference(ref, ref_dir, got, tmp_path / "run")


# -- checkpoint/resume -------------------------------------------------------------

def test_shard_checkpoint_resume_and_refusal(tmp_path, ref_runs):
    """A resume at the same count from a mid-churn shard manifest gives
    the reference's tree and continues its digest stream; a mismatched
    shard count refuses by name; a shard checkpoint cannot resume into
    the single-process controller."""
    ref, ref_dir = ref_runs[False]
    notel = {"telemetry.sample_every": None}
    _port(tmp_path / "cks", 2, extra={**notel,
                                      "general.checkpoint_every": "4s"})
    assert output_tree_digest(tmp_path / "cks") == ref_tree_digest(ref_dir)
    manifests = sorted((tmp_path / "cks" / "checkpoints")
                       .glob("*" + sh.MANIFEST_SUFFIX))
    assert manifests, "sharded run wrote no manifest"
    mani = manifests[0]
    doc = json.loads(mani.read_text())
    assert doc["format"] == sh.MANIFEST_FORMAT
    assert doc["sim_shards"] == 2 and len(doc["files"]) == 2
    for f in doc["files"]:
        h = ckpt.read_header(mani.parent / f)
        assert h["sim_shards"] == 2 and h["shard"] in (0, 1)

    res = sh.run_sharded(_cfg(tmp_path / "ckr", 2, extra=notel),
                         mirror_log=False, resume_from=str(mani),
                         device="cpu")
    assert output_tree_digest(tmp_path / "ckr") == ref_tree_digest(ref_dir)
    dig_res = (tmp_path / "ckr" / "state_digests.jsonl").read_text() \
        .splitlines()
    dig_ref = (ref_dir / "state_digests.jsonl").read_text().splitlines()
    assert dig_res and dig_res == dig_ref[-len(dig_res):]
    assert res["counters"] == ref["counters"]
    _no_launches(res)

    cfg4 = _cfg(tmp_path / "bad", 4, extra=notel)
    with pytest.raises(ckpt.CheckpointError, match="sim_shards=2"):
        sh.run_sharded(cfg4, mirror_log=False, resume_from=str(mani),
                       device="cpu")
    shard_file = mani.parent / doc["files"][0]
    with pytest.raises(ckpt.CheckpointError, match="sim_shards=2"):
        sh.run_sharded(_cfg(tmp_path / "bad2", 4, extra=notel),
                       mirror_log=False, resume_from=str(shard_file),
                       device="cpu")
    cfg1 = _cfg(tmp_path / "bad3", 1, extra=notel)
    with pytest.raises(ckpt.CheckpointError, match="sim_shards"):
        ckpt.load_checkpoint(str(shard_file), cfg1, mirror_log=False,
                             device="cpu")


# -- signals mid-round ---------------------------------------------------------------

@pytest.mark.parametrize("signame", ["SIGINT", "SIGTERM"])
def test_sharded_signal_mid_round(tmp_path, signame):
    """SIGINT/SIGTERM mid-round in a sharded CLI run: a valid partial
    summary naming the signal, the 128+N exit status, no leaked worker."""
    d = tmp_path / "run"
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch", str(CHURN_YAML),
         "--shards", "2", "--stop-time", "120s", "--device", "cpu",
         "--data-directory", str(d), "--state-digest-every", "20",
         "--quiet", "--json-summary"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(ROOT))
    try:
        digp = d / "state_digests.jsonl"
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if digp.is_file() and digp.stat().st_size > 0:
                break
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.05)
        else:
            pytest.fail("no round progress before the deadline")
        os.kill(proc.pid, getattr(signal, signame))
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
    res = json.loads(out)
    assert res["exit_reason"] == "interrupted", err.decode()
    assert res["interrupt_signal"] == signame
    assert res["rounds"] > 0 and res["sim_shards"] == 2
    assert proc.returncode == 128 + int(getattr(signal, signame))


# -- refusals ------------------------------------------------------------------------

def test_shard_config_refusals(tmp_path, capsys):
    cfg = _cfg(tmp_path, 2)
    cfg.experimental.scheduler_policy = "tpu_mesh"
    with pytest.raises(ValueError, match="tpu_mesh"):
        sh.validate_config_shardable(cfg)
    cfg = _cfg(tmp_path, 2)
    cfg.hosts[0].pcap_enabled = True
    with pytest.raises(ValueError, match="pcap"):
        sh.validate_config_shardable(cfg)
    cfg = _cfg(tmp_path, 2)
    cfg.hosts[0].processes[0].path = "/bin/true"
    with pytest.raises(ValueError, match="managed"):
        sh.validate_config_shardable(cfg)
    from shadow_tpu_torch import cli

    rc = cli.main([str(CHURN_YAML), "--shards", "2", "--device", "cpu",
                   "--scheduler-policy", "tpu_mesh", "--quiet",
                   "--data-directory", str(tmp_path / "m")])
    err = capsys.readouterr().err
    assert rc == 2 and "tpu_mesh" in err, err


# -- wire format + rings ---------------------------------------------------------------

ROWS = [
    (100, (3 << 40) | 7, 5, 2, 3, 4000, 80, 1234, 99, 0, 1, 1500,
     b"payload-bytes"),
    (200, (1 << 40) | 0, 2, 1, 1, 50000, 7000, 0, 7, 2, 3, 560,
     ("inv", (1, 2, 3), "tx-id")),
    (300, 42, 9, 4, 8, 1, 2, -5, -17, 0, 1, 40, None),
    (2**62, 2**57, 11, 7, 10, 65535, 65535, 2**61, 2**60, 63, 64,
     15000, "unicode-π"),
]


def test_pack_unpack_roundtrip_and_the_reference_wire():
    """The rows survive the round trip, and the port's blocks are the
    reference's byte for byte (the same wire format)."""
    assert sh.unpack_rows(sh.pack_rows(ROWS)) == ROWS
    assert sh.unpack_rows(sh.pack_rows([])) == []
    assert sh.pack_rows(ROWS) == ref_sh.pack_rows(ROWS)
    assert sh.unpack_rows(ref_sh.pack_rows(ROWS)) == ROWS


class _OddPayload:
    """Module-level so the pickle fallback can serialize it."""

    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return isinstance(other, _OddPayload) and other.v == self.v


def test_pack_pickle_fallback():
    rows = [(1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 1, 2, _OddPayload("x"))]
    assert sh.unpack_rows(sh.pack_rows(rows)) == rows


def test_shm_ring_wrap_and_spill():
    name = f"stpt_test_{os.getpid()}"
    ring = sh.ShmRing(name, size=256, create=True)
    try:
        blocks = [bytes([i]) * (40 + i) for i in range(4)]
        for _cycle in range(10):  # fill/drain cycles force the wrap path
            wrote = [b for b in blocks if ring.write(b)]
            assert wrote, "ring accepted nothing"
            assert ring.read_all() == wrote
        assert not ring.write(b"x" * 300)  # larger than capacity: spill
        assert ring.write(b"a" * 100)
        assert ring.read_all() == [b"a" * 100]
        assert ring.write(b"b" * 100)
        assert ring.write(b"c" * 100)
        assert ring.read_all() == [b"b" * 100, b"c" * 100]
    finally:
        ring.close()
        ring.unlink()


def test_ring_names_are_the_ports():
    assert sh._ring_name("t", 0, 1).startswith("stpt_")
    assert ref_sh._ring_name("t", 0, 1).startswith("stpu_")


def test_a_ring_that_cannot_be_made_raises_by_name(monkeypatch):
    """No room in /dev/shm for the rings, or a segment the system will
    not make: RingCreateError names the ring and the knob."""
    class _Small:
        f_bavail, f_frsize = 1, 4096

    monkeypatch.setattr(os, "statvfs", lambda _p: _Small())
    with pytest.raises(sh.RingCreateError, match="SHADOW_TPU_RING_BYTES"):
        sh.check_shm_room(4, sh.DEFAULT_RING_BYTES)
    monkeypatch.undo()
    with pytest.raises(sh.RingCreateError, match="stpt_bad"):
        sh.ShmRing("stpt_bad/name", size=256, create=True)


def test_keys_are_uids(tmp_path):
    """The canonical-key scheme the shard plane rests on: every diverted
    row's key is a well-formed uid of its source, and the C packer ships
    (t, key)-sorted blocks the Python unpacker reads."""
    from shadow_tpu_torch.network import colplane as cp

    cfg = parse_config(yaml.safe_load(CHURN_YAML.read_text()), {
        "general.data_directory": str(tmp_path),
        "general.stop_time": "4s",
        "experimental.scheduler_policy": "tpu_batch"})
    ctl = Controller(cfg, mirror_log=False, device="cpu")
    eng = ctl.engine
    assert isinstance(eng, cp.ColumnarPlane) and eng._c is not None
    eng.bind_shard(0, 2)
    core = eng._c  # the run's end detaches the engine from the plane
    ctl.run()
    # xout was drained nowhere (no parent): rows for shard-1 hosts stayed
    packed = core.take_xout_packed(1 << 30)
    rows_by_shard = [[r for blob in blocks for r in sh.unpack_rows(blob)]
                     for blocks in packed]
    moved = 0
    for rows in rows_by_shard:
        tks = [(r[0], r[1]) for r in rows]
        assert tks == sorted(tks)
        for r in rows:
            assert r[1] >> 32 == r[4], (r[1], r[4])
            moved += 1
    assert moved > 0
    assert eng.shard_n == 2


# -- chip_smoke.py's shards phase, on the CPU --------------------------------------

@pytest.mark.slow
def test_chip_smoke_shards_phase(tmp_path):
    """The phase's pinned gossip_churn constants are the reference's (the
    command in chip_smoke.py), and the whole phase passes on the CPU:
    tgen_1k at 1, 2 and 4 shards, gossip_churn at 1 and 2, the supervised
    chaos leg."""
    from shadow_tpu import cli as ref_cli
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.ops import transport_kernels as tk
    from shadow_tpu_torch.parallel import mesh
    from tests.test_torch_e2e import _chip_smoke, _run as _cli_run

    cs = _chip_smoke()
    argv = cs.CHURN_SHARD_ARGV
    ref = _cli_run(ref_cli.main, CHURN_YAML, tmp_path / "ref",
                   argv[2:], policy=argv[1])
    assert cs.fault_result(ref, str(tmp_path / "ref"),
                           ref_tree_digest) == cs.CHURN_SHARD_RESULTS
    assert cs.stream_sha(str(tmp_path / "ref"), "state_digests.jsonl") \
        == cs.CHURN_SHARD_DIGESTS
    cs.shards_path(cli, prop, tk, mesh, output_tree_digest,
                   str(tmp_path / "phase"), device="cpu")
