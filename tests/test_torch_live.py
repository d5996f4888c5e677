"""The live operations plane in the port (shadow_tpu_torch/live.py and its
hooks in the controller, the collector, the shards and the fleet) against
the reference (shadow_tpu/live.py).

Everything runs on ``--device cpu`` with tolerance 0 — the bar is byte
identity:

- ``normalize_command`` and ``format_command_record`` give the
  reference's canonical dicts, lines and error messages; a command log
  round-trips; either package's log loads in the other;
- the server acks, refuses and broadcasts; an overlong socket path is
  refused by name; ``close`` is idempotent, bounded, and leaves no thread;
- the wire protocol interoperates: the reference's client against the
  port's server, and the port's client against the reference's server;
- a run of the reference test's two-host BASE document driven live in the
  port (pause, link_down, resume, a follower attached) replays from its
  ``commands.jsonl`` in both packages under tpu_batch on the C engine and
  on the Python plane and under thread_per_core, with the reference's
  trees, state digests, metrics and sim-visible command log; and the port
  replays a log the reference recorded;
- ``stop``, ``checkpoint_now`` with a resume inside a command's fault
  window, a ``--shards 2`` replay, ``jump`` (from a checkpoint and from
  round 0) and the bisect-to-jump handoff;
- the live keys are volatile, a live object never reaches a checkpoint,
  fleet members never bind, and a sweep's endpoint refuses commands.

Socket paths live in short ``mkdtemp(dir="/tmp")`` directories, one per
test (AF_UNIX paths end near 107 bytes), and no test waits on a tight
wall-clock deadline.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest
import yaml

from shadow_tpu import live as ref_live
from shadow_tpu.config.schema import parse_config as ref_parse
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu_torch import checkpoint as ckpt
from shadow_tpu_torch import fleet
from shadow_tpu_torch import live as lv
from shadow_tpu_torch.config.schema import parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.parallel import shards as sh
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_live import BASE, LINK_DOWN

ROOT = Path(__file__).resolve().parent.parent
CHURN_YAML = ROOT / "examples" / "gossip_churn.yaml"
#: every run's streams: digests every 50 rounds, telemetry samples at 5 s
STREAMS = {"general.state_digest_every": 50,
           "telemetry.sample_every": "5s"}
#: the replay legs: (policy, C engine)
REPLAY_LEGS = {
    "c_engine": ("tpu_batch", True),
    "python_plane": ("tpu_batch", False),
    "thread_per_core": ("thread_per_core", True),
}


@pytest.fixture
def sockdir():
    d = tempfile.mkdtemp(dir="/tmp", prefix="stl")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _cfg(data_dir, over=None, doc=BASE):
    return parse_config(yaml.safe_load(doc), {
        "general.data_directory": str(data_dir), **STREAMS, **(over or {})})


def _ref_cfg(data_dir, over=None, doc=BASE):
    return ref_parse(yaml.safe_load(doc), {
        "general.data_directory": str(data_dir), **STREAMS, **(over or {})})


def _wait_for(pred, what):
    for _ in range(12000):  # two minutes at most: never a tight deadline
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"never saw {what}")


def _drive(sock, cmds, acks, send=lv.send_command):
    for c in cmds:
        acks.append(send(sock, c, timeout=60))


def _live_run(data_dir, sock, cmds, over=None, follow=False, ref=False,
              first=False):
    """One run of BASE with a live endpoint. The controller binds the
    socket when built; a follower (``follow``) attaches and holds its hello
    before the run starts, so it sees every record; a sibling thread sends
    ``cmds`` in order while the run goes — or, with ``first``, they are
    all acked before it starts and apply at its first boundary (t = 0).
    Where a command lands otherwise is wall-clock: a link_down that meets
    the client's handshake at 1 s ends BASE's transfer and the run at
    round 16, before its first digest. Returns (summary, acks,
    records)."""
    over = {"general.live_endpoint": sock, **(over or {})}
    if ref:
        ctl = RefController(_ref_cfg(data_dir, over), mirror_log=False)
    else:
        ctl = Controller(_cfg(data_dir, over), mirror_log=False,
                         device="cpu")
    acks, records = [], []
    threads = []
    if follow:
        threads.append(threading.Thread(
            target=lambda: records.extend(lv.stream_records(sock, 60)),
            daemon=True))
        threads[-1].start()
        _wait_for(lambda: records, "the follower's hello")
    if first:
        _drive(sock, cmds, acks)
    else:
        threads.append(threading.Thread(target=_drive,
                                        args=(sock, cmds, acks),
                                        daemon=True))
        threads[-1].start()
    s = ctl.run()
    for t in threads:
        t.join(timeout=60)
    return s, acks, records


def _replay(data_dir, log, over=None, ref=False, doc=BASE):
    over = {"general.replay_commands": str(log), **(over or {})}
    if ref:
        return RefController(_ref_cfg(data_dir, over, doc),
                             mirror_log=False).run()
    return Controller(_cfg(data_dir, over, doc), mirror_log=False,
                      device="cpu").run()


def _text(d, name):
    p = Path(d) / name
    return p.read_text() if p.exists() else None


def _sim_cmds(text):
    """The sim-visible command records: replay skips (and does not re-log)
    the wall_only pause/resume entries."""
    return [ln for ln in (text or "").splitlines()
            if not json.loads(ln).get("wall_only")]


def _same_run(a, b):
    """Two data directories hold the same run: tree, digests, metrics and
    the sim-visible command log."""
    assert output_tree_digest(a) == output_tree_digest(b)
    for name in ("state_digests.jsonl", "metrics.jsonl", "flows.jsonl"):
        assert _text(a, name) == _text(b, name), name
    assert _sim_cmds(_text(a, "commands.jsonl")) == \
        _sim_cmds(_text(b, "commands.jsonl"))


# -- command validation and the log -------------------------------------------

COMMANDS = [
    dict(LINK_DOWN),
    {"cmd": "link_up", "src_nodes": [1], "dst_nodes": [0]},
    {"cmd": "link_degrade", "src_nodes": [0], "dst_nodes": [1],
     "latency_factor": 2, "loss_add": 0.05, "bandwidth_scale": 0.5,
     "duration": "1500ms"},
    {"cmd": "host_down", "hosts": ["client"], "duration": 2},
    {"cmd": "host_up", "hosts": ["client"]},
    {"cmd": "pause"}, {"cmd": "resume"}, {"cmd": "checkpoint_now"},
    {"cmd": "stop"},
    # refused: unknown verb, missing verb, stray key, control parameters,
    # not an object, a bad duration
    {"cmd": "reboot_host"}, {"src_nodes": [0]},
    {**LINK_DOWN, "sneaky": 1}, {"cmd": "pause", "duration": "1s"},
    ["link_down"], {"cmd": "link_down", "duration": "soon"},
]


def _outcome(fn, payload):
    try:
        return ("ok", fn(payload))
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("i", range(len(COMMANDS)))
def test_normalize_command_matches_reference(i):
    payload = COMMANDS[i]
    got = _outcome(lv.normalize_command, payload)
    assert got == _outcome(ref_live.normalize_command, payload)
    if got[0] == "ok":  # the canonical form is a fixed point
        assert lv.normalize_command(dict(got[1])) == got[1]


@pytest.mark.parametrize("i", range(9))
def test_format_command_record_matches_reference(i):
    norm = lv.normalize_command(COMMANDS[i])
    for wall_only in (False, True):
        args = (norm, i + 1, 40 * i + 1, 5_000_000 * (i + 1))
        assert lv.format_command_record(*args, wall_only=wall_only) == \
            ref_live.format_command_record(*args, wall_only=wall_only)


def test_command_log_roundtrip_both_packages(tmp_path):
    lines = [lv.format_command_record(lv.normalize_command(c), k + 1,
                                      10 * k, 5_000_000 * k,
                                      wall_only=c["cmd"] in ("pause",
                                                             "resume"))
             for k, c in enumerate(COMMANDS[:9])]
    lv.append_command_lines(tmp_path, lines[:4])
    lv.append_command_lines(tmp_path, lines[4:])
    lv.append_command_lines(tmp_path, [])
    p = lv.command_log_path(tmp_path)
    assert p.read_text() == "\n".join(lines) + "\n"
    recs = lv.load_command_log(p)
    assert recs == ref_live.load_command_log(p)
    assert [r["seq"] for r in recs] == list(range(1, 10))
    p.write_text("\n".join(reversed(lines)) + "\n")
    for load in (lv.load_command_log, ref_live.load_command_log):
        with pytest.raises(ValueError, match="goes backwards"):
            load(p)
    p.write_text('{"cmd": {"cmd": "pause"}, "round": 1}\n')
    with pytest.raises(ValueError, match="missing 'seq'"):
        lv.load_command_log(p)
    assert lv.resolve_endpoint("auto", "/d/run") == "/d/run/live.sock"
    assert lv.resolve_endpoint("/x.sock", "/d/run") == "/x.sock"
    assert lv.default_endpoint(tmp_path) == str(tmp_path / "live.sock")


# -- the server -----------------------------------------------------------------

def test_server_refuse_ack_and_broadcast(sockdir):
    sock = os.path.join(sockdir, "s.sock")
    srv = lv.LiveServer(sock, refuse=lambda n: (
        "not here" if n["cmd"] == "pause" else None))
    got = []
    t = threading.Thread(
        target=lambda: got.extend(lv.stream_records(sock, timeout=10)),
        daemon=True)
    try:
        t.start()
        _wait_for(lambda: got, "the follower's hello")
        assert got[0]["type"] == "hello" and got[0]["v"] == 1
        assert lv.send_command(sock, {"cmd": "pause"}) == {
            "type": "error", "error": "not here"}
        assert lv.send_command(sock, {"cmd": "bogus"})["type"] == "error"
        ack = lv.send_command(sock, dict(LINK_DOWN))
        assert ack == {"type": "ack", "n": 1,
                       "cmd": lv.normalize_command(dict(LINK_DOWN))}
        # the refused and malformed commands never reached the queue
        assert [c["cmd"] for c in srv.poll_commands()] == ["link_down"]
        assert srv.poll_commands(timeout=0.01) == []
        srv.publish({"type": "hb", "t": 1})
        srv.publish_stream("metrics.jsonl", ['{"kind":"sample"}'])
        _wait_for(lambda: any(r["type"] == "stream" for r in got),
                  "the stream record")
    finally:
        srv.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [r["type"] for r in got] == ["hello", "hb", "stream"]
    assert got[2] == {"type": "stream", "stream": "metrics.jsonl",
                      "line": '{"kind":"sample"}'}


def test_endpoint_path_too_long(tmp_path):
    with pytest.raises(ValueError, match="AF_UNIX"):
        lv.LiveServer(str(tmp_path / ("x" * 120) / "live.sock"))


def test_close_is_idempotent_bounded_and_joins(sockdir):
    """close() wakes the accept loop (no client ever connects), closes a
    connected follower and a silent client, joins every thread it started,
    and a second close() returns at once."""
    before = set(threading.enumerate())
    sock = os.path.join(sockdir, "s.sock")
    srv = lv.LiveServer(sock)
    got = []
    follower = threading.Thread(
        target=lambda: got.extend(lv.stream_records(sock, timeout=10)),
        daemon=True)
    follower.start()
    silent = lv.connect(sock)
    _wait_for(lambda: len(srv._clients) == 2, "both clients")
    t0 = time.monotonic()
    srv.close()
    took = time.monotonic() - t0
    t1 = time.monotonic()
    srv.close()
    again = time.monotonic() - t1
    follower.join(timeout=60)
    silent.close()
    # close waits _CLOSE_WAIT_S at most (the margin absorbs a loaded box)
    assert took < srv._CLOSE_WAIT_S + 8.0, took
    assert again < 1.0, again
    assert not follower.is_alive()
    assert not Path(sock).exists()
    assert got and got[0]["type"] == "hello"

    def left():
        return [t for t in set(threading.enumerate()) - before
                if t.name.startswith("shadow-live") and t.is_alive()]

    _wait_for(lambda: not left(), "every serving thread to end")
    # a bare server's close ends its accept loop too
    srv2 = lv.LiveServer(os.path.join(sockdir, "b.sock"))
    srv2.close()
    srv2._accept_thread.join(timeout=60)
    assert not srv2._accept_thread.is_alive()


@pytest.mark.parametrize("client, server", [("reference", "port"),
                                            ("port", "reference")])
def test_wire_interop(sockdir, client, server):
    """hello, ack, error and broadcast records cross between the
    packages' clients and servers byte for byte."""
    cl = ref_live if client == "reference" else lv
    Srv = lv.LiveServer if server == "port" else ref_live.LiveServer
    sock = os.path.join(sockdir, "s.sock")
    srv = Srv(sock)
    got = []
    t = threading.Thread(
        target=lambda: got.extend(cl.stream_records(sock, timeout=10)),
        daemon=True)
    try:
        t.start()
        _wait_for(lambda: got, "hello")
        ack = cl.send_command(sock, dict(LINK_DOWN))
        assert ack == {"type": "ack", "n": 1,
                       "cmd": ref_live.normalize_command(dict(LINK_DOWN))}
        err = cl.send_command(sock, {"cmd": "nope"})
        assert err == {"type": "error", "error":
                       _outcome(ref_live.normalize_command,
                                {"cmd": "nope"})[1]}
        assert srv.poll_commands() == [ack["cmd"]]
        srv.publish({"type": "end", "exit_reason": "completed",
                     "rounds": 3, "t": 9})
        _wait_for(lambda: len(got) >= 2, "the end record")
    finally:
        srv.close()
    t.join(timeout=10)
    assert got[0] == {"type": "hello", "v": ref_live.PROTOCOL_VERSION,
                      "pid": os.getpid()}
    assert got[1] == {"type": "end", "exit_reason": "completed",
                      "rounds": 3, "t": 9}


# -- live run and replay: the byte-identity matrix ------------------------------

@pytest.fixture(scope="module")
def live_base():
    """One run of BASE driven live in the port (tpu_batch, C engine,
    heartbeats every 2 s): pause, link_down (3 s), resume, with a follower
    attached."""
    root = Path(tempfile.mkdtemp(prefix="stl_live_"))
    sock_dir = tempfile.mkdtemp(dir="/tmp", prefix="stl")
    d = root / "live"
    s, acks, records = _live_run(
        d, os.path.join(sock_dir, "s.sock"),
        [{"cmd": "pause"}, dict(LINK_DOWN), {"cmd": "resume"}],
        over={"experimental.scheduler_policy": "tpu_batch",
              "experimental.native_colcore": True,
              "general.heartbeat_interval": "2s"}, follow=True)
    yield {"root": root, "dir": d, "summary": s, "acks": acks,
           "records": records, "log": d / lv.COMMANDS_FILE}
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(sock_dir, ignore_errors=True)


def test_live_run_acks_logs_and_streams(live_base):
    s, acks, recs = (live_base["summary"], live_base["acks"],
                     live_base["records"])
    assert [a["type"] for a in acks] == ["ack"] * 3
    assert s["fault_transitions_applied"] >= 2  # down + scheduled heal
    log = [json.loads(x) for x in live_base["log"].read_text().splitlines()]
    assert [r["cmd"]["cmd"] for r in log] == ["pause", "link_down", "resume"]
    assert log[0].get("wall_only") and log[2].get("wall_only")
    # pause wall-blocked the boundary: all three landed on the same one
    assert len({r["t"] for r in log}) == 1
    kinds = {r["type"] for r in recs}
    assert {"hello", "hb", "command", "stream", "flows_snapshot",
            "end"} <= kinds
    assert recs[-1]["type"] == "end"
    assert recs[-1]["exit_reason"] == "completed"
    streams = {r["stream"] for r in recs if r["type"] == "stream"}
    assert streams == {"metrics.jsonl", "flows.jsonl"}
    # the tee carries the artifact lines verbatim, in file order, from
    # the follower's attach on (the meta record may precede it)
    tee = [r["line"] for r in recs if r["type"] == "stream"
           and r["stream"] == "metrics.jsonl"]
    lines = (live_base["dir"] / "metrics.jsonl").read_text().splitlines()
    assert tee and lines[-len(tee):] == tee


@pytest.mark.parametrize("leg", sorted(REPLAY_LEGS))
def test_replay_matches_reference(live_base, leg):
    """The port's live log replayed in both packages under one policy and
    engine: the port's replay equals the reference's replay and the live
    run, trees, digests, metrics and sim-visible commands."""
    policy, c = REPLAY_LEGS[leg]
    over = {"experimental.scheduler_policy": policy,
            "experimental.native_colcore": c}
    port_d = live_base["root"] / f"port_{leg}"
    ref_d = live_base["root"] / f"ref_{leg}"
    s_port = _replay(port_d, live_base["log"], over)
    s_ref = _replay(ref_d, live_base["log"], over, ref=True)
    _same_run(port_d, ref_d)
    _same_run(port_d, live_base["dir"])
    assert _text(port_d, "commands.jsonl") == _text(ref_d, "commands.jsonl")
    for k in ("rounds", "events", "units_sent", "units_dropped",
              "fault_transitions_applied"):
        assert s_port[k] == s_ref[k] == live_base["summary"][k], k


def test_port_replays_reference_log(tmp_path, sockdir):
    """A log the reference recorded live (link_down and a 1 s
    link_degrade at its first boundary, C engine) replays in the port with
    the reference's bytes."""
    degrade = {"cmd": "link_degrade", "src_nodes": [0], "dst_nodes": [1],
               "latency_factor": 3.0, "loss_add": 0.05,
               "bandwidth_scale": 0.5, "duration": "1s"}
    over = {"experimental.scheduler_policy": "tpu_batch",
            "experimental.native_colcore": True}
    s_ref, acks, _ = _live_run(tmp_path / "ref",
                               os.path.join(sockdir, "s.sock"),
                               [dict(LINK_DOWN), degrade], over=over,
                               ref=True, first=True)
    assert [a["type"] for a in acks] == ["ack", "ack"]
    log = tmp_path / "ref" / lv.COMMANDS_FILE
    s_port = _replay(tmp_path / "port", log, over)
    _same_run(tmp_path / "port", tmp_path / "ref")
    assert _text(tmp_path / "port", "commands.jsonl") == log.read_text()
    assert s_port["fault_transitions_applied"] == \
        s_ref["fault_transitions_applied"] >= 4


def test_noop_endpoint_is_transparent(tmp_path, sockdir):
    """A bound endpoint with a follower and no command changes nothing,
    and writes no commands.jsonl."""
    s_live, _, recs = _live_run(tmp_path / "live",
                                os.path.join(sockdir, "s.sock"), [],
                                follow=True)
    s_off = Controller(_cfg(tmp_path / "off"), mirror_log=False,
                       device="cpu").run()
    _same_run(tmp_path / "live", tmp_path / "off")
    assert not (tmp_path / "live" / lv.COMMANDS_FILE).exists()
    assert s_live["rounds"] == s_off["rounds"]
    assert recs[-1]["type"] == "end"


def test_stop_command_and_replay(tmp_path, sockdir):
    """A live stop (sent before the run's first boundary: one sent while it
    runs may arrive after its end) ends the run at a round boundary
    (partial summary, interrupt_signal live_stop) and replays to the same
    truncated run in both packages."""
    s1, acks, _ = _live_run(tmp_path / "live",
                            os.path.join(sockdir, "s.sock"),
                            [{"cmd": "stop"}], first=True)
    assert acks[0]["type"] == "ack"
    assert (s1["exit_reason"], s1["interrupt_signal"]) == (
        "interrupted", "live_stop")
    log = tmp_path / "live" / lv.COMMANDS_FILE
    assert json.loads(log.read_text())["cmd"] == {"cmd": "stop"}
    s2 = _replay(tmp_path / "port", log)
    s3 = _replay(tmp_path / "ref", log, ref=True)
    assert s2["exit_reason"] == s3["exit_reason"] == "interrupted"
    assert s2["rounds"] == s3["rounds"] == s1["rounds"]
    for d in ("port", "ref"):
        assert output_tree_digest(tmp_path / d) == \
            output_tree_digest(tmp_path / "live")
        assert _text(tmp_path / d, "commands.jsonl") == log.read_text()
        assert _text(tmp_path / d, "state_digests.jsonl") == \
            _text(tmp_path / "live", "state_digests.jsonl")


def test_checkpoint_now_and_mid_command_resume(tmp_path, sockdir):
    """pause, a 6 s link_down, checkpoint_now, resume (at the first
    boundary): the snapshot lands at the fault's own boundary with the
    heal pending in it. Resuming it with the recorded log replays nothing,
    yet the heal fires: tree and digest suffix equal the live run's, and
    the reference's replay."""
    down = {**LINK_DOWN, "duration": "6s"}
    s1, acks, recs = _live_run(
        tmp_path / "live", os.path.join(sockdir, "s.sock"),
        [{"cmd": "pause"}, down, {"cmd": "checkpoint_now"},
         {"cmd": "resume"}], follow=True, first=True)
    assert [a["type"] for a in acks] == ["ack"] * 4
    ckpts = sorted((tmp_path / "live" / "checkpoints").glob("*.ckpt"))
    assert len(ckpts) == 1, "checkpoint_now wrote no single snapshot"
    h = ckpt.read_header(str(ckpts[0]))
    log = tmp_path / "live" / lv.COMMANDS_FILE
    t_down = next(json.loads(ln)["t"] for ln in log.read_text().splitlines()
                  if json.loads(ln)["cmd"]["cmd"] == "link_down")
    assert int(h["sim_time_ns"]) == t_down
    # the post-save record names the path a user forks
    ck = [r for r in recs if r["type"] == "checkpoint"]
    assert [r["path"] for r in ck] == [str(ckpts[0])]
    cfg = _cfg(tmp_path / "res", {"general.replay_commands": str(log)})
    ctl, resume_at = ckpt.load_checkpoint(str(ckpts[0]), cfg,
                                          mirror_log=False, device="cpu")
    s2 = ctl.run(resume_at=resume_at)
    assert s2["exit_reason"] == "completed"
    assert output_tree_digest(tmp_path / "res") == \
        output_tree_digest(tmp_path / "live")
    d1 = _text(tmp_path / "live", "state_digests.jsonl").splitlines()
    d2 = _text(tmp_path / "res", "state_digests.jsonl").splitlines()
    assert d2 == d1[-len(d2):]
    assert not (tmp_path / "res" / lv.COMMANDS_FILE).exists()
    _replay(tmp_path / "ref", log, ref=True)
    _same_run(tmp_path / "ref", tmp_path / "live")


def test_sharded_live_run_and_replays(tmp_path, sockdir):
    """A live link_down into a 2-shard port run of gossip_churn (on top of
    its own fault timeline; pause refused by name on the sharded
    endpoint) replays at 2 shards in the port and at 1 in the reference
    with the same bytes."""
    doc = CHURN_YAML.read_text()
    over = {"general.stop_time": "8s",
            "experimental.scheduler_policy": "tpu_batch",
            "experimental.native_colcore": True}
    sock = os.path.join(sockdir, "s.sock")
    acks = []
    t = threading.Thread(target=_drive, args=(
        sock, [{**LINK_DOWN, "duration": "2s"}, {"cmd": "pause"}], acks),
        daemon=True)
    t.start()
    sh.run_sharded(_cfg(tmp_path / "live", {
        **over, "general.live_endpoint": sock, "general.sim_shards": 2},
        doc), mirror_log=False, device="cpu")
    t.join(timeout=60)
    assert acks[0]["type"] == "ack"
    assert acks[1]["type"] == "error"
    assert "single-process" in acks[1]["error"]
    log = tmp_path / "live" / lv.COMMANDS_FILE
    assert json.loads(log.read_text())["cmd"]["cmd"] == "link_down"
    sh.run_sharded(_cfg(tmp_path / "r2", {
        **over, "general.replay_commands": str(log),
        "general.sim_shards": 2}, doc), mirror_log=False, device="cpu")
    _replay(tmp_path / "ref", log, over, ref=True, doc=doc)
    for d in ("r2", "ref"):
        _same_run(tmp_path / d, tmp_path / "live")
        assert _text(tmp_path / d, "commands.jsonl") == log.read_text()


# -- time travel ------------------------------------------------------------------

def test_jump_reproduces_recorded_digest(tmp_path, sockdir):
    """jump --round R restores the nearest checkpoint below R, re-executes
    to R and matches the recorded digest; with the checkpoints hidden it
    re-executes from round 0, replaying the command log, and matches
    too."""
    _, acks, _ = _live_run(tmp_path / "run", os.path.join(sockdir, "s.sock"),
                           [dict(LINK_DOWN)],
                           over={"general.checkpoint_every": "4s"},
                           first=True)
    assert acks[0]["type"] == "ack"
    run_dir = tmp_path / "run"
    digs = [json.loads(x) for x in
            _text(run_dir, "state_digests.jsonl").splitlines()]
    target = digs[-1]["round"]
    cfg_path = tmp_path / "base.yaml"
    cfg_path.write_text(BASE)
    out = []
    assert lv.jump(run_dir, target, cfg_path, out=out.append,
                   inspect_dir=tmp_path / "j1", device="cpu") == 0, out
    assert any("restored" in ln for ln in out), out
    assert any("[MATCH]" in ln for ln in out), out
    (run_dir / "checkpoints").rename(run_dir / "hidden")
    out2 = []
    assert lv.main(["jump", str(run_dir), "--round", str(target),
                    "--config", str(cfg_path), "--inspect-dir",
                    str(tmp_path / "j2"), "--device", "cpu"]) == 0
    assert lv.jump(run_dir, target, cfg_path, out=out2.append,
                   inspect_dir=tmp_path / "j3", device="cpu") == 0, out2
    assert any("re-executing from round 0" in ln for ln in out2), out2
    assert any("[MATCH]" in ln for ln in out2), out2
    # a digest that does not match is reported, exit 1
    bad = run_dir / "state_digests.jsonl"
    bad.write_text(bad.read_text().replace(digs[-1]["digest"], "0" * 64))
    assert lv.jump(run_dir, target, cfg_path, out=[].append,
                   inspect_dir=tmp_path / "j4", device="cpu") == 1
    with pytest.raises(ValueError, match="--round must be >= 1"):
        lv.jump(run_dir, 0, cfg_path, device="cpu")


def test_bisect_to_jump_handoff(tmp_path, capsys):
    """bisect_divergence --json names the first divergent round; the
    port's jump reads it back out of mixed output (file or stdin), and an
    'identical' record jumps nowhere."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import bisect_divergence as bd
    finally:
        sys.path.pop(0)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    recs = [{"round": r, "t": r * 10, "digest": f"d{r}",
             "hosts": {"h0": f"x{r}", "h1": f"y{r}"}} for r in (50, 100)]
    a.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    recs[1] = {**recs[1], "digest": "DIFF",
               "hosts": {"h0": "DIFF", "h1": "y100"}}
    b.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    assert bd.main(["--json", str(a), str(b)]) == 1
    rec = json.loads(capsys.readouterr().out)
    src = tmp_path / "bisect.out"
    src.write_text("noise line\n" + json.dumps(rec) + "\n")
    assert lv._read_bisect(str(src)) == ref_live._read_bisect(str(src))
    assert lv._read_bisect(str(src))["round"] == 100
    assert bd.main(["--json", str(a), str(a)]) == 0
    ident = tmp_path / "ident.out"
    ident.write_text(capsys.readouterr().out)
    assert lv.main(["jump", str(tmp_path), "--config", "x.yaml",
                    "--from-bisect", str(ident), "--device", "cpu"]) == 0
    assert "no divergence" in capsys.readouterr().out
    (tmp_path / "empty.out").write_text("no json here\n")
    with pytest.raises(ValueError, match="no JSON record"):
        lv._read_bisect(str(tmp_path / "empty.out"))


# -- configuration, checkpoints, fleet ----------------------------------------

def test_live_config_keys_are_volatile():
    assert ("general", "live_endpoint") in ckpt.VOLATILE_CONFIG_KEYS
    assert ("general", "replay_commands") in ckpt.VOLATILE_CONFIG_KEYS
    cfg = _cfg("/tmp/unused", {"general.live_endpoint": "auto",
                               "general.replay_commands": "/tmp/x.jsonl"})
    assert cfg.general.live_endpoint == "auto"
    assert cfg.general.replay_commands == "/tmp/x.jsonl"
    assert ckpt.config_digest(cfg) == ckpt.config_digest(_cfg("/tmp/o"))


def test_live_objects_never_reach_a_checkpoint(sockdir):
    import io

    names = {label for _t, label in ckpt._forbidden()}
    assert {"live endpoint server (LiveServer)",
            "live endpoint client (_LiveClient)", "socket"} <= names
    srv = lv.LiveServer(os.path.join(sockdir, "s.sock"))
    try:
        with pytest.raises(ckpt.CheckpointError, match="LiveServer"):
            ckpt._SimPickler(io.BytesIO(), protocol=4).dump({"x": srv})
    finally:
        srv.close()


def test_fleet_members_never_bind(tmp_path):
    cfg_path = tmp_path / "base.yaml"
    cfg_path.write_text(BASE)
    cfg = fleet._member_config(str(cfg_path),
                               {"general.live_endpoint": "/tmp/x.sock"},
                               tmp_path / "sweep", 3)
    assert cfg.general.live_endpoint is None
    assert cfg.general.seed == 3


def test_sweep_endpoint_is_status_only(tmp_path, sockdir):
    """A sweep's endpoint (a CLI sweep: its workers fork from a parent
    with no other thread) refuses every command by name and streams the
    seeds' lifecycle to a follower."""
    sock = os.path.join(sockdir, "sweep.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.fleet", "sweep",
         str(CHURN_YAML), "--seeds", "2", "--seed-base", "5", "--jobs", "1",
         "--sweep-dir", str(tmp_path / "sw"), "--device", "cpu", "--quiet",
         "--json", "--live-endpoint", sock, "--set",
         "general.stop_time=5s"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    recs = []
    follower = threading.Thread(
        target=lambda: recs.extend(lv.stream_records(sock, timeout=120)),
        daemon=True)
    follower.start()
    refused = lv.send_command(sock, {"cmd": "pause"}, timeout=120)
    out, err = proc.communicate(timeout=600)
    follower.join(timeout=60)
    assert proc.returncode == 0, err
    assert refused["type"] == "error"
    assert "status-only" in refused["error"]
    kinds = [r["type"] for r in recs]
    assert kinds[0] == "hello" and kinds[-1] == "end"
    # seed 6 is dispatched once seed 5 is done, long after the follower
    # attached
    assert {"type": "seed_dispatched", "seed": 6, "worker": 0, "queued": 0,
            "resident": 1} in recs
    assert [r["seed"] for r in recs if r["type"] == "seed_done"][-1] == 6
    assert recs[-1]["ok"] == 2 and recs[-1]["failed"] == 0
    assert json.loads(out)["completed"] == [5, 6]


def test_live_cli_send_tail_and_replay(tmp_path, sockdir):
    """The reference CI's live-ops leg through the port's CLI (gossip_churn
    under tpu_batch, 25 s): a follower on `live tail`, a link_down through
    `live send` once the follower holds its hello, then
    `--replay-commands`: three heartbeats or
    more, a sample, the applied command and the end record reach the
    follower, and the replay gives the same trees and streams."""
    sock = os.path.join(sockdir, "live.sock")
    run = tmp_path / "live"
    common = ["--quiet", "--json-summary", "--scheduler-policy",
              "tpu_batch", "--device", "cpu", "--set",
              "general.stop_time=25s", "--state-digest-every", "100",
              "--sample-every", "5s"]
    # the follower writes to a file: a pipe nobody drains would stall it,
    # and the run's bounded close would then cut its stream
    tail_file = open(tmp_path / "tail.jsonl", "w")
    tail = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.live", "tail", sock,
         "--timeout", "300"],
        stdout=tail_file, stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    sim = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch", str(CHURN_YAML),
         "--data-directory", str(run), "--live-endpoint", sock, "--set",
         "general.heartbeat_interval=2s", *common],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    # the follower is attached once it holds the hello record: from then
    # on it sees every record the run publishes
    _wait_for(lambda: (tmp_path / "tail.jsonl").read_text().strip(),
              "the follower's hello")
    send = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch.live", "send", sock,
         '{"cmd":"link_down","src_nodes":[0],"dst_nodes":[1],'
         '"duration":"3s"}', "--timeout", "300"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    out, err = sim.communicate(timeout=300)
    _, tail_err = tail.communicate(timeout=60)
    tail_file.close()
    tail_out = (tmp_path / "tail.jsonl").read_text()
    # at this cut stop gossip members may end with process errors (exit 1),
    # as in the reference CI; the summary and the bytes are the gate
    assert sim.returncode in (0, 1), err
    assert send.returncode == 0, send.stdout + send.stderr
    assert json.loads(send.stdout)["type"] == "ack"
    assert tail.returncode == 0, tail_err
    recs = [json.loads(ln) for ln in tail_out.splitlines()]
    assert sum(r["type"] == "hb" for r in recs) >= 3
    assert any(r["type"] == "stream" and '"kind":"sample"' in r["line"]
               for r in recs)
    assert any(r["type"] == "command" and r["cmd"]["cmd"] == "link_down"
               for r in recs)
    assert recs[-1]["type"] == "end"
    live = json.loads(out)
    assert live["fault_transitions_applied"] >= 2
    rep = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", str(CHURN_YAML),
         "--data-directory", str(tmp_path / "rep"), "--replay-commands",
         str(run / lv.COMMANDS_FILE), *common],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert rep.returncode == sim.returncode, rep.stderr
    assert json.loads(rep.stdout)["process_errors"] == \
        live["process_errors"]
    _same_run(tmp_path / "rep", run)
    assert _text(tmp_path / "rep", "commands.jsonl") == \
        _text(run, "commands.jsonl")


@pytest.mark.slow
def test_chip_smoke_live_phase(tmp_path):
    """chip_smoke.py's phase ``live`` on the CPU, every leg at full width:
    the live tgen_1k run at floor 1 and its three replays, the jump, the
    user pair and the CI's gossip_churn leg (about two minutes)."""
    from shadow_tpu_torch import cli as port_cli
    from shadow_tpu_torch.ops import propagate as prop
    from shadow_tpu_torch.parallel import mesh
    from tests.test_torch_e2e import _chip_smoke

    _chip_smoke().live_path(port_cli, prop, mesh, output_tree_digest,
                            str(tmp_path), device="cpu")
