"""The multi-device layout of the port against the reference's.

The reference is one controller over ``jax.devices()``: under tpu_mesh it
puts shard i of its mesh data plane on device i and moves rows with
``lax.all_to_all``; under tpu_batch ``DeviceDrawPlane(n_shards=n)`` splits
each draw batch along the unit axis over n devices. tests/conftest.py gives
it 8 virtual CPU devices. The port names its device entries with
``--device`` (``cpu,cpu,cpu,cpu`` here; ``cuda:0,cuda:0`` or
``cuda:0,cuda:1`` on cards): MeshDataPlane(devices=...) holds one shard an
entry and exchanges a window's rows with one mesh_exchange_entry launch a
card (each block storing into every destination's inbox), DeviceDrawPlane
splits each batch over n entries. On CPU entries the per-entry halves run
as plain PyTorch (send into the inboxes, receive; each shard's rounds
stored into the inboxes, each entry's reduction), the same split the
card runs; entry_plan's launches and
routes are pure and tested with a fake peer-access table. The tolerance
is zero throughout: every value is integer and the exchange only moves
rows.
"""

import re

import numpy as np
import pytest
import torch
import yaml

from shadow_tpu.config import parse_config as ref_parse_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.fleet import output_tree_digest as ref_tree_digest
from shadow_tpu.ops.propagate import DeviceDrawPlane as RefDrawPlane
from shadow_tpu.parallel.mesh import MeshDataPlane as RefPlane
from shadow_tpu_torch import checkpoint as ckpt
from shadow_tpu_torch import cli as port_cli
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.ops import devcfg
from shadow_tpu_torch.ops import propagate as prop
from shadow_tpu_torch.parallel import mesh
from shadow_tpu_torch.parallel.mesh import MeshDataPlane
from shadow_tpu_torch.utils.digest import output_tree_digest
from tests.test_checkpoint import BASE
from tests.test_multichip import INCAST
from tests.test_torch_e2e import EX, _assert_identical, _run
from tests.test_torch_mesh import (assert_same_state, make_params,
                                   port_params, random_batch, window)

CPU = torch.device("cpu")


def entries(n: int) -> tuple:
    return (CPU,) * n


def four_cpu() -> str:
    return ",".join(["cpu"] * 4)


# -- device entries (ops/devcfg.py) -------------------------------------------

@pytest.mark.parametrize("spec, want", [
    ("cpu", 1), ("cpu,cpu,cpu,cpu", 4), (" cpu , cpu ", 2)])
def test_select_devices_names_the_entries(spec, want):
    got = devcfg.select_devices(spec)
    assert got == (CPU,) * want
    assert devcfg.visible_devices(spec) == want
    assert devcfg.select_device(spec) == CPU
    devcfg.require_device(spec)


@pytest.mark.parametrize("spec, needle", [
    ("cpu,cuda:0", "mixes cpu and cuda entries"),
    ("cuda:7", "names card index 7"),
    ("cuda:0,cuda", "unknown device entry 'cuda'"),
    ("gpu", "unknown device entry 'gpu'"),
    ("cpu,,cpu", "unknown device entry ''")])
def test_select_devices_refuses_by_name(spec, needle):
    if spec == "cuda:7" and torch.cuda.device_count() > 7:
        pytest.skip("this machine has an eighth card")
    with pytest.raises(devcfg.DeviceUnavailable, match=needle):
        devcfg.select_devices(spec)


# -- the per-entry halves compose to the whole-mesh plain versions ------------

@pytest.mark.parametrize("n, m, w", [(1, 256, 256), (2, 256, 300),
                                     (4, 1024, 256), (8, 256, 2048)])
def test_send_recv_halves_compose_to_the_exchange(n, m, w):
    """mesh_exchange_entry's plain version (every source's send half stored
    into every destination's inbox, then each destination's receive half)
    against the whole-mesh exchange_rounds_plain; on a CPU tensor the
    wrapper is the plain version and launches nothing."""
    rng = np.random.default_rng(n * m)
    u = np.zeros((6, n, m), np.int64)
    u[0] = rng.integers(0, 1000, (n, m)) * (n if w == 300 else 1)
    u[1] = rng.integers(0, 1 << 40, (n, m))
    u[2] = rng.integers(0, 1 << 58, (n, m))
    u[3] = rng.integers(-1, 13, (n, m))
    u[4] = rng.choice(np.array([0, 1, 16106, 1 << 24]), (n, m))
    u[5] = rng.random((n, m)) < 0.75
    units = torch.from_numpy(u)
    seed = (1 << 32) + 5
    for s in range(n):
        sd = mesh.send_plain(units, s, seed, 10)
        assert sd.shape == (n, m + 1, 4)
        assert int(sd[:, m, 0].sum()) == int((u[5, s] != 0).sum())
    want, g_min = mesh.exchange_rounds_plain(units, seed, 10, w)
    mesh.reset_launches()
    for fn in (mesh.exchange_entry_plain, mesh.mesh_exchange_entry):
        got, mins = fn(units, seed, 10, w)
        assert torch.equal(got, want)
        assert torch.equal(mins, g_min.expand(n))
    assert not any(mesh.LAUNCHES.values()) and not mesh.ENTRY_LAUNCHES


def _cards(*idx):
    return tuple(torch.device("cuda", i) for i in idx)


def _peer(a, b):
    return True


def _islands(a, b):
    """Two NVLink islands of four cards: peers within, host across."""
    return a // 4 == b // 4


@pytest.mark.parametrize("cards, access, groups", [
    ((0, 0, 0, 0), _peer, ((0, (0, 1, 2, 3)),)),
    ((0, 1), _peer, ((0, (0,)), (1, (1,)))),
    ((0, 1), lambda a, b: False, ((0, (0,)), (1, (1,)))),
    ((0, 0, 1, 1), _peer, ((0, (0, 1)), (1, (2, 3)))),
    (tuple(range(8)), _islands, tuple((i, (i,)) for i in range(8))),
    ((0,) * 17, _peer, ((0, tuple(range(17))),)),
    ((1, 0, 1), _peer, ((1, (0, 2)), (0, (1,))))],
    ids=["one_card_x4", "two_cards_peer", "two_cards_host",
         "two_cards_x2", "eight_cards", "cooperative_17", "interleaved"])
def test_entry_plan_groups_and_routes(cards, access, groups):
    """entry_plan with a fake can_access: one launch a card, its entries
    in shard order, the cards in the order of their first entry (17
    entries on one card are one group past CLUSTER_MAX: the kernel's
    cooperative launch); local within a card, peer where the source's
    card reaches the destination's, host otherwise; ``host_only`` routes
    every pair through the host with the same launches."""
    plan = mesh.entry_plan(_cards(*cards), access)
    assert plan.groups == groups
    for i, a in enumerate(cards):
        for d, b in enumerate(cards):
            want = ("local" if a == b else "peer" if access(a, b)
                    else "host")
            assert plan.routes[i][d] == want
    host = mesh.entry_plan(_cards(*cards), access, host_only=True)
    assert host.groups == groups
    assert {r for row in host.routes for r in row} == {"host"}


def test_entry_plan_asks_access_per_ordered_pair():
    asked = []

    def one_way(a, b):
        asked.append((a, b))
        return a < b

    plan = mesh.entry_plan(_cards(0, 1, 0), one_way)
    assert plan.routes == (("local", "peer", "local"),
                           ("host", "local", "host"),
                           ("local", "peer", "local"))
    assert set(asked) == {(0, 1), (1, 0)}


@pytest.mark.parametrize("entries, needle", [
    ((CPU,) * 2, "every entry must be a card"),
    ((torch.device("cuda"),), "every entry must be a card"),
    (_cards(*[0] * 33), "33 entries"),
    ((), "0 entries"),
    ((torch.device("cuda", 0), CPU), "every entry must be a card")])
def test_entry_plan_refusals(entries, needle):
    with pytest.raises(ValueError, match=needle):
        mesh.entry_plan(entries, _peer)


def test_entry_status_names_the_late_source_and_epoch():
    """The status words a block writes (here set by hand): all OK passes;
    a late source raises ExchangeTimeout naming the entry, the source and
    the epoch, ahead of a block that did not run; a block that did not run
    (its status still pending) raises on its own."""
    ok = np.zeros((4, 4), np.int64)
    mesh.check_entry_status(ok, 7)
    late = ok.copy()
    late[3] = [mesh.STATUS_PENDING, 0, 0, 0]
    late[2] = [mesh.STATUS_LATE, 1, 7, 6]
    with pytest.raises(mesh.ExchangeTimeout,
                       match=r"entry 2 waited 20000000 ns for source 1's "
                             r"rows of window epoch 7 \(its flag held 6\)"):
        mesh.check_entry_status(late, 7, 20_000_000)
    late[2] = 0
    with pytest.raises(RuntimeError,
                       match=r"entry 3's block did not run for window epoch "
                             r"7 \(status -1\)"):
        mesh.check_entry_status(late, 7)


@pytest.mark.parametrize("w, kwargs, err", [
    (0, {}, "w must be in"), (513, {}, "w must be in"),
    (8, {"max_pkts": 65}, "max_pkts")])
def test_exchange_entry_wrapper_refusals(w, kwargs, err):
    units = torch.zeros((6, 2, 256), dtype=torch.int64)
    with pytest.raises(ValueError, match=err):
        mesh.mesh_exchange_entry(units, 3, kwargs.get("max_pkts", 10), w)


def _round_inputs(rng, port, h, k, counts=None):
    """(units (K, 6, N, C), t_nows (K,)) of k random rounds for ``port``'s
    shards: ``counts[j]`` units in round j (random below 60 if None)."""
    units = torch.from_numpy(np.stack([np.stack(port.shard_units_np(
        *random_batch(rng, h, 40 if counts is None else counts[j],
                      j * 2_000_000, 1000 * j))) for j in range(k)]))
    return units, torch.arange(k) * 2_000_000


@pytest.mark.parametrize("n, k", [(1, 1), (2, 1), (2, 8), (8, 3), (17, 2),
                                  (4, 32)])
def test_round_halves_compose_to_the_scan(n, k):
    """mesh_rounds_entry's plain version (every shard's rounds alone, its
    counted rows stored into every destination's inbox, each entry's
    reduction) against the whole-mesh scan_rounds_plain; on CPU entries
    the wrapper is the plain version, advances the states in place and
    launches nothing; every entry holds the same g_min and counters."""
    rng = np.random.default_rng(7 + n + k)
    port = MeshDataPlane(port_params(make_params(37)), n_shards=n,
                         units_per_shard=64, device="cpu")
    state = port.state
    units, t_nows = _round_inputs(rng, port, 37, k)
    want = mesh.scan_rounds_plain(state, units, port._tables, t_nows,
                                  port._seed, 10)
    rows, counts, states, g_min, counters = mesh.rounds_entries_plain(
        [state[:, s:s + 1] for s in range(n)], units, port._tables, t_nows,
        port._seed, 10)
    assert rows.shape == (n, n, k, 64, 4) and counts.shape == (n, n, k)
    assert np.array_equal(mesh.read_rounds(rows.numpy(), counts.numpy()),
                          want[0].numpy())
    assert torch.equal(torch.cat(states, dim=1), want[1])
    mesh.reset_launches()
    states = [state[:, s:s + 1].clone() for s in range(n)]
    got = mesh.mesh_rounds_entry(states, units, [port._tables] * n, t_nows,
                                 port._seed, 10)
    assert torch.equal(got[0], want[0])
    assert torch.equal(torch.cat(states, dim=1), want[1])
    for t in range(n):
        assert torch.equal(got[1][t], want[2])
        assert torch.equal(got[2][t], want[3])
    assert not any(mesh.LAUNCHES.values()) and not mesh.ENTRY_LAUNCHES


def test_round_stage_reused_after_a_larger_call():
    """One RoundStage over four CPU entries kept through calls of 60, 3, 0
    and 25 units a round with rising epochs: the inboxes keep the larger
    calls' rows past each count, and every call still equals the
    whole-mesh scan_rounds_plain from the state the last one left, with
    each entry's status OK at its epoch."""
    n, k, h = 4, 8, 37
    rng = np.random.default_rng(44)
    port = MeshDataPlane(port_params(make_params(h)), n_shards=n,
                         units_per_shard=64, device="cpu")
    state = port.state
    states = [state[:, s:s + 1].clone() for s in range(n)]
    stage = mesh.RoundStage(entries(n), n, k, 64, states,
                            [port._tables] * n)
    for epoch, used in enumerate((60, 3, 0, 25), start=1):
        units, t_nows = _round_inputs(rng, port, h, k, [used] * k)
        t_nows = t_nows + epoch * 10 ** 9
        want = mesh.scan_rounds_plain(state, units, port._tables, t_nows,
                                      port._seed, 10)
        stage.units[...] = units.numpy()
        stage.t_now[...] = t_nows.numpy()
        stage.run(port._seed, 10, epoch)
        recv, g_min, counters = stage.read()
        np.testing.assert_array_equal(recv, want[0].numpy())
        assert torch.equal(torch.cat(states, dim=1), want[1])
        assert (g_min == want[2].numpy()).all()
        assert (counters == want[3].numpy()).all()
        assert stage.status.tolist() == [[mesh.STATUS_OK, 0, epoch,
                                          epoch]] * n
        state = want[1]
    # the inboxes still hold rows of the larger calls past the last counts
    counts = stage.out[:, 3 * k:3 * k + n * k].reshape(n, n, k)
    stale = (np.arange(64) >= counts[..., None]) & (stage.rows[..., 3] >= 2)
    assert stale.any()


def _round_struct():
    """csrc/mesh.cu's RoundBlock as [(field, int64 words)]."""
    src = (mesh.devcfg.CSRC / "mesh.cu").read_text()
    body = src[src.index("struct RoundBlock {"):]
    body = body[:body.index("};")]
    return [(name, mesh.MAX_SHARDS if arr else 1) for name, arr in
            re.findall(r"^\s*i64 (\w+)(\[kMaxShards\])?;", body, re.M)]


def test_round_block_table_layout():
    """round_block_table for a fake plan whose pairs take all three routes
    (cards 0, 0, 1; card 0 reaches card 1 over NVLink, card 1 reaches card
    0 only through the host), on fake addresses: ROUND_BLOCK_WORDS words a
    block in csrc/mesh.cu's RoundBlock order; each destination's rows
    block for the source, its trailers and flag on the pair's route (its
    page-locked copies for host, else its card's); the block's own
    trailers and flags on each source's route; zero past N."""
    fields = _round_struct()
    assert sum(w for _, w in fields) == mesh.ROUND_BLOCK_WORDS
    at, off = {}, 0
    for name, w in fields:
        at[name] = off
        off += w
    plan = mesh.entry_plan(_cards(0, 0, 1), lambda a, b: a < b)
    assert plan.routes == (("local", "local", "peer"),
                           ("local", "local", "peer"),
                           ("host", "host", "local"))
    n, k, c = 3, 8, 64

    def addrs(t):
        base = (t + 1) << 40
        host = (base + (4 << 32), base + (5 << 32)) if t < 2 else None
        return mesh.RoundAddrs(base, tuple(base + (1 << 32) + 8 * i
                                           for i in range(5)),
                               base + (2 << 32),
                               (base + (3 << 32), base + (3 << 32) + 4096),
                               host, base + (6 << 32), base + (7 << 32))

    ad = [addrs(t) for t in range(n)]
    for (_card, shards) in plan.groups:
        tab = mesh.round_block_table(shards, plan.routes, ad, k, c)
        assert tab.shape == (len(shards), mesh.ROUND_BLOCK_WORDS)
        for b, s in enumerate(shards):
            row, a = tab[b], ad[s]
            assert row[at["shard"]] == s and row[at["state"]] == a.state
            assert [row[at[f]] for f in ("host_node", "lat", "thresh",
                                         "rate", "cap")] == list(a.tables)
            assert row[at["out"]] == a.out and row[at["status"]] == a.status
            assert row[at["pad"]] == 0
            for d in range(n):
                assert row[at["rows"] + d] == ad[d].rows + s * k * c * 32
                dst = (ad[d].host if plan.routes[s][d] == "host"
                       else ad[d].card)
                assert row[at["trailer"] + d] == dst[0] + s * k * 32
                assert row[at["flag"] + d] == dst[1] + 8 * s
                own = (a.host if plan.routes[d][s] == "host" else a.card)
                assert row[at["own_trailer"] + d] == own[0] + d * k * 32
                assert row[at["own_flag"] + d] == own[1] + 8 * d
            for name in ("rows", "trailer", "flag", "own_trailer",
                         "own_flag"):
                assert not row[at[name] + n:at[name] + mesh.MAX_SHARDS].any()


@pytest.mark.parametrize("kwargs, err", [
    ({"k": 33}, "K in 1..32"), ({"states": 3}, "4 shards want 4 states"),
    ({"max_pkts": 65}, "max_pkts"), ({"hs": 9}, "must be \\(3, 1, 10\\)")])
def test_rounds_entry_wrapper_refusals(kwargs, err):
    n, k, hs, c = 4, kwargs.get("k", 2), 10, 16
    port = MeshDataPlane(port_params(make_params(n * hs)), n_shards=n,
                         units_per_shard=c, device="cpu")
    states = [port.state[:, s:s + 1].clone() for s in range(n)]
    if "hs" in kwargs:
        states[2] = torch.zeros((3, 1, kwargs["hs"]), dtype=torch.int64)
    states = states[:kwargs.get("states", n)]
    with pytest.raises(ValueError, match=err):
        mesh.mesh_rounds_entry(states, torch.zeros((k, 6, n, c),
                                                   dtype=torch.int64),
                               [port._tables] * n,
                               torch.zeros(k, dtype=torch.int64), 3,
                               kwargs.get("max_pkts", 10))


# -- (a) the exchange over entries --------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_exchange_over_entries_matches_the_reference(n):
    """exchange_rounds over n CPU entries against the reference's plane on
    n of conftest's devices: mixed windows, an incast (every unit to one
    destination shard), and windows whose bucket grows and shrinks (the
    entries' stages reused at a smaller window after a larger one, two
    slices past 16,384 units)."""
    h = 41
    ref = RefPlane(make_params(h), n_shards=n, units_per_shard=128)
    port = MeshDataPlane(port_params(make_params(h)), n_shards=n,
                         units_per_shard=128, devices=entries(n))
    assert port.entries == entries(n)
    rng = np.random.default_rng(n)
    for total, case in ((700, "mixed"), (30, "incast"), (5000, "mixed"),
                        (200, "incast"), (20000, "mixed"), (1, "mixed"),
                        (40, "mixed")):
        win = window(rng, h, total, case)
        want = ref.exchange_rounds(*win)
        got = port.exchange_rounds(*win)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert port.phase["windows"] == ref.phase["windows"]


def test_shards_above_the_entries_raise_as_the_reference():
    p = port_params(make_params(13))
    with pytest.raises(ValueError, match="4 shards > 2 devices"):
        MeshDataPlane(p, n_shards=4, devices=entries(2))
    plane = MeshDataPlane(p, n_shards=2, devices=entries(4))
    assert plane.entries == entries(2) and plane.n_shards == 2


# -- (b) the rounds over entries ----------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_rounds_over_entries_match_the_reference(n):
    """round_step and scan_rounds (K = 1 and 8, and a backlog past
    SCAN_KMAX) over n CPU entries against the reference's plane, the bucket
    state compared after every call."""
    h = 37
    ref = RefPlane(make_params(h, fast_hosts=(0, 5)), n_shards=n,
                   units_per_shard=128)
    port = MeshDataPlane(port_params(make_params(h, fast_hosts=(0, 5))),
                         n_shards=n, units_per_shard=128, devices=entries(n))
    rng = np.random.default_rng(100 + n)
    t = 0
    for step in range(3):
        batch = random_batch(rng, h, int(rng.integers(0, 90)), t, 7000 * step)
        rr, rg, rc = ref.round_step(ref.shard_units(*batch), t)
        pr, pg, pc = port.round_step(port.shard_units_np(*batch), t)
        np.testing.assert_array_equal(pr, np.asarray(rr))
        assert pg == int(rg)
        np.testing.assert_array_equal(pc, np.asarray(rc))
        assert_same_state(ref, port)
        t += 2_000_000
    for k in (1, 8, 40):
        chunks = []
        for j in range(k):
            batch = random_batch(rng, h, int(rng.integers(0, 60)), t,
                                 10 ** 6 + 1000 * j)
            chunks.append((port.shard_units_np(*batch), t))
            t += 2_000_000
        want = ref.scan_rounds(chunks)
        got = port.scan_rounds(chunks)
        assert len(got) == len(want) == k
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert_same_state(ref, port)


# -- (c) the draws split over entries -----------------------------------------

@pytest.mark.parametrize("size", [1, 7, 8, 33, 4096, 65536])
def test_draws_split_over_entries_match_the_reference(size):
    """DeviceDrawPlane(n_shards=4) over four CPU entries against the
    reference's over four devices: the flags (at several thresholds) and
    the speculative min-draws, also at the pinned SPEC_BUCKET."""
    seed = (1 << 33) + 12345
    ref = RefDrawPlane(seed, 65536, n_shards=4, max_pkts=10)
    port = prop.DeviceDrawPlane(seed, 65536, max_pkts=10,
                                device=four_cpu(), n_shards=4)
    assert port.n_shards == 4 and port.entries == entries(4)
    rng = np.random.default_rng(size)
    lo = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    npk = rng.integers(0, 14, size).astype(np.uint32)
    th = rng.choice(np.array([0, 1, 1 << 10, 1 << 18, 1 << 24],
                             dtype=np.uint32), size)
    np.testing.assert_array_equal(port.dispatch(lo, hi, npk, th).read(),
                                  ref.dispatch(lo, hi, npk, th).read())
    np.testing.assert_array_equal(port.dispatch_min(lo, hi, npk).read(),
                                  ref.dispatch_min(lo, hi, npk).read())
    spec = port.SPEC_BUCKET
    np.testing.assert_array_equal(
        port.dispatch_min(lo, hi, npk, min_bucket=spec, seed=9).read(),
        ref.dispatch_min(lo, hi, npk, min_bucket=spec, seed=9).read())
    # each dispatch took one split slot (the whole batch, an output region
    # an entry, the four CPU entries one group) and gave it back
    free = [slot for v in port._free.values() for slot in v]
    assert free and all(
        isinstance(slot, prop.SplitSlot) and slot.out.shape[0] == 4
        and slot.groups == ((CPU, (0, 1, 2, 3)),) for slot in free)
    assert not prop.ENTRY_LAUNCHES


def test_draw_split_clamps_to_the_entries_and_reuses_slots():
    """n_shards above the entries clamps (the reference clamps to its
    devices); a smaller batch after a larger one reuses the split slot
    and reads no stale unit; handles read out of order."""
    one = prop.DeviceDrawPlane(3, 65536, device="cpu", n_shards=4)
    assert one.n_shards == 1
    split = prop.DeviceDrawPlane(3, 65536, device="cpu,cpu,cpu", n_shards=0)
    assert split.n_shards == 3
    rng = np.random.default_rng(5)
    batches = []
    for n in (5000, 300, 7, 5000):
        cols = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32) for _ in range(3)]
        cols[2] = (cols[2] % 12).astype(np.uint32)
        th = np.full(n, 1 << 20, np.uint32)
        batches.append((*cols, th))
    handles = [split.dispatch(*b) for b in batches]
    for b, h in reversed(list(zip(batches, handles))):
        np.testing.assert_array_equal(h.read(), one.dispatch(*b).read())
    # the two 5,000-unit batches: one split slot each at that bucket
    assert all(len(v) <= 2 for v in split._free.values())


# -- (d) tpu_mesh end to end --------------------------------------------------

def test_tgen_100host_tpu_mesh_over_four_entries(tmp_path):
    """tgen_100host (to 20 s) under tpu_mesh at tpu_mesh_floor 0 (every
    causal window through the exchange), four shards on four CPU entries,
    against the reference's four shards on four devices: summary, tree,
    digest stream."""
    extra = ["--set", "experimental.tpu_mesh_shards=4", "--set",
             "experimental.tpu_mesh_floor=0", "--set",
             "experimental.native_colcore=false", "--state-digest-every",
             "50", "--stop-time", "20s"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    from shadow_tpu import cli as ref_cli

    ref = _run(ref_cli.main, EX / "tgen_100host.yaml", ref_dir, extra,
               policy="tpu_mesh")
    port = _run(port_cli.main, EX / "tgen_100host.yaml", port_dir,
                extra + ["--device", four_cpu()], policy="tpu_mesh")
    _assert_identical(ref, port, ref_dir, port_dir)
    assert port["phase_wall"]["mesh_windows"] > 0


def _incast(tmp_path, pkg, policy, device=None, **extra):
    ov = {"experimental.scheduler_policy": policy,
          "general.data_directory": str(tmp_path / f"{pkg}_{policy}"),
          "general.state_digest_every": 10,
          "experimental.native_colcore": False, **extra}
    if pkg == "ref":
        cfg = ref_parse_config(yaml.safe_load(INCAST), ov)
        return RefController(cfg, mirror_log=False).run(), ov
    cfg = parse_config(yaml.safe_load(INCAST), ov)
    return Controller(cfg, mirror_log=False, device=device).run(), ov


def test_incast_over_four_entries(tmp_path):
    """The reference's destination-skewed incast (48 sources, one sink)
    at tpu_mesh_floor 0 over four entries, against the reference's four
    devices and its per-unit plane."""
    keys = ("events", "units_sent", "units_dropped", "bytes_sent",
            "counters")
    over = {"experimental.tpu_mesh_floor": 0,
            "experimental.tpu_mesh_shards": 4}
    ref, rov = _incast(tmp_path, "ref", "tpu_mesh", **over)
    base, _ = _incast(tmp_path, "ref", "thread_per_core")
    port, pov = _incast(tmp_path, "port", "tpu_mesh", four_cpu(), **over)
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys} \
        == {k: base[k] for k in keys}
    assert ref["units_dropped"] > 0
    assert port["phase_wall"]["mesh_windows"] > 0
    rd, pd = rov["general.data_directory"], pov["general.data_directory"]
    assert output_tree_digest(pd) == ref_tree_digest(rd)
    assert open(f"{pd}/state_digests.jsonl").read() == open(
        f"{rd}/state_digests.jsonl").read()


# -- (e) tpu_batch end to end -------------------------------------------------

@pytest.mark.parametrize("config, device", [
    ("echo.yaml", "cpu,cpu,cpu,cpu"), ("echo.yaml", "cpu"),
    ("tgen_100host.yaml", "cpu,cpu,cpu,cpu")])
def test_tpu_batch_draws_over_entries(tmp_path, config, device):
    """tpu_batch at tpu_mesh_shards 4 and tpu_device_floor 1 (every draw
    window through the plane): each window split over four entries, or on
    the one entry of ``--device cpu`` (the reference's clamp), against the
    reference's four devices. tgen_100host runs to 20 s; its lossy links
    send windows through the plane (echo's lossless one sends none)."""
    from shadow_tpu import cli as ref_cli

    extra = ["--set", "experimental.tpu_mesh_shards=4", "--set",
             "experimental.tpu_device_floor=1", "--set",
             "experimental.native_colcore=false", "--state-digest-every",
             "5" if config == "echo.yaml" else "50"]
    if config != "echo.yaml":
        extra += ["--stop-time", "20s"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = _run(ref_cli.main, EX / config, ref_dir, extra)
    port = _run(port_cli.main, EX / config, port_dir,
                extra + ["--device", device])
    _assert_identical(ref, port, ref_dir, port_dir)
    if config != "echo.yaml":
        assert port["device"]["windows_dispatched"] > 0


# -- (f) checkpoint at four entries, resume at one ----------------------------

#: the checkpoint legs' overrides: every draw window through the plane
#: (tpu_batch) or every causal window through the exchange (tpu_mesh)
CKPT_OVER = {"experimental.native_colcore": False,
             "experimental.tpu_device_floor": 1,
             "experimental.tpu_mesh_floor": 0,
             "experimental.tpu_mesh_shards": 4,
             "general.state_digest_every": 50}


@pytest.fixture(scope="module")
def ckpt_ref(tmp_path_factory):
    """The reference's uninterrupted run of the checkpoint tests' lossy
    two-host tgen document (tests/test_checkpoint.py BASE) under tpu_batch
    over four devices; its results are every policy's."""
    d = tmp_path_factory.mktemp("ckpt_ref")
    cfg = ref_parse_config(yaml.safe_load(BASE), dict(CKPT_OVER, **{
        "experimental.scheduler_policy": "tpu_batch",
        "general.data_directory": str(d)}))
    return RefController(cfg, mirror_log=False).run(), d


@pytest.mark.parametrize("policy", ["tpu_batch", "tpu_mesh"])
def test_checkpoint_at_four_entries_resumes_at_one(tmp_path, ckpt_ref,
                                                    policy):
    """BASE checkpointed every 10 s over four entries resumes from its first
    checkpoint on ``--device cpu`` (one entry: tpu_batch's split clamps to
    it; tpu_mesh, at its auto shard count here, runs one shard) to the
    bytes of the uninterrupted reference; the checkpoint carries no device
    state."""
    ref, ref_dir = ckpt_ref
    over = dict(CKPT_OVER, **{"experimental.scheduler_policy": policy})
    if policy == "tpu_mesh":
        over["experimental.tpu_mesh_shards"] = 0
    doc = yaml.safe_load(BASE)
    src = tmp_path / "src"
    ctl = Controller(parse_config(doc, dict(over, **{
        "general.data_directory": str(src),
        "general.checkpoint_every": "10s"})), mirror_log=False,
        device=four_cpu())
    if policy == "tpu_mesh":
        assert ctl.engine.mesh_plane.entries == entries(4)
    else:
        assert ctl.engine.device.n_shards == 4
    whole = ctl.run()
    want = (ref_dir / "state_digests.jsonl").read_text().splitlines()
    assert (src / "state_digests.jsonl").read_text().splitlines() == want
    assert output_tree_digest(src) == ref_tree_digest(ref_dir)
    paths = sorted((src / "checkpoints").glob("*.ckpt"))
    assert len(paths) >= 2
    res_dir = tmp_path / "res"
    res_ctl, at = ckpt.load_checkpoint(
        str(paths[0]), parse_config(doc, dict(over, **{
            "general.data_directory": str(res_dir)})),
        mirror_log=False, device="cpu")
    if policy == "tpu_mesh":
        assert res_ctl.engine.mesh_plane.entries is None
        assert res_ctl.engine.mesh_plane.n_shards == 1
    else:
        assert res_ctl.engine.device.n_shards == 1
    res = res_ctl.run(resume_at=at)
    for k in ("rounds", "events", "units_sent", "units_dropped",
              "bytes_sent", "counters"):
        assert res[k] == ref[k] == whole[k], k
    assert ref["units_dropped"] > 0
    assert output_tree_digest(res_dir) == ref_tree_digest(ref_dir)
    got = (res_dir / "state_digests.jsonl").read_text().splitlines()
    assert got and got == want[-len(got):]


# -- (g) refusals by name -----------------------------------------------------

@pytest.mark.parametrize("extra, needle", [
    (["--scheduler-policy", "tpu_mesh", "--device", "cpu,cpu", "--set",
      "experimental.tpu_mesh_shards=4"],
     "tpu_mesh_shards=4 exceeds the 2 device entries of --device cpu,cpu"),
    (["--scheduler-policy", "tpu_batch", "--device", "cpu,cuda:0"],
     "mixes cpu and cuda entries"),
    (["--scheduler-policy", "tpu_mesh", "--device", "cuda:0,cuda:9"],
     "9 but"),
    (["--scheduler-policy", "tpu_batch", "--device", "cuda0"],
     "unknown device entry 'cuda0'")])
def test_device_lists_are_refused_by_name(tmp_path, capsys, extra, needle):
    if torch.cuda.device_count() > 9:
        pytest.skip("this machine has a tenth card")
    rc = port_cli.main([str(EX / "echo.yaml"), "--data-directory",
                        str(tmp_path / "d"), "--quiet", *extra])
    err = capsys.readouterr().err
    assert rc == 2, err
    assert err.startswith("shadow_tpu_torch: ") and needle in err, err
    assert len(err.strip().splitlines()) == 1, err
