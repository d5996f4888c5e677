"""Tests that need a CUDA card: the port's hand-written kernels against
their plain PyTorch versions on the card (chip_smoke.py runs the full
sweep). This file imports neither jax nor the reference package, so it
runs on a card machine without JAX, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch.network.fluid import NetParams
from shadow_tpu_torch.ops import propagate as prop
from shadow_tpu_torch.ops import transport_kernels as tk
from shadow_tpu_torch.parallel import mesh
from shadow_tpu_torch.parallel.mesh import MeshDataPlane

SEEDS = (11, (1 << 32) + 11)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(h=13, g=4):
    rng = np.random.default_rng(5)
    lat = rng.integers(3_000_000, 40_000_000, (g, g)).astype(np.int64)
    np.fill_diagonal(lat, 2_000_000)
    rate = rng.integers(2_000_000, 50_000_000, h)
    rate[0] = 16_000_000_000  # MAX_RATE: the uint64 edge
    return NetParams.build(
        host_node=rng.integers(0, g, h).astype(np.int32), rate_up=rate,
        rate_down=rate, latency_ns=lat,
        reliability=np.full((g, g), 0.97, np.float32), seed=SEEDS[1],
        round_ns=2_000_000)


def _batch(rng, h, k, t_now):
    src = np.sort(rng.integers(0, h, k))
    return (src, rng.integers(0, h, k), rng.integers(60, 15000, k),
            t_now + np.sort(rng.integers(0, 2_000_000, k)),
            np.arange(k, dtype=np.int64) + (1 << 40))


@pytest.mark.cuda
def test_draw_kernels_match_plain_on_card(dev):
    rng = np.random.default_rng(7)
    for p in (256, 1024):
        x = np.zeros((4, p), np.uint32)
        x[0] = rng.integers(0, 1 << 32, p, dtype=np.uint64)
        x[1] = rng.integers(0, 1 << 26, p)
        x[2] = rng.integers(0, 12, p)
        x[3] = rng.choice(np.array([0, 1, 1 << 20, 1 << 24]), p)
        x = torch.from_numpy(x).to(dev)
        for seed in SEEDS:
            key = (seed & 0xFFFFFFFF, seed >> 32)
            assert torch.equal(prop.draw_flags(x, key, 10),
                               prop.draw_flags_plain(x, key, 10))
            x3 = x[:3].contiguous()
            assert torch.equal(prop.min_draw(x3, key, 10),
                               prop.min_draw_plain(x3, key, 10))


def _smoke():
    """chip_smoke.py as a module: its sweep generators."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 10, 16, 31, 32, 33, 64])
def test_draw_kernels_edge_sweep_on_card(dev, width):
    """Lane-parallel draw_flags and min_draw against their plain versions
    on chip_smoke's edge sweep: P from 32 to 65,536, n in {P, P/2 + 1, 1,
    0} (pads included in the comparison), npkts 0 and above the width,
    thresholds 0, and units hit on lane 0 only and on the last lane
    only."""
    cs = _smoke()
    rng = np.random.default_rng(width)
    edges = 0
    for p in (32, 64, 256, 4096, 65536):
        for seed in SEEDS:
            key = (seed & 0xFFFFFFFF, seed >> 32)
            cases, first, last = cs.draw_sweep(torch, np, prop, dev, rng, p,
                                               width, key)
            edges += first + last
            for name, x, n in cases:
                got = getattr(prop, name)(x, key, width, n)
                want = getattr(prop, f"{name}_plain")(x, key, width, n)
                assert torch.equal(got, want), (name, p, n, seed)
    assert edges > 0 or width == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 5, 4096, 739532])
def test_threefry_paths_match_plain_on_card(dev, n):
    """threefry_kernel's 16-byte path (n % 4 == 0, aligned rows) and its
    scalar path (other n, or rows 4 bytes past a 16-byte boundary)."""
    from shadow_tpu_torch.ops import prng

    rng = np.random.default_rng(n)
    c = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(c).to(dev)
    shifted = torch.empty(2 * n + 1, dtype=torch.uint32, device=dev)
    shifted[1:] = x.view(-1)
    xi = x.to(torch.int64)
    for key in ((11, 0), (0xDEADBEEF, 0x12345678)):
        want = torch.stack(prng.threefry2x32_torch(key[0], key[1], xi[0],
                                                   xi[1]))
        for inp in (x, shifted[1:].view(2, n)):
            got = prng.threefry2x32_device(inp, key)
            assert torch.equal(got.to(torch.int64), want)


@pytest.mark.cuda
def test_draw_slots_hazards_on_card(dev):
    """The draw plane's page-locked slots on the card against a CPU plane
    (chip_smoke.check_slots): dispatches in flight read in reverse, a
    65,536 / 256 / 65,536 bucket sequence, a min_draw result kept across
    its slot's reuse, a dropped handle, warm_shapes and calibrate; and
    each dispatch is one launch."""
    cs = _smoke()
    prop.reset_launches()
    assert cs.check_slots(torch, np, prop, np.random.default_rng(1)) > 0
    plane = prop.DeviceDrawPlane(SEEDS[1], 4096, device="cuda")
    z = np.ones(100, np.uint32)
    before = dict(prop.LAUNCHES)
    plane.dispatch(z, z, z, z).read()
    plane.dispatch_min(z, z, z).read()
    assert prop.LAUNCHES == {k: v + (k in ("draw_flags", "min_draw"))
                             for k, v in before.items()}


@pytest.mark.cuda
def test_draw_entry_kernels_match_plain_on_card(dev):
    """draw_flags_entry and min_draw_entry against their plain versions
    (chip_smoke.check_draw_entry: 2, 3, 4 and 8 entries, batches of 1 to
    65,536 units with empty pieces, every piece's table and card 0's
    pieces of an interleaved list, widths 10 and 33); each wrapper call is
    one launch."""
    cs = _smoke()
    before = dict(prop.LAUNCHES)
    err, n_cmp = cs.check_draw_entry(torch, np, prop, dev,
                                     np.random.default_rng(3))
    assert err == {"draw_flags_entry": 0, "min_draw_entry": 0}
    assert n_cmp == 2 * 2 * 2 * len(cs.DRAW_ENTRY_COUNTS) \
        * len(cs.DRAW_ENTRY_SIZES)
    assert prop.LAUNCHES["draw_flags_entry"] \
        - before["draw_flags_entry"] == n_cmp // 2
    assert prop.LAUNCHES["min_draw_entry"] \
        - before["min_draw_entry"] == n_cmp // 2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 1024])
@pytest.mark.parametrize("h", [13, 20000])
@pytest.mark.parametrize("n", [1, 2, 8, 16, 32])
def test_mesh_kernels_match_plain_on_card(dev, n, h, c):
    """Every launch path: N up to and past the cluster limit, exchange
    buckets whose send rows fit shared memory and buckets whose rows do
    not, round tables resident in shared memory (13 hosts) and read from
    device memory (20,000 hosts), C = 64 slots (fewer than a block's
    threads) and 1,024, and scans whose real prefixes are 0, 1, 60, 257
    and 700 units (at most C)."""
    rng = np.random.default_rng(9 + n)
    mesh.reset_launches()
    for m, w in ((256, 256), (1024, 2048)):
        u = np.zeros((6, n, m), np.int64)
        u[0] = rng.integers(0, 13, (n, m))
        u[1] = rng.integers(0, 10 ** 11, (n, m))
        u[2] = rng.integers(0, 1 << 50, (n, m))
        u[3] = rng.integers(0, 12, (n, m))
        u[4] = rng.choice(np.array([0, 9000, 1 << 24]), (n, m))
        u[5] = rng.random((n, m)) < 0.7
        x = torch.from_numpy(u).to(dev)
        w = min(w, n * m)
        for seed in SEEDS:
            got = mesh.mesh_exchange(x, seed, 10, w)
            want = mesh.exchange_rounds_plain(x, seed, 10, w)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    plane = MeshDataPlane(_params(h), n_shards=n, units_per_shard=c,
                          device="cuda")
    units = plane.shard_units(*_batch(rng, 13, 60, 10 ** 9))
    for seed in SEEDS:
        got = mesh.mesh_round_step(plane.state, units, plane._tables,
                                   10 ** 9, seed, 10)
        want = mesh.round_step_plain(plane.state, units, plane._tables,
                                     10 ** 9, seed, 10)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        uk = units[None].expand(8, -1, -1, -1).contiguous()
        tk = torch.arange(1, 9, device=dev) * 10 ** 9
        got = mesh.mesh_scan(plane.state, uk, plane._tables, tk, seed, 10)
        want = mesh.scan_rounds_plain(plane.state, uk, plane._tables, tk,
                                      seed, 10)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        uk = torch.stack([
            plane.shard_units(*_batch(rng, h, min(k, c), j * 10 ** 9))
            for j, k in enumerate((0, 1, 60, 257, 700))])
        tk = torch.arange(5, device=dev) * 10 ** 9
        got = mesh.mesh_scan(plane.state, uk, plane._tables, tk, seed, 10)
        want = mesh.scan_rounds_plain(plane.state, uk, plane._tables, tk,
                                      seed, 10)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    cluster, resident = mesh.round_path(n, plane.hs, c, 4)
    assert mesh.PATHS["rounds_cluster" if cluster else "rounds_pair"] == 6
    assert mesh.PATHS["rounds_smem" if resident else "rounds_global"] == 6
    want = {k: 0 for k in mesh.PATHS if k.startswith("exchange_")}
    for m in (256, 1024):
        want[f"exchange_{mesh.exchange_path(n, m)}"] += len(SEEDS)
    assert {k: mesh.PATHS[k] for k in want} == want


@pytest.mark.cuda
def test_staged_exchange_matches_plain_on_card(dev):
    """MeshDataPlane.exchange_rounds on the card over windows whose bucket
    grows and shrinks, against a fresh CPU plane's tables."""
    rng = np.random.default_rng(4)
    for n in (1, 8):
        plane = MeshDataPlane(_params(), n_shards=n, device="cuda")
        for total in (700, 30, 5000, 1, 20000, 200):
            win = (rng.integers(0, 13, total), rng.integers(0, 13, total),
                   rng.integers(0, 1 << 40, total),
                   rng.integers(0, 1 << 58, total),
                   rng.integers(1, 11, total),
                   rng.choice(np.array([0, 1, 16106, 1 << 24]), total))
            want = MeshDataPlane(_params(), n_shards=n,
                                 device="cpu").exchange_rounds(*win)
            got = plane.exchange_rounds(*win)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 161, 4096, 70000])
def test_ack_advance_matches_plain_on_card(dev, n):
    """The transport kernel against its plain version on the card, and the
    whole DeviceAckKernel.run round trip against the numpy host version,
    on a sweep of every branch (chip_smoke.ack_sweep)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cols = cs.ack_sweep(np, np.random.default_rng(n), n)
    x = torch.from_numpy(np.stack(cols)).to(dev)
    tk.reset_launches()
    got = tk.ack_advance_device(x)
    assert tk.LAUNCHES["ack_advance"] == 1
    assert torch.equal(got, torch.stack(tk.ack_advance_torch(*x.unbind(0))))
    for a, b in zip(tk.DeviceAckKernel("cuda").run(*cols),
                    tk.ack_advance(*cols)):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_ack_slots_match_plain_on_card(dev):
    """The transport's slot path on the card (chip_smoke.check_ack_slots):
    buckets that grow and shrink, a reused slot with fewer rows, the
    bucket edges and the largest cohort, each one launch, against the
    plain and numpy host versions; one slot a bucket."""
    cs = _smoke()
    assert cs.check_ack_slots(torch, np, tk, dev,
                              np.random.default_rng(3)) > 0


@pytest.mark.cuda
def test_ack_cohort_allocates_nothing_after_its_bucket_is_made(dev):
    """After the first cohort of a bucket, a cohort makes no slot and no
    device allocation, and launches once."""
    kern = tk.DeviceAckKernel("cuda")
    cols = _smoke().ack_sweep(np, np.random.default_rng(5), 256)
    kern.run(*(c[:161] for c in cols))
    made = kern.slots.made
    allocated = torch.cuda.memory_allocated(dev)
    tk.reset_launches()
    for n in (161, 1, 200, 256):
        slot = kern.slots.take(n)
        for r, c in enumerate(cols):
            slot.inp[r, :n] = c[:n]
        out = kern.advance(slot, n)
        for a, b in zip(out, tk.ack_advance(*(c[:n] for c in cols))):
            assert np.array_equal(a, b)
        kern.slots.give(slot)
    assert tk.LAUNCHES["ack_advance"] == 4
    assert kern.slots.made == made
    assert torch.cuda.memory_allocated(dev) == allocated


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 17, 300])
def test_apsp_matches_plain_on_card(dev, g):
    """The min-plus squaring kernel against its plain version on the card,
    bit for bit, on a graph with ties, separate components and
    subnormal reliability products (chip_smoke.apsp_case)."""
    import importlib.util
    from pathlib import Path

    from shadow_tpu_torch.network.graph import INF_I32
    from shadow_tpu_torch.ops import apsp

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    lat, rel = cs.apsp_case(np, np.random.default_rng(g), g)
    lat32 = torch.from_numpy(
        np.minimum(lat, int(INF_I32)).astype(np.int32)).to(dev)
    rel32 = torch.from_numpy(rel).to(dev)
    steps = apsp.squaring_steps(g)
    apsp.reset_launches()
    got = apsp.squarings(lat32, rel32, steps)
    assert apsp.LAUNCHES["apsp"] == steps
    want = apsp.squarings_plain(lat32, rel32, steps)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
def test_threefry_alone_matches_plain_on_card(dev):
    from shadow_tpu_torch.ops import prng

    rng = np.random.default_rng(3)
    c = rng.integers(0, 1 << 32, (2, 4097), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(c).to(dev)
    for seed in SEEDS:
        key = (seed & 0xFFFFFFFF, seed >> 32)
        xi = x.to(torch.int64)
        want = torch.stack(prng.threefry2x32_torch(key[0], key[1], xi[0],
                                                   xi[1]))
        assert torch.equal(prng.threefry2x32_device(x, key).to(torch.int64),
                           want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
def test_entry_kernels_match_plain_on_card(dev, n):
    """The per-entry kernels on N entries of one card: mesh_exchange_entry
    (one launch, on the local route and on the host route forced through
    its plan, then one EntryWindow kept through three epochs on each) and
    mesh_rounds_entry (one launch on each route, the states advanced in
    place), each against its plain version."""
    cs = _smoke()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(cs.exchange_inputs(np, rng, n, 256, False))
    seed = SEEDS[1]
    want = mesh.exchange_entry_plain(x, seed, 10, 512)
    entries = (torch.device("cuda", 0),) * n
    for host_only in (False, True):
        plan = mesh.entry_plan(entries, torch.cuda.can_device_access_peer,
                               host_only)
        mesh.reset_launches()
        got = mesh.mesh_exchange_entry(x.to(dev), seed, 10, 512,
                                       plan=plan)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        assert mesh.LAUNCHES["mesh_exchange_entry"] == 1
        assert mesh.ENTRY_LAUNCHES == dict.fromkeys(range(n), 1)
        # one window kept through rising epochs, as the plane drives it
        st = mesh.EntryWindow(entries, n, 256, 512, plan)
        stream = [torch.cuda.current_stream(dev)]
        for epoch in range(1, 4):
            u = cs.exchange_inputs(np, rng, n, 256, epoch == 2)
            st.units[:] = u
            st.launch(seed, 10, epoch, stream)
            st.finish(epoch, stream)
            rows, g_min = mesh.exchange_entry_plain(torch.from_numpy(u),
                                                    seed, 10, 512)
            for t, e in enumerate(st.stages):
                assert np.array_equal(e.out[:4 * 512], rows[t].reshape(-1))
                assert e.out[4 * 512] == g_min[t]
    tabs, hs = cs.round_tables(np, rng, n)
    tables = tuple(torch.from_numpy(np.asarray(t, np.int64)) for t in tabs)
    state = torch.from_numpy(cs.round_state(np, rng, tabs, n, hs, 10 ** 10))
    units = torch.from_numpy(np.stack([cs.round_units(
        np, rng, n, hs, 300, 10 ** 10 + j * 2_000_000) for j in range(8)]))
    t_nows = torch.arange(8) * 2_000_000 + 10 ** 10
    rows, counts, states, g_min, counters = mesh.rounds_entries_plain(
        [state[:, s:s + 1] for s in range(n)], units, tables, t_nows, seed,
        10)
    want = mesh.read_rounds(rows.numpy(), counts.numpy())
    for host_only in (False, True):
        plan = mesh.entry_plan(entries, torch.cuda.can_device_access_peer,
                               host_only)
        on_card = [state[:, s:s + 1].to(dev) for s in range(n)]
        mesh.reset_launches()
        got = mesh.mesh_rounds_entry(
            on_card, units, [tuple(t.to(dev) for t in tables)] * n, t_nows,
            seed, 10, plan=plan)
        assert np.array_equal(got[0].numpy(), want)
        assert torch.equal(got[1], g_min) and torch.equal(got[2], counters)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, states))
        assert mesh.LAUNCHES["mesh_rounds_entry"] == 1
        assert mesh.ENTRY_LAUNCHES == dict.fromkeys(range(n), 1)


@pytest.mark.cuda
def test_planes_over_card_entries_match_cpu_entries(dev):
    """MeshDataPlane and DeviceDrawPlane over four entries of one card
    against the same planes over four CPU entries."""
    rng = np.random.default_rng(9)
    card = MeshDataPlane(_params(), n_shards=4,
                         devices=(torch.device("cuda", 0),) * 4)
    host = MeshDataPlane(_params(), n_shards=4,
                         devices=(torch.device("cpu"),) * 4)
    for total in (700, 30, 5000, 1, 20000, 200):
        win = (rng.integers(0, 13, total), rng.integers(0, 13, total),
               rng.integers(0, 1 << 40, total),
               rng.integers(0, 1 << 58, total), rng.integers(1, 11, total),
               rng.choice(np.array([0, 1, 16106, 1 << 24]), total))
        for a, b in zip(card.exchange_rounds(*win),
                        host.exchange_rounds(*win)):
            np.testing.assert_array_equal(a, b)
    chunks = [(card.shard_units_np(*_batch(rng, 13, 40, t * 2_000_000)),
               t * 2_000_000) for t in range(9)]
    for a, b in zip(card.scan_rounds(chunks), host.scan_rounds(chunks)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(card.state, host.state)
    split = prop.DeviceDrawPlane(SEEDS[1], 65536,
                                 device=",".join(["cuda:0"] * 4), n_shards=4)
    one = prop.DeviceDrawPlane(SEEDS[1], 65536, device="cpu")
    prop.reset_launches()
    for k in (1, 7, 33, 4096):
        cols = [rng.integers(0, 1 << 32, k, dtype=np.uint64).astype(
            np.uint32) for _ in range(3)]
        cols[2] %= 12
        th = np.full(k, 1 << 20, np.uint32)
        np.testing.assert_array_equal(split.dispatch(*cols, th).read(),
                                      one.dispatch(*cols, th).read())
        np.testing.assert_array_equal(split.dispatch_min(*cols).read(),
                                      one.dispatch_min(*cols).read())
    # one entry launch a dispatch for the card's four pieces
    assert prop.LAUNCHES == {"draw_flags": 0, "min_draw": 0,
                             "draw_flags_entry": 4, "min_draw_entry": 4}
    assert prop.ENTRY_LAUNCHES == dict.fromkeys(range(4), 8)
