"""The port's mesh data plane (shadow_tpu_torch/parallel/mesh.py) against the
reference's sharded programs (shadow_tpu/parallel/mesh.py).

Each of the three programs is a hand-written CUDA kernel (csrc/mesh.cu)
beside a plain PyTorch version that the wrappers run for CPU tensors. On
this CPU box the plain versions stand in; they are held with tolerance 0
(all the math is integer) against the reference's jitted shard_map
programs on CPU-XLA, which tests/conftest.py gives 8 virtual devices, so
the reference runs at N in {1, 2, 8} shards while the port holds all N
shards on its one device. The round is also held against the host oracle
(fluid.TokenBuckets.depart_times + fluid.loss_flags). The CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py
(marker ``cuda``) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.network.fluid import MAX_RATE as REF_MAX_RATE
from shadow_tpu.network.fluid import NetParams as RefNetParams
from shadow_tpu.parallel.mesh import MeshDataPlane as RefPlane
from shadow_tpu_torch import convert
from shadow_tpu_torch.core.time import NS_PER_SEC
from shadow_tpu_torch.network.fluid import MAX_RATE, TokenBuckets, loss_flags
from shadow_tpu_torch.parallel import mesh
from shadow_tpu_torch.parallel.mesh import (F_DST, F_FLAGS, F_TARR, F_UID,
                                            MeshDataPlane)

ROUND_NS = 2_000_000


def make_params(h, g=4, seed=11, fast_hosts=()):
    rng = np.random.default_rng(5)
    lat = rng.integers(3_000_000, 40_000_000, (g, g)).astype(np.int64)
    lat = np.minimum(lat, lat.T)
    np.fill_diagonal(lat, 2_000_000)
    rate_up = rng.integers(2_000_000, 50_000_000, h)
    for i in fast_hosts:
        rate_up[i] = REF_MAX_RATE - i  # the uint64 edge of the bucket math
    return RefNetParams.build(
        host_node=rng.integers(0, g, h).astype(np.int32),
        rate_up=rate_up,
        rate_down=rng.integers(2_000_000, 50_000_000, h),
        latency_ns=lat,
        reliability=np.full((g, g), 0.97, np.float32),
        seed=seed,
        round_ns=ROUND_NS,
    )


def port_params(ref_params):
    return convert.net_params_from_arrays(
        {k: getattr(ref_params, k) for k in convert.FIELDS},
        ref_params.seed, ROUND_NS)


def planes(ref_params, n, ups=128):
    return (RefPlane(ref_params, n_shards=n, units_per_shard=ups),
            MeshDataPlane(port_params(ref_params), n_shards=n,
                          units_per_shard=ups, device="cpu"))


def random_batch(rng, h, n, t_now, uid_base):
    src = np.sort(rng.integers(0, h, n).astype(np.int32))
    dst = rng.integers(0, h, n).astype(np.int32)
    size = rng.integers(60, 15000, n).astype(np.int32)
    t_emit = np.sort(rng.integers(t_now, t_now + 2_000_000, n)).astype(
        np.int64)
    for s in np.unique(src):  # per-source emission order is FIFO
        m = src == s
        t_emit[m] = np.sort(t_emit[m])
    uid = np.arange(n, dtype=np.int64) + uid_base
    return src, dst, size, t_emit, uid


def assert_same_state(ref, port):
    for name in ("t_base", "tokens", "debt"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)


# -- _exchange_rounds ---------------------------------------------------------

def window(rng, h, total, case):
    """One causal window's units (emission order) for exchange_rounds."""
    src = rng.integers(0, h, total)
    dst = rng.integers(0, h, total)
    if case == "incast":  # every unit to one host: one destination shard
        dst[:] = 5
    t_arr = rng.integers(0, 10 ** 11, total)
    uid = rng.integers(0, 1 << 50, total)
    npk = rng.integers(1, 11, total)
    th = rng.choice(np.array([0, 1, 16106, 1 << 20, 1 << 24]), total)
    return src, dst, t_arr, uid, npk, th


@pytest.mark.parametrize("case, total", [
    ("mixed", 700), ("incast", 3000),
    # more than one 16,384-unit slice: two launches, one table each
    ("multi_slice", 20000)])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_exchange_rounds_matches_reference(n, case, total):
    ref, port = planes(make_params(13, seed=(1 << 32) + 7), n)
    rng = np.random.default_rng(n * 100 + total)
    win = window(rng, 13, total, case)
    want = ref.exchange_rounds(*win)
    got = port.exchange_rounds(*win)
    assert len(got) == len(want) == -(-total // 16384)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert port.phase["windows"] == len(got)
    # every unit comes back exactly once, with its arrival and its flag
    tab = np.concatenate(got)
    tab = tab[tab[:, F_FLAGS] >= 2]
    assert sorted(tab[:, F_UID].tolist()) == sorted(win[3].tolist())
    src, dst, t_arr, uid, npk, th = win
    flags = loss_flags(port.params.seed,
                       (uid & 0xFFFFFFFF).astype(np.uint32),
                       (uid >> 32).astype(np.uint32),
                       np.minimum(npk, 10).astype(np.uint32),
                       th.astype(np.uint32))
    by_uid = {int(r[F_UID]): r for r in tab}
    for i in range(total):
        r = by_uid[int(uid[i])]
        assert (r[F_TARR], r[F_FLAGS] & 1, r[F_DST]) == (
            t_arr[i], flags[i], dst[i] // n)


@pytest.mark.parametrize("m, w", [(256, 256), (256, 2048), (1024, 1024)])
@pytest.mark.parametrize("n", [1, 8])
def test_exchange_program_matches_reference(n, m, w):
    """The plain version against the jitted _exchange_rounds itself, on a
    packed (6, N, m) input with invalid slots, npkts outside [1, width] and
    thresholds up to 2**24; w up to N * m."""
    if w > n * m:
        w = n * m
    ref, _ = planes(make_params(13), n)
    rng = np.random.default_rng(m + w + n)
    u = np.zeros((6, n, m), np.int64)
    u[0] = rng.integers(0, 13, (n, m))
    u[1] = rng.integers(0, 10 ** 11, (n, m))
    u[2] = rng.integers(0, 1 << 50, (n, m))
    u[3] = rng.integers(-2, 70, (n, m))
    u[4] = rng.choice(np.array([0, 1, 9000, 1 << 24]), (n, m))
    u[5] = rng.random((n, m)) < 0.7
    recv, g_min = ref._get_exchange(m, w)(tuple(jnp.asarray(x) for x in u))
    got, g = mesh.exchange_rounds_plain(torch.from_numpy(u), ref._seed, 10, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(recv))
    assert int(g[0]) == int(g_min)


# -- _round_step --------------------------------------------------------------

def host_oracle(port_p, tb, src, dst, size, t_emit, t_now):
    dep = tb.depart_times(src, size, t_emit, t_now)
    sn, dn = port_p.host_node[src], port_p.host_node[dst]
    return dep + port_p.latency_ns[sn, dn], port_p.drop_thresh[sn, dn]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_round_step_matches_reference_and_host_oracle(n):
    """The port of tests/test_multichip.py::test_mesh_round_matches_host_
    plane: several stateful rounds, 13 hosts (a multiple of no shard
    count), against the reference plane and the host oracle."""
    h = 13
    ref, port = planes(make_params(h), n)
    tb = TokenBuckets(port.params)
    rng = np.random.default_rng(77)
    t_now, uid_base = 1_000_000, 1 << 40
    for rnd in range(4):
        k = int(rng.integers(5, 90))
        src, dst, size, t_emit, uid = random_batch(rng, h, k, t_now,
                                                   uid_base)
        uid_base += k
        want = ref.round_step(ref.shard_units(src, dst, size, t_emit, uid),
                              t_now=t_now)
        received, g_min, counters = port.round_step(
            port.shard_units(src, dst, size, t_emit, uid), t_now=t_now)
        np.testing.assert_array_equal(received, want[0])
        assert g_min == want[1]
        np.testing.assert_array_equal(counters, want[2])
        assert_same_state(ref, port)

        arr, th = host_oracle(port.params, tb, src, dst, size, t_emit, t_now)
        flags = loss_flags(port.params.seed,
                           (uid & 0xFFFFFFFF).astype(np.uint32),
                           (uid >> 32).astype(np.uint32),
                           np.minimum(np.maximum(1, -(-size // 1500)),
                                      10).astype(np.uint32), th)
        tab = received.reshape(-1, 4)
        got = {int(r[F_UID]): (int(r[F_TARR]), bool(r[F_FLAGS] & 1))
               for r in tab[tab[:, F_FLAGS] >= 2]}
        assert got == {int(uid[i]): (int(arr[i]), bool(flags[i]))
                       for i in range(k)}
        assert counters.tolist() == [int((~flags).sum()), int(flags.sum())]
        assert g_min == int(arr.min())
        for name in ("t_base", "tokens", "debt"):
            m = getattr(port, name).numpy()
            host = getattr(tb, name)
            assert [m[i % n, i // n] for i in range(h)] == host.tolist(), (
                rnd, name)
        t_now += 2_000_000


def edge_state(rng, ref, t_now):
    """A mid-run (N, Hs) bucket state mixing, host by host, the cases the
    closed form must get right: the uint64 edge (rate near MAX_RATE, a
    refill interval ending at a second's last nanosecond, and debt making
    need = k * rate + rate - 1), need <= 0 (a full bucket), a saturating
    rebase (idle since long ago), and plain random state."""
    n, hs = ref.n_shards, ref.hs
    rate = np.asarray(ref._tables[3]).reshape(hs, n).T
    cap = np.asarray(ref._tables[4]).reshape(hs, n).T
    t_base = np.zeros((n, hs), np.int64)
    tokens = np.zeros((n, hs), np.int64)
    debt = np.zeros((n, hs), np.int64)
    for s in range(n):
        for j in range(hs):
            r, c = int(rate[s, j]), int(cap[s, j])
            case = "edge" if r >= MAX_RATE - 100 else rng.choice(
                ["full", "idle", "random"])
            if case == "edge":
                t_base[s, j] = t_now - (3 * NS_PER_SEC + NS_PER_SEC - 1)
                debt[s, j] = 11 * r + r - 1 - 60
            elif case == "full":
                t_base[s, j], tokens[s, j] = t_now, c
            elif case == "idle":
                t_base[s, j], tokens[s, j] = t_now - 50 * NS_PER_SEC, c // 3
            else:
                t_base[s, j] = t_now - int(rng.integers(0, 3 * NS_PER_SEC))
                tokens[s, j] = int(rng.integers(0, c))
                debt[s, j] = int(rng.integers(0, 4 * c))
    return t_base, tokens, debt


@pytest.mark.parametrize("seed", [11, (1 << 32) + 11])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_round_step_from_carried_state(n, seed):
    """Both planes start mid-run from one state (the reference's arrays,
    carried over by convert.mesh_state_from_arrays) holding the uint64
    edge, need <= 0 rows and saturating rebases, and run three rounds with
    blackholed (rok = 0) units, a first unit of exactly 60 bytes at the
    edge hosts, and a seed above 2**32 (both key words)."""
    h = 13
    params = make_params(h, seed=seed, fast_hosts=(0, 1))
    ref, port = planes(params, n)
    rng = np.random.default_rng(n + seed % 97)
    t_now = 40 * NS_PER_SEC
    t_base, tokens, debt = edge_state(rng, ref, t_now)
    ref_state = tuple(jnp.asarray(a) for a in (t_base, tokens, debt))
    port.set_state(convert.mesh_state_from_arrays(t_base, tokens, debt))
    state_t = port.state
    uid_base = 1 << 36
    for rnd in range(3):
        k = int(rng.integers(20, 110))
        src, dst, size, t_emit, uid = random_batch(rng, h, k, t_now,
                                                   uid_base)
        src[:2] = 0
        size[:2] = 60
        src.sort(kind="stable")
        rok = rng.random(k) < 0.8
        uid_base += k
        units = ref.shard_units(src, dst, size, t_emit, uid, rok)
        recv, ref_state, g_min, counters = ref._step(
            ref_state, units, ref._tables, jnp.int64(t_now))
        got = mesh.round_step_plain(
            state_t, port.shard_units(src, dst, size, t_emit, uid, rok),
            port._tables, t_now, seed, 10)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(recv))
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.stack([np.asarray(a)
                                                for a in ref_state]))
        assert int(got[2][0]) == int(g_min)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(counters))
        # blackholed units charge their bucket but write no arrival row
        tab = got[0].numpy().reshape(-1, 4)
        assert (tab[:, F_FLAGS] >= 2).sum() == rok.sum()
        state_t = got[1]
        t_now += 3 * NS_PER_SEC + NS_PER_SEC - 1


@pytest.mark.parametrize("rate, x", [
    (MAX_RATE, NS_PER_SEC - 1), (MAX_RATE, 0), (MAX_RATE - 1, 7),
    (1, NS_PER_SEC - 1), (999_999_999, 123_456_789)])
def test_uint64_edge_of_the_bucket_math(rate, x):
    """rate * r // 1e9 and ceil(r * 1e9 / rate) reach 1.6e19 in the
    reference's uint64 products; the plain version's split stays exact."""
    r = torch.tensor([rate], dtype=torch.int64)
    for q in (0, 1, 1000):
        dt = torch.tensor([q * NS_PER_SEC + x], dtype=torch.int64)
        assert int(mesh._bytes_over(r, dt)[0]) == (
            rate * (q * NS_PER_SEC + x) // NS_PER_SEC)
    for need in (1, rate - 1, rate, 5 * rate + rate - 1, 7 * rate + x):
        got = int(mesh._ceil_ns(torch.tensor([need]), r)[0])
        assert got == -(-need * NS_PER_SEC // rate)


# -- _scan_rounds -------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 5, 20])
@pytest.mark.parametrize("n", [1, 8])
def test_scan_rounds_matches_reference(n, chunks):
    """K = 1, 8 and 32 (5 and 20 chunks pad to 8 and 32 with all-invalid
    steps), the bucket state carried across the fused rounds."""
    h = 13
    ref, port = planes(make_params(h, seed=(1 << 32) + 3), n, ups=64)
    rng = np.random.default_rng(chunks)
    t_now, uid_base, batch = 1_000_000, 1 << 30, []
    for _ in range(chunks):
        k = int(rng.integers(1, 40))
        src, dst, size, t_emit, uid = random_batch(rng, h, k, t_now,
                                                   uid_base)
        uid_base += k
        batch.append((port.shard_units_np(src, dst, size, t_emit, uid),
                      t_now))
        t_now += 2_000_000
    want = ref.scan_rounds(batch)
    got = port.scan_rounds(batch)
    assert len(got) == len(want) == chunks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert_same_state(ref, port)


def test_scan_program_pads_like_the_reference():
    """mesh_scan at K = 8 with three padded steps equals round_step_plain
    run step by step, and the padded steps leave the state as it was."""
    port = MeshDataPlane(port_params(make_params(13)), n_shards=2,
                         units_per_shard=32, device="cpu")
    rng = np.random.default_rng(4)
    steps = [port.shard_units_np(*random_batch(rng, 13, 20, 0, 1 << 20)[:5])
             for _ in range(5)] + [port.shard_units_np([], [], [], [], [])] * 3
    units = torch.from_numpy(np.stack([np.stack(s) for s in steps]))
    t_nows = torch.tensor([10 ** 6 * (j + 1) for j in range(5)] + [5 * 10 ** 6]
                          * 3)
    recv, state, g_min, counters = mesh.mesh_scan(
        port.state, units, port._tables, t_nows, port._seed, 10)
    st = port.state
    for j in range(8):
        r, st, g, c = mesh.round_step_plain(st, units[j], port._tables,
                                            int(t_nows[j]), port._seed, 10)
        assert torch.equal(r, recv[j]) and torch.equal(c, counters[j])
        assert int(g[0]) == int(g_min[j])
        if j >= 5:
            assert not (r[..., F_FLAGS] >= 2).any()
            assert int(g[0]) == mesh.INF
    assert torch.equal(st, state)


# -- routing, the plane and the wrappers --------------------------------------

def test_arrivals_route_to_destination_shards():
    """received[i] holds exactly the units addressed to shard i's hosts
    (dst % N == i), each with its shard-local destination id."""
    h, n = 8, 4
    port = MeshDataPlane(port_params(make_params(h)), n_shards=n,
                         units_per_shard=64, device="cpu")
    rng = np.random.default_rng(3)
    src, dst, size, t_emit, uid = random_batch(rng, h, 40, 0, 1 << 20)
    received, _, _ = port.round_step(
        port.shard_units(src, dst, size, t_emit, uid), t_now=0)
    by_uid_dst = {int(u): int(d) for u, d in zip(uid, dst)}
    seen = 0
    for i in range(n):
        tab = received[i].reshape(-1, 4)
        for row in tab[tab[:, F_FLAGS] >= 2]:
            d = by_uid_dst[int(row[F_UID])]
            assert d % n == i and int(row[F_DST]) == d // n
            seen += 1
    assert seen == 40


def test_cpu_plane_launches_no_kernel():
    mesh.reset_launches()
    ref, port = planes(make_params(13), 2)
    port.exchange_rounds(*window(np.random.default_rng(0), 13, 50, "mixed"))
    port.round_step(port.shard_units([0], [1], [100], [0], [1]), 0)
    assert mesh.LAUNCHES == {"mesh_exchange": 0, "mesh_round_step": 0,
                             "mesh_scan": 0}


def _units(n=2, m=256, dtype=torch.int64):
    return torch.zeros((6, n, m), dtype=dtype)


@pytest.mark.parametrize("bad, kwargs, err", [
    (_units(dtype=torch.int32), {}, TypeError),
    (_units()[:5], {}, ValueError),
    (_units()[:, :, ::2], {}, ValueError),
    (_units(), {"w": 0}, ValueError),
    (_units(), {"w": 513}, ValueError),
    (_units(n=33, m=8), {"w": 8}, ValueError),
    (_units(), {"max_pkts": 65}, ValueError),
])
def test_exchange_wrapper_rejects_bad_inputs(bad, kwargs, err):
    args = {"seed": 1, "max_pkts": 10, "w": 256}
    args.update(kwargs)
    with pytest.raises(err):
        mesh.mesh_exchange(bad, **args)


def test_round_wrappers_reject_bad_inputs():
    port = MeshDataPlane(port_params(make_params(13)), n_shards=2,
                         units_per_shard=16, device="cpu")
    units = port.shard_units([0], [1], [100], [0], [1])
    with pytest.raises(ValueError, match="units"):
        mesh.mesh_round_step(port.state, units[:, :1].contiguous(),
                             port._tables, 0, 1, 10)
    with pytest.raises(ValueError, match="tables"):
        mesh.mesh_round_step(port.state, units, port._tables[:4], 0, 1, 10)
    with pytest.raises(ValueError, match="t_now_k"):
        mesh.mesh_scan(port.state, units[None], port._tables,
                       torch.zeros(2, dtype=torch.int64), 1, 10)
    with pytest.raises(ValueError, match="state"):
        port.set_state(torch.zeros((3, 2, 5), dtype=torch.int64))


def test_mesh_state_from_arrays():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    st = convert.mesh_state_from_arrays(a, a + 1, a + 2)
    assert st.dtype == torch.int64 and tuple(st.shape) == (3, 2, 3)
    assert st[2].tolist() == (a + 2).tolist()
    with pytest.raises(ValueError, match="integer"):
        convert.mesh_state_from_arrays(a.astype(float), a, a)
    with pytest.raises(ValueError, match="N, Hs"):
        convert.mesh_state_from_arrays(a, a[:1], a)
