"""The mesh data plane: one simulation round as a sharded program.

The port of shadow_tpu/parallel/mesh.py. Hosts are sharded round-robin over
N shards (host h lives on shard h % N as local host h // N). Three
programs, one per granularity, each a hand-written CUDA kernel
(csrc/mesh.cu) beside a plain PyTorch version in this module:

1. ``mesh_round_step`` (replaces ``_round_step``) — ONE round, per-shard
   bucket state on the device:

    per-shard closed-form departures  (lazy rebase, segmented cumsum, debt)
    -> latency + threshold gather     (replicated (G,G) tables)
    -> per-packet threefry loss draws (pure function of unit identity)
    -> the arrival exchange           (route rows to their dst shards)
    -> global min + sent/dropped sums (the lookahead barrier, the counters)

2. ``mesh_scan`` (replaces ``_scan_rounds``) — K rounds in one launch, the
   bucket state carried from round to round.

3. ``mesh_exchange`` (replaces ``_exchange_rounds``) — the in-simulation
   collective behind ``scheduler_policy: tpu_mesh``: departures are closed
   form and computed host-side where emissions originate, so a whole causal
   window's deferrable rest — draws + arrival exchange + barrier minimum —
   runs as one program, however many rounds the window spans.

Two layouts (MeshDataPlane). The one-device layout holds all N shards'
bucket state as (N, Hs) tensors on one ``torch.device``, and the
reference's ``lax.all_to_all`` becomes the in-device exchange
``received[i] = send[:, i]``; the kernels run one block per shard. The
multi-device layout puts shard i on device entry i (devcfg.select_devices:
``--device cuda:0,cuda:1``, or one card named several times). A window's
exchange is ``mesh_exchange_entry``: one launch a card, one block an entry
it holds, each block storing its rows straight into every destination's
inbox (on its card, on a peer card over NVLink, or in mapped host memory:
``entry_plan`` gives each pair's route) and waiting on the other blocks'
release/acquire flags before it receives. The standalone rounds are
``mesh_rounds_entry``, the same way: one launch a card, one block an
entry running its shard's K rounds on its state in place, storing each
round's rows for every destination into that destination's rows inbox
(page-locked: the host reads it) and one trailer a round into its trailer
inbox, then waiting on the flags and reducing every source's trailers
into its own barrier minima and counters (``RoundStage``, kept per
(N, K, C) bucket).

Launch paths of the one-device layout, chosen by shape alone
(``exchange_path``, ``round_path``; csrc/mesh.cu says why): up to
CLUSTER_MAX shards a call is ONE launch of the N blocks as a thread block
cluster; above it the exchange runs as a send launch and a receive launch
and the rounds as a round launch and a reduce launch. The
exchange keeps its send rows in shared memory where N * m * 32 bytes fit
SMEM_MAX; the rounds keep their tables and bucket state in shared memory
where ``round_smem_bytes`` fits it. ``PATHS`` counts the launches of each.

Each wrapper checks dtypes, shapes, contiguity and device, runs the plain
version for CPU tensors and, for CUDA tensors, launches its kernel on the
current stream or raises: there is no fallback, and no quiet merge of
entries into one launch. ``LAUNCHES`` counts the kernel launches per
wrapper (plain runs are not launches), ``ENTRY_LAUNCHES`` the per-entry
wrappers' by entry.

Determinism: all math is integer (int64 times, uint32 hashes); the exchange
only permutes rows and every value is a pure function of unit identity, so
any shard count yields bit-identical simulations (tests/test_torch_mesh.py
holds the plain versions to the reference's programs with tolerance 0).
"""

from __future__ import annotations

import time as _walltime  # detlint: ok(wallclock): per-window wall attribution
from typing import NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.core.time import NS_PER_SEC
from shadow_tpu_torch.network.fluid import MAX_PKTS, MIN_CAP, MTU, NetParams
from shadow_tpu_torch.ops import devcfg
from shadow_tpu_torch.ops.propagate import _lane_draws

#: field order in the exchange table (int64): destination local host id,
#: arrival time (ns), uid (packed 64-bit), flags (bit0 dropped, bit1 valid)
F_DST, F_TARR, F_UID, F_FLAGS = range(4)

#: "no arrival" for the barrier minimum
INF = 1 << 62
#: shards a kernel launch supports (csrc/mesh.cu kMaxShards)
MAX_SHARDS = 32
#: shards that run as one thread block cluster (csrc/mesh.cu kClusterMax)
CLUSTER_MAX = 16
#: dynamic shared memory a mesh kernel asks for at most (kDynSmemMax)
SMEM_MAX = 200 * 1024
#: threads a block (kThreads) and src_l slots of a round prefetched into
#: shared memory (kSrcWin)
THREADS = 256
SRC_WIN = 2048
_M32 = 0xFFFFFFFF

#: kernel launches per wrapper since the last reset_launches(); only CUDA
#: launches count (the plain version on a CPU tensor is not a launch)
LAUNCHES = {"mesh_exchange": 0, "mesh_round_step": 0, "mesh_scan": 0,
            "mesh_exchange_entry": 0, "mesh_rounds_entry": 0}
#: the per-entry kernels' blocks by device entry index since the last
#: reset_launches(): the block of every entry a mesh_exchange_entry or
#: mesh_rounds_entry launch holds
ENTRY_LAUNCHES: dict = {}
#: wrapper calls per launch path since the last reset_launches(): the
#: exchange's three paths, the rounds' launch shape (cluster or pair) and
#: where their tables live (shared or device memory), and how a card's
#: mesh_rounds_entry launch keeps its blocks together (cluster or
#: cooperative; rounds_entry_path)
PATHS = {"exchange_cluster_smem": 0, "exchange_cluster_global": 0,
         "exchange_pair": 0, "rounds_cluster": 0, "rounds_pair": 0,
         "rounds_smem": 0, "rounds_global": 0, "entry_rounds_cluster": 0,
         "entry_rounds_cooperative": 0}
#: exchange_path's names, in csrc/mesh.cu's numbering of the paths
_EXCHANGE_PATHS = ("pair", "cluster_global", "cluster_smem")
#: int64 words of one block's table in mesh_exchange_entry (csrc/mesh.cu
#: EntryBlock: shard, 4 x MAX_SHARDS addresses, output, status, pad)
ENTRY_BLOCK_WORDS = 4 * MAX_SHARDS + 4
#: an entry's status words [code, late source, epoch, flag seen]: code
#: STATUS_PENDING (written by the host before a launch), STATUS_OK or
#: STATUS_LATE (a source's flag never came)
STATUS_PENDING, STATUS_OK, STATUS_LATE = -1, 0, 1
#: how long a block of mesh_exchange_entry or mesh_rounds_entry waits for
#: a source's flag: far past a call's microseconds, so only a source that
#: never publishes (a launch that never ran, a lost card) reaches it
ENTRY_TIMEOUT_NS = 10 * NS_PER_SEC
#: rounds of one mesh_rounds_entry call at most (csrc/mesh.cu kMaxRounds;
#: MeshDataPlane.SCAN_KMAX)
MAX_ROUNDS = 32
#: int64 words of one block's table in mesh_rounds_entry (csrc/mesh.cu
#: RoundBlock: shard, state, the five tables, output, status, pad, then
#: MAX_SHARDS each of rows, trailer and flag addresses of the destinations
#: and of its own trailers and flags)
ROUND_BLOCK_WORDS = 5 * MAX_SHARDS + 10


def reset_launches() -> None:
    for counts in (LAUNCHES, PATHS):
        for k in counts:
            counts[k] = 0
    ENTRY_LAUNCHES.clear()


def exchange_path(n: int, m: int) -> str:
    """How mesh_exchange runs N shards of m slots: ``cluster_smem`` (one
    cluster launch, the send rows in shared memory), ``cluster_global`` (one
    cluster launch, the send rows in device memory) or ``pair`` (a send and
    a receive launch, above CLUSTER_MAX shards)."""
    if n > CLUSTER_MAX:
        return "pair"
    return "cluster_smem" if 32 * n * m <= SMEM_MAX else "cluster_global"


def round_smem_bytes(hs: int, c: int, h_pad: int, g: int,
                     resident: bool) -> int:
    """Dynamic shared memory of the round kernel (csrc/mesh.cu
    round_smem_bytes): two buffers of a round's prefetched unit columns,
    plus, when ``resident``, the shard's bucket state, rate and cap (5 Hs),
    host_node (H_pad) and the latency and threshold tables (2 G^2), all
    int64."""
    words = 2 * (min(c, SRC_WIN) + 5 * min(c, THREADS))
    if resident:
        words += 5 * hs + h_pad + 2 * g * g
    return 8 * words


def round_path(n: int, hs: int, c: int, g: int) -> tuple:
    """(cluster, resident) for mesh_round_step and mesh_scan on N shards of
    Hs hosts, C slots and G nodes: one cluster launch up to CLUSTER_MAX
    shards; tables and state in shared memory where they fit SMEM_MAX."""
    return (n <= CLUSTER_MAX,
            round_smem_bytes(hs, c, n * hs, g, True) <= SMEM_MAX)


def rounds_entry_path(blocks: int) -> str:
    """How a card's mesh_rounds_entry launch keeps its ``blocks`` blocks
    resident together (they wait on each other's flags): ``cluster`` (one
    thread block cluster, up to CLUSTER_MAX blocks) or ``cooperative``
    (above it)."""
    return "cluster" if blocks <= CLUSTER_MAX else "cooperative"


# -- plain PyTorch versions ---------------------------------------------------

def _jidx(i: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather index rule: a negative index counts from the end, then
    the index clamps into [0, size)."""
    return torch.where(i < 0, i + size, i).clamp(0, size - 1)


def _bytes_over(rate: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """rate * dt // 1e9, exact. The reference multiplies rate by the
    sub-second remainder in uint64 (up to 1.6e19, past int64); torch has
    no uint64 division, so split rate = a * 1e9 + b:
    rate * r // 1e9 = a * r + b * r // 1e9, with b * r < 1e18."""
    q, r = dt // NS_PER_SEC, dt % NS_PER_SEC
    a, b = rate // NS_PER_SEC, rate % NS_PER_SEC
    return rate * q + a * r + (b * r) // NS_PER_SEC


def _ceil_ns(need: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """ceil(need * 1e9 / rate), exact: q * 1e9 + ceil(r * 1e9 / rate) with
    r * 1e9 = A * 1e4, A = r * 1e5 = q1 * rate + r1, so the ceiling is
    q1 * 1e4 + (r1 * 1e4 + rate - 1) // rate, every product below 2**63."""
    q, r = need // rate, need % rate
    big = r * 100_000
    q1, r1 = big // rate, big % rate
    return q * NS_PER_SEC + q1 * 10_000 + (r1 * 10_000 + rate - 1) // rate


def _drops(uid: torch.Tensor, lanes: torch.Tensor, th: torch.Tensor,
           seed: int, width: int) -> torch.Tensor:
    """(...) bool: some lane p < lanes of the unit draws a 24-bit value
    below th (lanes and th are int64 holding uint32 values)."""
    draws, valid = _lane_draws(uid & _M32, (uid >> 32) & _M32, lanes,
                               (seed & _M32, (seed >> 32) & _M32), width)
    return ((draws < th[..., None]) & valid).any(dim=-1)


def _rank(ds: torch.Tensor, n: int) -> torch.Tensor:
    """(N, M) destinations in [0, n] -> each unit's rank among the earlier
    units of its row with the same destination (the reference's stable
    argsort + searchsorted)."""
    onehot = torch.nn.functional.one_hot(ds, n + 1)
    return torch.gather(onehot.cumsum(dim=1), 2, ds[..., None])[..., 0] - 1


def exchange_rounds_plain(units: torch.Tensor, seed: int, max_pkts: int,
                          w: int):
    """Plain version of mesh_exchange (and of the reference's
    _exchange_rounds). ``units``: (6, N, m) int64 rows [dst_g, t_arr, uid,
    npkts, thresh, valid]. Returns (received (N, w, 4) int64 — shard i's
    arrival rows, valid rows first in (source shard, slot) order, then zero
    rows — and g_min (1,) int64, the earliest t_arr of any valid unit)."""
    dst, t_arr, uid, npk, th, valid_in = units
    n, m = dst.shape
    dev = units.device
    valid = valid_in != 0
    lanes = torch.clamp(npk, max=max_pkts) & _M32
    dropped = _drops(uid, lanes, th & _M32, seed, max_pkts) & valid
    ds = torch.where(valid, dst % n, n)
    rank = _rank(ds, n)
    flags = dropped.long() | (valid.long() << 1)
    payload = torch.stack([dst // n, t_arr, uid, flags], dim=-1)
    # destination n collects the invalid units (the reference's mode="drop")
    send = torch.zeros((n, n + 1, m, 4), dtype=torch.int64, device=dev)
    src = torch.arange(n, device=dev)[:, None].expand(n, m)
    send[src, ds, rank] = payload
    recv = send[:, :n].transpose(0, 1).reshape(n, n * m, 4)
    order = torch.argsort((recv[..., F_FLAGS] < 2).long(), dim=1,
                          stable=True)[:, :w]
    recv = torch.gather(recv, 1, order[..., None].expand(n, w, 4))
    g_min = torch.where(valid, t_arr, INF).min().reshape(1)
    return recv, g_min


def _round_rows(state: torch.Tensor, units: torch.Tensor, tables,
                t_now: int, seed: int, max_pkts: int, n: int,
                shards: torch.Tensor):
    """One round of shards ``shards`` (R,) of n, row b of ``state`` (3, R,
    Hs) and ``units`` (6, R, C) being shard shards[b]'s. Returns (received
    (n, R, C, 4): [d, b] the rows shard shards[b] routed to shard d, in
    slot order, zero rows after them; the new state; partials (R, 3)
    [sent, dropped, earliest t_arr of a routed unit])."""
    t_base, tokens, debt = state
    src_l, dst_g, size, t_emit, uid, rok = units
    r, hs = t_base.shape
    c = src_l.shape[1]
    host_node, lat_ns, thresh, rate_all, cap_all = tables
    h_pad, g = host_node.shape[0], lat_ns.shape[0]
    dev = state.device
    me = shards.to(dev)[:, None]
    my_global = torch.arange(hs, dtype=torch.int64, device=dev)[None] * n + me
    rate, cap = rate_all[my_global], cap_all[my_global]

    # lazy saturation rebase at the barrier (fluid.TokenBuckets.rebase)
    avail = tokens + _bytes_over(rate, t_now - t_base) - debt
    sat = avail > cap
    t_base = torch.where(sat, t_now, t_base)
    tokens = torch.where(sat, cap, tokens)
    debt = torch.where(sat, 0, debt)

    # per-source FIFO cumulative bytes (src-sorted; padding sorts last)
    valid = src_l < hs
    size_m = torch.where(valid, size, 0)
    csum = size_m.cumsum(dim=1)
    prev = torch.cat([torch.full((r, 1), -1, dtype=torch.int64, device=dev),
                      src_l[:, :-1]], dim=1)
    seg_base = torch.cummax(torch.where(src_l != prev, csum - size_m, 0),
                            dim=1).values
    sl = torch.clamp(src_l, max=hs - 1)
    slj = _jidx(sl, hs)

    def at(x):
        return torch.gather(x, 1, slj)

    need = at(debt) + (csum - seg_base) - at(tokens)
    t_ready = torch.where(need > 0, at(t_base) + _ceil_ns(need, at(rate)), 0)
    t_dep = torch.maximum(t_emit, t_ready)
    # debt commit (segment_sum: ids outside [0, Hs) are dropped)
    debt = debt.scatter_add(1, slj, torch.where(valid & (sl >= 0), size_m, 0))

    # latency + loss threshold gather
    src_g = sl * n + me
    sn = _jidx(host_node[_jidx(torch.clamp(src_g, max=h_pad - 1), h_pad)], g)
    dn = _jidx(host_node[_jidx(torch.clamp(dst_g, max=h_pad - 1), h_pad)], g)
    t_arr = t_dep + lat_ns[sn, dn]
    th = thresh[sn, dn] & _M32

    npkts = torch.clamp(-((-size) // MTU), min=1, max=max_pkts)
    route = valid & (rok != 0)
    dropped = _drops(uid, npkts, th, seed, max_pkts) & route

    # route arrivals to their destination shards
    ds = torch.where(route, dst_g % n, n)
    rank = _rank(ds, n)
    flags = dropped.long() | (route.long() << 1)
    payload = torch.stack([dst_g // n, t_arr, uid, flags], dim=-1)
    received = torch.zeros((n + 1, r, c, 4), dtype=torch.int64, device=dev)
    rows = torch.arange(r, device=dev)[:, None].expand(r, c)
    received[ds, rows, rank] = payload
    partials = torch.stack([(route & ~dropped).sum(dim=1),
                            dropped.sum(dim=1),
                            torch.where(route, t_arr, INF).min(dim=1).values],
                           dim=1)
    return received[:n], torch.stack([t_base, tokens, debt]), partials


def round_step_plain(state: torch.Tensor, units: torch.Tensor, tables,
                     t_now: int, seed: int, max_pkts: int):
    """Plain version of mesh_round_step (and of the reference's
    _round_step). ``state``: (3, N, Hs) int64 [t_base, tokens, debt];
    ``units``: (6, N, C) int64 rows [src_l, dst_g, size, t_emit, uid, rok],
    src-sorted within each shard with padding (src_l == Hs) last;
    ``tables``: (host_node (H_pad,), latency_ns (G, G), drop_thresh (G, G),
    rate (H_pad,), cap (H_pad,)), all int64. ``rok`` marks routable units:
    blackholed ones still charge their source bucket but produce no
    arrival row. Returns (received (N, N, C, 4) — received[i, j, c] = the
    c-th arrival shard j routed to shard i —, the new state, g_min (1,),
    counters (2,) [sent, dropped])."""
    n = state.shape[1]
    received, state, partials = _round_rows(
        state, units, tables, t_now, seed, max_pkts, n,
        torch.arange(n, dtype=torch.int64))
    g_min, counters = reduce_plain(partials[:, None])
    return received, state, g_min, counters[0]


def scan_rounds_plain(state: torch.Tensor, units_k: torch.Tensor, tables,
                      t_now_k: torch.Tensor, seed: int, max_pkts: int):
    """Plain version of mesh_scan (and of the reference's _scan_rounds):
    round_step_plain over ``units_k`` (K, 6, N, C) at ``t_now_k`` (K,), the
    state carried. Returns (received (K, N, N, C, 4), state, g_min (K,),
    counters (K, 2))."""
    recv, gmin, ct = [], [], []
    for j in range(units_k.shape[0]):
        r, state, g, cn = round_step_plain(state, units_k[j], tables,
                                           int(t_now_k[j]), seed, max_pkts)
        recv.append(r)
        gmin.append(g)
        ct.append(cn)
    return torch.stack(recv), state, torch.cat(gmin), torch.stack(ct)


# -- plain versions of the per-entry halves ---------------------------------
# One shard on its own device entry: the send half of exchange_rounds_plain
# on the source's entry, the receive half on the destination's from the
# blocks every source stored into its inbox; the rounds of one shard, their
# rows stored into every destination's inbox, then each entry's reduction
# of every source's partials. Composed over every shard they give the
# whole-mesh versions above.

def send_plain(units: torch.Tensor, s: int, seed: int,
               max_pkts: int) -> torch.Tensor:
    """Source shard s's half of exchange_rounds_plain (mesh_exchange_entry's
    send phase). ``units``: (6, N, m) int64 (only column block s is read).
    Returns (N, m + 1, 4) int64: block d holds the rows shard s sends to
    shard d in slot order, then zero rows, and in its row m [count, s's
    earliest valid t_arr (INF if none), 0, 0]."""
    dst, t_arr, uid, npk, th, valid_in = units[:, s]
    n, m = units.shape[1:]
    dev = units.device
    valid = valid_in != 0
    # the draws of the valid slots only: a window fills few of its m
    ok = valid.nonzero()[:, 0]
    dropped = torch.zeros(m, dtype=torch.bool, device=dev)
    if ok.numel():
        dropped[ok] = _drops(uid[ok],
                             torch.clamp(npk[ok], max=max_pkts) & _M32,
                             th[ok] & _M32, seed, max_pkts)
    ds = torch.where(valid, dst % n, n)
    rank = _rank(ds[None], n)[0]
    flags = dropped.long() | (valid.long() << 1)
    send = torch.zeros((n + 1, m + 1, 4), dtype=torch.int64, device=dev)
    send[ds, rank] = torch.stack([dst // n, t_arr, uid, flags], dim=-1)
    send[:, m, 0] = torch.bincount(ds, minlength=n + 1)
    send[:, m, 1] = torch.where(valid, t_arr, INF).min()
    return send[:n]


def recv_plain(gathered: torch.Tensor, w: int):
    """A destination's half of exchange_rounds_plain (mesh_exchange_entry's
    receive phase). ``gathered``: (N, m + 1, 4) int64, the destination's
    inbox: source j's block for it at [j] (send_plain's layout). Returns
    (recv (w, 4): the first w of the sent rows in (source, slot) order,
    then zero rows; g_min (1,): the earliest of the sources' minima)."""
    m = gathered.shape[1] - 1
    counts = gathered[:, m, 0]
    keep = torch.arange(m, device=gathered.device)[None] < counts[:, None]
    rows = gathered[:, :m][keep][:w]
    recv = torch.zeros((w, 4), dtype=torch.int64, device=gathered.device)
    recv[:rows.shape[0]] = rows
    return recv, gathered[:, m, 1].min().reshape(1)


def exchange_entry_plain(units: torch.Tensor, seed: int, max_pkts: int,
                         w: int):
    """Plain version of mesh_exchange_entry: every source shard's send half
    (send_plain), each destination d's inbox (N, m + 1, 4) made of block d
    of every source's rows in source order (the kernel's stores), and each
    destination's receive half (recv_plain). ``units``: (6, N, m) int64.
    Returns (recv (N, w, 4), g_min (N,)): entry d's rows and the barrier
    minimum as entry d computes it (every entry's is the same)."""
    n = units.shape[1]
    sends = torch.stack([send_plain(units, s, seed, max_pkts)
                         for s in range(n)])
    recv, g_min = zip(*(recv_plain(sends[:, d], w) for d in range(n)))
    return torch.stack(recv), torch.cat(g_min)


def rounds_entry_plain(state: torch.Tensor, units_k: torch.Tensor, tables,
                       t_now_k: torch.Tensor, s: int, n: int, seed: int,
                       max_pkts: int):
    """Shard s of n alone, K rounds (one block of mesh_rounds_entry).
    ``state``: (3, 1, Hs); ``units_k``: (K, 6, 1, C); ``t_now_k``: (K,);
    ``tables`` whole, as round_step_plain's. Returns (received (N, K, C,
    4): [d, j] the rows shard s routed to shard d in round j, zero rows
    after them; the state after the last round; partials (K, 3) [sent,
    dropped, earliest t_arr of a routed unit])."""
    recv, part = [], []
    shard = torch.tensor([s], dtype=torch.int64)
    for j in range(units_k.shape[0]):
        r, state, p = _round_rows(state, units_k[j], tables,
                                  int(t_now_k[j]), seed, max_pkts, n, shard)
        recv.append(r[:, 0])
        part.append(p[0])
    return torch.stack(recv, dim=1), state, torch.stack(part)


def reduce_plain(partials: torch.Tensor):
    """Every shard's partials (N, K, 3) -> (g_min (K,), counters (K, 2)
    [sent, dropped]): the barrier minimum and the counters of each
    round."""
    return (partials[..., 2].min(dim=0).values,
            torch.stack([partials[..., 0].sum(dim=0),
                         partials[..., 1].sum(dim=0)], dim=-1))


def rounds_entries_plain(states, units_k: torch.Tensor, tables,
                         t_now_k: torch.Tensor, seed: int, max_pkts: int,
                         rows: torch.Tensor = None):
    """Plain version of mesh_rounds_entry: every shard's K rounds alone
    (rounds_entry_plain), its counted rows of round j for destination d
    stored into d's rows inbox at ``rows[d, s, j]`` (only those rows, as
    the kernel's stores: rows past a count keep what an earlier call
    left) and their count at ``counts[d, s, j]``, then each entry's
    reduction of every source's partials (reduce_plain; every entry's is
    the same). ``states``: N (3, 1, Hs) int64; ``units_k``: (K, 6, N, C);
    ``tables`` whole; all on one device. ``rows``: the (N, N, K, C, 4)
    inboxes to store into, else fresh zeros. Returns (rows, counts (N, N,
    K), the N new states, g_min (N, K), counters (N, K, 2))."""
    k, _, n, c = units_k.shape
    dev = units_k.device
    if rows is None:
        rows = torch.zeros((n, n, k, c, 4), dtype=torch.int64, device=dev)
    counts = torch.zeros((n, n, k), dtype=torch.int64, device=dev)
    new_states, parts = [], []
    for s in range(n):
        recv, state, part = rounds_entry_plain(
            states[s], units_k[:, :, s:s + 1], tables, t_now_k, s, n, seed,
            max_pkts)
        # every routed row carries the valid bit, and they come first
        cnt = (recv[..., F_FLAGS] >> 1).sum(dim=-1)
        keep = torch.arange(c, device=dev) < cnt[..., None]
        rows[:, s][keep] = recv[keep]
        counts[:, s] = cnt
        new_states.append(state)
        parts.append(part)
    g_min, counters = reduce_plain(torch.stack(parts))
    return (rows, counts, new_states, g_min.expand(n, k),
            counters.expand(n, k, 2))


def read_rounds(rows: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The received tables of a mesh_rounds_entry call from its inboxes:
    (K, N, N, C, 4) [j, d, s] the first counts[d, s, j] rows of
    rows[d, s, j], zero rows after them (a reused inbox holds older rows
    there). ``rows``: (N, N, K, C, 4); ``counts``: (N, N, K)."""
    n, _, k, c, _ = rows.shape
    recv = np.zeros((k, n, n, c, 4), dtype=np.int64)
    top = int(counts.max(initial=0))
    if top:
        keep = np.arange(top) < counts[..., None]
        recv[:, :, :, :top] = np.where(keep[..., None], rows[:, :, :, :top],
                                       0).transpose(2, 0, 1, 3, 4)
    return recv


# -- wrappers -----------------------------------------------------------------

def _check(x: torch.Tensor, shape_len: int, what: str, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: {name} must be a torch.Tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"{what}: {name} must be int64, got {x.dtype}")
    if x.dim() != shape_len:
        raise ValueError(f"{what}: {name} must have {shape_len} dims, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _check_common(n: int, per_shard: int, max_pkts: int, what: str) -> None:
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"{what}: {n} shards, want 1..{MAX_SHARDS}")
    if per_shard < 1:
        raise ValueError(f"{what}: no unit slots")
    if not 1 <= max_pkts <= 64:
        raise ValueError(f"{what}: max_pkts must be in [1, 64], got "
                         f"{max_pkts}")


def _check_round(state, units, tables, what: str) -> None:
    _check(state, 3, what, "state")
    if state.shape[0] != 3:
        raise ValueError(f"{what}: state must be (3, N, Hs)")
    n, hs = state.shape[1:]
    if units.shape[-3:-1] != (6, n):
        raise ValueError(f"{what}: units must be (..., 6, {n}, C), got "
                         f"{tuple(units.shape)}")
    if len(tables) != 5:
        raise ValueError(f"{what}: tables must be (host_node, latency_ns, "
                         f"drop_thresh, rate, cap)")
    for name, t, d in zip(("host_node", "latency_ns", "drop_thresh", "rate",
                           "cap"), tables, (1, 2, 2, 1, 1)):
        _check(t, d, what, name)
        if t.device != state.device:
            raise ValueError(f"{what}: {name} is on {t.device}, state on "
                             f"{state.device}")
    h_pad = n * hs
    if any(t.shape != (h_pad,) for t in (tables[0], tables[3], tables[4])):
        raise ValueError(f"{what}: host tables must be ({h_pad},)")
    g = tables[1].shape[0]
    if tables[1].shape != (g, g) or tables[2].shape != (g, g):
        raise ValueError(f"{what}: latency_ns and drop_thresh must be (G, G)")
    if units.device != state.device:
        raise ValueError(f"{what}: units are on {units.device}, state on "
                         f"{state.device}")


def exchange_scratch(n: int, m: int, path: str, device) -> tuple:
    """Device scratch of one mesh_exchange launch on ``path``: (send
    (N, N, m, 4) int64 or None, counts (N, N) int32 or None, local_min (N,)
    int64 or None); the cluster kernels keep what they can in shared
    memory."""
    send = counts = local_min = None
    if path != "cluster_smem":
        send = torch.empty((n, n, m, 4), dtype=torch.int64, device=device)
    if path == "pair":
        counts = torch.empty((n, n), dtype=torch.int32, device=device)
        local_min = torch.empty(n, dtype=torch.int64, device=device)
    return send, counts, local_min


def _exchange_launch(units_ptr: int, n: int, m: int, w: int, seed: int,
                     max_pkts: int, path: str, scratch: tuple,
                     recv_ptr: int, g_min_ptr: int, dev, stream: int) -> None:
    """Launch mesh_exchange on ``path`` (csrc/mesh.cu shadow_mesh_exchange)
    on ``dev``'s ``stream`` and count it, or raise."""
    lib = devcfg.kernel_lib("mesh")
    with devcfg.current(dev):
        code = lib.shadow_mesh_exchange(
            units_ptr, n, m, w, seed & _M32, (seed >> 32) & _M32, max_pkts,
            _EXCHANGE_PATHS.index(path),
            *(None if t is None else t.data_ptr() for t in scratch),
            recv_ptr, g_min_ptr, stream)
    devcfg.check_launch(lib, code, "mesh_exchange")
    LAUNCHES["mesh_exchange"] += 1
    PATHS[f"exchange_{path}"] += 1


def mesh_exchange(units: torch.Tensor, seed: int, max_pkts: int, w: int):
    """One causal window's draws + arrival exchange + barrier minimum:
    (6, N, m) int64 -> (received (N, w, 4), g_min (1,)); see
    exchange_rounds_plain. CPU tensor: the plain version. CUDA tensor: the
    kernel on the current stream (on exchange_path's path), or an
    exception."""
    what = "mesh_exchange"
    _check(units, 3, what, "units")
    if units.shape[0] != 6:
        raise ValueError(f"{what}: units must be (6, N, m)")
    n, m = units.shape[1:]
    _check_common(n, m, max_pkts, what)
    if not 1 <= w <= n * m:
        raise ValueError(f"{what}: w must be in [1, {n * m}], got {w}")
    if units.device.type == "cpu":
        return exchange_rounds_plain(units, seed, max_pkts, w)
    dev = units.device
    path = exchange_path(n, m)
    recv = torch.empty((n, w, 4), dtype=torch.int64, device=dev)
    g_min = torch.empty(1, dtype=torch.int64, device=dev)
    _exchange_launch(units.data_ptr(), n, m, w, seed, max_pkts, path,
                     exchange_scratch(n, m, path, dev), recv.data_ptr(),
                     g_min.data_ptr(), dev,
                     torch.cuda.current_stream(dev).cuda_stream)
    return recv, g_min


def _launch_rounds(what, state, units, tables, k, t_now, t_now_k, seed,
                   max_pkts):
    """Launch mesh_round_step (k == 0: one round at t_now) or mesh_scan
    (k rounds at t_now_k) on round_path's path; the kernel writes the new
    state to a fresh tensor."""
    n, hs = state.shape[1:]
    c = units.shape[-1]
    g = tables[1].shape[0]
    dev = state.device
    steps = max(k, 1)
    cluster, resident = round_path(n, hs, c, g)
    lib = devcfg.kernel_lib("mesh")
    state_out = torch.empty_like(state)
    received = torch.empty((steps, n, n, c, 4), dtype=torch.int64,
                           device=dev)
    aux = torch.empty(steps * (3 * n + 3), dtype=torch.int64, device=dev)
    partials = aux[:steps * 3 * n]
    g_min = aux[steps * 3 * n:steps * (3 * n + 1)]
    counters = aux[steps * (3 * n + 1):].view(steps, 2)
    host_node, lat, thresh, rate, cap = tables
    with devcfg.current(dev):
        code = lib.shadow_mesh_rounds(
            state.data_ptr(), state_out.data_ptr(), n, hs, units.data_ptr(),
            c, k, t_now, None if t_now_k is None else t_now_k.data_ptr(),
            host_node.data_ptr(), n * hs, lat.data_ptr(), thresh.data_ptr(),
            g, rate.data_ptr(), cap.data_ptr(), seed & _M32,
            (seed >> 32) & _M32, max_pkts, int(cluster), int(resident),
            received.data_ptr(), partials.data_ptr(), g_min.data_ptr(),
            counters.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    devcfg.check_launch(lib, code, what)
    LAUNCHES[what] += 1
    PATHS["rounds_cluster" if cluster else "rounds_pair"] += 1
    PATHS["rounds_smem" if resident else "rounds_global"] += 1
    return received, state_out, g_min, counters


def mesh_round_step(state: torch.Tensor, units: torch.Tensor, tables,
                    t_now: int, seed: int, max_pkts: int):
    """One sharded round; arguments and results as round_step_plain. CPU
    tensors: the plain version. CUDA tensors: the kernel on the current
    stream (the new state is a new tensor, ``state`` is not written), or an
    exception. Padding (src_l == Hs) must come last in each shard's slots,
    as shard_units_np packs it."""
    what = "mesh_round_step"
    _check(units, 3, what, "units")
    _check_round(state, units, tables, what)
    _check_common(state.shape[1], units.shape[-1], max_pkts, what)
    if state.device.type == "cpu":
        return round_step_plain(state, units, tables, int(t_now), seed,
                                max_pkts)
    recv, state, g_min, counters = _launch_rounds(
        what, state, units, tables, 0, int(t_now), None, seed, max_pkts)
    return recv[0], state, g_min, counters[0]


def mesh_scan(state: torch.Tensor, units_k: torch.Tensor, tables,
              t_now_k: torch.Tensor, seed: int, max_pkts: int):
    """K sharded rounds in one launch; arguments and results as
    scan_rounds_plain. CPU tensors: the plain version. CUDA tensors: the
    kernel on the current stream, or an exception."""
    what = "mesh_scan"
    _check(units_k, 4, what, "units_k")
    _check_round(state, units_k, tables, what)
    _check_common(state.shape[1], units_k.shape[-1], max_pkts, what)
    k = units_k.shape[0]
    _check(t_now_k, 1, what, "t_now_k")
    if k < 1 or t_now_k.shape != (k,) or t_now_k.device != state.device:
        raise ValueError(f"{what}: t_now_k must be ({k},) on {state.device}")
    if state.device.type == "cpu":
        return scan_rounds_plain(state, units_k, tables, t_now_k, seed,
                                 max_pkts)
    return _launch_rounds(what, state, units_k, tables, k, 0, t_now_k, seed,
                          max_pkts)


# -- the per-entry wrappers ---------------------------------------------------
# One shard a device entry: each launch runs on its card's stream with that
# card current, as the raw CUDA calls need, and counts every block under
# its entry.

class EntryPlan(NamedTuple):
    """How mesh_exchange_entry runs over a tuple of card entries (see
    entry_plan)."""

    #: ((card index, (shard, ...)), ...): one launch a card, its entries'
    #: shards in order, the cards in the order of their first entry; the
    #: kernel runs a group as one cluster up to CLUSTER_MAX blocks, above it
    #: as one cooperative launch
    groups: tuple
    #: routes[i][d]: how source shard i's rows reach destination shard d's
    #: inbox: ``local`` (on the source's own card), ``peer`` (on a card the
    #: source reaches over NVLink) or ``host`` (in page-locked host memory
    #: both cards map)
    routes: tuple


def entry_plan(entries, can_access, host_only: bool = False) -> EntryPlan:
    """The launches and routes of mesh_exchange_entry over ``entries`` (card
    entries in shard order; one card may repeat). ``can_access(a, b)``:
    whether card a can store into card b's memory
    (torch.cuda.can_device_access_peer). A pair on one card is ``local``,
    a pair of cards with access ``peer``, any other pair ``host``.
    ``host_only`` routes every pair through host memory, the same card
    included (the card check runs that route on one card)."""
    entries = tuple(entries)
    if not 1 <= len(entries) <= MAX_SHARDS:
        raise ValueError(f"mesh_exchange_entry: {len(entries)} entries, "
                         f"want 1..{MAX_SHARDS}")
    if any(d.type != "cuda" or d.index is None for d in entries):
        raise ValueError(f"mesh_exchange_entry: every entry must be a card "
                         f"with its index, got {entries}")
    cards = [d.index for d in entries]
    routes = tuple(tuple(
        "host" if host_only else "local" if a == b
        else "peer" if can_access(a, b) else "host" for b in cards)
        for a in cards)
    return EntryPlan(tuple((d.index, ix) for d, ix in
                           devcfg.group_entries(entries)), routes)


#: ordered pairs of cards (source, destination) whose peer access is on
_PEER_ON: set = set()


def enable_peer(src: int, dst: int) -> None:
    """Let card ``src`` store into card ``dst``'s memory, once per ordered
    pair (csrc/mesh.cu shadow_mesh_enable_peer), or raise."""
    if (src, dst) in _PEER_ON:
        return
    lib = devcfg.kernel_lib("mesh")
    with devcfg.current(torch.device("cuda", src)):
        code = lib.shadow_mesh_enable_peer(dst)
    devcfg.check_launch(lib, code, f"peer access cuda:{src} -> cuda:{dst}")
    _PEER_ON.add((src, dst))


class ExchangeTimeout(RuntimeError):
    """A block of mesh_exchange_entry or mesh_rounds_entry waited past its
    limit for a source's rows: a source never published (its launch did
    not run, or its card was lost). The call is not retried and never
    falls back."""


def check_entry_status(status, epoch: int,
                       timeout_ns: int = ENTRY_TIMEOUT_NS,
                       what: str = "mesh_exchange_entry",
                       of: str = "window") -> None:
    """Raise unless every entry's status words (N, 4) [code, late source,
    epoch, flag seen] say its block of ``what`` received ``of`` (a window,
    or a call of the rounds) ``epoch``: ExchangeTimeout naming the entry,
    the source it waited for and the epoch; RuntimeError for a block that
    did not run."""
    rows = np.asarray(status, dtype=np.int64).reshape(-1, 4).tolist()
    for t, (code, src, ep, seen) in enumerate(rows):
        if code == STATUS_LATE:
            raise ExchangeTimeout(
                f"{what}: entry {t} waited {timeout_ns} ns for source "
                f"{src}'s rows of {of} epoch {ep} (its flag held {seen})")
    for t, (code, *_rest) in enumerate(rows):
        if code != STATUS_OK:
            raise RuntimeError(
                f"{what}: entry {t}'s block did not run for {of} epoch "
                f"{epoch} (status {code})")


def mesh_exchange_entry(units: torch.Tensor, seed: int, max_pkts: int,
                        w: int, plan: EntryPlan = None,
                        timeout_ns: int = ENTRY_TIMEOUT_NS):
    """One causal window's exchange with one shard a device entry: (6, N,
    m) int64 -> (recv (N, w, 4), g_min (N,)), entry t's rows and barrier
    minimum at [t]; see exchange_entry_plain. CPU tensor: the plain
    version. CUDA tensor: ``units`` is staged into a fresh EntryWindow over
    N entries of its card and mesh_exchange_entry runs once as ``plan``
    (default entry_plan's) launches it, on the card's current stream, then
    the one sync; the results are on ``units``' device. Raises
    ExchangeTimeout when a source never publishes within ``timeout_ns``."""
    what = "mesh_exchange_entry"
    _check(units, 3, what, "units")
    if units.shape[0] != 6:
        raise ValueError(f"{what}: units must be (6, N, m)")
    n, m = units.shape[1:]
    _check_common(n, m, max_pkts, what)
    if not 1 <= w <= n * m:
        raise ValueError(f"{what}: w must be in [1, {n * m}], got {w}")
    if units.device.type == "cpu":
        return exchange_entry_plain(units, seed, max_pkts, w)
    st = EntryWindow((units.device,) * n, n, m, w, plan)
    st.host_in.copy_(units)
    streams = [torch.cuda.current_stream(torch.device("cuda", card))
               for card, _ in st.plan.groups]
    st.launch(seed, max_pkts, 1, streams, timeout_ns)
    st.finish(1, streams, timeout_ns)
    recv = torch.from_numpy(np.stack([e.out[:4 * w] for e in st.stages]))
    g_min = torch.from_numpy(np.array([e.out[4 * w] for e in st.stages]))
    return recv.view(n, w, 4).to(units.device), g_min.to(units.device)


def _check_entry_tables(states, tables, n: int, what: str) -> None:
    """Each of the N entries' state (3, 1, Hs) and its copy of the tables
    (host tables (N Hs,), latency_ns and drop_thresh (G, G)), int64 and
    contiguous on the entry's device, every entry a card or every entry
    the CPU."""
    if len(states) != n or len(tables) != n:
        raise ValueError(f"{what}: {n} shards want {n} states and {n} "
                         f"table sets, got {len(states)} and {len(tables)}")
    if len({st.device.type for st in states}) != 1:
        raise ValueError(f"{what}: the entries mix cpu and cuda")
    hs = states[0].shape[-1]
    g = tables[0][1].shape[0]
    for t, (st, tab) in enumerate(zip(states, tables)):
        _check(st, 3, what, f"states[{t}]")
        if tuple(st.shape) != (3, 1, hs):
            raise ValueError(f"{what}: states[{t}] must be (3, 1, {hs}), got "
                             f"{tuple(st.shape)}")
        if len(tab) != 5:
            raise ValueError(f"{what}: tables[{t}] must be (host_node, "
                             f"latency_ns, drop_thresh, rate, cap)")
        for name, x, shape in zip(
                ("host_node", "latency_ns", "drop_thresh", "rate", "cap"),
                tab, ((n * hs,), (g, g), (g, g), (n * hs,), (n * hs,))):
            _check(x, len(shape), what, name)
            if tuple(x.shape) != shape or x.device != st.device:
                raise ValueError(f"{what}: tables[{t}]'s {name} must be "
                                 f"{shape} on {st.device}, got "
                                 f"{tuple(x.shape)} on {x.device}")


def mesh_rounds_entry(states, units_k: torch.Tensor, tables,
                      t_now_k: torch.Tensor, seed: int, max_pkts: int,
                      plan: EntryPlan = None,
                      timeout_ns: int = ENTRY_TIMEOUT_NS):
    """K rounds of N shards with one shard a device entry. ``states``: N
    (3, 1, Hs) int64 tensors, shard t's on entry t's device, advanced in
    place; ``units_k``: (K, 6, N, C) int64, K up to MAX_ROUNDS, shard s's
    slots at [:, :, s] as shard_units_np packs them; ``tables``: N tuples
    (host_node, latency_ns, drop_thresh, rate, cap), entry t's on its
    device; ``t_now_k``: (K,). Returns (received (K, N, N, C, 4): [j, d,
    s] the rows shard s routed to shard d in round j, zero rows after
    them; g_min (N, K) and counters (N, K, 2) [sent, dropped] as entry t
    reduced them, at [t]), on the CPU. CPU entries: the plain version
    (rounds_entries_plain). Cards: the units staged into a fresh
    RoundStage and mesh_rounds_entry run once as ``plan`` (default
    entry_plan's) launches it, on each card's current stream, then one
    sync a card; raises ExchangeTimeout when a source never publishes
    within ``timeout_ns``."""
    what = "mesh_rounds_entry"
    _check(units_k, 4, what, "units_k")
    k, six, n, c = units_k.shape
    if six != 6 or not 1 <= k <= MAX_ROUNDS:
        raise ValueError(f"{what}: units_k must be (K, 6, N, C) with K in "
                         f"1..{MAX_ROUNDS}, got {tuple(units_k.shape)}")
    _check_common(n, c, max_pkts, what)
    _check(t_now_k, 1, what, "t_now_k")
    if tuple(t_now_k.shape) != (k,):
        raise ValueError(f"{what}: t_now_k must be ({k},)")
    stage = RoundStage(tuple(st.device for st in states), n, k, c, states,
                       tables, plan)
    stage.units[...] = units_k.cpu().numpy()
    stage.t_now[...] = t_now_k.cpu().numpy()
    streams = None
    if stage.cuda:
        streams = [torch.cuda.current_stream(torch.device("cuda", card))
                   for card, _ in stage.plan.groups]
    stage.run(seed, max_pkts, 1, streams, timeout_ns)
    return tuple(torch.from_numpy(x) for x in stage.read())

# -- the plane ----------------------------------------------------------------

class ExchangeStage:
    """The buffers of one exchange bucket (N, m, w), made once and kept for
    the plane's life: the packed (6, N, m) units in host memory (``units``,
    a numpy view; page-locked on a card) and, on a card, the launch's
    scratch, the output (recv (N, w, 4) then g_min, contiguous) in
    page-locked host memory (``out``) and one CUDA event. The kernel reads
    the units from and writes the output to the page-locked buffers in
    place, through their device addresses, so a window queues no copy: one
    cudaMemcpyAsync each way around the kernel cost more card time and more
    host time a window of tgen_1k's floor-0 run (PERF.md)."""

    def __init__(self, n: int, m: int, w: int, device) -> None:
        self.shape = (n, m, w)
        cuda = device.type == "cuda"
        self.host_in = torch.zeros((6, n, m), dtype=torch.int64,
                                   pin_memory=cuda)
        self.units = self.host_in.numpy()
        if not cuda:
            return
        self.path = exchange_path(n, m)
        self.scratch = exchange_scratch(n, m, self.path, device)
        self.host_out = torch.empty(4 * n * w + 1, dtype=torch.int64,
                                    pin_memory=True)
        self.out = self.host_out.numpy()
        self.event = torch.cuda.Event()
        with devcfg.current(device):
            out = devcfg.device_pointer(self.host_out, "mesh")
            self._ptrs = (devcfg.device_pointer(self.host_in, "mesh"), out,
                          out + 8 * 4 * n * w)
        self.device = device

    def launch(self, seed: int, max_pkts: int, stream) -> None:
        """Queue mesh_exchange on ``units`` into ``out`` on ``stream``."""
        n, m, w = self.shape
        units, recv, g_min = self._ptrs
        _exchange_launch(units, n, m, w, seed, max_pkts, self.path,
                         self.scratch, recv, g_min, self.device,
                         stream.cuda_stream)

    def dispatch(self, seed: int, max_pkts: int, stream) -> None:
        """Run mesh_exchange on ``units`` into ``out`` on ``stream`` and
        wait for it on the event."""
        self.launch(seed, max_pkts, stream)
        self.event.record(stream)
        self.event.synchronize()


class EntryStage:
    """One card entry's buffers of exchange bucket (N, m, w), made once and
    kept for the plane's life: its inbox (N, m + 1, 4), source j's block at
    [j], and its N flags on its card; the same in page-locked host memory
    when some source reaches it only through the host (``host``); and its
    output in page-locked host memory, which its block writes in place: its
    w rows, g_min, then its status words [code, late source, epoch, flag
    seen]. The flags start at 0 and are never reset (epochs start at 1)."""

    def __init__(self, dev, n: int, m: int, w: int, host: bool) -> None:
        self.dev = dev
        self.m = m
        self.inbox = torch.empty((n, m + 1, 4), dtype=torch.int64, device=dev)
        self.flags = torch.zeros(n, dtype=torch.int64, device=dev)
        self.host_out = torch.empty(4 * w + 5, dtype=torch.int64,
                                    pin_memory=True)
        self.out = self.host_out.numpy()
        self.status = self.out[4 * w + 1:]
        with devcfg.current(dev):
            self.out_ptr = devcfg.device_pointer(self.host_out, "mesh")
            if host:
                self.host_inbox = torch.empty((n, m + 1, 4),
                                              dtype=torch.int64,
                                              pin_memory=True)
                self.host_flags = torch.zeros(n, dtype=torch.int64,
                                              pin_memory=True)
                self.host_ptrs = tuple(devcfg.device_pointer(t, "mesh") for t
                                       in (self.host_inbox, self.host_flags))

    def slot(self, j: int, route: str) -> tuple:
        """The card addresses of source j's inbox block and flag here, on
        ``route``."""
        inbox, flags = (self.host_ptrs if route == "host" else
                        (self.inbox.data_ptr(), self.flags.data_ptr()))
        return inbox + j * (self.m + 1) * 32, flags + 8 * j


class EntryWindow:
    """The buffers of exchange bucket (N, m, w) over device entries: the
    packed (6, N, m) units in host memory (``units``, a numpy view;
    page-locked when the entries are cards, where every block reads its
    shard's slots in place) and, on cards, one EntryStage an entry, each
    launch group's block table on its card (csrc/mesh.cu EntryBlock) and
    one CUDA event a group. ``plan`` (entry_plan's by default) may launch
    fewer than every shard: the others' blocks then never publish."""

    def __init__(self, entries: tuple, n: int, m: int, w: int,
                 plan: EntryPlan = None) -> None:
        self.shape = (n, m, w)
        cuda = entries[0].type == "cuda"
        self.host_in = torch.zeros((6, n, m), dtype=torch.int64,
                                   pin_memory=cuda)
        self.units = self.host_in.numpy()
        if not cuda:
            return
        if plan is None:
            plan = entry_plan(entries, torch.cuda.can_device_access_peer)
        _prepare_plan(plan, entries, n, "mesh_exchange_entry")
        self.plan = plan
        routes = plan.routes
        with devcfg.current(entries[0]):
            self.in_ptr = devcfg.device_pointer(self.host_in, "mesh")
        self.stages = [EntryStage(dev, n, m, w,
                                  any(routes[j][t] == "host"
                                      for j in range(n)))
                       for t, dev in enumerate(entries)]
        self.tables = []
        k = MAX_SHARDS
        for card, shards in plan.groups:
            tab = np.zeros((len(shards), ENTRY_BLOCK_WORDS), dtype=np.int64)
            for b, s in enumerate(shards):
                tab[b, 0] = s
                for d in range(n):
                    tab[b, [1 + d, 1 + k + d]] = self.stages[d].slot(
                        s, routes[s][d])
                    tab[b, [1 + 2 * k + d, 1 + 3 * k + d]] = \
                        self.stages[s].slot(d, routes[d][s])
                tab[b, 1 + 4 * k] = self.stages[s].out_ptr
                tab[b, 2 + 4 * k] = self.stages[s].out_ptr + 8 * (4 * w + 1)
            self.tables.append(torch.from_numpy(tab).to(
                torch.device("cuda", card)))
        self.events = [torch.cuda.Event() for _ in plan.groups]
        for card, _ in plan.groups:
            # the zeroed flags and the tables land before any launch
            torch.cuda.synchronize(card)

    def launch(self, seed: int, max_pkts: int, epoch: int, streams,
               timeout_ns: int = ENTRY_TIMEOUT_NS) -> None:
        """Queue mesh_exchange_entry on ``units`` for window ``epoch`` (a
        value no flag of this window holds yet), one launch a group of the
        plan on its stream of ``streams``, and count it; every entry's
        status reads STATUS_PENDING until its block ends."""
        n, m, w = self.shape
        lib = devcfg.kernel_lib("mesh")
        for e in self.stages:
            e.status[0] = STATUS_PENDING
        for (_card, shards), tab, stream in zip(self.plan.groups, self.tables,
                                                streams):
            with devcfg.current(tab.device):
                code = lib.shadow_mesh_exchange_entry(
                    self.in_ptr, n * m, n, m, w, seed & _M32,
                    (seed >> 32) & _M32, max_pkts, epoch, timeout_ns,
                    tab.data_ptr(), len(shards), stream.cuda_stream)
            devcfg.check_launch(lib, code, "mesh_exchange_entry")
            LAUNCHES["mesh_exchange_entry"] += 1
            for s in shards:
                ENTRY_LAUNCHES[s] = ENTRY_LAUNCHES.get(s, 0) + 1

    def finish(self, epoch: int, streams,
               timeout_ns: int = ENTRY_TIMEOUT_NS) -> None:
        """Wait for the launches of window ``epoch`` (one event a group on
        its stream of ``streams``), then check every entry's status (see
        check_entry_status)."""
        for ev, stream in zip(self.events, streams):
            ev.record(stream)
        for ev in self.events:
            ev.synchronize()
        if any(e.status[0] != STATUS_OK for e in self.stages):
            check_entry_status(np.stack([e.status for e in self.stages]),
                               epoch, timeout_ns)


def _prepare_plan(plan: EntryPlan, entries: tuple, n: int,
                  what: str) -> None:
    """Raise unless ``plan`` fits the N ``entries``; enable peer access for
    every pair it routes over NVLink."""
    routes = plan.routes
    if len(routes) != n or any(len(r) != n for r in routes) or any(
            entries[s].index != card for card, shards in plan.groups
            for s in shards):
        raise ValueError(f"{what}: the plan {plan} does not fit {n} entries "
                         f"{entries}")
    for i in range(n):
        for d in range(n):
            if routes[i][d] == "peer":
                enable_peer(entries[i].index, entries[d].index)


class RoundAddrs(NamedTuple):
    """The card addresses of one entry's part of a RoundStage (see
    round_block_table)."""

    #: its (3, 1, Hs) state
    state: int
    #: its host_node, latency_ns, drop_thresh, rate and cap
    tables: tuple
    #: its rows inbox (N, K, C, 4), source j's block at [j]
    rows: int
    #: (its trailer inbox (N, K, 4), its flags (N,)) on its card
    card: tuple
    #: the same in page-locked host memory, or None where no route into it
    #: is ``host``
    host: tuple
    #: its output: g_min (K,), counters (K, 2), counts (N, K)
    out: int
    #: its status words [code, late source, epoch, flag seen]
    status: int


def round_block_table(shards, routes, addrs, k: int, c: int) -> np.ndarray:
    """The block table of one card's mesh_rounds_entry launch (csrc/mesh.cu
    RoundBlock, ROUND_BLOCK_WORDS int64 words a block): block b runs shard
    ``shards[b]``. ``routes`` is entry_plan's; ``addrs`` every entry's
    RoundAddrs, in shard order. A source s stores into destination d's
    rows inbox at block s, and into d's trailer inbox and flag for s on
    the route routes[s][d] (host: d's page-locked copies; else d's card)."""
    n = len(addrs)
    mx = MAX_SHARDS

    def slot(t: int, j: int, route: str) -> tuple:
        trailers, flags = addrs[t].host if route == "host" else addrs[t].card
        return trailers + j * k * 32, flags + 8 * j

    tab = np.zeros((len(shards), ROUND_BLOCK_WORDS), dtype=np.int64)
    for b, s in enumerate(shards):
        a = addrs[s]
        tab[b, :9] = (s, a.state, *a.tables, a.out, a.status)
        for d in range(n):
            tab[b, 10 + d] = addrs[d].rows + s * k * c * 32
            tab[b, [10 + mx + d, 10 + 2 * mx + d]] = slot(d, s, routes[s][d])
            tab[b, [10 + 3 * mx + d, 10 + 4 * mx + d]] = slot(s, d,
                                                              routes[d][s])
    return tab


class RoundStage:
    """The buffers of round bucket (N, K, C) over device entries, made once
    and kept, bound to the entries' ``states`` (N (3, 1, Hs), advanced in
    place) and ``tables`` (N tuples, each entry's copy): the packed (K, 6,
    N, C) units and t_now_k (``units``, ``t_now``); the rows inboxes
    (``rows``, (N, N, K, C, 4): destination d's from source s at [d, s]);
    one output row an entry (``out``, (N, 3 K + N K + 4): its g_min (K,),
    counters (K, 2), the counts (N, K) of its rows inbox, status words).
    On cards these are page-locked: the blocks read the units and store
    their rows and outputs in place, and the host reads the rows (no copy
    on either side). Also on cards: each entry's trailer inbox (N, K, 4)
    and flags (N,) on its card, and in page-locked memory where a source
    reaches it only through the host; each launch group's block table
    (round_block_table) on its card; one event a group. The flags start
    at 0 and are never reset (epochs start at 1). ``plan``
    (entry_plan's by default) may launch fewer than every shard: the
    others' blocks then never publish."""

    def __init__(self, entries: tuple, n: int, k: int, c: int, states,
                 tables, plan: EntryPlan = None) -> None:
        _check_entry_tables(states, tables, n, "mesh_rounds_entry")
        self.shape = (n, k, c)
        self.states, self.tables = states, tables
        self.cuda = entries[0].type == "cuda"
        words = 3 * k + n * k + 4

        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int64, pin_memory=self.cuda)

        self.host_units = buf(k, 6, n, c)
        self.host_t_now = buf(k)
        # a call stores only its counted rows, and reads take only those
        self.host_rows = buf(n, n, k, c, 4)
        self.host_out = buf(n, words)
        self.units, self.t_now, self.rows, self.out = (
            t.numpy() for t in (self.host_units, self.host_t_now,
                                self.host_rows, self.host_out))
        self.status = self.out[:, words - 4:]
        if not self.cuda:
            return
        what = "mesh_rounds_entry"
        if plan is None:
            plan = entry_plan(entries, torch.cuda.can_device_access_peer)
        _prepare_plan(plan, entries, n, what)
        self.plan = plan
        hs, g = states[0].shape[2], tables[0][1].shape[0]
        self._dims = (hs, n * hs, g, int(
            round_smem_bytes(hs, c, n * hs, g, True) <= SMEM_MAX))
        with devcfg.current(entries[0]):
            units, t_now, rows, out = (devcfg.device_pointer(t, "mesh") for t
                                       in (self.host_units, self.host_t_now,
                                           self.host_rows, self.host_out))
        self._in_ptrs = (units, t_now)
        #: every trailer inbox and flag tensor, kept alive with the stage
        self._inboxes = []
        addrs = []
        for t, dev in enumerate(entries):
            card = (torch.zeros((n, k, 4), dtype=torch.int64, device=dev),
                    torch.zeros(n, dtype=torch.int64, device=dev))
            self._inboxes += card
            host = None
            if any(plan.routes[j][t] == "host" for j in range(n)):
                pinned = (torch.zeros((n, k, 4), dtype=torch.int64,
                                      pin_memory=True),
                          torch.zeros(n, dtype=torch.int64, pin_memory=True))
                self._inboxes += pinned
                with devcfg.current(dev):
                    host = tuple(devcfg.device_pointer(x, "mesh")
                                 for x in pinned)
            addrs.append(RoundAddrs(
                states[t].data_ptr(), tuple(x.data_ptr() for x in tables[t]),
                rows + t * n * k * c * 32, tuple(x.data_ptr() for x in card),
                host, out + t * words * 8, out + (t * words + words - 4) * 8))
        self.block_tables = [
            torch.from_numpy(round_block_table(shards, plan.routes, addrs, k,
                                               c)).to(torch.device("cuda",
                                                                   card))
            for card, shards in plan.groups]
        self.events = [torch.cuda.Event() for _ in plan.groups]
        for card, _ in plan.groups:
            # the zeroed flags and the tables land before any launch
            torch.cuda.synchronize(card)

    def launch(self, seed: int, max_pkts: int, epoch: int, streams,
               timeout_ns: int = ENTRY_TIMEOUT_NS) -> None:
        """Queue mesh_rounds_entry on the staged units for call ``epoch``
        (a value no flag of this stage holds yet), one launch a group of
        the plan on its stream of ``streams`` (rounds_entry_path's), and
        count it; every entry's status reads STATUS_PENDING until its
        block ends."""
        n, k, c = self.shape
        hs, h_pad, g, resident = self._dims
        lib = devcfg.kernel_lib("mesh")
        self.status[:, 0] = STATUS_PENDING
        for (_card, shards), tab, stream in zip(self.plan.groups,
                                                self.block_tables, streams):
            path = rounds_entry_path(len(shards))
            with devcfg.current(tab.device):
                code = lib.shadow_mesh_rounds_entry(
                    *self._in_ptrs, n, hs, c, k, h_pad, g, seed & _M32,
                    (seed >> 32) & _M32, max_pkts, resident, epoch,
                    timeout_ns, tab.data_ptr(), len(shards),
                    int(path == "cooperative"), stream.cuda_stream)
            devcfg.check_launch(lib, code, "mesh_rounds_entry")
            LAUNCHES["mesh_rounds_entry"] += 1
            PATHS[f"entry_rounds_{path}"] += 1
            for s in shards:
                ENTRY_LAUNCHES[s] = ENTRY_LAUNCHES.get(s, 0) + 1

    def finish(self, epoch: int, streams,
               timeout_ns: int = ENTRY_TIMEOUT_NS) -> None:
        """Wait for the launches of call ``epoch`` (one event a group on its
        stream of ``streams``), then check every entry's status (see
        check_entry_status)."""
        for ev, stream in zip(self.events, streams):
            ev.record(stream)
        for ev in self.events:
            ev.synchronize()
        if (self.status[:, 0] != STATUS_OK).any():
            check_entry_status(self.status, epoch, timeout_ns,
                               "mesh_rounds_entry", "call")

    def run(self, seed: int, max_pkts: int, epoch: int, streams=None,
            timeout_ns: int = ENTRY_TIMEOUT_NS) -> None:
        """One call on the staged units and times: on cards launch, then
        finish; on CPU entries the plain version (rounds_entries_plain) into
        the same inboxes and outputs, the states advanced in place."""
        if self.cuda:
            self.launch(seed, max_pkts, epoch, streams, timeout_ns)
            self.finish(epoch, streams, timeout_ns)
            return
        n, k, _c = self.shape
        _rows, counts, states, g_min, counters = rounds_entries_plain(
            self.states, self.host_units, self.tables[0], self.host_t_now,
            seed, max_pkts, self.host_rows)
        for st, new in zip(self.states, states):
            st.copy_(new)
        self.out[:, :k] = g_min.numpy()
        self.out[:, k:3 * k] = counters.reshape(n, 2 * k).numpy()
        self.out[:, 3 * k:3 * k + n * k] = counts.reshape(n, n * k).numpy()
        self.status[:] = (STATUS_OK, 0, epoch, epoch)

    def read(self) -> tuple:
        """The last call's results as numpy, the caller's own: (received
        (K, N, N, C, 4) from the rows inboxes (read_rounds), g_min (N, K)
        and counters (N, K, 2) as each entry reduced them)."""
        n, k, _c = self.shape
        counts = self.out[:, 3 * k:3 * k + n * k].reshape(n, n, k)
        return (read_rounds(self.rows, counts), self.out[:, :k].copy(),
                self.out[:, k:3 * k].reshape(n, k, 2).copy())


class MeshDataPlane:
    """Host-sharded data plane over N shards.

    Usage: build with NetParams, feed per-round unit batches with
    ``round_step``, fuse K rounds per launch with ``scan_rounds``, or
    resolve a causal window's units with ``exchange_rounds`` (the tpu_mesh
    policy). The bucket state is the (3, N, Hs) ``state`` ([t_base,
    tokens, debt]; row i = shard i's hosts).

    Two layouts, the reference's signature for both. ``devices=None``: every
    shard on the one device ``device`` names (its entry 0), each call one
    launch of the N shard blocks (mesh_exchange, mesh_round_step,
    mesh_scan). A ``devices`` tuple (entries of devcfg.select_devices; an
    entry may repeat): shard i on ``devices[i]``, N = n_shards or every
    entry, and more shards than entries raise, as the reference does. Each
    entry holds the tables and its shard's state (3, 1, Hs), which the
    rounds advance in place. A window is one mesh_exchange_entry launch a
    card and a call of the rounds one mesh_rounds_entry launch a card (the
    plan, entry_plan's, built once: each card's entries and each pair's
    route), each with one event and one sync a card, on a stream of the
    plane's a card. Entries that name the same card stay separate
    entries, each with its own block, inboxes and flags: nothing merges
    them. CPU entries run the plain versions, the same halves.
    """

    #: fused-launch cap: scan_rounds pads each group of round chunks to K in
    #: (1, 8, SCAN_KMAX); longer backlogs run as several launches (the
    #: state carries on the device between them)
    SCAN_KMAX = 32
    #: window-slice widths for the exchange: the smallest bucket that fits
    #: the per-shard slot demand wins; bigger backlogs run as several slices
    EXCHANGE_BUCKETS = (256, 1024, 4096, 16384)

    def __init__(self, params: NetParams, n_shards: int | None = None,
                 units_per_shard: int = 1024, devices=None,
                 max_pkts: int = MAX_PKTS, device: str = "cuda") -> None:
        if devices is None:
            self.device = devcfg.select_device(device)
            n = n_shards or devcfg.visible_devices(device)
            self.entries = None
        else:
            entries = tuple(devices)
            n = n_shards or len(entries)
            if n > len(entries):
                raise ValueError(f"{n} shards > {len(entries)} devices")
            self.entries = entries[:n]
            self.device = self.entries[0]
        if not 1 <= n <= MAX_SHARDS:
            raise ValueError(f"{n} shards (want 1..{MAX_SHARDS})")
        #: exchange buffers by (N, m, w): at most 16 shapes (the buckets)
        self._stages: dict = {}
        #: over entries, the rounds' buffers by K in (1, 8, SCAN_KMAX)
        self._round_stages: dict = {}
        self.n_shards = n
        self.units_per_shard = int(units_per_shard)
        self.params = params
        self._seed = int(params.seed)
        self._max_pkts = int(max_pkts)
        #: per-window wall attribution for the collective (exchange_rounds)
        self.phase = {"build": 0.0, "dispatch": 0.0, "readback": 0.0,
                      "windows": 0}
        self._cuda = self.device.type == "cuda"

        h = params.rate_up.shape[0]
        self.h_pad = -(-h // n) * n
        self.hs = self.h_pad // n
        rate = np.ones(self.h_pad, dtype=np.int64)
        cap = np.full(self.h_pad, MIN_CAP, dtype=np.int64)
        rate[:h] = params.rate_up
        cap[:h] = params.cap_up
        node = np.zeros(self.h_pad, dtype=np.int64)
        node[:h] = params.host_node
        tables = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
            for a in (node, params.latency_ns, params.drop_thresh, rate,
                      cap))

        def shard_state(vals):
            arr = np.zeros((n, self.hs), dtype=np.int64)
            for i in range(n):
                row = vals[i::n]
                arr[i, : row.shape[0]] = row
            return arr

        state = torch.from_numpy(np.stack([
            shard_state(np.zeros(h, dtype=np.int64)),
            shard_state(params.cap_up),
            shard_state(np.zeros(h, dtype=np.int64))]))
        self._pad_chunk = None  # cached all-invalid packed chunk
        if self.entries is None:
            self._tables = tuple(t.to(self.device) for t in tables)
            self._state = state.to(self.device)
        else:
            #: per entry: the tables (replicated) and its shard's state
            #: (3, 1, Hs), which the rounds' stages hold the addresses of
            self._tables = [tuple(t.to(d) for t in tables)
                            for d in self.entries]
            self._states = [state[:, i:i + 1].clone().to(d)
                            for i, d in enumerate(self.entries)]
            #: the last call's epoch (windows and rounds alike)
            self._epoch = 0
        if self._cuda:
            devcfg.kernel_lib("mesh")  # build or load now, not mid-round
            if self.entries is not None:
                #: the launch groups and routes of the entry kernels, and a
                #: stream a group
                self._plan = entry_plan(self.entries,
                                        torch.cuda.can_device_access_peer)
                self._group_streams = [
                    torch.cuda.Stream(torch.device("cuda", card))
                    for card, _ in self._plan.groups]

    @property
    def state(self) -> torch.Tensor:
        """The (3, N, Hs) bucket state: on the plane's device, or gathered
        from the entries onto the CPU."""
        if self.entries is None:
            return self._state
        return torch.cat([st.cpu() for st in self._states], dim=1)

    @property
    def t_base(self) -> torch.Tensor:
        return self.state[0]

    @property
    def tokens(self) -> torch.Tensor:
        return self.state[1]

    @property
    def debt(self) -> torch.Tensor:
        return self.state[2]

    def set_state(self, state: torch.Tensor) -> None:
        """Adopt a (3, N, Hs) int64 bucket state (for example one carried
        over from another plane by convert.mesh_state_from_arrays)."""
        want = (3, self.n_shards, self.hs)
        if tuple(state.shape) != want or state.dtype != torch.int64:
            raise ValueError(f"state must be int64 {want}, got "
                             f"{state.dtype} {tuple(state.shape)}")
        if self.entries is None:
            self._state = state.to(self.device).clone()
        else:  # in place: the rounds' stages hold the states' addresses
            for i, st in enumerate(self._states):
                st.copy_(state[:, i:i + 1])

    def _rounds(self, rounds: list, t_nows: np.ndarray, single: bool):
        """K rounds at ``t_nows`` (K,), the state carried: ``rounds`` holds
        each round's six (N, C) int64 unit arrays (shard_units_np's).
        Returns (received (K, N, N, C, 4), g_min (K,), counters (K, 2)) as
        numpy. One device: one mesh_round_step (``single``) or mesh_scan
        launch. Entries: the units packed into the (K, C) bucket's
        RoundStage and one mesh_rounds_entry call for the next epoch (one
        launch, one event and one sync a card; the plain version on CPU
        entries); g_min and counters are entry 0's (every entry holds the
        same)."""
        if self.entries is None:
            arrs = np.stack([np.stack(r) for r in rounds])
            units = torch.from_numpy(arrs).to(self.device)
            if single:
                recv, self._state, g_min, counters = mesh_round_step(
                    self._state, units[0], self._tables, int(t_nows[0]),
                    self._seed, self._max_pkts)
                recv, g_min, counters = recv[None], g_min, counters[None]
            else:
                recv, self._state, g_min, counters = mesh_scan(
                    self._state, units, self._tables,
                    torch.from_numpy(t_nows).to(self.device), self._seed,
                    self._max_pkts)
            return (recv.cpu().numpy(), g_min.cpu().numpy(),
                    counters.cpu().numpy())
        st = self.round_stage(len(rounds))
        for j, cols in enumerate(rounds):
            for f in range(6):
                st.units[j, f] = cols[f]
        st.t_now[:] = t_nows
        self._epoch += 1
        st.run(self._seed, self._max_pkts, self._epoch,
               self._group_streams if self._cuda else None)
        recv, g_min, counters = st.read()
        return recv, g_min[0], counters[0]

    def round_stage(self, k: int) -> RoundStage:
        """The rounds' buffers of bucket (N, K, C) over the entries, made on
        first use and bound to the entries' states and tables."""
        st = self._round_stages.get(k)
        if st is None:
            st = self._round_stages[k] = RoundStage(
                self.entries, self.n_shards, k, self.units_per_shard,
                self._states, self._tables,
                self._plan if self._cuda else None)
        return st

    def scan_rounds(self, chunks):
        """Fused execution of a backlog of round chunks.

        ``chunks``: list of ((src,dst,size,t_emit,uid,rok) packed numpy
        (N, C) arrays from shard_units_np, t_now) in simulation order.
        Pads each group to K in (1, 8, SCAN_KMAX) with invalid units and
        runs ONE mesh_scan per group (on entries, one mesh_rounds_entry
        launch a card). Returns the list of materialized exchange tables
        ((N, N, C, 4) numpy) aligned with ``chunks``."""
        out = []
        i = 0
        n = len(chunks)
        while i < n:
            part = chunks[i:i + self.SCAN_KMAX]
            k = len(part)
            K = 1 if k == 1 else (8 if k <= 8 else self.SCAN_KMAX)
            if self._pad_chunk is None:
                self._pad_chunk = self.shard_units_np([], [], [], [], [])
            pads = K - k
            t_last = part[-1][1]
            rounds = [p[0] for p in part] + [self._pad_chunk] * pads
            t_nows = np.array([p[1] for p in part] + [t_last] * pads,
                              dtype=np.int64)
            recv, _gmin, _ct = self._rounds(rounds, t_nows, False)
            out.extend(recv[j] for j in range(k))
            i += k
        return out

    def stage(self, m: int, w: int):
        """The buffers of bucket (N, m, w), made on first use: an
        ExchangeStage on one device, an EntryWindow over entries."""
        key = (self.n_shards, m, w)
        st = self._stages.get(key)
        if st is None:
            st = self._stages[key] = (
                ExchangeStage(*key, self.device) if self.entries is None
                else EntryWindow(self.entries, *key,
                                 self._plan if self._cuda else None))
        return st

    def _exchange_entries(self, st, w: int) -> np.ndarray:
        """One slice's exchange over the entries; the (N * w, 4) table,
        destinations in order. On cards: one mesh_exchange_entry launch a
        card for the next epoch, reading the page-locked window and writing
        each entry's page-locked output in place, one event a card and one
        sync. On CPU entries: the plain version."""
        if not self._cuda:
            recv, _ = mesh_exchange_entry(st.host_in, self._seed,
                                          self._max_pkts, w)
            return recv.reshape(-1, 4).numpy()
        self._epoch += 1
        st.launch(self._seed, self._max_pkts, self._epoch,
                  self._group_streams)
        st.finish(self._epoch, self._group_streams)
        return np.concatenate([e.out[:4 * w] for e in st.stages]).reshape(
            -1, 4)

    def exchange_rounds(self, src, dst, t_arr, uid, npk, th):
        """Resolve a causal window's units: draws + arrival exchange in as
        few launches as the slot buckets allow. Inputs are 1-D numpy arrays
        over ALL the window's (post-blackhole) units, in emission order.
        Returns a list of materialized (N*w, 4) exchange tables covering
        every unit (F_* field order; F_FLAGS bit1 marks valid rows); the
        tables are the caller's own.

        Each slice is packed straight into its bucket's page-locked buffer
        (ExchangeStage), exchanged on the card and waited for on CUDA
        events; one slice is in flight at a time, so a buffer is never
        rewritten while the card reads it. Every slice rewrites the valid
        column of every slot: units left in a buffer by a larger window are
        invalid slots, which the kernels skip and the plain versions
        discard."""
        n = self.n_shards
        out = []
        total = len(src)
        if total == 0:
            return out
        i = 0
        step = self.EXCHANGE_BUCKETS[-1]
        ph = self.phase
        cols = (dst, t_arr, uid, npk, th)
        while i < total:
            t0 = _walltime.perf_counter()
            j = min(total, i + step)
            sl = slice(i, j)
            sh = np.asarray(src[sl], dtype=np.int64) % n
            counts = np.bincount(sh, minlength=n)
            need = int(counts.max(initial=1))
            m = next(b for b in self.EXCHANGE_BUCKETS if b >= need)
            # destination capacity: the whole slice could land on one
            # shard; round the slice width up to a bucket for shape reuse
            wneed = min(n * m, int(j - i))
            w = min(n * m,
                    next(b for b in self.EXCHANGE_BUCKETS if b >= wneed))
            st = self.stage(m, w)
            packed = st.units
            packed[5] = 0
            if n == 1:  # one shard: the slots are the slice in order
                k = j - i
                for f, col in enumerate(cols):
                    packed[f, 0, :k] = col[sl]
                packed[5, 0, :k] = 1
            else:
                order = np.argsort(sh, kind="stable")
                rank = np.concatenate(
                    [np.arange(k, dtype=np.int64) for k in counts])
                shs = sh[order]
                for f, col in enumerate(cols):
                    packed[f, shs, rank] = np.asarray(col[sl],
                                                      np.int64)[order]
                packed[5, shs, rank] = 1
            t1 = _walltime.perf_counter()
            if self.entries is not None:
                table = self._exchange_entries(st, w)
                t2 = _walltime.perf_counter()
                out.append(table)
            elif self._cuda:
                # block on the exchange, as the reference does: the launch
                # lands in dispatch, copying the table out of the
                # page-locked buffer in readback
                st.dispatch(self._seed, self._max_pkts,
                            torch.cuda.current_stream(self.device))
                t2 = _walltime.perf_counter()
                out.append(st.out[:4 * n * w].reshape(-1, 4).copy())
            else:
                recv, _gmin = mesh_exchange(st.host_in, self._seed,
                                            self._max_pkts, w)
                t2 = _walltime.perf_counter()
                out.append(recv.numpy().reshape(-1, 4))
            t3 = _walltime.perf_counter()
            ph["build"] += t1 - t0
            ph["dispatch"] += t2 - t1
            ph["readback"] += t3 - t2
            ph["windows"] += 1
            i = j
        return out

    def shard_units(self, src, dst, size, t_emit, uid, rok=None):
        """shard_units_np as one (6, N, C) int64 tensor on the plane's
        device (entry 0's on entries; per-round API)."""
        return torch.from_numpy(np.stack(self.shard_units_np(
            src, dst, size, t_emit, uid, rok))).to(self.device)

    def shard_units_np(self, src, dst, size, t_emit, uid, rok=None):
        """Pack a (src-sorted FIFO) host batch into per-shard padded slots.
        ``rok`` (optional bool array) marks routable units; unroutable ones
        charge buckets but produce no arrival. Returns the six (N, C) int64
        arrays ``round_step`` consumes."""
        n, c, hs = self.n_shards, self.units_per_shard, self.hs
        out_src = np.full((n, c), hs, dtype=np.int64)  # hs = invalid sentinel
        out_dst = np.zeros((n, c), dtype=np.int64)
        out_size = np.zeros((n, c), dtype=np.int64)
        out_emit = np.zeros((n, c), dtype=np.int64)
        out_uid = np.zeros((n, c), dtype=np.int64)
        out_rok = np.zeros((n, c), dtype=np.int64)
        sh = np.asarray(src, dtype=np.int64) % n
        counts = np.bincount(sh, minlength=n)
        if counts.max(initial=0) > c:
            raise ValueError("units_per_shard slot overflow")
        order = np.argsort(sh, kind="stable")  # per-shard FIFO preserved
        if order.size:
            rank = np.concatenate(
                [np.arange(k, dtype=np.int64) for k in counts])
            shs, ks = sh[order], rank
            out_src[shs, ks] = np.asarray(src, dtype=np.int64)[order] // n
            out_dst[shs, ks] = np.asarray(dst, dtype=np.int64)[order]
            out_size[shs, ks] = np.asarray(size, dtype=np.int64)[order]
            out_emit[shs, ks] = np.asarray(t_emit, dtype=np.int64)[order]
            out_uid[shs, ks] = np.asarray(uid, dtype=np.int64)[order]
            if rok is None:
                out_rok[shs, ks] = 1
            else:
                out_rok[shs, ks] = np.asarray(rok, dtype=np.int64)[order]
        return (out_src, out_dst, out_size, out_emit, out_uid, out_rok)

    def round_step(self, units, t_now: int):
        """Synchronous round: ``units`` is shard_units' (6, N, C) tensor (or
        shard_units_np's six arrays). Returns (received, g_min, counters)
        with ``received`` materialized — received[i, j, c] = the c-th
        arrival shard j routed to shard i (see F_* field order)."""
        if isinstance(units, torch.Tensor):
            units = units.cpu().numpy()
        received, g_min, counters = self._rounds(
            [units], np.array([t_now], dtype=np.int64), True)
        return received[0], int(g_min[0]), counters[0]
