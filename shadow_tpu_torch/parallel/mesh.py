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

N shards on one device. PyTorch has no virtual devices, so the plane holds
all N shards' bucket state as (N, Hs) tensors on its one ``torch.device``
and the reference's ``lax.all_to_all`` becomes the in-device exchange
``received[i] = send[:, i]``. The kernels run one block per shard.

Launch paths, chosen by shape alone (``exchange_path``, ``round_path``;
csrc/mesh.cu says why): up to CLUSTER_MAX shards a call is ONE launch of
the N blocks as a thread block cluster; above it the exchange runs as a
send launch and a receive launch (the seam where a multi-card slice puts an
NCCL all_to_all) and the rounds as a round launch and a reduce launch. The
exchange keeps its send rows in shared memory where N * m * 32 bytes fit
SMEM_MAX; the rounds keep their tables and bucket state in shared memory
where ``round_smem_bytes`` fits it. ``PATHS`` counts the launches of each.

Each wrapper checks dtypes, shapes, contiguity and device, runs the plain
version for CPU tensors and, for CUDA tensors, launches its kernel on the
current stream or raises: there is no fallback. ``LAUNCHES`` counts the
kernel launches per wrapper (plain runs are not launches).

Determinism: all math is integer (int64 times, uint32 hashes); the exchange
only permutes rows and every value is a pure function of unit identity, so
any shard count yields bit-identical simulations (tests/test_torch_mesh.py
holds the plain versions to the reference's programs with tolerance 0).
"""

from __future__ import annotations

import time as _walltime  # detlint: ok(wallclock): per-window wall attribution

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
LAUNCHES = {"mesh_exchange": 0, "mesh_round_step": 0, "mesh_scan": 0}
#: wrapper calls per launch path since the last reset_launches(): the
#: exchange's three paths, and the rounds' launch shape (cluster or pair)
#: and where their tables live (shared or device memory)
PATHS = {"exchange_cluster_smem": 0, "exchange_cluster_global": 0,
         "exchange_pair": 0, "rounds_cluster": 0, "rounds_pair": 0,
         "rounds_smem": 0, "rounds_global": 0}
#: exchange_path's names, in csrc/mesh.cu's numbering of the paths
_EXCHANGE_PATHS = ("pair", "cluster_global", "cluster_smem")


def reset_launches() -> None:
    for counts in (LAUNCHES, PATHS):
        for k in counts:
            counts[k] = 0


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
    t_base, tokens, debt = state
    src_l, dst_g, size, t_emit, uid, rok = units
    host_node, lat_ns, thresh, rate_all, cap_all = tables
    n, hs = t_base.shape
    c = src_l.shape[1]
    h_pad, g = host_node.shape[0], lat_ns.shape[0]
    dev = state.device
    me = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
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
    prev = torch.cat([torch.full((n, 1), -1, dtype=torch.int64, device=dev),
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
    received = torch.zeros((n + 1, n, c, 4), dtype=torch.int64, device=dev)
    received[ds, me.expand(n, c), rank] = payload
    g_min = torch.where(route, t_arr, INF).min().reshape(1)
    counters = torch.stack([(route & ~dropped).sum(), dropped.sum()])
    return (received[:n], torch.stack([t_base, tokens, debt]), g_min,
            counters)


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
                     recv_ptr: int, g_min_ptr: int, stream: int) -> None:
    """Launch mesh_exchange on ``path`` (csrc/mesh.cu shadow_mesh_exchange)
    and count it, or raise."""
    lib = devcfg.kernel_lib("mesh")
    code = lib.shadow_mesh_exchange(
        units_ptr, n, m, w, seed & _M32, (seed >> 32) & _M32, max_pkts,
        _EXCHANGE_PATHS.index(path),
        *(None if t is None else t.data_ptr() for t in scratch), recv_ptr,
        g_min_ptr, stream)
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
                     g_min.data_ptr(),
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
    code = lib.shadow_mesh_rounds(
        state.data_ptr(), state_out.data_ptr(), n, hs, units.data_ptr(), c,
        k, t_now, None if t_now_k is None else t_now_k.data_ptr(),
        host_node.data_ptr(), n * hs, lat.data_ptr(), thresh.data_ptr(), g,
        rate.data_ptr(), cap.data_ptr(), seed & _M32, (seed >> 32) & _M32,
        max_pkts, int(cluster), int(resident), received.data_ptr(),
        partials.data_ptr(), g_min.data_ptr(), counters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
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
        out = devcfg.device_pointer(self.host_out, "mesh")
        self._ptrs = (devcfg.device_pointer(self.host_in, "mesh"), out,
                      out + 8 * 4 * n * w)

    def launch(self, seed: int, max_pkts: int, stream) -> None:
        """Queue mesh_exchange on ``units`` into ``out`` on ``stream``."""
        n, m, w = self.shape
        units, recv, g_min = self._ptrs
        _exchange_launch(units, n, m, w, seed, max_pkts, self.path,
                         self.scratch, recv, g_min, stream.cuda_stream)

    def dispatch(self, seed: int, max_pkts: int, stream) -> None:
        """Run mesh_exchange on ``units`` into ``out`` on ``stream`` and
        wait for it on the event."""
        self.launch(seed, max_pkts, stream)
        self.event.record(stream)
        self.event.synchronize()


class MeshDataPlane:
    """Host-sharded data plane over N shards on one device.

    Usage: build with NetParams, feed per-round unit batches with
    ``round_step``, fuse K rounds per launch with ``scan_rounds``, or
    resolve a causal window's units with ``exchange_rounds`` (the tpu_mesh
    policy). The bucket state lives on the plane's device as the (3, N, Hs)
    tensor ``state`` ([t_base, tokens, debt]; row i = shard i's hosts).
    """

    #: fused-launch cap: scan_rounds pads each group of round chunks to K in
    #: (1, 8, SCAN_KMAX); longer backlogs run as several launches (the
    #: state carries on the device between them)
    SCAN_KMAX = 32
    #: window-slice widths for the exchange: the smallest bucket that fits
    #: the per-shard slot demand wins; bigger backlogs run as several slices
    EXCHANGE_BUCKETS = (256, 1024, 4096, 16384)

    def __init__(self, params: NetParams, n_shards: int | None = None,
                 units_per_shard: int = 1024, max_pkts: int = MAX_PKTS,
                 device: str = "cuda") -> None:
        self.device = devcfg.select_device(device)
        n = n_shards or devcfg.visible_devices(self.device)
        if not 1 <= n <= MAX_SHARDS:
            raise ValueError(f"{n} shards (want 1..{MAX_SHARDS})")
        #: exchange buffers by (N, m, w): at most 16 shapes (the buckets)
        self._stages: dict = {}
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
        self._tables = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(
                self.device)
            for a in (node, params.latency_ns, params.drop_thresh, rate,
                      cap))

        def shard_state(vals):
            arr = np.zeros((n, self.hs), dtype=np.int64)
            for i in range(n):
                row = vals[i::n]
                arr[i, : row.shape[0]] = row
            return arr

        self.state = torch.from_numpy(np.stack([
            shard_state(np.zeros(h, dtype=np.int64)),
            shard_state(params.cap_up),
            shard_state(np.zeros(h, dtype=np.int64))])).to(self.device)
        self._pad_chunk = None  # cached all-invalid packed chunk
        if self._cuda:
            devcfg.kernel_lib("mesh")  # build or load now, not mid-round

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
        self.state = state.to(self.device).clone()

    def scan_rounds(self, chunks):
        """Fused execution of a backlog of round chunks.

        ``chunks``: list of ((src,dst,size,t_emit,uid,rok) packed numpy
        (N, C) arrays from shard_units_np, t_now) in simulation order.
        Pads each group to K in (1, 8, SCAN_KMAX) with invalid units and
        runs ONE mesh_scan per group. Returns the list of materialized
        exchange tables ((N, N, C, 4) numpy) aligned with ``chunks``."""
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
            arrs = np.stack([np.stack(p[0]) for p in part]
                            + [np.stack(self._pad_chunk)] * pads)
            t_nows = np.array([p[1] for p in part] + [t_last] * pads,
                              dtype=np.int64)
            recv_k, self.state, _gmin, _ct = mesh_scan(
                self.state, torch.from_numpy(arrs).to(self.device),
                self._tables, torch.from_numpy(t_nows).to(self.device),
                self._seed, self._max_pkts)
            recv = recv_k.cpu().numpy()
            out.extend(recv[j] for j in range(k))
            i += k
        return out

    def stage(self, m: int, w: int) -> ExchangeStage:
        """The buffers of bucket (N, m, w), made on first use."""
        key = (self.n_shards, m, w)
        st = self._stages.get(key)
        if st is None:
            st = self._stages[key] = ExchangeStage(*key, self.device)
        return st

    def exchange_rounds(self, src, dst, t_arr, uid, npk, th):
        """Resolve a causal window's units: draws + arrival exchange in as
        few launches as the slot buckets allow. Inputs are 1-D numpy arrays
        over ALL the window's (post-blackhole) units, in emission order.
        Returns a list of materialized (N*w, 4) exchange tables covering
        every unit (F_* field order; F_FLAGS bit1 marks valid rows); the
        tables are the caller's own.

        Each slice is packed straight into its bucket's page-locked buffer
        (ExchangeStage), exchanged on the card and waited for on one CUDA
        event; one slice is in flight at a time, so a buffer is never
        rewritten while the card reads it. Every slice rewrites the valid
        column of every slot: units left in a buffer by a larger window are
        invalid slots, which the kernel skips and the plain version
        discards."""
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
            if self._cuda:
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
        device (per-round API)."""
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
        if not isinstance(units, torch.Tensor):
            units = torch.from_numpy(np.stack(units))
        received, self.state, g_min, counters = mesh_round_step(
            self.state, units.to(self.device), self._tables, int(t_now),
            self._seed, self._max_pkts)
        return (received.cpu().numpy(), int(g_min[0]),
                counters.cpu().numpy())
