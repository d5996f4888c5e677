// Mesh data-plane kernels: the sharded round of the tpu_mesh policy, with
// N shards of hosts held on one card.
//
// Replaces the three jax.jit shard_map programs of
// shadow_tpu/parallel/mesh.py:
//   mesh_exchange   <- _exchange_rounds (mesh.py:222, jit :426): one causal
//                      window's loss draws, the arrival exchange to the
//                      destination shards, compaction to w rows a shard, and
//                      the global minimum arrival (the lookahead barrier)
//   mesh_round_step <- _round_step (mesh.py:103, jit :336): one whole round:
//                      lazy bucket rebase, closed-form departures, debt
//                      commit, latency/threshold gathers, draws, exchange,
//                      barrier minimum and sent/dropped counters
//   mesh_scan       <- _scan_rounds (mesh.py:202, jit :364): K rounds in one
//                      persistent launch, the bucket state carried across
//                      them
//
// The shard axis. JAX runs one program per device of a mesh and moves the
// exchange table with lax.all_to_all. Here one block owns one source shard
// (its hosts h with h % N == s, its bucket state row, its units), and the
// exchange is a write into the destination shard's slot of a table in
// device memory: send[s, d, rank] (exchange) or received[d, s, rank] (round
// step). A block never reads another block's state, so rounds need no
// grid-wide synchronisation; the only cross-shard steps are the receive
// (a second launch) and the reductions of the barrier minimum and the
// counters (a second launch, mesh_reduce_kernel, for the round kernels).
// A later multi-card port swaps the write into the table for an NCCL
// all_to_all between the two launches and keeps the per-shard work.
//
// Bit identity. All math is integer, held to the plain PyTorch versions in
// shadow_tpu_torch/parallel/mesh.py with tolerance 0:
// - floor division and modulo where JAX floors (CUDA's / and % truncate);
// - the two sub-second products of the bucket math run in unsigned 64 bits
//   (rate <= MAX_RATE = 16e9 and a remainder below 1e9 reach 1.6e19, past
//   int64), as the reference's uint64 casts do;
// - int64 sums and products wrap (done in unsigned arithmetic: signed
//   overflow is undefined in C++, and XLA wraps);
// - gathers use JAX's index rule: a negative index counts from the end, then
//   the index clamps into range; segment_sum drops ids outside [0, Hs);
// - thresholds compare as uint32 (the reference's astype(uint32)) against
//   24-bit draws, which cannot wrap;
// - the stable argsort + searchsorted rank of the reference is the count of
//   earlier units of the same source shard with the same destination:
//   __match_any_sync within a warp, a prefix over the block's warps, and a
//   running count carried from tile to tile.
//
// Bound on an H100: a unit costs up to max_pkts Threefry evaluations (75
// integer operations each) and about 100 bytes in and 32 out. On tgen_1k's
// windows (tens of units, N=1, m=256) that is nanoseconds of work against
// microseconds of launch: the launches and the host round trip around them
// set the time (chip_smoke.py measures both). The design is the simple one:
// one block per shard walking its units in tiles of kThreads, so a window
// with one shard uses one SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (shadow_tpu_torch/ops/devcfg.py does this).
// Interface: plain C, loaded with ctypes; each entry point launches its
// kernels on the given stream and returns cudaGetLastError() (0 = launched).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 32;
constexpr i64 kNsPerSec = 1000000000LL;
constexpr i64 kMtu = 1500;
constexpr i64 kInf = 1LL << 62;
constexpr i64 kNegInf = LLONG_MIN;

// -- integer helpers with the reference's semantics --------------------------

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ i64 floormod(i64 a, i64 b) {
  i64 r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// JAX gather index: negative counts from the end, then clamp into [0, size)
__device__ __forceinline__ i64 jidx(i64 i, i64 size) {
  if (i < 0) i += size;
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// fluid's bytes_over: rate * dt // 1e9 with the sub-second product in uint64
__device__ __forceinline__ i64 bytes_over(i64 rate, i64 dt) {
  const i64 q = floordiv(dt, kNsPerSec);
  const i64 r = floormod(dt, kNsPerSec);
  const i64 frac = static_cast<i64>(
      static_cast<u64>(rate) * static_cast<u64>(r) /
      static_cast<u64>(kNsPerSec));
  return wadd(wmul(rate, q), frac);
}

// ceil(need * 1e9 / rate) as q * 1e9 + ceil(r * 1e9 / rate), the second
// product in uint64 (r < rate <= MAX_RATE)
__device__ __forceinline__ i64 ceil_ns(i64 need, i64 rate) {
  const i64 q = floordiv(need, rate);
  const i64 r = floormod(need, rate);
  const u64 ur = static_cast<u64>(rate);
  const i64 frac = static_cast<i64>(
      (static_cast<u64>(r) * static_cast<u64>(kNsPerSec) + ur - 1ULL) / ur);
  return wadd(wmul(q, kNsPerSec), frac);
}

// -- block-wide scans --------------------------------------------------------

struct OpSum {
  __device__ i64 operator()(i64 a, i64 b) const { return wadd(a, b); }
};
struct OpMax {
  __device__ i64 operator()(i64 a, i64 b) const { return a > b ? a : b; }
};
struct OpMin {
  __device__ i64 operator()(i64 a, i64 b) const { return a < b ? a : b; }
};

// Inclusive scan of v over the block (every thread calls it); *total gets
// the whole block's reduction. warp_tot: kWarps slots of shared memory.
template <typename Op>
__device__ i64 block_scan(i64 v, Op op, i64 identity, i64* warp_tot,
                          i64* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const i64 t = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v = op(t, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    i64 t = lane < kWarps ? warp_tot[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const i64 u = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t = op(u, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = op(warp_tot[warp - 1], v);
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return v;
}

// Rank of this thread's unit among the units of its shard with the same
// destination ds (0..n; n = no destination), counting every earlier tile
// through carry[] (n + 1 running counts in shared memory).
struct RankScratch {
  int warp_cnt[kWarps][kMaxShards + 1];
  int carry[kMaxShards + 1];
};

__device__ int tile_rank(int ds, bool active, int n, RankScratch* sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * (n + 1); i += blockDim.x)
    sc->warp_cnt[i / (n + 1)][i % (n + 1)] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, active ? ds : -1);
  const int wrank = __popc(peers & ((1u << lane) - 1u));
  if (active && wrank == 0) sc->warp_cnt[warp][ds] = __popc(peers);
  __syncthreads();
  if (threadIdx.x <= n) {
    int run = sc->carry[threadIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int c = sc->warp_cnt[w][threadIdx.x];
      sc->warp_cnt[w][threadIdx.x] = run;
      run += c;
    }
    sc->carry[threadIdx.x] = run;
  }
  __syncthreads();
  const int rank = active ? sc->warp_cnt[warp][ds] + wrank : 0;
  __syncthreads();
  return rank;
}

__device__ __forceinline__ void put_row(i64* row, i64 a, i64 b, i64 c,
                                        i64 d) {
  row[0] = a;
  row[1] = b;
  row[2] = c;
  row[3] = d;
}

// -- mesh_exchange -----------------------------------------------------------

// units: (6, n, m) int64 rows [dst_g, t_arr, uid, npkts, thresh, valid].
// Block s (source shard) draws each valid unit's flag and writes its row
// [dst_g // n, t_arr, uid, dropped | valid << 1] to send[s, dst_g % n, rank];
// counts[s, d] = units of shard s sent to shard d; local_min[s] = the
// earliest t_arr of its valid units (kInf if none). Rows of send past
// counts[s, d] are not written: mesh_recv reads only the counted ones.
__global__ void __launch_bounds__(kThreads)
mesh_send_kernel(const i64* __restrict__ units, int n, int m, uint32_t k0,
                 uint32_t k1, uint32_t width, i64* __restrict__ send,
                 int* __restrict__ counts, i64* __restrict__ local_min) {
  __shared__ RankScratch sc;
  __shared__ i64 warp_tot[kWarps];
  const int s = blockIdx.x;
  const i64 plane = static_cast<i64>(n) * m;
  if (threadIdx.x <= n) sc.carry[threadIdx.x] = 0;
  __syncthreads();
  i64 my_min = kInf;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool active = i < m;
    int ds = n;
    i64 dst = 0, t_arr = 0, uid = 0, flags = 0;
    if (active) {
      const i64 at = static_cast<i64>(s) * m + i;
      dst = units[at];
      t_arr = units[plane + at];
      uid = units[2 * plane + at];
      const i64 npk = units[3 * plane + at];
      const i64 th = units[4 * plane + at];
      if (units[5 * plane + at] != 0) {
        ds = static_cast<int>(floormod(dst, n));
        const i64 npk_c = npk < static_cast<i64>(width) ? npk : width;
        const uint32_t lanes = min(static_cast<uint32_t>(npk_c), width);
        const bool dropped = shadow_tf::any_lane_hits(
            k0, k1, static_cast<uint32_t>(uid),
            static_cast<uint32_t>(static_cast<u64>(uid) >> 32), lanes,
            static_cast<uint32_t>(th));
        flags = (dropped ? 1 : 0) | 2;
        my_min = t_arr < my_min ? t_arr : my_min;
      }
    }
    const int rank = tile_rank(ds, active, n, &sc);
    if (active && ds < n) {
      i64* row = send + ((static_cast<i64>(s) * n + ds) * m + rank) * 4;
      put_row(row, floordiv(dst, n), t_arr, uid, flags);
    }
  }
  if (threadIdx.x < n) counts[s * n + threadIdx.x] = sc.carry[threadIdx.x];
  i64 total;
  block_scan(my_min, OpMin(), kInf, warp_tot, &total);
  if (threadIdx.x == 0) local_min[s] = total;
}

// Block i (destination shard) gathers send[:, i] in (source shard, slot)
// order, the counted rows first, into recv[i] (w rows: the first w of them,
// then zero rows). Block 0 also writes g_min = min(local_min).
__global__ void __launch_bounds__(kThreads)
mesh_recv_kernel(const i64* __restrict__ send, const int* __restrict__ counts,
                 const i64* __restrict__ local_min, int n, int m, int w,
                 i64* __restrict__ recv, i64* __restrict__ g_min) {
  __shared__ int off[kMaxShards + 1];
  const int i = blockIdx.x;
  if (threadIdx.x == 0) {
    int run = 0;
    for (int j = 0; j < n; ++j) {
      off[j] = run;
      run += counts[j * n + i];
    }
    off[n] = run;
    if (i == 0) {
      i64 g = kInf;
      for (int j = 0; j < n; ++j) g = local_min[j] < g ? local_min[j] : g;
      *g_min = g;
    }
  }
  __syncthreads();
  const int total = off[n];
  for (int r = threadIdx.x; r < w; r += kThreads) {
    i64* out = recv + (static_cast<i64>(i) * w + r) * 4;
    if (r < total) {
      int j = 0;
      while (off[j + 1] <= r) ++j;
      const i64* row =
          send + ((static_cast<i64>(j) * n + i) * m + (r - off[j])) * 4;
      put_row(out, row[0], row[1], row[2], row[3]);
    } else {
      put_row(out, 0, 0, 0, 0);
    }
  }
}

// -- mesh_round_step and mesh_scan -------------------------------------------

struct RoundArgs {
  i64* t_base;  // (n, hs) bucket state, updated in place
  i64* tokens;
  i64* debt;
  const i64* host_node;  // (h_pad,)
  const i64* lat;        // (g, g)
  const i64* thresh;     // (g, g)
  const i64* rate;       // (h_pad,)
  const i64* cap;        // (h_pad,)
  int n, hs, c, h_pad, g;
  uint32_t k0, k1, width;
};

// One round of shard s = blockIdx.x. units: (6, n, c) int64 rows [src_l,
// dst_g, size, t_emit, uid, rok], src-sorted within each shard, padding
// (src_l == hs) last. Writes received[d, s, :] for every destination d (the
// counted rows, then zero rows) and partials[s] = [sent, dropped, min t_arr
// of the routed units].
__device__ void round_body(const RoundArgs& a, const i64* __restrict__ units,
                           i64 t_now, i64* __restrict__ received,
                           i64* __restrict__ partials, RankScratch* sc,
                           i64* warp_tot, i64* carry) {
  const int s = blockIdx.x;
  const int n = a.n, hs = a.hs, c = a.c;
  const i64 row0 = static_cast<i64>(s) * hs;
  // lazy saturation rebase at the barrier (fluid.TokenBuckets.rebase)
  for (int h = threadIdx.x; h < hs; h += kThreads) {
    const i64 gh = static_cast<i64>(h) * n + s;
    const i64 avail = wsub(wadd(a.tokens[row0 + h],
                                bytes_over(a.rate[gh],
                                           wsub(t_now, a.t_base[row0 + h]))),
                           a.debt[row0 + h]);
    if (avail > a.cap[gh]) {
      a.t_base[row0 + h] = t_now;
      a.tokens[row0 + h] = a.cap[gh];
      a.debt[row0 + h] = 0;
    }
  }
  if (threadIdx.x <= n) sc->carry[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    carry[0] = 0;        // running sum of sizes
    carry[1] = kNegInf;  // running max of the segment bases
  }
  __syncthreads();
  const i64 plane = static_cast<i64>(n) * c;
  const i64* u_src = units;
  const i64* u_dst = units + plane;
  const i64* u_size = units + 2 * plane;
  const i64* u_emit = units + 3 * plane;
  const i64* u_uid = units + 4 * plane;
  const i64* u_rok = units + 5 * plane;
  i64 sent = 0, dropped_ct = 0, my_min = kInf;
  for (int base = 0; base < c; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool active = i < c;
    const i64 at = static_cast<i64>(s) * c + i;
    const i64 src_l = active ? u_src[at] : hs;
    const bool valid = active && src_l < hs;
    const i64 size_m = valid ? u_size[at] : 0;
    // per-source FIFO cumulative bytes: csum, then the running max of the
    // segment starts (the reference's cumsum and cummax)
    i64 tile_sum;
    const i64 csum = wadd(carry[0], block_scan(size_m, OpSum(), 0, warp_tot,
                                               &tile_sum));
    const i64 prev = i == 0 ? -1 : (active ? u_src[at - 1] : hs);
    const i64 v = active && src_l != prev ? wsub(csum, size_m) : 0;
    i64 tile_max;
    i64 seg_base = block_scan(active ? v : kNegInf, OpMax(), kNegInf,
                              warp_tot, &tile_max);
    seg_base = seg_base > carry[1] ? seg_base : carry[1];
    int ds = n;
    i64 dst_g = 0, t_arr = 0, uid = 0, flags = 0;
    if (active) {
      const i64 sl = src_l < hs - 1 ? src_l : hs - 1;
      const i64 slj = row0 + jidx(sl, hs);
      const i64 need = wsub(wadd(a.debt[slj], wsub(csum, seg_base)),
                            a.tokens[slj]);
      const i64 t_ready =
          need > 0 ? wadd(a.t_base[slj],
                          ceil_ns(need, a.rate[jidx(sl, hs) * n + s]))
                   : 0;
      const i64 t_emit = u_emit[at];
      const i64 t_dep = t_emit > t_ready ? t_emit : t_ready;
      dst_g = u_dst[at];
      uid = u_uid[at];
      const i64 src_g = wadd(wmul(sl, n), s);
      const i64 sn = jidx(a.host_node[jidx(src_g < a.h_pad - 1
                                               ? src_g : a.h_pad - 1,
                                           a.h_pad)], a.g);
      const i64 dn = jidx(a.host_node[jidx(dst_g < a.h_pad - 1
                                               ? dst_g : a.h_pad - 1,
                                           a.h_pad)], a.g);
      t_arr = wadd(t_dep, a.lat[sn * a.g + dn]);
      const bool route = valid && u_rok[at] != 0;
      if (route) {
        const i64 size = u_size[at];
        i64 npk = -floordiv(-size, kMtu);
        npk = npk < 1 ? 1 : npk;
        npk = npk < static_cast<i64>(a.width) ? npk : a.width;
        const bool dropped = shadow_tf::any_lane_hits(
            a.k0, a.k1, static_cast<uint32_t>(uid),
            static_cast<uint32_t>(static_cast<u64>(uid) >> 32),
            static_cast<uint32_t>(npk),
            static_cast<uint32_t>(a.thresh[sn * a.g + dn]));
        ds = static_cast<int>(floormod(dst_g, n));
        flags = (dropped ? 1 : 0) | 2;
        sent += dropped ? 0 : 1;
        dropped_ct += dropped ? 1 : 0;
        my_min = t_arr < my_min ? t_arr : my_min;
      }
    }
    const int rank = tile_rank(ds, active, n, sc);
    if (active && ds < n) {
      i64* row = received + ((static_cast<i64>(ds) * n + s) * c + rank) * 4;
      put_row(row, floordiv(dst_g, n), t_arr, uid, flags);
    }
    if (threadIdx.x == 0) {
      carry[0] = wadd(carry[0], tile_sum);
      carry[1] = tile_max > carry[1] ? tile_max : carry[1];
    }
    __syncthreads();
  }
  // commit: debt += per-source sums (segment_sum; every read of the
  // pre-commit debt above is done). Integer atomics: exact in any order.
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const i64 at = static_cast<i64>(s) * c + i;
    const i64 src_l = u_src[at];
    const i64 sl = src_l < hs - 1 ? src_l : hs - 1;
    if (src_l < hs && sl >= 0 && u_size[at] != 0)
      atomicAdd(reinterpret_cast<u64*>(&a.debt[row0 + sl]),
                static_cast<u64>(u_size[at]));
  }
  // the rows of received[:, s] past each destination's count are zero
  for (int d = 0; d < n; ++d) {
    i64* blk = received + (static_cast<i64>(d) * n + s) * c * 4;
    for (int r = sc->carry[d] + threadIdx.x; r < c; r += kThreads)
      put_row(blk + static_cast<i64>(r) * 4, 0, 0, 0, 0);
  }
  i64 tot_sent, tot_drop, tot_min;
  block_scan(sent, OpSum(), 0, warp_tot, &tot_sent);
  block_scan(dropped_ct, OpSum(), 0, warp_tot, &tot_drop);
  block_scan(my_min, OpMin(), kInf, warp_tot, &tot_min);
  if (threadIdx.x == 0) {
    partials[s * 3] = tot_sent;
    partials[s * 3 + 1] = tot_drop;
    partials[s * 3 + 2] = tot_min;
  }
  __syncthreads();  // state and carries are reused by the next round
}

__global__ void __launch_bounds__(kThreads)
mesh_round_step_kernel(RoundArgs a, const i64* __restrict__ units, i64 t_now,
                       i64* __restrict__ received,
                       i64* __restrict__ partials) {
  __shared__ RankScratch sc;
  __shared__ i64 warp_tot[kWarps];
  __shared__ i64 carry[2];
  round_body(a, units, t_now, received, partials, &sc, warp_tot, carry);
}

// K rounds in one launch: block s carries its shard's bucket state (in
// device memory, read and written only by this block) from round to round.
__global__ void __launch_bounds__(kThreads)
mesh_scan_kernel(RoundArgs a, const i64* __restrict__ units_k,
                 const i64* __restrict__ t_now_k, int k,
                 i64* __restrict__ received_k, i64* __restrict__ partials_k) {
  __shared__ RankScratch sc;
  __shared__ i64 warp_tot[kWarps];
  __shared__ i64 carry[2];
  const i64 u_step = 6LL * a.n * a.c;
  const i64 r_step = static_cast<i64>(a.n) * a.n * a.c * 4;
  for (int j = 0; j < k; ++j)
    round_body(a, units_k + j * u_step, t_now_k[j], received_k + j * r_step,
               partials_k + static_cast<i64>(j) * a.n * 3, &sc, warp_tot,
               carry);
}

// partials (k, n, 3) -> g_min (k,) and counters (k, 2) [sent, dropped]
__global__ void mesh_reduce_kernel(const i64* __restrict__ partials, int n,
                                   int k, i64* __restrict__ g_min,
                                   i64* __restrict__ counters) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k;
       j += gridDim.x * blockDim.x) {
    i64 sent = 0, dropped = 0, g = kInf;
    for (int s = 0; s < n; ++s) {
      const i64* p = partials + (static_cast<i64>(j) * n + s) * 3;
      sent = wadd(sent, p[0]);
      dropped = wadd(dropped, p[1]);
      g = p[2] < g ? p[2] : g;
    }
    g_min[j] = g;
    counters[2 * j] = sent;
    counters[2 * j + 1] = dropped;
  }
}

bool bad_shape(int n, int per_shard, int width) {
  return n < 1 || n > kMaxShards || per_shard < 1 || width < 1 || width > 64;
}

RoundArgs round_args(void* t_base, void* tokens, void* debt, int n, int hs,
                     int c, const void* host_node, int h_pad, const void* lat,
                     const void* thresh, int g, const void* rate,
                     const void* cap, uint32_t k0, uint32_t k1, int width) {
  RoundArgs a;
  a.t_base = static_cast<i64*>(t_base);
  a.tokens = static_cast<i64*>(tokens);
  a.debt = static_cast<i64*>(debt);
  a.host_node = static_cast<const i64*>(host_node);
  a.lat = static_cast<const i64*>(lat);
  a.thresh = static_cast<const i64*>(thresh);
  a.rate = static_cast<const i64*>(rate);
  a.cap = static_cast<const i64*>(cap);
  a.n = n;
  a.hs = hs;
  a.c = c;
  a.h_pad = h_pad;
  a.g = g;
  a.k0 = k0;
  a.k1 = k1;
  a.width = static_cast<uint32_t>(width);
  return a;
}

}  // namespace

extern "C" {

// units (6, n, m) -> recv (n, w, 4), g_min (1,); send (n, n, m, 4),
// counts (n, n) int32 and local_min (n,) are scratch.
int shadow_mesh_exchange(const void* units, int n, int m, int w, uint32_t k0,
                         uint32_t k1, int width, void* send, void* counts,
                         void* local_min, void* recv, void* g_min,
                         void* stream) {
  if (bad_shape(n, m, width) || w < 1 || w > n * m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mesh_send_kernel<<<n, kThreads, 0, st>>>(
      static_cast<const i64*>(units), n, m, k0, k1,
      static_cast<uint32_t>(width), static_cast<i64*>(send),
      static_cast<int*>(counts), static_cast<i64*>(local_min));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mesh_recv_kernel<<<n, kThreads, 0, st>>>(
      static_cast<const i64*>(send), static_cast<const int*>(counts),
      static_cast<const i64*>(local_min), n, m, w, static_cast<i64*>(recv),
      static_cast<i64*>(g_min));
  return static_cast<int>(cudaGetLastError());
}

// One round (k == 0) or k rounds (k >= 1, units (k, 6, n, c), t_now_k
// (k,)): state (n, hs) x3 updated in place; received (k, n, n, c, 4),
// g_min (k,), counters (k, 2); partials (k, n, 3) is scratch.
int shadow_mesh_rounds(void* t_base, void* tokens, void* debt, int n, int hs,
                       const void* units, int c, int k, long long t_now,
                       const void* t_now_k, const void* host_node, int h_pad,
                       const void* lat, const void* thresh, int g,
                       const void* rate, const void* cap, uint32_t k0,
                       uint32_t k1, int width, void* received, void* partials,
                       void* g_min, void* counters, void* stream) {
  if (bad_shape(n, c, width) || hs < 1 || k < 0 || g < 1 ||
      h_pad != n * hs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RoundArgs a = round_args(t_base, tokens, debt, n, hs, c, host_node,
                                 h_pad, lat, thresh, g, rate, cap, k0, k1,
                                 width);
  const i64* u = static_cast<const i64*>(units);
  i64* rcv = static_cast<i64*>(received);
  i64* part = static_cast<i64*>(partials);
  if (k == 0) {
    mesh_round_step_kernel<<<n, kThreads, 0, st>>>(a, u, t_now, rcv, part);
  } else {
    mesh_scan_kernel<<<n, kThreads, 0, st>>>(
        a, u, static_cast<const i64*>(t_now_k), k, rcv, part);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int steps = k == 0 ? 1 : k;
  mesh_reduce_kernel<<<(steps + 127) / 128, 128, 0, st>>>(
      part, n, steps, static_cast<i64*>(g_min), static_cast<i64*>(counters));
  return static_cast<int>(cudaGetLastError());
}

const char* shadow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
