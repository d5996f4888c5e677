// Mesh data-plane kernels: the sharded round of the tpu_mesh policy, with
// N shards of hosts held on one card, or one shard on each device entry.
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
//   mesh_exchange_entry <- _exchange_rounds over a mesh of several devices:
//                      one shard a device entry, one launch a card (below)
//   mesh_rounds_entry <- _round_step and _scan_rounds over a mesh of
//                      several devices, the same way (below)
//
// The shard axis. JAX runs one program per device of a mesh and moves the
// exchange table with lax.all_to_all. Here one block owns one source shard
// (its hosts h with h % N == s, its bucket state row, its units); the
// exchange is a write into the destination shard's slot of a table, which
// the destination block then reads.
//
// What bounds these kernels on an H100, and the design. The work is tiny:
// tgen_1k's windows hold about 37 units (N = 1, m = 256) and its rounds
// about 24 units in 2,048 slots, so a call moves kilobytes and computes a
// few hundred Threefry lanes: nanoseconds at the card's rates (chip_smoke.py
// computes each call's bound). What costs is latency: launches, the chain of
// dependent loads and block barriers inside one block (a shard is one
// block, so N = 1 runs on one SM of 132), and the host round trip around
// each launch. The first design (two launches a call, every slot walked,
// the state in device memory, up to 10 Threefry lanes in a row per unit)
// took 0.785 ms a K = 32 scan of tgen_1k's rounds, 0.031 ms a round step
// and 0.0073 ms a window (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// This design:
// - One launch per call. The N shard blocks run as one thread block cluster
//   (cudaLaunchKernelEx with a cluster dimension of N): the receive reads
//   each source block's counts and rows through distributed shared memory
//   after cluster.sync(), and block 0 reduces the rounds' barrier minimum
//   and counters after the last round, where the first design needed a
//   second launch for each.
// - Work only on real slots. Units fill each shard's slots from the front
//   (padding last, valid units first), so a block first finds the real
//   prefix (one pass with a block maximum) and runs the body only on the
//   tiles inside it. The rows of the rounds' received table past each
//   destination's count come from one memset of the table before the
//   launch, spread over the card (one block wrote 64 KB a round row by
//   row); the exchange writes its few zero rows with 16-byte stores.
// - Loss draws lane-parallel (tile_draws): the block's threads share the
//   (unit, lane) pairs of a tile, so a tile of a few dozen units costs one
//   Threefry evaluation a thread instead of up to 10 in a row.
// - Round state in shared memory. Where they fit, a block loads its
//   shard's bucket state, its hosts' rate and cap, host_node and the
//   (G, G) latency and threshold tables into shared memory once per launch
//   (cp.async), carries the state there across the K rounds (the per-round
//   rebase over every host then reads shared memory) and writes it back
//   once. Each round's unit columns (the src_l column up to kSrcWin slots,
//   the first tile of the other five) are prefetched with cp.async into a
//   second buffer while the round before runs.
// - Small tiles in one warp. Where a tile's real units fit one warp (most
//   rounds), the two scans and the rank run as warp shuffles with no block
//   barrier.
// - The debt commit as two native 32-bit shared-memory atomics (the H100
//   has no 64-bit shared-memory add; the compiler spins on a CAS).
// - The plane's exchange window is read from and its table written to
//   page-locked host memory in place (the plane passes their device
//   addresses), so a window is one launch and no copy. The kernel then
//   waits on PCIe: its card time a window rises, but it stays below that
//   of one cudaMemcpyAsync each way around a kernel on device memory, and
//   the host's time a window falls with it.
// Measured on the same inputs (tools/mesh_ab.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.143 ms a K = 32 scan, 0.0114 ms a round step, 0.0053 ms a
// window on device memory. What is left is the per-round chain: the rebase
// over every host, the prefix pass, the prefetch's copies, the draws and
// the 64-bit divisions of the bucket math, one block barrier after
// another.
//
// Which shapes take which path (the wrapper in parallel/mesh.py chooses by
// shape alone and counts each path; a refused launch raises there):
// - N <= kClusterMax (16, a non-portable cluster size the H100 launches):
//   one cluster launch. Above it (up to kMaxShards), the kernels run as
//   two launches: mesh_send_kernel then mesh_recv_kernel for the exchange
//   (the pair), the round kernel then mesh_reduce_kernel for the rounds.
// - Exchange send rows: in each source block's shared memory when
//   N * m * 32 bytes <= kDynSmemMax, else in a device-memory table inside
//   the same launch.
// - Rounds: tables and state resident in shared memory when
//   round_smem_bytes() <= kDynSmemMax (tgen_1k: 117,632 bytes), else read
//   from device memory (the prefetch buffers stay in shared memory either
//   way).
//
// One shard on each device entry (parallel/mesh.py MeshDataPlane with a
// devices tuple; the reference puts shard i on devices[i] of a jax Mesh
// and moves the exchange table with lax.all_to_all inside one program).
// mesh_exchange_entry_kernel does a window's whole exchange in ONE launch
// a card, one block for each entry the card holds (shadow_mesh_exchange_
// entry). Block s runs the send phase of shard s and stores destination
// d's rows, then a trailer row [count, local minimum, 0, 0], straight into
// entry d's inbox (N, m + 1, 4) at slot s: on the same card (local), on
// another card over NVLink (peer; the plane enables peer access once per
// ordered pair of cards), or in page-locked host memory that both cards
// map (host, where a card cannot reach the other). After a system fence
// and a block barrier it publishes the window's epoch into flag [d][s] of
// every destination with a system-scope release store; then it waits
// with acquire loads until its own N flags hold the epoch and runs the
// receive phase from its inbox into its entry's page-locked output. The
// epoch counts the plane's windows from 1 and the flags start at 0, so no
// flag is ever reset and a stale one never matches. The wait is bounded
// by %globaltimer: a block whose source never publishes writes a status
// naming the source and the epoch and returns, and the wrapper raises
// after its one sync. The blocks of one card wait on each other, so they
// are one launch that the card runs all at once: a cluster up to
// kClusterMax blocks, a cooperative launch above it. What bounded the
// first per-entry design (a send launch, N^2 copies and a receive launch
// an entry, about 50 host calls around 6 us of card work a window at N =
// 4) was the host; here a window is one launch, one event and one sync a
// card. Launches on distinct cards depend only on each other's stores,
// never on stream order.
// mesh_rounds_entry_kernel runs the standalone rounds (K rounds, the
// bucket state carried) the same way: ONE launch a card, block s running
// shard s's K rounds through the one-device kernels' shard body
// (shard_rounds, its state in place on its entry). No step of a round
// reads what it received, so the rows need no barrier: block s stores
// round j's rows for destination d straight into d's rows inbox [s, j],
// which lives in page-locked host memory because only the host reads it.
// After the K rounds it stores one trailer [sent, dropped, min t_arr,
// rows to d] a round into d's trailer inbox (on d's card, over NVLink, or
// in mapped host memory, as the exchange's inboxes), publishes the call's
// epoch into d's flag and waits for its own N flags as the exchange does;
// then it reduces every source's trailers into its own g_min (k,) and
// counters (k, 2) (each entry holds them, as the reference's all_gather
// and psum give every shard) and copies the counts for the host, which
// reads only counted rows (a reused inbox keeps older rows past them). It
// replaces a launch an entry, a memset an entry, N^2 copies and a
// reduction launch (the first per-entry form, about 45 host calls and
// 4 syncs a call at N = 4). Each entry point launches on the calling
// thread's current device, which the caller makes the stream's card.
// cudaFuncSetAttribute applies to the current device only, so prepared<>
// prepares a kernel once per device.
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
//   running count carried from tile to tile;
// - slots past the real prefix are padding (src_l >= Hs, or valid == 0):
//   the reference's program computes them and discards every value, so
//   skipping them changes nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (shadow_tpu_torch/ops/devcfg.py does this).
// Interface: plain C, loaded with ctypes; each entry point launches its
// kernels on the given stream and returns the first CUDA error (0 =
// launched).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 32;
// rounds of one mesh_rounds_entry launch (parallel/mesh.py MAX_ROUNDS, the
// plane's SCAN_KMAX)
constexpr int kMaxRounds = 32;
// devices a process may launch the round kernels on (prepared<>)
constexpr int kMaxDevices = 64;
// blocks in one cluster: 8 is portable; 16 needs the non-portable attribute
// (parallel/mesh.py CLUSTER_MAX)
constexpr int kClusterMax = 16;
// dynamic shared memory a mesh kernel asks for at most (227 KB a block on
// the H100, less the static scratch; parallel/mesh.py SMEM_MAX)
constexpr int kDynSmemMax = 200 * 1024;
// src_l slots of a round prefetched into shared memory (the real-prefix
// pass reads the rest from device memory)
constexpr int kSrcWin = 2048;
constexpr i64 kNsPerSec = 1000000000LL;
constexpr i64 kMtu = 1500;
constexpr i64 kInf = 1LL << 62;
constexpr i64 kNegInf = LLONG_MIN;

// exchange paths (parallel/mesh.py exchange_path)
constexpr int kPathPair = 0;
constexpr int kPathClusterGlobal = 1;
constexpr int kPathClusterSmem = 2;

// an entry's status after mesh_exchange_entry (parallel/mesh.py STATUS_*;
// the host writes kStatusPending before each launch)
constexpr i64 kStatusOk = 0;
constexpr i64 kStatusLate = 1;

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
// (dt in [0, 1 s), every round's case: q = 0 and r = dt, no floor steps)
__device__ __forceinline__ i64 bytes_over(i64 rate, i64 dt) {
  if (dt >= 0 && dt < kNsPerSec)
    return static_cast<i64>(static_cast<u64>(rate) * static_cast<u64>(dt) /
                            static_cast<u64>(kNsPerSec));
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

// -- memory helpers ----------------------------------------------------------

// the shared-space address of a pointer into shared memory
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// one 8-byte asynchronous copy from device to shared memory (cp.async)
__device__ __forceinline__ void cp_async8(i64* smem, const i64* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// System-scope acquire load and release store: the flags between the
// blocks of mesh_exchange_entry, on this card, another card or in mapped
// host memory.
__device__ __forceinline__ i64 load_acquire_sys(const i64* p) {
  i64 v;
  asm volatile("ld.acquire.sys.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release_sys(i64* p, i64 v) {
  asm volatile("st.release.sys.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
// nanoseconds of the card's global timer
__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// a 32-byte table row as two 16-byte stores (rows are 32-byte aligned)
__device__ __forceinline__ void put_row(i64* row, i64 a, i64 b, i64 c,
                                        i64 d) {
  longlong2* r = reinterpret_cast<longlong2*>(row);
  r[0] = make_longlong2(a, b);
  r[1] = make_longlong2(c, d);
}
__device__ __forceinline__ void copy_row(i64* to, const i64* from) {
  const longlong2* f = reinterpret_cast<const longlong2*>(from);
  longlong2* t = reinterpret_cast<longlong2*>(to);
  const longlong2 x = f[0];
  const longlong2 y = f[1];
  t[0] = x;
  t[1] = y;
}

// -- block-wide scans and reductions -----------------------------------------

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
// one_warp (the same in every thread): only warp 0 holds values other
// than the identity, so its own scan is the block's and no barrier is
// needed; the other warps' results and totals are not to be used.
template <typename Op>
__device__ i64 block_scan(i64 v, Op op, i64 identity, i64* warp_tot,
                          i64* total, bool one_warp = false) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const i64 t = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v = op(t, v);
  }
  if (one_warp) {
    *total = __shfl_sync(0xFFFFFFFFu, v, 31);
    return v;
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

// Maximum of v over the block, returned to every thread. scratch: kWarps
// ints of shared memory, free again after the caller's next barrier.
__device__ int block_max(int v, int* scratch) {
  v = __reduce_max_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = scratch[w] > m ? scratch[w] : m;
  return m;
}

// Sums of a and b and the minimum of c over the block, valid in thread 0.
// scratch: kWarps x 3 of shared memory, free after the caller's next barrier.
__device__ void block_sum_sum_min(i64* a, i64* b, i64* c, i64 (*scratch)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    *a = wadd(*a, __shfl_xor_sync(0xFFFFFFFFu, *a, o));
    *b = wadd(*b, __shfl_xor_sync(0xFFFFFFFFu, *b, o));
    const i64 t = __shfl_xor_sync(0xFFFFFFFFu, *c, o);
    *c = t < *c ? t : *c;
  }
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x >> 5][0] = *a;
    scratch[threadIdx.x >> 5][1] = *b;
    scratch[threadIdx.x >> 5][2] = *c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      *a = wadd(*a, scratch[w][0]);
      *b = wadd(*b, scratch[w][1]);
      *c = scratch[w][2] < *c ? scratch[w][2] : *c;
    }
  }
}

// Rank of this thread's unit among the units of its shard with the same
// destination ds (0..n; n = no destination), counting every earlier tile
// through carry[] (n + 1 running counts in shared memory). one_warp (the
// same in every thread): only warp 0 has active units, and it ranks them
// alone, without block barriers.
struct RankScratch {
  int warp_cnt[kWarps][kMaxShards + 1];
  int carry[kMaxShards + 1];
};

__device__ int tile_rank(int ds, bool active, int n, RankScratch* sc,
                         bool one_warp = false) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (one_warp) {
    if (warp != 0) return 0;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, active ? ds : -1);
    const int wrank = __popc(peers & ((1u << lane) - 1u));
    const int rank = active ? sc->carry[ds] + wrank : 0;
    __syncwarp();
    if (active && wrank == 0) sc->carry[ds] += __popc(peers);
    __syncwarp();
    return rank;
  }
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

// The loss draws of one tile's units, lane-parallel: the block's threads
// share the (unit, lane) pairs of the first `count` units, so a tile of a
// few dozen units takes one Threefry evaluation a thread instead of up to
// `width` in a row. A unit drops iff one of its first `lanes` lanes draws a
// 24-bit value below th (th == 0 never drops). Returns the
// calling thread's unit's flag. Every thread calls it.
struct DrawScratch {
  uint32_t lo[kThreads], hi[kThreads], lanes[kThreads], th[kThreads];
  int hit[kThreads];
};

__device__ bool tile_draws(uint32_t lo, uint32_t hi, uint32_t lanes,
                           uint32_t th, int count, uint32_t width,
                           uint32_t k0, uint32_t k1, DrawScratch* d) {
  const int t = threadIdx.x;
  d->lo[t] = lo;
  d->hi[t] = hi;
  d->lanes[t] = th == 0u ? 0u : lanes;
  d->th[t] = th;
  d->hit[t] = 0;
  __syncthreads();
  const int pairs = count * static_cast<int>(width);
  for (int idx = t; idx < pairs; idx += kThreads) {
    const int u = idx / static_cast<int>(width);
    const uint32_t l = static_cast<uint32_t>(idx - u * static_cast<int>(width));
    if (l < d->lanes[u]) {
      const uint2 x = shadow_tf::threefry2x32(
          k0, k1, d->lo[u], d->hi[u] | (l << shadow_tf::kPktShift));
      if ((x.x >> 8) < d->th[u]) d->hit[u] = 1;
    }
  }
  __syncthreads();
  return d->hit[t] != 0;
}

// -- mesh_exchange -----------------------------------------------------------

// units: one source shard's m slots of the (6, n, m) int64 rows [dst_g,
// t_arr, uid, npkts, thresh, valid], field f of slot i at units[f * plane
// + i]. The shard's send phase: draws each valid unit's flag and writes its
// row [dst_g // n, t_arr, uid, dropped | valid << 1] to row `rank` of
// sink(d), destination d's rows; leaves the count of units sent to
// destination d in sc->carry[d] and returns the earliest t_arr of its valid
// units (kInf if none) to every thread. Only the tiles up to the last valid
// slot run.
template <typename Sink>
__device__ i64 send_phase(const i64* __restrict__ units, i64 plane, int n,
                          int m, uint32_t k0, uint32_t k1, uint32_t width,
                          Sink sink, RankScratch* sc, DrawScratch* dr,
                          i64* warp_tot, int* red_i) {
  const i64* u_ok = units + 5 * plane;
  int last = -1;
  for (int i = threadIdx.x; i < m; i += kThreads)
    if (u_ok[i] != 0) last = i;
  if (threadIdx.x <= n) sc->carry[threadIdx.x] = 0;
  const int p = block_max(last, red_i) + 1;
  i64 my_min = kInf;
  for (int base = 0; base < p; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool active = i < p;
    int ds = n;
    i64 dst = 0, t_arr = 0, uid = 0;
    uint32_t lanes = 0, th = 0;
    if (active && u_ok[i] != 0) {
      const i64 at = i;
      dst = units[at];
      t_arr = units[plane + at];
      uid = units[2 * plane + at];
      const i64 npk = units[3 * plane + at];
      th = static_cast<uint32_t>(units[4 * plane + at]);
      ds = static_cast<int>(floormod(dst, n));
      const i64 npk_c = npk < static_cast<i64>(width) ? npk : width;
      lanes = min(static_cast<uint32_t>(npk_c), width);
      my_min = t_arr < my_min ? t_arr : my_min;
    }
    const bool dropped = tile_draws(
        static_cast<uint32_t>(uid),
        static_cast<uint32_t>(static_cast<u64>(uid) >> 32), lanes, th,
        min(p - base, kThreads), width, k0, k1, dr);
    const i64 flags = (dropped ? 1 : 0) | 2;
    const int rank = tile_rank(ds, active, n, sc, p - base <= 32);
    if (ds < n)
      put_row(sink(ds) + static_cast<i64>(rank) * 4, floordiv(dst, n), t_arr,
              uid, flags);
  }
  i64 total;
  block_scan(my_min, OpMin(), kInf, warp_tot, &total);
  return total;
}

// One destination shard's receive phase: the rows sent to it, in (source
// shard, slot) order, into its w rows of recv (the first w of them, then
// zero rows). off[j] = rows from sources before j, off[n] = all of them;
// source(j) = the first of the rows source j sent to this destination.
template <typename Source>
__device__ void recv_phase(int n, int w, const int* off, Source source,
                           i64* __restrict__ recv) {
  const int total = off[n];
  for (int r = threadIdx.x; r < w; r += kThreads) {
    i64* out = recv + static_cast<i64>(r) * 4;
    if (r < total) {
      int j = 0;
      while (off[j + 1] <= r) ++j;
      copy_row(out, source(j) + static_cast<i64>(r - off[j]) * 4);
    } else {
      put_row(out, 0, 0, 0, 0);
    }
  }
}

// One launch for N <= kClusterMax: the n blocks are one cluster; block s is
// source shard s in the send phase and destination shard s in the receive
// phase, cluster.sync() between them. kSmemRows: the send rows live in the
// source block's dynamic shared memory and destinations read them through
// distributed shared memory; otherwise in send (n, n, m, 4) in device
// memory. Block 0 writes g_min.
template <bool kSmemRows>
__global__ void __launch_bounds__(kThreads)
mesh_exchange_kernel(const i64* __restrict__ units, int n, int m, int w,
                     uint32_t k0, uint32_t k1, uint32_t width,
                     i64* __restrict__ send, i64* __restrict__ recv,
                     i64* __restrict__ g_min) {
  extern __shared__ __align__(16) i64 dyn[];
  __shared__ RankScratch sc;
  __shared__ DrawScratch dr;
  __shared__ i64 warp_tot[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ i64 local_min;
  __shared__ int off[kMaxShards + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = blockIdx.x;  // the grid is one cluster
  i64* rows = kSmemRows ? dyn : send + static_cast<i64>(s) * n * m * 4;
  const i64 mn = send_phase(
      units + static_cast<i64>(s) * m, static_cast<i64>(n) * m, n, m, k0, k1,
      width, [=](int d) { return rows + static_cast<i64>(d) * m * 4; }, &sc,
      &dr, warp_tot, red_i);
  if (threadIdx.x == 0) local_min = mn;
  if (!kSmemRows) __threadfence();
  cluster.sync();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int j = 0; j < n; ++j) {
      off[j] = run;
      run += cluster.map_shared_rank(&sc, j)->carry[s];
    }
    off[n] = run;
    if (s == 0) {
      i64 g = kInf;
      for (int j = 0; j < n; ++j) {
        const i64 v = *cluster.map_shared_rank(&local_min, j);
        g = v < g ? v : g;
      }
      *g_min = g;
    }
  }
  __syncthreads();
  recv_phase(n, w, off,
             [&](int j) -> const i64* {
               return (kSmemRows ? cluster.map_shared_rank(dyn, j)
                                 : send + static_cast<i64>(j) * n * m * 4) +
                      static_cast<i64>(s) * m * 4;
             },
             recv + static_cast<i64>(s) * w * 4);
  cluster.sync();  // a block's shared memory outlives every read of it
}

// N > kClusterMax, the pair. The send phase as a launch of its own: block
// s is source shard s, its m slots at units + s * m (fields `plane`
// apart), its rows into send + s * n * m * 4 (a block of m rows a
// destination), its counts into counts[s * n + d] and its minimum into
// local_min[s].
__global__ void __launch_bounds__(kThreads)
mesh_send_kernel(const i64* __restrict__ units, i64 plane, int n, int m,
                 uint32_t k0, uint32_t k1, uint32_t width,
                 i64* __restrict__ send, int* __restrict__ counts,
                 i64* __restrict__ local_min) {
  __shared__ RankScratch sc;
  __shared__ DrawScratch dr;
  __shared__ i64 warp_tot[kWarps];
  __shared__ int red_i[kWarps];
  const int s = blockIdx.x;
  i64* rows = send + static_cast<i64>(s) * n * m * 4;
  const i64 mn = send_phase(
      units + static_cast<i64>(s) * m, plane, n, m, k0, k1, width,
      [=](int d) { return rows + static_cast<i64>(d) * m * 4; }, &sc, &dr,
      warp_tot, red_i);
  if (threadIdx.x < n) counts[s * n + threadIdx.x] = sc.carry[threadIdx.x];
  if (threadIdx.x == 0) local_min[s] = mn;
}

// ... then the receive phase: block t is destination shard t, its w rows
// into recv + t * w * 4, source j's rows for it at send + (j * n + t) * m
// * 4. Block 0 writes g_min, the minimum over every source.
__global__ void __launch_bounds__(kThreads)
mesh_recv_kernel(const i64* __restrict__ send, const int* __restrict__ counts,
                 const i64* __restrict__ local_min, int n, int m, int w,
                 i64* __restrict__ recv, i64* __restrict__ g_min) {
  __shared__ int off[kMaxShards + 1];
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    int run = 0;
    i64 g = kInf;
    for (int j = 0; j < n; ++j) {
      off[j] = run;
      run += counts[j * n + t];
      g = local_min[j] < g ? local_min[j] : g;
    }
    off[n] = run;
    if (t == 0) *g_min = g;
  }
  __syncthreads();
  recv_phase(n, w, off,
             [&](int j) -> const i64* {
               return send + (static_cast<i64>(j) * n + t) * m * 4;
             },
             recv + static_cast<i64>(t) * w * 4);
}

// -- mesh_exchange_entry -----------------------------------------------------

// One block of a mesh_exchange_entry launch, in device memory on the
// launch's card (parallel/mesh.py EntryWindow builds it once a bucket;
// every address is a card address, of device or mapped host memory).
struct EntryBlock {
  i64 shard;                   // the entry's shard s
  i64 slot[kMaxShards];        // destination d's inbox block for source s
  i64 flag[kMaxShards];        // destination d's flag for source s
  i64 inbox[kMaxShards];       // the entry's own inbox block from source j
  i64 own_flag[kMaxShards];    // the entry's own flag for source j
  i64 out;                     // its (w, 4) rows, then g_min
  i64 status;                  // [code, late source, epoch, flag seen]
  i64 pad;
};
constexpr int kEntryBlockWords = 4 * kMaxShards + 4;
static_assert(sizeof(EntryBlock) == 8 * kEntryBlockWords,
              "EntryBlock is parallel/mesh.py ENTRY_BLOCK_WORDS int64 words");

// Block b is the entry table[b].shard of n: its send phase stores
// destination d's rows and trailer [count, local minimum, 0, 0] (row m)
// into slot[d], publishes `epoch` into flag[d], waits for its own n flags
// to hold `epoch` (at most timeout_ns, else it writes status [kStatusLate,
// source, epoch, flag seen] and returns), then runs the receive phase from
// its inbox blocks into out (rows in (source, slot) order, zero rows, then
// g_min, the minimum over every source's trailer) and writes kStatusOk.
__global__ void __launch_bounds__(kThreads)
mesh_exchange_entry_kernel(const i64* __restrict__ units, i64 plane, int n,
                           int m, int w, uint32_t k0, uint32_t k1,
                           uint32_t width, i64 epoch, i64 timeout_ns,
                           const EntryBlock* __restrict__ table) {
  __shared__ RankScratch sc;
  __shared__ DrawScratch dr;
  __shared__ i64 warp_tot[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ i64* slot[kMaxShards];
  __shared__ const i64* inbox[kMaxShards];
  __shared__ i64 seen[kMaxShards];
  __shared__ int off[kMaxShards + 1];
  __shared__ int late;  // the first source whose flag never came, else n
  const EntryBlock* e = table + blockIdx.x;
  const int s = static_cast<int>(e->shard);
  if (threadIdx.x < n) {
    slot[threadIdx.x] = reinterpret_cast<i64*>(e->slot[threadIdx.x]);
    inbox[threadIdx.x] = reinterpret_cast<const i64*>(e->inbox[threadIdx.x]);
  }
  if (threadIdx.x == 0) late = n;
  __syncthreads();
  const i64 mn = send_phase(units + static_cast<i64>(s) * m, plane, n, m, k0,
                            k1, width, [&](int d) { return slot[d]; }, &sc,
                            &dr, warp_tot, red_i);
  if (threadIdx.x < n)
    put_row(slot[threadIdx.x] + static_cast<i64>(m) * 4,
            sc.carry[threadIdx.x], mn, 0, 0);
  // every row and trailer of this block reaches every destination before
  // any flag says so
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x < n) {
    store_release_sys(reinterpret_cast<i64*>(e->flag[threadIdx.x]), epoch);
    const i64* f = reinterpret_cast<const i64*>(e->own_flag[threadIdx.x]);
    const u64 t0 = global_ns();
    i64 v;
    while ((v = load_acquire_sys(f)) != epoch) {
      if (global_ns() - t0 > static_cast<u64>(timeout_ns)) {
        atomicMin(&late, static_cast<int>(threadIdx.x));
        break;
      }
      __nanosleep(64);
    }
    seen[threadIdx.x] = v;
  }
  // the acquires above, then this barrier, order every source's rows
  // before the reads below
  __syncthreads();
  i64* status = reinterpret_cast<i64*>(e->status);
  i64* out = reinterpret_cast<i64*>(e->out);
  if (late < n) {
    if (threadIdx.x == 0) {
      status[1] = late;
      status[2] = epoch;
      status[3] = seen[late];
      status[0] = kStatusLate;
    }
    return;
  }
  if (threadIdx.x == 0) {
    int run = 0;
    i64 g = kInf;
    for (int j = 0; j < n; ++j) {
      const i64* trailer = inbox[j] + static_cast<i64>(m) * 4;
      off[j] = run;
      run += static_cast<int>(trailer[0]);
      g = trailer[1] < g ? trailer[1] : g;
    }
    off[n] = run;
    out[static_cast<i64>(w) * 4] = g;
  }
  __syncthreads();
  recv_phase(n, w, off, [&](int j) { return inbox[j]; }, out);
  if (threadIdx.x == 0) status[0] = kStatusOk;
}

// -- mesh_round_step and mesh_scan -------------------------------------------

// The launch's shapes and, for the one-device kernel, its tensors: block b
// of mesh_rounds_kernel is shard b of n, row b of the state, the units and
// the partials. mesh_rounds_entry_kernel takes each block's state and
// tables from its RoundBlock and reads only the shapes, units and t_now_k
// here.
struct RoundArgs {
  const i64* state_in;  // (3, n, hs) [t_base, tokens, debt]
  i64* state_out;       // (3, n, hs), the state after the last round
  const i64* host_node;  // (h_pad,)
  const i64* lat;        // (g, g)
  const i64* thresh;     // (g, g)
  const i64* rate;       // (h_pad,)
  const i64* cap;        // (h_pad,)
  const i64* units;      // (k, 6, n, c)
  const i64* t_now_k;    // (k,), or null: one round at t_now
  i64 t_now;
  i64* received;  // (k, n, n, c, 4): round j's rows from s to d at [j, d, s]
  i64* partials;  // (k, n, 3) [sent, dropped, min t_arr] per shard
  i64* g_min;     // (k,)
  i64* counters;  // (k, 2) [sent, dropped]
  int k, n, hs, c, h_pad, g;
  int win, tile;  // prefetched slots: src_l up to win, the rest up to tile
  int resident;   // tables and state in shared memory
  uint32_t k0, k1, width;
};

// Where one block's shard lives: its state (three planes st_plane apart;
// read from st_in, written to st_out, which may be the same memory), the
// tables it gathers from (rate and cap strided n: shard s's local host h
// at h * n + s) and its rounds' times (t_now_k[j], or null: a.t_now).
struct ShardIO {
  const i64* st_in;
  i64* st_out;
  i64 st_plane;
  const i64* host_node;
  const i64* lat;
  const i64* thresh;
  const i64* rate;
  const i64* cap;
  const i64* t_now_k;
};

// Where a block reads its shard's bucket state (indexed by local host) and
// the tables: shared-memory copies or device memory, the same indexing.
struct View {
  i64* tb;
  i64* tok;
  i64* debt;
  const i64* rate;  // rate[h * rstride]: the shard's hosts
  const i64* cap;
  i64 rstride;
  const i64* node;  // (h_pad,)
  const i64* lat;   // (g, g)
  const i64* thresh;
};

// One round's unit columns for this shard: the prefetched slots from
// shared memory, the others from device memory. g: field f of slot i at
// g[f * plane + i].
struct Cols {
  const i64* g;
  const i64* buf;
  i64 plane;
  int win, tile;
  __device__ i64 src(int i) const { return i < win ? buf[i] : g[i]; }
  __device__ i64 at(int f, int i) const {
    return i < tile ? buf[win + (f - 1) * tile + i] : g[f * plane + i];
  }
};

__device__ void prefetch_round(const i64* g, i64* buf, i64 plane, int win,
                               int tile) {
  for (int i = threadIdx.x; i < win; i += kThreads) cp_async8(buf + i, g + i);
  for (int f = 1; f < 6; ++f)
    for (int i = threadIdx.x; i < tile; i += kThreads)
      cp_async8(buf + win + (f - 1) * tile + i, g + f * plane + i);
}

struct RoundScratch {
  RankScratch sc;
  DrawScratch dr;
  i64 warp_tot[kWarps];
  i64 red[kWarps][3];
  int red_i[kWarps];
  i64 carry[2];  // running sum of sizes, running max of segment bases
};

// Where mesh_rounds_kernel's block b puts a round's results: round j's
// rows to destination d in the (k, n, n, c, 4) table (zeroed before the
// launch), its partials in (k, n, 3).
struct TableSink {
  i64* received;
  i64* partials;
  int n, c, b;
  __device__ i64* row(int j, int d) const {
    return received + ((static_cast<i64>(j) * n + d) * n + b) * c * 4;
  }
  // every thread calls it after the round; the sums are thread 0's
  __device__ void round_end(int j, i64 sent, i64 dropped, i64 mn,
                            const int*) const {
    if (threadIdx.x == 0) {
      i64* p = partials + (static_cast<i64>(j) * n + b) * 3;
      p[0] = sent;
      p[1] = dropped;
      p[2] = mn;
    }
  }
};

// debt[sl] += size, exact modulo 2^64. In shared memory as two native
// 32-bit atomics, the low word's carry added to the high word (the H100
// has no 64-bit shared-memory add: the compiler spins on a
// compare-and-swap); in device memory one 64-bit atomic.
__device__ __forceinline__ void add_debt(const View& v, int resident, i64 sl,
                                         i64 size) {
  const u64 x = static_cast<u64>(size);
  if (!resident) {
    atomicAdd(reinterpret_cast<u64*>(v.debt + sl), x);
    return;
  }
  const unsigned w = smem_u32(v.debt + sl);  // little-endian: low word first
  const unsigned lo = static_cast<unsigned>(x);
  unsigned old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "r"(w), "r"(lo)
               : "memory");
  const unsigned hi = static_cast<unsigned>(x >> 32) + (old + lo < old);
  if (hi != 0)
    asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(w + 4), "r"(hi)
                 : "memory");
}

// Round j of shard s at t_now. Units are src-sorted within each shard,
// padding (src_l >= hs) last. Writes the counted rows of round j from s
// to every destination d at sink.row(j, d) (the sink's rows past the
// count are not written), then calls sink.round_end with the round's
// sums (valid in thread 0) and each destination's count.
template <typename Sink>
__device__ void round_body(const RoundArgs& a, const View& v, const Cols& u,
                           int j, int s, i64 t_now, const Sink& sink,
                           RoundScratch* rs) {
  const int n = a.n, hs = a.hs, c = a.c;
  // lazy saturation rebase at the barrier (fluid.TokenBuckets.rebase), and
  // the real prefix: slots [0, p) hold every unit with src_l < hs
  for (int h = threadIdx.x; h < hs; h += kThreads) {
    const i64 cp = v.cap[h * v.rstride];
    const i64 avail = wsub(wadd(v.tok[h], bytes_over(v.rate[h * v.rstride],
                                                     wsub(t_now, v.tb[h]))),
                           v.debt[h]);
    if (avail > cp) {
      v.tb[h] = t_now;
      v.tok[h] = cp;
      v.debt[h] = 0;
    }
  }
  int last = -1;
  for (int i = threadIdx.x; i < c; i += kThreads)
    if (u.src(i) < hs) last = i;
  if (threadIdx.x <= n) rs->sc.carry[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    rs->carry[0] = 0;
    rs->carry[1] = kNegInf;
  }
  const int p = block_max(last, rs->red_i) + 1;
  i64 sent = 0, dropped_ct = 0, my_min = kInf;
  for (int base = 0; base < p; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool active = i < p;
    const i64 src_l = active ? u.src(i) : hs;
    const bool valid = active && src_l < hs;
    const i64 size_m = valid ? u.at(2, i) : 0;
    const bool one_warp = p - base <= 32;  // most rounds: a few dozen units
    // per-source FIFO cumulative bytes: csum, then the running max of the
    // segment starts (the reference's cumsum and cummax)
    i64 tile_sum;
    const i64 csum = wadd(rs->carry[0],
                          block_scan(size_m, OpSum(), 0, rs->warp_tot,
                                     &tile_sum, one_warp));
    const i64 prev = i == 0 ? -1 : (active ? u.src(i - 1) : hs);
    const i64 sv = active && src_l != prev ? wsub(csum, size_m) : 0;
    i64 tile_max;
    i64 seg_base = block_scan(active ? sv : kNegInf, OpMax(), kNegInf,
                              rs->warp_tot, &tile_max, one_warp);
    seg_base = seg_base > rs->carry[1] ? seg_base : rs->carry[1];
    bool route = false;
    i64 dst_g = 0, t_arr = 0, uid = 0;
    uint32_t lanes = 0, th = 0;
    if (active) {
      const i64 sl = src_l < hs - 1 ? src_l : hs - 1;
      const i64 slj = jidx(sl, hs);
      const i64 need = wsub(wadd(v.debt[slj], wsub(csum, seg_base)),
                            v.tok[slj]);
      const i64 t_ready =
          need > 0
              ? wadd(v.tb[slj], ceil_ns(need, v.rate[slj * v.rstride]))
              : 0;
      const i64 t_emit = u.at(3, i);
      const i64 t_dep = t_emit > t_ready ? t_emit : t_ready;
      dst_g = u.at(1, i);
      uid = u.at(4, i);
      const i64 src_g = wadd(wmul(sl, n), s);
      const i64 sn = jidx(v.node[jidx(src_g < a.h_pad - 1 ? src_g
                                                          : a.h_pad - 1,
                                      a.h_pad)], a.g);
      const i64 dn = jidx(v.node[jidx(dst_g < a.h_pad - 1 ? dst_g
                                                          : a.h_pad - 1,
                                      a.h_pad)], a.g);
      t_arr = wadd(t_dep, v.lat[sn * a.g + dn]);
      route = valid && u.at(5, i) != 0;
      if (route) {
        i64 npk = -floordiv(-size_m, kMtu);
        npk = npk < 1 ? 1 : npk;
        npk = npk < static_cast<i64>(a.width) ? npk : a.width;
        lanes = static_cast<uint32_t>(npk);
        th = static_cast<uint32_t>(v.thresh[sn * a.g + dn]);
      }
    }
    const bool dropped = tile_draws(
        static_cast<uint32_t>(uid),
        static_cast<uint32_t>(static_cast<u64>(uid) >> 32), lanes, th,
        min(p - base, kThreads), a.width, a.k0, a.k1, &rs->dr);
    int ds = n;
    i64 flags = 0;
    if (route) {
      ds = static_cast<int>(floormod(dst_g, n));
      flags = (dropped ? 1 : 0) | 2;
      sent += dropped ? 0 : 1;
      dropped_ct += dropped ? 1 : 0;
      my_min = t_arr < my_min ? t_arr : my_min;
    }
    const int rank = tile_rank(ds, active, n, &rs->sc, one_warp);
    if (ds < n)
      put_row(sink.row(j, ds) + static_cast<i64>(rank) * 4,
              floordiv(dst_g, n), t_arr, uid, flags);
    if (threadIdx.x == 0) {
      rs->carry[0] = wadd(rs->carry[0], tile_sum);
      rs->carry[1] = tile_max > rs->carry[1] ? tile_max : rs->carry[1];
    }
    __syncthreads();
  }
  // commit: debt += per-source sums (segment_sum; every read of the
  // pre-commit debt above is done). Integer atomics: exact in any order.
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const i64 src_l = u.src(i);
    const i64 sl = src_l < hs - 1 ? src_l : hs - 1;
    if (src_l < hs && sl >= 0) {
      const i64 size = u.at(2, i);
      if (size != 0) add_debt(v, a.resident, sl, size);
    }
  }
  block_sum_sum_min(&sent, &dropped_ct, &my_min, rs->red);
  // rows to each destination: the ranks' running counts
  sink.round_end(j, sent, dropped_ct, my_min, rs->sc.carry);
  __syncthreads();  // state, scratch and carries are reused by the next round
}

// The K rounds (K = 1 for mesh_round_step) of shard s, whose slots are row
// `row` of the (k, 6, n, c) units, in one block: its bucket state carried
// from round to round in shared memory (resident) or in io.st_out, the
// rounds' results into `sink`. The body of both round kernels.
template <typename Sink>
__device__ void shard_rounds(const RoundArgs& a, const ShardIO& io, int row,
                             int s, const Sink& sink, i64* dyn,
                             RoundScratch* rs) {
  const int n = a.n, hs = a.hs, gg = a.g * a.g;
  const i64 sp = io.st_plane;
  View v;
  i64* bufs;
  if (a.resident) {
    i64* p = dyn;
    v.tb = p;
    v.tok = p + hs;
    v.debt = p + 2 * hs;
    i64* rate_s = p + 3 * hs;
    i64* cap_s = p + 4 * hs;
    i64* node_s = p + 5 * hs;
    i64* lat_s = node_s + a.h_pad;
    i64* th_s = lat_s + gg;
    bufs = th_s + gg;
    for (int h = threadIdx.x; h < hs; h += kThreads) {
      cp_async8(v.tb + h, io.st_in + h);
      cp_async8(v.tok + h, io.st_in + sp + h);
      cp_async8(v.debt + h, io.st_in + 2 * sp + h);
      cp_async8(rate_s + h, io.rate + static_cast<i64>(h) * n + s);
      cp_async8(cap_s + h, io.cap + static_cast<i64>(h) * n + s);
    }
    for (int i = threadIdx.x; i < a.h_pad; i += kThreads)
      cp_async8(node_s + i, io.host_node + i);
    for (int i = threadIdx.x; i < gg; i += kThreads) {
      cp_async8(lat_s + i, io.lat + i);
      cp_async8(th_s + i, io.thresh + i);
    }
    v.rate = rate_s;
    v.cap = cap_s;
    v.rstride = 1;
    v.node = node_s;
    v.lat = lat_s;
    v.thresh = th_s;
  } else {
    bufs = dyn;
    v.tb = io.st_out;
    v.tok = io.st_out + sp;
    v.debt = io.st_out + 2 * sp;
    for (int h = threadIdx.x; h < hs; h += kThreads) {
      v.tb[h] = io.st_in[h];
      v.tok[h] = io.st_in[sp + h];
      v.debt[h] = io.st_in[2 * sp + h];
    }
    v.rate = io.rate + s;
    v.cap = io.cap + s;
    v.rstride = n;
    v.node = io.host_node;
    v.lat = io.lat;
    v.thresh = io.thresh;
  }
  const i64 plane = static_cast<i64>(n) * a.c;
  const int bsz = a.win + 5 * a.tile;
  const int k = a.k > 0 ? a.k : 1;
  const i64* u0 = a.units + static_cast<i64>(row) * a.c;
  prefetch_round(u0, bufs, plane, a.win, a.tile);
  cp_async_commit();
  for (int j = 0; j < k; ++j) {
    cp_async_wait_all();  // round j's columns (and the tables) landed
    __syncthreads();
    if (j + 1 < k)
      prefetch_round(u0 + (j + 1) * 6 * plane, bufs + ((j + 1) & 1) * bsz,
                     plane, a.win, a.tile);
    cp_async_commit();
    const Cols u{u0 + j * 6 * plane, bufs + (j & 1) * bsz, plane, a.win,
                 a.tile};
    round_body(a, v, u, j, s, io.t_now_k ? io.t_now_k[j] : a.t_now, sink,
               rs);
  }
  if (a.resident) {
    for (int h = threadIdx.x; h < hs; h += kThreads) {
      io.st_out[h] = v.tb[h];
      io.st_out[sp + h] = v.tok[h];
      io.st_out[2 * sp + h] = v.debt[h];
    }
  }
}

// n shards' partials (k, n, 3) of rounds [j0, k) -> g_min and counters,
// one round a thread of the calling threads.
__device__ void reduce_rounds(const i64* __restrict__ partials, int n, int k,
                              int j0, int stride, i64* __restrict__ g_min,
                              i64* __restrict__ counters) {
  for (int j = j0; j < k; j += stride) {
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

// K rounds (K = 1 for mesh_round_step) in one launch, block b = shard b.
// kCluster: the n blocks are one cluster and block 0 reduces every round's
// partials after the last round; otherwise mesh_reduce_kernel does, as a
// second launch.
template <bool kCluster>
__global__ void __launch_bounds__(kThreads) mesh_rounds_kernel(RoundArgs a) {
  extern __shared__ __align__(16) i64 dyn[];
  __shared__ RoundScratch rs;
  const int b = blockIdx.x;
  const i64 sh = static_cast<i64>(b) * a.hs;
  const ShardIO io{a.state_in + sh, a.state_out + sh,
                   static_cast<i64>(a.n) * a.hs, a.host_node, a.lat,
                   a.thresh, a.rate, a.cap, a.t_now_k};
  shard_rounds(a, io, b, b, TableSink{a.received, a.partials, a.n, a.c, b},
               dyn, &rs);
  if constexpr (kCluster) {
    __threadfence();
    cg::this_cluster().sync();
    if (b == 0)
      reduce_rounds(a.partials, a.n, a.k > 0 ? a.k : 1, threadIdx.x,
                    kThreads, a.g_min, a.counters);
  }
}

// Partials (k, n, 3) -> g_min (k,) and counters (k, 2), N > kClusterMax.
__global__ void mesh_reduce_kernel(const i64* __restrict__ partials, int n,
                                   int k, i64* __restrict__ g_min,
                                   i64* __restrict__ counters) {
  reduce_rounds(partials, n, k, blockIdx.x * blockDim.x + threadIdx.x,
                gridDim.x * blockDim.x, g_min, counters);
}

// -- mesh_rounds_entry -------------------------------------------------------

// One block of a mesh_rounds_entry launch, in device memory on the
// launch's card (parallel/mesh.py round_block_table; every address is a
// card address, of device or mapped host memory).
struct RoundBlock {
  i64 shard;      // the entry's shard s
  i64 state;      // its (3, 1, hs) state, advanced in place
  i64 host_node;  // its copy of the tables
  i64 lat;
  i64 thresh;
  i64 rate;
  i64 cap;
  i64 out;     // its g_min (k,), counters (k, 2), then counts (n, k)
  i64 status;  // [code, late source, epoch, flag seen]
  i64 pad;
  i64 rows[kMaxShards];         // destination d's (k, c, 4) rows from s
  i64 trailer[kMaxShards];      // destination d's (k, 4) trailers from s
  i64 flag[kMaxShards];         // destination d's flag for source s
  i64 own_trailer[kMaxShards];  // the entry's own trailers from source j
  i64 own_flag[kMaxShards];     // the entry's own flag for source j
};
constexpr int kRoundBlockWords = 5 * kMaxShards + 10;
static_assert(sizeof(RoundBlock) == 8 * kRoundBlockWords,
              "RoundBlock is parallel/mesh.py ROUND_BLOCK_WORDS int64 words");

// Where mesh_rounds_entry_kernel's block puts a round's results: its rows
// to destination d straight into d's rows inbox (rows[d], shared), its
// sums and counts into shared memory for the trailers.
struct EntrySink {
  i64* const* rows;
  i64 (*part)[3];
  int (*cnt)[kMaxShards];
  int n, c;
  __device__ i64* row(int j, int d) const {
    return rows[d] + static_cast<i64>(j) * c * 4;
  }
  __device__ void round_end(int j, i64 sent, i64 dropped, i64 mn,
                            const int* carry) const {
    if (threadIdx.x == 0) {
      part[j][0] = sent;
      part[j][1] = dropped;
      part[j][2] = mn;
    }
    if (threadIdx.x < n) cnt[j][threadIdx.x] = carry[threadIdx.x];
  }
};

// Block b is the entry table[b].shard of n: it runs its shard's k rounds
// (shard_rounds, its state in place), storing round j's rows for
// destination d into rows[d] + j * c * 4; then, for every destination d,
// the trailers [sent, dropped, min t_arr, rows to d] of its k rounds into
// trailer[d]; publishes `epoch` into flag[d]; waits for its own n flags to
// hold `epoch` (at most timeout_ns, else it writes status [kStatusLate,
// source, epoch, flag seen] and returns); then reduces every source's
// trailers into out: g_min (k,), counters (k, 2) [sent, dropped], and
// copies the counts (source j's rows of round r at [j, r]) after them,
// and writes kStatusOk.
__global__ void __launch_bounds__(kThreads)
mesh_rounds_entry_kernel(RoundArgs a, i64 epoch, i64 timeout_ns,
                         const RoundBlock* __restrict__ table) {
  extern __shared__ __align__(16) i64 dyn[];
  __shared__ RoundScratch rs;
  __shared__ i64* rows[kMaxShards];
  __shared__ i64 t_now[kMaxRounds];
  __shared__ i64 part[kMaxRounds][3];
  __shared__ int cnt[kMaxRounds][kMaxShards];
  __shared__ i64 seen[kMaxShards];
  __shared__ int late;  // the first source whose flag never came, else n
  const RoundBlock* e = table + blockIdx.x;
  const int s = static_cast<int>(e->shard);
  const int n = a.n, k = a.k;
  if (threadIdx.x < n)
    rows[threadIdx.x] = reinterpret_cast<i64*>(e->rows[threadIdx.x]);
  // the times land with round 0's columns (the first wait in shard_rounds)
  if (threadIdx.x < k)
    cp_async8(t_now + threadIdx.x, a.t_now_k + threadIdx.x);
  if (threadIdx.x == 0) late = n;
  __syncthreads();
  i64* st = reinterpret_cast<i64*>(e->state);
  const ShardIO io{st,
                   st,
                   a.hs,
                   reinterpret_cast<const i64*>(e->host_node),
                   reinterpret_cast<const i64*>(e->lat),
                   reinterpret_cast<const i64*>(e->thresh),
                   reinterpret_cast<const i64*>(e->rate),
                   reinterpret_cast<const i64*>(e->cap),
                   t_now};
  shard_rounds(a, io, s, s, EntrySink{rows, part, cnt, n, a.c}, dyn, &rs);
  for (int i = threadIdx.x; i < n * k; i += kThreads) {
    const int d = i / k, j = i - d * k;
    put_row(reinterpret_cast<i64*>(e->trailer[d]) + j * 4, part[j][0],
            part[j][1], part[j][2], cnt[j][d]);
  }
  // every row and trailer of this block reaches every destination before
  // any flag says so
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x < n) {
    store_release_sys(reinterpret_cast<i64*>(e->flag[threadIdx.x]), epoch);
    const i64* f = reinterpret_cast<const i64*>(e->own_flag[threadIdx.x]);
    const u64 t0 = global_ns();
    i64 v;
    while ((v = load_acquire_sys(f)) != epoch) {
      if (global_ns() - t0 > static_cast<u64>(timeout_ns)) {
        atomicMin(&late, static_cast<int>(threadIdx.x));
        break;
      }
      __nanosleep(64);
    }
    seen[threadIdx.x] = v;
  }
  // the acquires above, then this barrier, order every source's trailers
  // before the reads below
  __syncthreads();
  i64* status = reinterpret_cast<i64*>(e->status);
  if (late < n) {
    if (threadIdx.x == 0) {
      status[1] = late;
      status[2] = epoch;
      status[3] = seen[late];
      status[0] = kStatusLate;
    }
    return;
  }
  i64* out = reinterpret_cast<i64*>(e->out);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    i64 sent = 0, dropped = 0, g = kInf;
    for (int src = 0; src < n; ++src) {
      const i64* t =
          reinterpret_cast<const i64*>(e->own_trailer[src]) + j * 4;
      sent = wadd(sent, t[0]);
      dropped = wadd(dropped, t[1]);
      g = t[2] < g ? t[2] : g;
    }
    out[j] = g;
    out[k + 2 * j] = sent;
    out[k + 2 * j + 1] = dropped;
  }
  for (int i = threadIdx.x; i < n * k; i += kThreads) {
    const int src = i / k, j = i - src * k;
    out[3 * k + i] =
        reinterpret_cast<const i64*>(e->own_trailer[src])[j * 4 + 3];
  }
  if (threadIdx.x == 0) status[0] = kStatusOk;
}

// -- launch helpers ----------------------------------------------------------

// Dynamic shared memory of the round kernel (parallel/mesh.py
// round_smem_bytes): two prefetch buffers, plus the tables and state when
// resident.
i64 round_smem_bytes(int hs, int c, int h_pad, int g, bool resident) {
  const i64 win = c < kSrcWin ? c : kSrcWin;
  const i64 tile = c < kThreads ? c : kThreads;
  i64 words = 2 * (win + 5 * tile);
  if (resident) words += 5LL * hs + h_pad + 2LL * g * g;
  return 8 * words;
}

// Allow a kernel up to kDynSmemMax of dynamic shared memory and, for a
// cluster kernel, clusters of up to 16 blocks. Once per kernel.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmemMax);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// cudaFuncSetAttribute applies to the current device only: prepare each
// kernel once on each device that launches it.
template <auto Kernel>
cudaError_t prepared(bool cluster) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev, cluster] {
    result[dev] = prepare(Kernel, cluster);
  });
  return result[dev];
}

// Launch Kernel with n blocks of kThreads that run all at once: one
// cluster of n blocks (n <= kClusterMax), or, with `cooperative`, one
// cooperative launch (every block resident, or the launch fails).
template <auto Kernel, typename... Args>
cudaError_t launch_together(int n, size_t smem, cudaStream_t st,
                            bool cooperative, Args... args) {
  cudaError_t e = prepared<Kernel>(true);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (cooperative) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool bad_shape(int n, int per_shard, int width) {
  return n < 1 || n > kMaxShards || per_shard < 1 || width < 1 || width > 64;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// The round kernels' arguments (g_min and counters left null: only the
// cluster launch and mesh_reduce_kernel write them; mesh_rounds_entry
// passes no tensor but the units and t_now_k).
RoundArgs round_args(const void* state_in, void* state_out, int n, int hs,
                     const void* units, int c, int k, long long t_now,
                     const void* t_now_k, const void* host_node, int h_pad,
                     const void* lat, const void* thresh, int g,
                     const void* rate, const void* cap, uint32_t k0,
                     uint32_t k1, int width, int resident, void* received,
                     void* partials) {
  RoundArgs a;
  a.state_in = static_cast<const i64*>(state_in);
  a.state_out = static_cast<i64*>(state_out);
  a.host_node = static_cast<const i64*>(host_node);
  a.lat = static_cast<const i64*>(lat);
  a.thresh = static_cast<const i64*>(thresh);
  a.rate = static_cast<const i64*>(rate);
  a.cap = static_cast<const i64*>(cap);
  a.units = static_cast<const i64*>(units);
  a.t_now_k = static_cast<const i64*>(t_now_k);
  a.t_now = t_now;
  a.received = static_cast<i64*>(received);
  a.partials = static_cast<i64*>(partials);
  a.g_min = nullptr;
  a.counters = nullptr;
  a.k = k;
  a.n = n;
  a.hs = hs;
  a.c = c;
  a.h_pad = h_pad;
  a.g = g;
  a.win = c < kSrcWin ? c : kSrcWin;
  a.tile = c < kThreads ? c : kThreads;
  a.resident = resident != 0;
  a.k0 = k0;
  a.k1 = k1;
  a.width = static_cast<uint32_t>(width);
  return a;
}

}  // namespace

extern "C" {

// units (6, n, m) -> recv (n, w, 4), g_min (1,). path: 0 = the pair
// (send (n, n, m, 4), counts (n, n) int32 and local_min (n,) are scratch),
// 1 = one cluster launch with send as scratch, 2 = one cluster launch with
// the send rows in shared memory (send, counts, local_min unused).
// units, recv and g_min may be the device addresses of page-locked host
// memory (the plane's staging: the kernel reads and writes it in place).
int shadow_mesh_exchange(void* units, int n, int m, int w, uint32_t k0,
                         uint32_t k1, int width, int path, void* send,
                         void* counts, void* local_min, void* recv,
                         void* g_min, void* stream) {
  const i64 rows_bytes = 32LL * n * m;
  if (bad_shape(n, m, width) || w < 1 || w > n * m || misaligned(recv) ||
      path < kPathPair || path > kPathClusterSmem ||
      (path != kPathPair && n > kClusterMax) ||
      (path == kPathClusterSmem && rows_bytes > kDynSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const i64* u = static_cast<const i64*>(units);
  i64* snd = static_cast<i64*>(send);
  i64* rcv = static_cast<i64*>(recv);
  i64* gm = static_cast<i64*>(g_min);
  if (path == kPathPair) {
    mesh_send_kernel<<<n, kThreads, 0, st>>>(
        u, static_cast<i64>(n) * m, n, m, k0, k1,
        static_cast<uint32_t>(width), snd, static_cast<int*>(counts),
        static_cast<i64*>(local_min));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    mesh_recv_kernel<<<n, kThreads, 0, st>>>(
        snd, static_cast<const int*>(counts),
        static_cast<const i64*>(local_min), n, m, w, rcv, gm);
    e = cudaGetLastError();
  } else if (path == kPathClusterGlobal) {
    e = launch_together<mesh_exchange_kernel<false>>(
        n, 0, st, false, u, n, m, w, k0, k1, static_cast<uint32_t>(width),
        snd, rcv, gm);
  } else {
    e = launch_together<mesh_exchange_kernel<true>>(
        n, static_cast<size_t>(rows_bytes), st, false, u, n, m, w, k0, k1,
        static_cast<uint32_t>(width), snd, rcv, gm);
  }
  return static_cast<int>(e);
}

// The device address of pinned host memory (for kernels that read and
// write it in place); 0 on success.
int shadow_device_pointer(void* host, void** dev) {
  return static_cast<int>(cudaHostGetDevicePointer(dev, host, 0));
}

// One round (k == 0, at t_now) or k rounds (k >= 1, units (k, 6, n, c),
// t_now_k (k,)): state_in (3, n, hs) is read, state_out (3, n, hs) gets
// the state after the last round; received (k, n, n, c, 4), g_min (k,),
// counters (k, 2); partials (k, n, 3) is scratch. cluster: one cluster
// launch (n <= kClusterMax), else the round kernel then mesh_reduce_kernel;
// resident: tables and state in shared memory (round_smem_bytes must fit).
int shadow_mesh_rounds(const void* state_in, void* state_out, int n, int hs,
                       const void* units, int c, int k, long long t_now,
                       const void* t_now_k, const void* host_node, int h_pad,
                       const void* lat, const void* thresh, int g,
                       const void* rate, const void* cap, uint32_t k0,
                       uint32_t k1, int width, int cluster, int resident,
                       void* received, void* partials, void* g_min,
                       void* counters, void* stream) {
  const i64 smem = round_smem_bytes(hs, c, h_pad, g, resident != 0);
  if (bad_shape(n, c, width) || hs < 1 || k < 0 || g < 1 ||
      h_pad != n * hs || (cluster && n > kClusterMax) ||
      smem > kDynSmemMax || misaligned(received) ||
      (k == 0) != (t_now_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = k == 0 ? 1 : k;
  RoundArgs a = round_args(state_in, state_out, n, hs, units, c, k, t_now,
                           t_now_k, host_node, h_pad, lat, thresh, g, rate,
                           cap, k0, k1, width, resident, received, partials);
  a.g_min = static_cast<i64*>(g_min);
  a.counters = static_cast<i64*>(counters);
  // the rows past each destination's count are zero: one memset over the
  // card, where one block a shard would write them row by row
  cudaError_t e = cudaMemsetAsync(
      received, 0, 32LL * steps * n * n * c, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cluster)
    return static_cast<int>(launch_together<mesh_rounds_kernel<true>>(
        n, static_cast<size_t>(smem), st, false, a));
  e = prepared<mesh_rounds_kernel<false>>(false);
  if (e != cudaSuccess) return static_cast<int>(e);
  mesh_rounds_kernel<false><<<n, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mesh_reduce_kernel<<<(steps + 127) / 128, 128, 0, st>>>(
      a.partials, n, steps, a.g_min, a.counters);
  return static_cast<int>(cudaGetLastError());
}

// -- one shard on its own device entry --------------------------------------
// Each entry point launches on the calling thread's current device, which
// must be the stream's.

// One window's exchange over the device entries, for the `blocks` entries
// this card holds: table (blocks EntryBlocks in this card's memory) names
// each block's shard, inbox slots, flags, output and status. units (6, n,
// m), field f of shard s's slot i at units[f * plane + s * m + i], is read
// in place (the plane's page-locked window). One launch of the blocks
// that runs them all at once: a cluster up to kClusterMax, else
// cooperative. epoch >= 1 is the window's; a block waits at most
// timeout_ns for each source's flag.
int shadow_mesh_exchange_entry(const void* units, long long plane, int n,
                               int m, int w, uint32_t k0, uint32_t k1,
                               int width, long long epoch,
                               long long timeout_ns, const void* table,
                               int blocks, void* stream) {
  if (bad_shape(n, m, width) || w < 1 || w > n * m ||
      plane < static_cast<long long>(n) * m || blocks < 1 || blocks > n ||
      epoch < 1 || timeout_ns < 1 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_together<mesh_exchange_entry_kernel>(
          blocks, 0, static_cast<cudaStream_t>(stream),
          blocks > kClusterMax, static_cast<const i64*>(units),
          static_cast<i64>(plane), n, m, w, k0, k1,
          static_cast<uint32_t>(width), static_cast<i64>(epoch),
          static_cast<i64>(timeout_ns),
          static_cast<const EntryBlock*>(table)));
}

// Let the current device reach `peer`'s memory (the peer route of
// mesh_exchange_entry); access already enabled counts as success.
int shadow_mesh_enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it recorded
    e = cudaSuccess;
  }
  return static_cast<int>(e);
}

// K rounds of the n shards of a mesh over device entries, for the `blocks`
// entries this card holds: table (blocks RoundBlocks in this card's
// memory) names each block's shard, state, tables, inbox slots, flags,
// output and status. units (k, 6, n, c), field f of shard s's slot i in
// round j at units[(j * 6 + f) * n * c + s * c + i], and t_now_k (k,) are
// read in place (the plane's page-locked stage). One launch of the blocks
// that runs them all at once: one cluster, or with `cooperative` one
// cooperative launch (every block resident, or the launch fails). epoch >=
// 1 is the call's; a block waits at most timeout_ns for each source's
// flag. resident: tables and state in shared memory (round_smem_bytes must
// fit).
int shadow_mesh_rounds_entry(const void* units, const void* t_now_k, int n,
                             int hs, int c, int k, int h_pad, int g,
                             uint32_t k0, uint32_t k1, int width,
                             int resident, long long epoch,
                             long long timeout_ns, const void* table,
                             int blocks, int cooperative, void* stream) {
  const i64 smem = round_smem_bytes(hs, c, h_pad, g, resident != 0);
  if (bad_shape(n, c, width) || hs < 1 || k < 1 || k > kMaxRounds || g < 1 ||
      h_pad != n * hs || smem > kDynSmemMax || blocks < 1 || blocks > n ||
      (!cooperative && blocks > kClusterMax) || epoch < 1 ||
      timeout_ns < 1 || units == nullptr || t_now_k == nullptr ||
      table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const RoundArgs a = round_args(nullptr, nullptr, n, hs, units, c, k, 0,
                                 t_now_k, nullptr, h_pad, nullptr, nullptr, g,
                                 nullptr, nullptr, k0, k1, width, resident,
                                 nullptr, nullptr);
  return static_cast<int>(launch_together<mesh_rounds_entry_kernel>(
      blocks, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream),
      cooperative != 0, a, static_cast<i64>(epoch),
      static_cast<i64>(timeout_ns), static_cast<const RoundBlock*>(table)));
}

const char* shadow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
