// Loss-draw kernels for the columnar data plane: per-unit Threefry-2x32-20
// draws over each unit's packet lanes.
//
// Replaces the two jax.jit programs of shadow_tpu/ops/propagate.py:
//   draw_flags  <- _draw_kernel      (propagate.py:85), per-unit drop flags
//   min_draw    <- _min_draw_kernel  (propagate.py:58), per-unit min draw
// and, for a batch split over device entries (the reference's sharded
// draw, propagate.py:197 and :229), draw_flags_entry and min_draw_entry:
// one launch a card for every piece the card's entries hold. Inside all
// four, the threefry2x32 that shadow_tpu/ops/prng.py:30 traces
// with xp=jnp (csrc/threefry.cuh). threefry_kernel evaluates that device
// function alone (the reference traces it only inside its programs): it is
// how chip_smoke.py times the function and holds it against ops/prng.py's
// plain version; no run path launches it.
//
// Bound on an H100: a unit costs one Threefry evaluation (about 75 integer
// operations) per packet lane it needs, at most width lanes (10 by
// default, 64 at most). tgen_1k's draw windows pad to 256 units and hold
// about 41 real ones with about 260 lanes: a few KiB moved and 20,000
// operations, nanoseconds at the card's rates. What sets a window's time is
// latency: the launch, the read of the window over PCIe, and the chain of
// dependent operations inside one thread.
//
// Design:
// - Lane-parallel. A segment of seg threads draws one unit (seg the next
//   power of two >= min(width, 32); above 32 lanes a thread takes two), so
//   a unit's lanes are drawn at once, and the segment combines them with
//   one warp-synchronous instruction (a ballot for draw_flags,
//   __reduce_min_sync for min_draw). A block holds 32 units (32 * seg
//   threads): its segment leaders leave one result a unit in shared
//   memory, and its first warp packs the 32 drop flags into one uint32
//   with a second ballot (on a little-endian card those 4 bytes are
//   np.packbits(flags, bitorder="little")) or stores the 32 minima as one
//   128-byte row. The block first stages its units' columns in shared
//   memory, a 128-byte row at a time: read in place, the window then
//   crosses PCIe in a few large requests, not one small one a thread.
// - Only real units. The caller passes the real unit count n <= P; the grid
//   covers ceil(n / 32) blocks, so padded units cost no Threefry work, and
//   the output past them is written as padding (flag words 0, minima
//   0xFFFFFFFF), which is what the plain versions give there. The input
//   past n is never read, so a buffer reused for a smaller batch needs no
//   clearing.
// - In place. The draw plane passes the device addresses of page-locked
//   host buffers, so a window is one launch and no copy
//   (ops/propagate.py; chip_smoke.py measures that against one copy each
//   way around the kernel).
// - Split over entries, one launch a card. A piece is what one entry draws:
//   `piece` consecutive units of the batch. The card's pieces go in a
//   table passed by value in the launch's parameters (first column, real
//   units, output address, first block: no device-memory table, no copy a
//   window); each block finds its piece in the table and runs the same
//   block body as the one-batch kernels on the piece's columns, read in
//   place from the one page-locked batch (every card maps it), into the
//   entry's own page-locked output region. A piece with no real unit gets
//   one block, which writes its pads. A piece starts at column i * piece,
//   which is not a multiple of 32 units when the entry count is not a
//   power of two: its 128-byte row loads then straddle two segments
//   (correct, two requests where one would do).
// - threefry_kernel takes four counter pairs a thread with 16-byte loads
//   and stores of each row (four independent chains), where n and the
//   addresses allow it.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/draw_ab.py, chip_smoke.py):
// 0.0027 ms a tgen_1k window on device memory against 0.0036 ms for the
// one-thread-a-unit loop this replaced, about 0.005 ms in place (the read
// crosses PCIe), and a dispatch's host time 3-4x lower; min_draw on a full
// 16,384-unit bucket about 8 % slower than that loop (a 16-thread segment
// for units of 1 to 10 lanes leaves most of its threads idle once the card
// is busy); threefry_kernel 0.0038 ms by the profiler, its bound 0.0035.
// Split over four entries of one card (chip_smoke.py phase multi device):
// draw_flags_entry 0.0051 ms a tgen_1k window in place against draw_flags'
// 0.0048 on one entry, min_draw_entry 0.0121 ms on 16,384 units against
// min_draw's 0.0124.
//
// The threefry key (the simulation seed) is a kernel argument, i.e. data:
// one build serves every seed, as the reference's kernels take it traced
// (propagate.py:66-71; the fleet's shared draw plane depends on it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (shadow_tpu_torch/ops/devcfg.py does this).
// Interface: plain C, loaded with ctypes; each entry point launches on the
// given stream and returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using shadow_tf::kNoDraw;
using shadow_tf::lane_pair_min;
using shadow_tf::segment_mask;
using shadow_tf::threefry2x32;

constexpr int kUnitsPerBlock = 32;
constexpr int kMaxBlock = kUnitsPerBlock * 32;
constexpr int kThreads = 256;
// pieces one launch of an entry kernel draws (one a device entry of the
// card): the table's size limit; the wrappers refuse more
constexpr int kMaxPieces = 32;

// The 32 units of block `block`: the first `rows` rows of their columns,
// staged in shared memory by whole 128-byte rows (one load a row, warps
// taking a row each), so a window read in place crosses PCIe in a few
// large requests and not as one small request a thread. Units past n read
// 0. Every thread calls it.
template <int kRows>
__device__ __forceinline__ void stage_units(
    const uint32_t* __restrict__ packed, int P, int n, int block,
    uint32_t (&cols)[kRows][kUnitsPerBlock]) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int u = block * kUnitsPerBlock + lane;
  for (int r = static_cast<int>(threadIdx.x >> 5); r < kRows;
       r += static_cast<int>(blockDim.x >> 5))
    cols[r][lane] = u < n ? packed[r * P + u] : 0u;
  __syncthreads();
}

// out[pad0 .. end) = fill, spread over every thread of the `blocks` blocks
// (this one is `block`) that cover one batch.
__device__ __forceinline__ void fill_pads(uint32_t* __restrict__ out,
                                          int pad0, int end, uint32_t fill,
                                          int block, int blocks) {
  const int stride = blocks * static_cast<int>(blockDim.x);
  for (int i = pad0 + block * static_cast<int>(blockDim.x) +
               static_cast<int>(threadIdx.x);
       i < end; i += stride)
    out[i] = fill;
}

// Block `block` of the `blocks` = max(1, ceil(n / 32)) blocks that draw one
// batch. packed: (4, P) uint32 rows [uid_lo, uid_hi, npkts, thresh] with
// row stride P, of which the first n units are real. words: (n_words,)
// uint32, bit u of word w = unit 32*w + u drops; 0 past the real units.
__device__ __forceinline__ void draw_flags_block(
    const uint32_t* __restrict__ packed, int P, int n, int block, int blocks,
    uint32_t k0, uint32_t k1, uint32_t width, int log_seg,
    uint32_t* __restrict__ words, int n_words) {
  __shared__ uint32_t cols[4][kUnitsPerBlock];
  __shared__ uint32_t unit_hit[kUnitsPerBlock];
  stage_units<4>(packed, P, n, block, cols);
  const int ub = static_cast<int>(threadIdx.x >> log_seg);
  const uint32_t th = cols[3][ub];
  // th == 0 never drops, and units past n have npkts 0 here: no lane of
  // either is drawn
  const uint32_t lanes = th == 0u ? 0u : min(cols[2][ub], width);
  const uint32_t lane = threadIdx.x & ((1u << log_seg) - 1u);
  const uint32_t m =
      lane_pair_min(k0, k1, cols[0][ub], cols[1][ub], lanes, lane);
  // every thread of the warp votes; each segment reads its own bits
  const bool hit =
      (__ballot_sync(0xFFFFFFFFu, m < th) & segment_mask(1 << log_seg)) != 0u;
  if (lane == 0u) unit_hit[ub] = hit;
  __syncthreads();
  if (threadIdx.x < 32) {
    const uint32_t word = __ballot_sync(0xFFFFFFFFu,
                                        unit_hit[threadIdx.x] != 0u);
    if (threadIdx.x == 0) words[block] = word;
  }
  fill_pads(words, blocks, n_words, 0u, block, blocks);
}

// Block `block` of the blocks that draw one batch, as draw_flags_block.
// packed: (3, P) uint32 rows [uid_lo, uid_hi, npkts] with row stride P, of
// which the first n units are real; out: (n_out,) uint32, the minimum
// 24-bit draw over the unit's first min(npkts, width) lanes, or 0xFFFFFFFF
// when that is no lane at all (and past the real units).
__device__ __forceinline__ void min_draw_block(
    const uint32_t* __restrict__ packed, int P, int n, int block, int blocks,
    uint32_t k0, uint32_t k1, uint32_t width, int log_seg,
    uint32_t* __restrict__ out, int n_out) {
  __shared__ uint32_t cols[3][kUnitsPerBlock];
  __shared__ uint32_t unit_min[kUnitsPerBlock];
  stage_units<3>(packed, P, n, block, cols);
  const int ub = static_cast<int>(threadIdx.x >> log_seg);
  const uint32_t lane = threadIdx.x & ((1u << log_seg) - 1u);
  uint32_t m = lane_pair_min(k0, k1, cols[0][ub], cols[1][ub],
                             min(cols[2][ub], width), lane);
  m = __reduce_min_sync(segment_mask(1 << log_seg), m);
  if (lane == 0u) unit_min[ub] = m;
  __syncthreads();
  if (threadIdx.x < 32)
    out[block * kUnitsPerBlock + threadIdx.x] = unit_min[threadIdx.x];
  fill_pads(out, blocks * kUnitsPerBlock, n_out, kNoDraw, block, blocks);
}

// One batch: packed (rows, P), row-major, its first n units real; the
// output covers the whole bucket P (P / 32 flag words, P minima).
__global__ void __launch_bounds__(kMaxBlock)
draw_flags_kernel(const uint32_t* __restrict__ packed, int P, int n,
                  uint32_t k0, uint32_t k1, uint32_t width, int log_seg,
                  uint32_t* __restrict__ words) {
  draw_flags_block(packed, P, n, static_cast<int>(blockIdx.x),
                   static_cast<int>(gridDim.x), k0, k1, width, log_seg, words,
                   P / 32);
}

__global__ void __launch_bounds__(kMaxBlock)
min_draw_kernel(const uint32_t* __restrict__ packed, int P, int n,
                uint32_t k0, uint32_t k1, uint32_t width, int log_seg,
                uint32_t* __restrict__ out) {
  min_draw_block(packed, P, n, static_cast<int>(blockIdx.x),
                 static_cast<int>(gridDim.x), k0, k1, width, log_seg, out, P);
}

// One piece of a batch split over device entries: its first column in the
// batch, its real units, its first block in the grid and its blocks
// (max(1, ceil(n / 32))), and its output region (region / 32 flag words or
// region minima, region the piece's width rounded up to 32 units, so no
// flag word holds two pieces' bits).
struct DrawPiece {
  uint32_t* out;
  int col;
  int n;
  int block0;
  int blocks;
};

// The pieces one card draws in one launch, passed by value in the kernel's
// parameters: no device-memory table and no copy a window. kMaxPieces
// bounds it to 776 bytes of the 4 KiB a launch's parameters may hold.
struct PieceTable {
  int count;
  DrawPiece rows[kMaxPieces];
};
static_assert(sizeof(PieceTable) + 64 <= 4096,
              "the piece table must fit a launch's 4 KiB of parameters");

// The piece block blockIdx.x draws: the last whose first block is at or
// before it (a scan of the table in the constant bank, the same for every
// thread of the block).
__device__ __forceinline__ int find_piece(const PieceTable& table) {
  const int b = static_cast<int>(blockIdx.x);
  int i = 0;
  while (i + 1 < table.count && table.rows[i + 1].block0 <= b) ++i;
  return i;
}

// A batch split over entries, one launch a card: packed (rows, P), the
// whole batch, read in place; each block finds its piece in the table and
// runs draw_flags_block / min_draw_block on the piece's columns into the
// piece's own region, pads included (a piece with no real unit gets one
// block, which writes only pads).
__global__ void __launch_bounds__(kMaxBlock)
draw_flags_entry_kernel(const uint32_t* __restrict__ packed, int P,
                        int region, uint32_t k0, uint32_t k1, uint32_t width,
                        int log_seg, const PieceTable table) {
  const int i = find_piece(table);
  const DrawPiece pc = table.rows[i];
  draw_flags_block(packed + pc.col, P, pc.n,
                   static_cast<int>(blockIdx.x) - pc.block0, pc.blocks, k0,
                   k1, width, log_seg, pc.out, region / 32);
}

__global__ void __launch_bounds__(kMaxBlock)
min_draw_entry_kernel(const uint32_t* __restrict__ packed, int P, int region,
                      uint32_t k0, uint32_t k1, uint32_t width, int log_seg,
                      const PieceTable table) {
  const int i = find_piece(table);
  const DrawPiece pc = table.rows[i];
  min_draw_block(packed + pc.col, P, pc.n,
                 static_cast<int>(blockIdx.x) - pc.block0, pc.blocks, k0, k1,
                 width, log_seg, pc.out, region);
}

// counters: (2, n) uint32 rows [c0, c1]; out: (2, n) uint32 rows [x0, x1].
// Four pairs a thread; kVec: n % 4 == 0 and both rows 16-byte aligned, so
// each row's four words move as one 16-byte load or store.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ counters, int n, uint32_t k0,
                uint32_t k1, uint32_t* __restrict__ out) {
  const int i = 4 * static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  uint32_t c0[4], c1[4];
  if (kVec) {
    const uint4 a = *reinterpret_cast<const uint4*>(counters + i);
    const uint4 b = *reinterpret_cast<const uint4*>(counters + n + i);
    c0[0] = a.x; c0[1] = a.y; c0[2] = a.z; c0[3] = a.w;
    c1[0] = b.x; c1[1] = b.y; c1[2] = b.z; c1[3] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c0[j] = i + j < n ? counters[i + j] : 0u;
      c1[j] = i + j < n ? counters[n + i + j] : 0u;
    }
  }
  uint2 x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = threefry2x32(k0, k1, c0[j], c1[j]);
  if (kVec) {
    *reinterpret_cast<uint4*>(out + i) =
        make_uint4(x[0].x, x[1].x, x[2].x, x[3].x);
    *reinterpret_cast<uint4*>(out + n + i) =
        make_uint4(x[0].y, x[1].y, x[2].y, x[3].y);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j < n) {
        out[i + j] = x[j].x;
        out[n + i + j] = x[j].y;
      }
    }
  }
}

// log2 of the segment width: the next power of two >= min(width, 32).
int log_segment(int width) {
  int log_seg = 0;
  while ((1 << log_seg) < width && log_seg < 5) ++log_seg;
  return log_seg;
}

bool bad_draw_args(int P, int n, int width) {
  return P <= 0 || P % 32 != 0 || n < 0 || n > P || width < 1 || width > 64;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The table of `count` pieces from rows (count, 3) int64 [first column,
// real units, output address] of a batch of P columns, each region units
// wide; the grid's blocks in *blocks. False for a table the kernels do not
// take.
bool fill_table(const int64_t* rows, int count, int P, int region,
                PieceTable* table, int* blocks) {
  if (rows == nullptr || count < 1 || count > kMaxPieces || P <= 0 ||
      region <= 0 || region % 32 != 0)
    return false;
  table->count = count;
  int b = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t col = rows[3 * i], n = rows[3 * i + 1],
                  out = rows[3 * i + 2];
    if (col < 0 || n < 0 || n > region || col + n > P || out == 0 ||
        (out & 3) != 0)
      return false;
    DrawPiece& pc = table->rows[i];
    pc.out = reinterpret_cast<uint32_t*>(out);
    pc.col = static_cast<int>(col);
    pc.n = static_cast<int>(n);
    pc.block0 = b;
    pc.blocks = n > 0 ? static_cast<int>((n + kUnitsPerBlock - 1) /
                                         kUnitsPerBlock)
                      : 1;
    b += pc.blocks;
  }
  *blocks = b;
  return true;
}

}  // namespace

extern "C" {

// Grids: max(1, ceil(n / 32)) blocks of 32 * seg threads.
int shadow_draw_flags(const void* packed, int P, int n, uint32_t k0,
                      uint32_t k1, int width, void* words, void* stream) {
  if (bad_draw_args(P, n, width))
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_seg = log_segment(width);
  const int blocks = n > 0 ? (n + kUnitsPerBlock - 1) / kUnitsPerBlock : 1;
  draw_flags_kernel<<<blocks, kUnitsPerBlock << log_seg, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), P, n, k0, k1,
      static_cast<uint32_t>(width), log_seg, static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

int shadow_min_draw(const void* packed, int P, int n, uint32_t k0,
                    uint32_t k1, int width, void* out, void* stream) {
  if (bad_draw_args(P, n, width))
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_seg = log_segment(width);
  const int blocks = n > 0 ? (n + kUnitsPerBlock - 1) / kUnitsPerBlock : 1;
  min_draw_kernel<<<blocks, kUnitsPerBlock << log_seg, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), P, n, k0, k1,
      static_cast<uint32_t>(width), log_seg, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// A batch split over device entries, one launch for the pieces of one
// card: rows (count, 3) int64 [first column, real units, output address],
// count <= 32; grid: the pieces' blocks, max(1, ceil(n / 32)) each.
int shadow_draw_flags_entry(const void* packed, int P, const void* rows,
                            int count, int region, uint32_t k0, uint32_t k1,
                            int width, void* stream) {
  PieceTable table;
  int blocks = 0;
  if (width < 1 || width > 64 ||
      !fill_table(static_cast<const int64_t*>(rows), count, P, region,
                  &table, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_seg = log_segment(width);
  draw_flags_entry_kernel<<<blocks, kUnitsPerBlock << log_seg, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), P, region, k0, k1,
      static_cast<uint32_t>(width), log_seg, table);
  return static_cast<int>(cudaGetLastError());
}

int shadow_min_draw_entry(const void* packed, int P, const void* rows,
                          int count, int region, uint32_t k0, uint32_t k1,
                          int width, void* stream) {
  PieceTable table;
  int blocks = 0;
  if (width < 1 || width > 64 ||
      !fill_table(static_cast<const int64_t*>(rows), count, P, region,
                  &table, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_seg = log_segment(width);
  min_draw_entry_kernel<<<blocks, kUnitsPerBlock << log_seg, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), P, region, k0, k1,
      static_cast<uint32_t>(width), log_seg, table);
  return static_cast<int>(cudaGetLastError());
}

int shadow_threefry(const void* counters, int n, uint32_t k0, uint32_t k1,
                    void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int quads = (n + 3) / 4;
  const int blocks = (quads + kThreads - 1) / kThreads;
  const auto* c = static_cast<const uint32_t*>(counters);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(c) && aligned16(o))
    threefry_kernel<true><<<blocks, kThreads, 0, s>>>(c, n, k0, k1, o);
  else
    threefry_kernel<false><<<blocks, kThreads, 0, s>>>(c, n, k0, k1, o);
  return static_cast<int>(cudaGetLastError());
}

// The device address of page-locked host memory (for a kernel that reads
// or writes it in place); 0 on success.
int shadow_device_pointer(void* host, void** dev) {
  return static_cast<int>(cudaHostGetDevicePointer(dev, host, 0));
}

const char* shadow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
