// Loss-draw kernels for the columnar data plane: per-unit Threefry-2x32-20
// draws over each unit's packet lanes.
//
// Replaces the two jax.jit programs of shadow_tpu/ops/propagate.py:
//   draw_flags  <- _draw_kernel      (propagate.py:85), per-unit drop flags
//   min_draw    <- _min_draw_kernel  (propagate.py:58), per-unit min draw
// and, inside both, the threefry2x32 that shadow_tpu/ops/prng.py:30 traces
// with xp=jnp (csrc/threefry.cuh).
//
// Bound on an H100: a unit costs one Threefry evaluation (75 integer
// operations that differ from lane to lane) per packet lane it needs, at
// most width lanes (10 by default, 64 at most). tgen_1k's windows pad to
// 256 units and need about 200 lanes each: about 15,000 operations and
// 4 KiB moved, about 1.2 ns at the card's memory bandwidth, against about
// 3.4 us per launch measured (H100 SXM, 700 W, chip_smoke.py). So launch
// latency and the host<->device copies around the launch, not this code, set
// the time of a dispatch (chip_smoke.py measures both).
//
// Design: one thread per unit, a loop over its lanes. draw_flags leaves the
// loop at the first lane that drops the unit (the reference computes every
// lane and masks; the answer is the same) and each warp packs its 32 flags
// with __ballot_sync into one uint32 word: on a little-endian card those 4
// bytes are np.packbits(flags, bitorder="little") of the warp's 32 units.
// This first design is correct and simple, not fast: no lane-level
// parallelism inside a unit, no fusion of the copies around the launch.
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

using shadow_tf::kPktShift;
using shadow_tf::threefry2x32;

constexpr int kThreads = 256;

// packed: (4, P) uint32 rows [uid_lo, uid_hi, npkts, thresh], row-major.
// words: (P / 32,) uint32, bit u of word w = unit 32*w + u drops.
__global__ void draw_flags_kernel(const uint32_t* __restrict__ packed, int P,
                                  uint32_t k0, uint32_t k1, uint32_t width,
                                  uint32_t* __restrict__ words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  if (i < P) {
    const uint32_t lo = packed[i];
    const uint32_t hi = packed[P + i];
    const uint32_t lanes = min(packed[2 * P + i], width);
    hit = shadow_tf::any_lane_hits(k0, k1, lo, hi, lanes, packed[3 * P + i]);
  }
  // P is a multiple of 32, so every warp is either wholly inside or wholly
  // outside [0, P): the full-mask ballot is well defined
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, hit);
  if (i < P && (threadIdx.x & 31) == 0) words[i >> 5] = word;
}

// packed: (3, P) uint32 rows [uid_lo, uid_hi, npkts]; out: (P,) uint32, the
// minimum 24-bit draw over the unit's first min(npkts, width) lanes, or
// 0xFFFFFFFF when that is no lane at all.
__global__ void min_draw_kernel(const uint32_t* __restrict__ packed, int P,
                                uint32_t k0, uint32_t k1, uint32_t width,
                                uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const uint32_t lo = packed[i];
  const uint32_t hi = packed[P + i];
  const uint32_t lanes = min(packed[2 * P + i], width);
  uint32_t m = 0xFFFFFFFFu;
  for (uint32_t p = 0; p < lanes; ++p) {
    const uint2 x = threefry2x32(k0, k1, lo, hi | (p << kPktShift));
    m = min(m, x.x >> 8);
  }
  out[i] = m;
}

}  // namespace

extern "C" {

int shadow_draw_flags(const void* packed, int P, uint32_t k0, uint32_t k1,
                      int width, void* words, void* stream) {
  if (P <= 0 || P % 32 != 0 || width < 1 || width > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kThreads - 1) / kThreads;
  draw_flags_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), P, k0, k1,
      static_cast<uint32_t>(width), static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

int shadow_min_draw(const void* packed, int P, uint32_t k0, uint32_t k1,
                    int width, void* out, void* stream) {
  if (P <= 0 || width < 1 || width > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kThreads - 1) / kThreads;
  min_draw_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), P, k0, k1,
      static_cast<uint32_t>(width), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* shadow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
