// Threefry-2x32-20 as a __device__ function, shared by the loss-draw
// kernels (draw.cu) and the mesh data-plane kernels (mesh.cu).
//
// The port of the threefry2x32 that shadow_tpu/ops/prng.py:30 traces with
// xp=jnp: 20 rounds with rotations (13,15,26,6) and (17,29,16,24), a key
// injection after every 4 rounds, uint32 wraparound throughout. Bit for bit
// ops/prng.py's numpy and plain PyTorch versions.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace shadow_tf {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kPktShift = 26;  // packet-lane index position in counter word 1

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#define TF_ROUND(r)      \
  x0 += x1;              \
  x1 = rotl32(x1, (r));  \
  x1 ^= x0;
#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_GROUP_A x0 += k1; x1 += k2 + 1u;
  TF_GROUP_B x0 += k2; x1 += k0 + 2u;
  TF_GROUP_A x0 += k0; x1 += k1 + 3u;
  TF_GROUP_B x0 += k1; x1 += k2 + 4u;
  TF_GROUP_A x0 += k2; x1 += k0 + 5u;
#undef TF_GROUP_B
#undef TF_GROUP_A
#undef TF_ROUND
  return make_uint2(x0, x1);
}

// Lane-parallel draws of one unit's packet lanes. A segment of `seg`
// threads (a power of two up to 32, aligned in its warp) draws one unit:
// its thread l evaluates lanes l and l + 32, where they lie below `lanes`
// (l + 32 only when seg is 32, so widths up to 64 take two lanes a thread
// and no unit's lanes run in a chain of more than two), and the segment
// combines its threads' results with one warp-synchronous instruction.

// The draw of no lane: above every 24-bit draw.
constexpr uint32_t kNoDraw = 0xFFFFFFFFu;

// The least 24-bit draw of packet lanes l and l + 32 of the unit (lo, hi)
// among those below `lanes`; kNoDraw when neither is.
__device__ __forceinline__ uint32_t lane_pair_min(uint32_t k0, uint32_t k1,
                                                  uint32_t lo, uint32_t hi,
                                                  uint32_t lanes,
                                                  uint32_t l) {
  uint32_t m = kNoDraw;
  if (l < lanes) m = threefry2x32(k0, k1, lo, hi | (l << kPktShift)).x >> 8;
  if (l + 32u < lanes)
    m = min(m, threefry2x32(k0, k1, lo, hi | ((l + 32u) << kPktShift)).x >> 8);
  return m;
}

// The calling thread's segment as a warp mask (seg a power of two <= 32).
__device__ __forceinline__ uint32_t segment_mask(int seg) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const uint32_t ones = seg == 32 ? 0xFFFFFFFFu : (1u << seg) - 1u;
  return ones << (lane & ~(seg - 1));
}

}  // namespace shadow_tf
