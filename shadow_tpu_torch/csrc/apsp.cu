// Device APSP: one min-plus squaring of the (G, G) latency table, carrying
// path reliability along the chosen decomposition.
//
// Replaces the jax.jit program of shadow_tpu/ops/apsp.py:
//   apsp_square_kernel <- _apsp_kernel (apsp.py:30, jit :29), one launch
//                         per iteration of its lax.scan; the wrapper
//                         (shadow_tpu_torch/ops/apsp.py::squarings)
//                         ping-pongs two buffer pairs between launches,
//                         since a squaring cannot update in place
// For every (i, j) it finds k* = the FIRST k with the least
// cand = min(lat[i,k] + lat[k,j], INF_I32), and writes
// lat'[i,j] = cand(k*) and rel'[i,j] = rel[i,k*] * rel[k*,j].
//
// Bit identity with the plain PyTorch version
// (shadow_tpu_torch/ops/apsp.py::square_plain) and the reference,
// tolerance 0:
// - latencies are int32 in [0, INF_I32], so lat[i,k] + lat[k,j] fits;
// - the running minimum starts at (INF_I32, k = 0) and moves only on a
//   strict <, walking k upward: the first minimum, as jnp.argmin. A sum
//   at or above INF_I32 never moves it, so saturation needs no instruction,
//   and a pair with every candidate at INF keeps k* = 0, as the reference;
// - no padding: the reference pads G to a multiple of its block with
//   unreachable rows, and a padded k never wins (its candidate is
//   INF + INF), so this kernel takes any G and masks the ragged tile;
// - the product follows XLA's CPU program, which flushes denormals:
//   ftz_mul counts an operand below 2^-126 as zero and flushes a product
//   that is below 2^-126 after rounding to 24 bits with an unbounded
//   exponent, computed from the exact product in double, so it depends on
//   no flush mode (nvcc is run without --ftz).
//
// Bound on an H100: a squaring does G^3 candidates of about three integer
// operations each (add, compare, select), against 2 G^2 int32/float32
// reads and writes: at G = 4,096 and 12 squarings, 2.5e12 operations, about
// 0.15 s at a quarter of the FP32 rate, against 0.8 ms of bytes. Operations
// bound it. Design: the simple tiled one, as a GEMM's without tensor cores
// (wgmma has no min-plus): a block of 16 x 16 threads owns a 64 x 64
// output tile, each thread 4 x 4 outputs (rows ty + 16 r, columns
// tx + 16 c), walking k in tiles of 16 through shared memory holding
// lat[i0:i0+64, k0:k0+16] (transposed) and lat[k0:k0+16, j0:j0+64]; per
// candidate one add, one compare and two selects in registers. The
// reliability gather runs once per output after the walk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (shadow_tpu_torch/ops/devcfg.py does this).
// Interface: plain C, loaded with ctypes; the entry point launches on the
// given stream and returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = (1 << 30) - 1;  // INF_I32 of network/graph.py
constexpr int kThreads = 16;         // threads per block side
constexpr int kPer = 4;              // outputs per thread side
constexpr int kTile = kThreads * kPer;
constexpr int kTileK = 16;

__device__ __forceinline__ float ftz_mul(float a, float b) {
  if (fabsf(a) < 0x1p-126f) a = copysignf(0.0f, a);
  if (fabsf(b) < 0x1p-126f) b = copysignf(0.0f, b);
  const double p = __dmul_rn(static_cast<double>(a), static_cast<double>(b));
  // the 24-bit rounding of p, scaled by 2^64 into the normal range
  const float q = __double2float_rn(p * 0x1p64);
  if (fabsf(q) < 0x1p-62f)  // tiny after rounding
    return copysignf(0.0f, static_cast<float>(p));
  return __double2float_rn(p);
}

__global__ void __launch_bounds__(kThreads * kThreads)
apsp_square_kernel(const int* __restrict__ lat,
                   const float* __restrict__ rel, int G,
                   int* __restrict__ out_lat, float* __restrict__ out_rel) {
  __shared__ int As[kTileK][kTile];  // As[k][i] = lat[i0 + i, k0 + k]
  __shared__ int Bs[kTileK][kTile];  // Bs[k][j] = lat[k0 + k, j0 + j]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  int best[kPer][kPer];
  int kbest[kPer][kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      best[r][c] = kInf;
      kbest[r][c] = 0;
    }
  for (int k0 = 0; k0 < G; k0 += kTileK) {
    // 1,024 entries of each tile, 4 a thread; out-of-range entries are
    // INF, whose sums never move a minimum
#pragma unroll
    for (int e = tid; e < kTile * kTileK; e += kThreads * kThreads) {
      const int ai = e / kTileK, ak = e % kTileK;
      const int gi = i0 + ai, gk = k0 + ak;
      As[ak][ai] = (gi < G && gk < G) ? lat[gi * G + gk] : kInf;
      const int bk = e / kTile, bj = e % kTile;
      const int hk = k0 + bk, hj = j0 + bj;
      Bs[bk][bj] = (hk < G && hj < G) ? lat[hk * G + hj] : kInf;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      int a[kPer], b[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) a[r] = As[k][ty + kThreads * r];
#pragma unroll
      for (int c = 0; c < kPer; ++c) b[c] = Bs[k][tx + kThreads * c];
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int s = a[r] + b[c];
          const bool lt = s < best[r][c];
          best[r][c] = lt ? s : best[r][c];
          kbest[r][c] = lt ? k0 + k : kbest[r][c];
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + ty + kThreads * r;
    if (i >= G) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = j0 + tx + kThreads * c;
      if (j >= G) continue;
      const int ks = kbest[r][c];
      out_lat[i * G + j] = best[r][c];
      out_rel[i * G + j] = ftz_mul(rel[i * G + ks], rel[ks * G + j]);
    }
  }
}

}  // namespace

extern "C" {

int shadow_apsp_square(const void* lat, const void* rel, int G,
                       void* out_lat, void* out_rel, void* stream) {
  if (G <= 0 || G >= (1 << 15)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads, kThreads);
  const dim3 grid((G + kTile - 1) / kTile, (G + kTile - 1) / kTile);
  apsp_square_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lat), static_cast<const float*>(rel), G,
      static_cast<int*>(out_lat), static_cast<float*>(out_rel));
  return static_cast<int>(cudaGetLastError());
}

const char* shadow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
