// Transport kernel of the device-resident columnar transport: one clean
// cumulative-ack advance per endpoint row.
//
// Replaces the jax.jit program of shadow_tpu/ops/transport_kernels.py:
//   ack_advance_kernel <- ack_advance (transport_kernels.py:112, jit :179),
//                         with cc_on_ack (:63) and icbrt (:48) inside it
// It computes, for each row, StreamSender.on_ack's strict-advance
// arithmetic: NewReno and CUBIC congestion-window growth in int64, a
// 21-step binary-search cube root, and CUBIC epoch adoption, returning
// (snd_una', bytes_acked', cwnd', w_max', epoch_start').
//
// Bit identity with the plain PyTorch version
// (shadow_tpu_torch/ops/transport_kernels.py::ack_advance_torch) and the
// reference, tolerance 0:
// - every // of the reference floors; CUDA's / truncates, so each division
//   goes through floor_div (a negative dividend occurs: (now - eps) when
//   now < eps, and the CUBIC increment when cwnd > target, where the
//   value is computed by the reference and then discarded);
// - sums, differences and products run in unsigned 64 bits and are cast
//   back, so they wrap as XLA's and numpy's int64 do (signed overflow is
//   undefined in C++). The transport's clamps keep mid^3 <= 2^60,
//   a^3 <= 8e15 and min(target - cwnd, 2^40) * nn <= 2^60 anyway;
// - the cube root runs exactly 21 trips over [0, 2^20] with
//   mid = (lo + hi + 1) >> 1 and never ends early: its identity with the
//   scalar transport._icbrt rests on the fixed trip count;
// - the reference computes all three window candidates for every row and
//   selects; this kernel computes only the selected one (every divisor is
//   cwnd >= MIN_CWND > 0 or a constant, so no row can fault).
//
// Bound on an H100: a row reads 9 and writes 5 int64 values (112 bytes),
// about 33 ps at 3.35 TB/s, and does at most about 240 integer operations
// (the cube root's 21 trips take most), about 14 ps at a quarter of the
// FP32 rate: bytes bound it. The cohorts of the shipped configs hold tens
// to a few hundred rows, so launch latency and the host round trip around
// the launch set the time, not this code (chip_smoke.py measures both).
//
// Design: one thread a row, 256 threads a block, a grid of ceil(n / 256)
// blocks over the n real rows of a slot of bucket width P (rows stride P,
// n <= P): no thread works on a pad, and the pads are neither read nor
// written. DeviceAckKernel (ops/transport_kernels.py) hands the kernel
// the card's addresses of a page-locked slot that is made once per bucket
// and reused, so the kernel reads the cohort and writes its result in
// place across PCIe: a cohort queues one launch and no copy. Each column
// is contiguous, so a warp's load of one column is 256 consecutive bytes,
// one coalesced request; the nine loads of a thread are independent and
// in flight together. chip_smoke.py times this against one copy each way
// to device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (shadow_tpu_torch/ops/devcfg.py does this).
// Interface: plain C, loaded with ctypes; the entry point launches on the
// given stream and returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr i64 kNsPerMs = 1000000LL;
constexpr i64 kMss = 1460;
constexpr i64 kMinCwnd = 2 * kMss;
constexpr i64 kCcCubic = 1;
constexpr int kIcbrtIters = 21;

// int64 arithmetic that wraps, as XLA's and numpy's does
__device__ __forceinline__ i64 add(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
__device__ __forceinline__ i64 sub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}
__device__ __forceinline__ i64 mul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}

// Python's a // b for b > 0 (every divisor here is positive)
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ i64 clamp(i64 x, i64 lo, i64 hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// floor integer cube root of 0 <= x < 2^60: transport._icbrt, fixed-trip
__device__ i64 icbrt(i64 x) {
  i64 lo = 0;
  i64 hi = 1LL << 20;
#pragma unroll
  for (int it = 0; it < kIcbrtIters; ++it) {
    const i64 mid = add(add(lo, hi), 1) >> 1;
    if (mul(mul(mid, mid), mid) <= x) {
      lo = mid;
    } else {
      hi = sub(mid, 1);
    }
  }
  return lo;
}

// in: (9, p) int64 rows [cc_id, cwnd, ssthresh, w_max, epoch_start,
//     snd_una, bytes_acked, cum_ack, now], row-major, of which the first
//     n columns are real
// out: (5, p) int64 rows [snd_una', bytes_acked', cwnd', w_max',
//      epoch_start'], of which the first n columns are written
__global__ void ack_advance_kernel(const i64* __restrict__ in, int p, int n,
                                   i64* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 N = p;  // 64-bit row offsets: 8 * p may pass 2^31
  const i64 cc_id = in[i];
  const i64 cwnd = in[N + i];
  const i64 ssthresh = in[2 * N + i];
  const i64 w_max = in[3 * N + i];
  const i64 epoch_start = in[4 * N + i];
  const i64 snd_una = in[5 * N + i];
  const i64 bytes_acked = in[6 * N + i];
  const i64 cum_ack = in[7 * N + i];
  const i64 now = in[8 * N + i];

  const i64 newly = sub(cum_ack, snd_una);
  i64 cwnd2, w_max2 = w_max, eps2 = epoch_start;
  if (cwnd < ssthresh) {
    // slow start, both algorithms: cwnd += min(newly, cwnd)
    cwnd2 = add(cwnd, newly < cwnd ? newly : cwnd);
  } else if (cc_id == kCcCubic) {
    // CubicLike congestion avoidance; the first CA ack with no recorded
    // epoch adopts (now, cwnd)
    const bool es0 = epoch_start == 0;
    const i64 eps = es0 ? now : epoch_start;
    const i64 wmax = es0 ? cwnd : w_max;
    const i64 t_ms = floor_div(sub(now, eps), kNsPerMs);
    const i64 wmax_c = wmax < (1LL << 32) ? wmax : (1LL << 32);
    const i64 k_ms = icbrt(
        mul(floor_div(mul(wmax_c, 3), 4 * kMss), 1000000000LL));
    const i64 d = clamp(sub(t_ms, k_ms), -200000, 200000);
    const i64 a = d < 0 ? -d : d;
    const i64 delta = floor_div(
        mul(floor_div(mul(mul(a, a), a), 1000000), 4 * kMss), 10000);
    const i64 target = clamp(d < 0 ? sub(wmax, delta) : add(wmax, delta),
                             kMinCwnd, 1LL << 45);
    const i64 nn = newly < (1LL << 20) ? newly : (1LL << 20);
    if (cwnd < target) {
      const i64 gap = sub(target, cwnd);
      const i64 inc = floor_div(mul(gap < (1LL << 40) ? gap : (1LL << 40),
                                    nn), cwnd);
      const i64 grown = add(cwnd, inc > 1 ? inc : 1);
      cwnd2 = grown < target ? grown : target;
    } else {
      const i64 step = floor_div(mul(kMss, nn), mul(100, cwnd));
      cwnd2 = add(cwnd, step > 1 ? step : 1);
    }
    w_max2 = wmax;
    eps2 = eps;
  } else {
    // NewReno congestion avoidance: cwnd += max(1, MSS * newly // cwnd)
    const i64 step = floor_div(mul(kMss, newly), cwnd);
    cwnd2 = add(cwnd, step > 1 ? step : 1);
  }
  out[i] = cum_ack;
  out[N + i] = add(bytes_acked, newly);
  out[2 * N + i] = cwnd2;
  out[3 * N + i] = w_max2;
  out[4 * N + i] = eps2;
}

}  // namespace

extern "C" {

// ack_advance on the first n of p columns of in (9, p) into out (5, p):
// device memory, or the device addresses of page-locked host memory
int shadow_ack_advance(const void* in, int p, int n, void* out,
                       void* stream) {
  if (n <= 0 || n > p) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  ack_advance_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(in), p, n, static_cast<i64*>(out));
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
