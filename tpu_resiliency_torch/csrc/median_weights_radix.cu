// Telemetry window reduction on Hopper by radix select: masked median + masked total
// per window, for long windows.
//
// Replaces the Pallas TPU kernel `_median_weights_radix_kernel` and its
// `_radix_select` (mode "radix") in tpu_resiliency/ops/scoring_pallas.py.
//
// Input: `data` f32 [R, S, W] windows addressed through element strides (the
// telemetry ring's [W, R, S] storage read as a permuted view, no copy) and `counts`
// i32 [R, S]. Output: contiguous f32 [R, S] medians (+inf where count <= 0) and
// weights (the masked sum).
//
// What it computes. Each float maps to its unsigned order key
//   u = b < 0 ? ~b : b | 0x80000000   (b: the float's bits)
// which orders as the floats do, with -0.0 below +0.0 (JAX's signed key XOR
// INT_MIN). The order statistics k = (n-1)/2 and n/2, n = max(count, 1), are
// selected among the valid slots MSB first: at each of the 32 bits the candidates
// that match the prefix chosen so far and have a 0 there are counted; the selection
// keeps the 0 branch if k is below that count, else it takes k minus the count into
// the 1 branch. After 32 bits the prefix is the selected key. The TPU kernel
// extracts the value as the min over the surviving candidates, which all share that
// key, so the value is the key decoded, -0.0 included; where no valid slot has the
// key (k past the valid slots, only when count > W) the min is over nothing, +inf.
//
// Invalid slots and the padding past W get the key 0xffffffff. A counted key must
// match a prefix followed by a 0 bit, which all-ones never does, so every count, and
// therefore every branch, equals the TPU kernel's with its candidate mask.
//
// Design. A block of 8 warps stages 32 neighbouring windows (window_tile.cuh:
// coalesced row loads of the strided ring, padded rows). Each warp then selects one
// window at a time: lane l holds keys l, l + 32, ... in registers (KPL keys, a
// template parameter: the next power of two of W / 32), and each pass counts its
// matches and sums them over the warp with one __reduce_add_sync. Both order
// statistics are counted in the same pass over the keys; while their prefixes agree
// (always for odd n) one count serves both. The weight is each lane's sum of its
// valid values, summed over the warp by shuffles: another order than the plain
// version's sum, so weights agree within a tolerance, medians bit for bit.
//
// Bound. Per report the kernel must read R*S*W*4 + R*S*4 bytes and write 2*R*S*4;
// at 4096 x 64 x 512 that is 540,016,640 B, 0.1612 ms at 3.35 TB/s. The radix
// formulation does 64*W key tests per window (8.59e9 at that shape, 0.128 ms at the
// 67 T/s 32-bit non-tensor rate), so bytes bound it on paper. This version spends
// about three integer instructions per key per pass (shift, compare, add) over all
// keys in every pass: it is limited by instruction issue, not by memory. Skipping
// keys that left the candidate set, or counting on bit-sliced keys, is later work.
//
// Shared memory: W * 33 * 4 B of dynamic shared memory per block (the staged tile)
// plus 128 B of counts, so W <= 1758 on Hopper's 227 KB (the Python gate).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (tpu_resiliency_torch/ops/_build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "window_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;
constexpr size_t kStaticSharedLimit = 48 * 1024;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

template <int KPL>
__global__ void __launch_bounds__(kThreads)
median_weights_radix_kernel(const float* __restrict__ data,
                            const int* __restrict__ counts,
                            float* __restrict__ medians,
                            float* __restrict__ weights, long long n_windows,
                            int signals, int window, long long sr, long long ss,
                            long long sw, long long cr, long long cs) {
  extern __shared__ float xs[];  // [window][kTileStride]
  __shared__ int cnt[tr::kTileWindows];
  const long long g0 = static_cast<long long>(blockIdx.x) * tr::kTileWindows;
  tr::stage_tile(data, counts, xs, cnt, g0, n_windows, signals, window, sr, ss,
                 sw, cr, cs);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x / 32; t < tr::kTileWindows; t += kThreads / 32) {
    const long long g = g0 + t;
    if (g >= n_windows) break;  // warp-uniform
    const int count = cnt[t];
    const int n_valid = min(count, window);
    unsigned key[KPL];
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = lane + 32 * i;
      const bool valid = j < n_valid;
      const float v = valid ? xs[j * tr::kTileStride + t] : 0.0f;
      key[i] = valid ? order_key(v) : kNoKey;
      total += v;
    }

    const int n = max(count, 1);
    unsigned k_lo = (n - 1) / 2;
    unsigned k_hi = n / 2;
    unsigned p_lo = 0;  // key bits chosen so far, MSB first
    unsigned p_hi = 0;
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned t_lo = p_lo << 1;  // prefix followed by a 0 bit
      const unsigned t_hi = p_hi << 1;
      unsigned c_lo = 0;
      unsigned c_hi = 0;
      if (t_lo == t_hi) {
#pragma unroll
        for (int i = 0; i < KPL; ++i) c_lo += (key[i] >> bit) == t_lo;
        c_lo = __reduce_add_sync(kFullMask, c_lo);
        c_hi = c_lo;
      } else {
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const unsigned u = key[i] >> bit;
          c_lo += u == t_lo;
          c_hi += u == t_hi;
        }
        c_lo = __reduce_add_sync(kFullMask, c_lo);
        c_hi = __reduce_add_sync(kFullMask, c_hi);
      }
      if (k_lo < c_lo) {
        p_lo = t_lo;
      } else {
        k_lo -= c_lo;
        p_lo = t_lo | 1u;
      }
      if (k_hi < c_hi) {
        p_hi = t_hi;
      } else {
        k_hi -= c_hi;
        p_hi = t_hi | 1u;
      }
    }

    // Does a valid slot hold each selected key? Always, unless count > W.
    bool has_lo = false;
    bool has_hi = false;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const bool valid = lane + 32 * i < n_valid;
      has_lo |= valid && key[i] == p_lo;
      has_hi |= valid && key[i] == p_hi;
    }
    has_lo = __any_sync(kFullMask, has_lo);
    has_hi = __any_sync(kFullMask, has_hi);

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFullMask, total, off);
    }
    if (lane == 0) {
      const float lo = has_lo ? from_order_key(p_lo) : CUDART_INF_F;
      const float hi = has_hi ? from_order_key(p_hi) : CUDART_INF_F;
      medians[g] = count > 0 ? 0.5f * (lo + hi) : CUDART_INF_F;
      weights[g] = total;
    }
  }
}

template <int KPL>
int launch(const float* data, const int* counts, float* medians, float* weights,
           long long n_windows, int signals, int window, long long sr,
           long long ss, long long sw, long long cr, long long cs,
           cudaStream_t stream) {
  const long long blocks = (n_windows + tr::kTileWindows - 1) / tr::kTileWindows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(window) * tr::kTileStride * sizeof(float);
  if (smem > kStaticSharedLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        median_weights_radix_kernel<KPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  median_weights_radix_kernel<KPL>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          data, counts, medians, weights, n_windows, signals, window, sr, ss, sw,
          cr, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: one block of 256 threads per 32 windows, with
// window * 33 * 4 bytes of dynamic shared memory. Returns the CUDA error code of the
// launch (0 on success); the caller raises on anything else.
int tr_median_weights_radix(const float* data, const int* counts, float* medians,
                            float* weights, long long n_windows, int signals,
                            int window, long long sr, long long ss, long long sw,
                            long long cr, long long cs, void* stream) {
  if (n_windows <= 0 || signals <= 0 || window <= 0 || window > 64 * 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpl = (window + 31) / 32;
#define TR_RADIX_LAUNCH(K)                                                   \
  return launch<K>(data, counts, medians, weights, n_windows, signals, window, \
                   sr, ss, sw, cr, cs, st)
  if (kpl <= 1) TR_RADIX_LAUNCH(1);
  if (kpl <= 2) TR_RADIX_LAUNCH(2);
  if (kpl <= 4) TR_RADIX_LAUNCH(4);
  if (kpl <= 8) TR_RADIX_LAUNCH(8);
  if (kpl <= 16) TR_RADIX_LAUNCH(16);
  if (kpl <= 32) TR_RADIX_LAUNCH(32);
  TR_RADIX_LAUNCH(64);
#undef TR_RADIX_LAUNCH
}

const char* tr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
