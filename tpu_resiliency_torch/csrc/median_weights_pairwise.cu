// Telemetry window reduction on Hopper by all-pairs ranking: masked median + masked
// total per window.
//
// Replaces the Pallas TPU kernel `_median_weights_pairwise_kernel` (mode
// "pairwise") and its shared tail `_write_median_and_weight` in
// tpu_resiliency/ops/scoring_pallas.py.
//
// Input: `data` f32 [R, S, W] windows addressed through element strides (the
// telemetry ring's [W, R, S] storage read as a permuted view, no copy) and `counts`
// i32 [R, S]. Output: contiguous f32 [R, S] medians (+inf where count <= 0) and
// weights (the masked sum).
//
// What it computes. The TPU kernel ranks every element of a window at once from one
// [W, W] comparison block: slots past the count become +inf, and
//   rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}
// is each element's stable rank. The shared tail then sums, into 0.0, the values
// (invalid slots zeroed) whose rank is (n-1)/2 and those whose rank is n/2, with
// n = max(count, 1), and the median is half their sum. Stable ranks are distinct, so
// each sum holds one value; it is still added into 0.0f here, so that a picked -0.0
// comes out as +0.0 exactly as the TPU kernel gives it. Over a window of one slot
// XLA folds the sum into the element itself, so there the value is taken as it is.
//
// W <= kRegisterMaxWindow (64 as built): one thread per window, the window in its
// registers. The thread holds x[P], P the smallest power of two >= W (a template
// parameter, chosen from W at launch), and loads it as the loop kernel's register
// path does: neighbouring threads take neighbouring signals, so on the ring view a
// warp's load of slot j reads 32 consecutive words; all W loads are in flight at
// once, predicated on the window only. Slots at or past the count become +inf, slots
// past W are +inf padding. The rank above is the same sum as
//   rank_i = sum_{j<i} [x_j <= x_i] + sum_{j>i} [x_j < x_i],
// and one compare per unordered pair j < i gives both of its terms: c = [x_j <= x_i]
// adds c to rank_i, and [x_i < x_j] = 1 - c to rank_j (NaN is outside the contract,
// as in every TPU kernel). So rank_j starts at its count of later slots, P - 1 - j,
// and each pair adds c to one rank and takes it from the other. The padding changes
// no real slot's rank: a pad lies after every real slot, and +inf < x is false for
// every x. Every index into x and rank is a compile-time constant (all loops are
// unrolled): no shared memory, no barrier, no local memory. The ranks are exact
// small integers held in f32, so each pair is one compare and two FADDs, which issue
// on the FMA pipe beside the compares. The values ranked (n-1)/2 and n/2 are picked
// by predicated selects and added into 0.0f; a statistic past the valid slots gives
// 0, as the TPU tail gives it. The weight is a sequential sum in slot order.
//
// Longer windows: a block of 8 warps stages 32 neighbouring windows (window_tile.cuh:
// coalesced row loads of the strided ring, padded rows). The all-pairs work is then
// parallel over elements: lane t of a warp ranks element i of tile window t, the
// warps taking i = warp, warp + 8, ...; each thread compares its element with the W
// staged slots of its window (a warp reads one word of each of 32 windows per step,
// no bank conflicts). The thread whose rank is a median rank writes its value into
// the window's slot in shared memory; after a barrier the first warp writes the
// medians and the weights (a sequential sum in slot order, as the loop kernel).
// Shared memory: W * 33 * 4 B of dynamic shared memory per block plus 384 B, so
// W <= 1758 on Hopper's 227 KB.
//
// Bound. At 4096 x 64 x 32 the kernel must read 34.6 MB and write 2.1 MB, 0.011 ms
// at 3.35 TB/s. The register path compares each pair of its P slots once,
// P(P-1)/2 = 496 per window (130 M there), 0.008 ms at the H100's compare rate (64 per
// clock per SM: 132 SMs at 1.98 GHz, 16.7 T/s), so bytes bound it. Its instruction
// issue is longer: one compare and two FADDs per pair, about 2,000 instructions per
// thread at P = 32, take 0.016 ms to issue at one per clock per scheduler. The tiled
// path compares all W^2 ordered pairs, as the TPU kernel does, each behind one
// shared-memory load.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (tpu_resiliency_torch/ops/_build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "window_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRegisterThreads = 128;
constexpr size_t kStaticSharedLimit = 48 * 1024;
// Largest window held in registers, a power of two. The build passes it
// (ops/_build.py DEFINES), which is where ops/scoring_kernels.py reads it too.
#ifndef TR_PAIRWISE_REGISTER_MAX_WINDOW
#error "compile with -DTR_PAIRWISE_REGISTER_MAX_WINDOW (ops/_build.py)"
#endif
constexpr int kRegisterMaxWindow = TR_PAIRWISE_REGISTER_MAX_WINDOW;
static_assert(kRegisterMaxWindow >= 1 && (kRegisterMaxWindow & (kRegisterMaxWindow - 1)) == 0,
              "the register path holds a power of two of slots");

template <int P>
__global__ void __launch_bounds__(kRegisterThreads)
median_weights_pairwise_registers_kernel(const float* __restrict__ data,
                                         const int* __restrict__ counts,
                                         float* __restrict__ medians,
                                         float* __restrict__ weights,
                                         long long n_windows, int signals, int window,
                                         long long sr, long long ss, long long sw,
                                         long long cr, long long cs) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_windows) return;

  const long long r = g / signals;
  const long long s = g - r * signals;
  const float* src = data + r * sr + s * ss;
  const int count = counts[r * cr + s * cs];

  // Every load is predicated on the window alone, so none waits for the count; the
  // first P/2 + 1 slots lie inside every window of this P.
  float x[P];
  const float* p = src;
#pragma unroll
  for (int j = 0; j < P; ++j, p += sw) {
    x[j] = j <= P / 2 || j < window ? *p : CUDART_INF_F;
  }

  const int n_valid = min(max(count, 0), window);
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool valid = j < n_valid;
    total += valid ? x[j] : 0.0f;
    x[j] = valid ? x[j] : CUDART_INF_F;
  }

  // One compare per pair j < i: c = [x_j <= x_i] counts for rank_i, 1 - c for rank_j.
  float rank[P];
#pragma unroll
  for (int i = 0; i < P; ++i) rank[i] = static_cast<float>(P - 1 - i);
#pragma unroll
  for (int i = 1; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const float c = x[j] <= x[i] ? 1.0f : 0.0f;
      rank[i] += c;
      rank[j] -= c;
    }
  }

  // A statistic at or past P matches no rank (ranks are 0 .. P - 1); it is past the
  // valid slots too, and gives 0 below.
  const int n = max(count, 1);
  const int k_lo = (n - 1) / 2;
  const int k_hi = n / 2;
  const float f_lo = static_cast<float>(min(k_lo, P));
  const float f_hi = static_cast<float>(min(k_hi, P));
  float v_lo = 0.0f;
  float v_hi = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    v_lo = rank[i] == f_lo ? x[i] : v_lo;
    v_hi = rank[i] == f_hi ? x[i] : v_hi;
  }
  // P == 1 is exactly window == 1, where the picked value keeps its sign.
  const float lo = k_lo < n_valid ? (P == 1 ? v_lo : 0.0f + v_lo) : 0.0f;
  const float hi = k_hi < n_valid ? (P == 1 ? v_hi : 0.0f + v_hi) : 0.0f;
  medians[g] = count > 0 ? 0.5f * (lo + hi) : CUDART_INF_F;
  weights[g] = total;
}

// Launches the register kernel of the smallest P >= window (window <= P on entry).
template <int P, typename... Args>
int launch_registers(int window, unsigned blocks, cudaStream_t stream, Args... args) {
  if constexpr (P > 1) {
    if (window <= P / 2) return launch_registers<P / 2>(window, blocks, stream, args...);
  }
  median_weights_pairwise_registers_kernel<P><<<blocks, kRegisterThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
median_weights_pairwise_kernel(const float* __restrict__ data,
                               const int* __restrict__ counts,
                               float* __restrict__ medians,
                               float* __restrict__ weights, long long n_windows,
                               int signals, int window, long long sr,
                               long long ss, long long sw, long long cr,
                               long long cs) {
  extern __shared__ float xs[];  // [window][kTileStride]
  __shared__ int cnt[tr::kTileWindows];
  __shared__ float lo_s[tr::kTileWindows];
  __shared__ float hi_s[tr::kTileWindows];
  const long long g0 = static_cast<long long>(blockIdx.x) * tr::kTileWindows;
  if (threadIdx.x < tr::kTileWindows) {
    lo_s[threadIdx.x] = 0.0f;
    hi_s[threadIdx.x] = 0.0f;
  }
  tr::stage_tile(data, counts, xs, cnt, g0, n_windows, signals, window, sr, ss,
                 sw, cr, cs);
  __syncthreads();

  const int t = threadIdx.x % tr::kTileWindows;
  const int count = cnt[t];
  const int n = max(count, 1);
  const int lo_idx = (n - 1) / 2;
  const int hi_idx = n / 2;
  for (int i = threadIdx.x / tr::kTileWindows; i < window;
       i += kThreads / tr::kTileWindows) {
    const float xi = xs[i * tr::kTileStride + t];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += xs[j * tr::kTileStride + t] <= xi;
    for (int j = i + 1; j < window; ++j) rank += xs[j * tr::kTileStride + t] < xi;
    const float xf = i < count ? xi : 0.0f;
    const float picked = window == 1 ? xf : 0.0f + xf;
    if (rank == lo_idx) lo_s[t] = picked;
    if (rank == hi_idx) hi_s[t] = picked;
  }
  __syncthreads();

  const long long g = g0 + t;
  if (threadIdx.x < tr::kTileWindows && g < n_windows) {
    float total = 0.0f;
    const int valid = min(count, window);
    for (int j = 0; j < valid; ++j) total += xs[j * tr::kTileStride + t];
    medians[g] = count > 0 ? 0.5f * (lo_s[t] + hi_s[t]) : CUDART_INF_F;
    weights[g] = total;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`: for window <= kRegisterMaxWindow the register kernel, one
// thread per window in blocks of 128; else the tiled kernel, one block of 256 threads
// per 32 windows, with window * 33 * 4 bytes of dynamic shared memory. Returns the
// CUDA error code of the launch (0 on success); the caller raises on anything else.
int tr_median_weights_pairwise(const float* data, const int* counts,
                               float* medians, float* weights,
                               long long n_windows, int signals, int window,
                               long long sr, long long ss, long long sw,
                               long long cr, long long cs, void* stream) {
  if (n_windows <= 0 || signals <= 0 || window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (window <= kRegisterMaxWindow) {
    const long long reg_blocks = (n_windows + kRegisterThreads - 1) / kRegisterThreads;
    if (reg_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    return launch_registers<kRegisterMaxWindow>(
        window, static_cast<unsigned>(reg_blocks), static_cast<cudaStream_t>(stream),
        data, counts, medians, weights, n_windows, signals, window, sr, ss, sw, cr, cs);
  }
  const long long blocks = (n_windows + tr::kTileWindows - 1) / tr::kTileWindows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(window) * tr::kTileStride * sizeof(float);
  if (smem > kStaticSharedLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        median_weights_pairwise_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  median_weights_pairwise_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      data, counts, medians, weights, n_windows, signals, window, sr, ss, sw, cr,
      cs);
  return static_cast<int>(cudaGetLastError());
}

const char* tr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
