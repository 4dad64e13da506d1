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
// INT_MIN). With n = max(count, 1) and n_valid = min(count, W), the median is the
// mean of the order statistics k_lo = (n-1)/2 and k_hi = n/2 among the valid slots,
// each decoded from its key, so -0.0 comes out as -0.0. An order statistic past the
// valid slots (only when count > W) is +inf, as the TPU kernel's masked min over no
// candidate. Any exact selection on the key returns the key the TPU kernel's 32
// one-bit passes reach, so the medians equal its bits.
//
// Design. A block of 8 warps stages 32 neighbouring windows (window_tile.cuh:
// coalesced row loads of the strided ring, padded rows), and one warp selects one
// window at a time; lane l holds the keys of slots l, l + 32, ... in registers (KPL
// keys, the next power of two of W / 32). Only k_lo is selected, by digit rounds over
// a candidate list that shrinks (multi-bit radix select with candidate filtering, as
// in "AIR Top-K", Zhang et al., SC '23). The first candidates are the valid keys; a
// round
//  - ends the selection if the candidates' OR equals their AND (all one key);
//  - else takes the 5-bit digit just below and including hb, the highest bit where
//    they differ (the bits above it are common, so no prefix test is needed);
//  - counts the 32 digit bins, lane b counting bin b: per slot one ballot of the
//    candidacy and one of each digit bit, lane b's count is the popcount of their
//    AND with each plane taken as is or inverted after bit j of b. No atomics, so the
//    time does not depend on how the keys crowd into bins;
//  - picks the bin holding rank k from an inclusive warp scan of the counts and
//    takes the lower bins' count off k;
//  - compacts that bin's keys, in slot order, into the window's own column of the
//    staged tile (dead once the keys are in registers): the write index never passes
//    the read index, so the column is rewritten in place.
// Later rounds read their candidates from the column until at most 32 are left;
// from then on (and from the start where a window holds at most 32 valid keys) they
// are one register per lane and a round writes nothing. The digit bits are tested on
// the key itself with per-round masks, and the first round visits every register
// slot: a branch per slot around the ballots cost more than it saved. Each round
// fixes bit hb at least, so there are at most 32; on telemetry (a few % of noise
// around a base) a window takes about three, and only the first reads all W keys.
// k_hi then follows from k_lo in one pass over the register keys: with
// c_le = #(keys <= lo) and nxt the least key above lo, hi = lo if c_le > k_hi, else
// nxt (k_hi <= k_lo + 1). The weight is each lane's sum of its valid values, summed
// over the warp by shuffles: another order than the plain version's sum, so weights
// agree within a tolerance, medians bit for bit.
//
// Bound. Per report the kernel must read R*S*W*4 + R*S*4 bytes and write 2*R*S*4; at
// 4096 x 64 x 512 that is 540,016,640 B, 0.1612 ms at 3.35 TB/s. Its key operations,
// 2 * sum_r m_r + 3 * n_valid per window (m_r: candidates of round r; a count and a
// compaction test per candidate, the order key, the hi pass), take far less at
// 67 T/s; chip_smoke.py counts them on the run's own data. The earlier design ran 32
// one-bit passes over all W keys for both order statistics, about 130 issued
// instructions per register key, and was bound by instruction issue at 8.2x the
// bytes bound. This one issues about 40 per register key in its first round and
// little after it. On an H100 (700 W) at that shape the same launch on windows of
// one value each, where no round runs, takes about 70% of its time on telemetry: the
// tile's staging (window_tile.cuh), whose loop keeps one load per thread in flight,
// now holds the kernel, not the selection.
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
constexpr int kDigitBits = 5;  // 32 bins: one per lane
constexpr unsigned kDigitMask = (1u << kDigitBits) - 1u;
constexpr size_t kStaticSharedLimit = 48 * 1024;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// The 5-bit digit of a round: the candidates' bits [shift, shift + 5), where shift
// puts the top bit of `diff` (their highest differing bit) at the digit's top, or 0.
struct Digit {
  unsigned low;   // 1 << shift
  unsigned mask;  // kDigitMask << shift

  __device__ __forceinline__ explicit Digit(unsigned diff) {
    const int shift = max(31 - __clz(diff) - (kDigitBits - 1), 0);
    low = 1u << shift;
    mask = kDigitMask << shift;
  }
};

// How many of this slot's 32 candidates have digit == lane: the AND of the
// candidacy ballot with each digit-bit plane, inverted where the lane's bit is 0.
__device__ __forceinline__ unsigned bin_count(bool cand, unsigned u, Digit d,
                                              const unsigned (&flip)[kDigitBits]) {
  unsigned match = __ballot_sync(kFullMask, cand);
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    match &= __ballot_sync(kFullMask, (u & (d.low << b)) != 0u) ^ flip[b];
  }
  return __popc(match);
}

// The bin holding candidate rank k, from the bin counts (lane b holds bin b's), as
// the key bits it selects (bin << shift). Takes the lower bins' count off k and sets
// m to the chosen bin's count.
__device__ __forceinline__ unsigned choose_bin(unsigned count, int lane, Digit d,
                                               unsigned& k, unsigned& m) {
  unsigned incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += up;
  }
  const unsigned bin = __ffs(__ballot_sync(kFullMask, incl > k)) - 1;
  k -= __shfl_sync(kFullMask, incl - count, bin);
  m = __shfl_sync(kFullMask, count, bin);
  return bin * d.low;
}

// Appends u to the window's column if keep, after the `out` keys kept so far and the
// kept keys of lower lanes; folds it into the kept keys' OR and AND.
__device__ __forceinline__ void append(bool keep, unsigned u, float* col,
                                       unsigned lower_lanes, unsigned& out,
                                       unsigned& k_or, unsigned& k_and) {
  const unsigned kept = __ballot_sync(kFullMask, keep);
  if (keep) {
    col[(out + __popc(kept & lower_lanes)) * tr::kTileStride] = __uint_as_float(u);
    k_or |= u;
    k_and &= u;
  }
  out += __popc(kept);
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
  const unsigned lower_lanes = (1u << lane) - 1u;
  unsigned flip[kDigitBits];  // lane b keeps plane j where bit j of b is 1
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) flip[b] = ((lane >> b) & 1) ? 0u : kFullMask;

  for (int t = threadIdx.x / 32; t < tr::kTileWindows; t += kThreads / 32) {
    const long long g = g0 + t;
    if (g >= n_windows) break;  // warp-uniform
    const int count = cnt[t];
    const int n_valid = min(count, window);
    float* col = xs + t;  // slot j of this window at col[j * kTileStride]
    unsigned key[KPL];
    float total = 0.0f;
    unsigned k_or = 0;
    unsigned k_and = kNoKey;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = lane + 32 * i;
      const bool valid = j < n_valid;
      const float v = valid ? col[j * tr::kTileStride] : 0.0f;
      key[i] = valid ? order_key(v) : kNoKey;
      total += v;
      if (valid) k_or |= key[i];
      k_and &= key[i];
    }

    const int n = max(count, 1);
    const int k_lo = (n - 1) / 2;
    const int k_hi = n / 2;
    unsigned lo = kNoKey;
    unsigned hi = kNoKey;
    if (k_lo < n_valid) {  // warp-uniform, as every branch below
      unsigned all_or = __reduce_or_sync(kFullMask, k_or);
      unsigned all_and = __reduce_and_sync(kFullMask, k_and);
      unsigned k = k_lo;
      // The candidates once at most 32 are left: u in each lane where cand.
      bool cand = lane < n_valid;
      unsigned u = key[0];
      if (KPL > 1 && n_valid > 32 && all_or != all_and) {
        // First round: the valid register keys; the chosen bin goes to the column.
        // Every slot is visited (the candidacy ballot masks the invalid ones): a
        // branch per slot around the ballots costs more than a full window saves.
        Digit d(all_or ^ all_and);
        unsigned c = 0;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          c += bin_count(lane + 32 * i < n_valid, key[i], d, flip);
        }
        unsigned m;
        unsigned sel = choose_bin(c, lane, d, k, m);
        unsigned out = 0;
        k_or = 0;
        k_and = kNoKey;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          append(lane + 32 * i < n_valid && (key[i] & d.mask) == sel, key[i], col,
                 lower_lanes, out, k_or, k_and);
        }
        __syncwarp();
        all_or = __reduce_or_sync(kFullMask, k_or);
        all_and = __reduce_and_sync(kFullMask, k_and);
        // Column rounds while more than 32 candidates differ.
        while (m > 32 && all_or != all_and) {
          d = Digit(all_or ^ all_and);
          c = 0;
          for (unsigned s0 = 0; s0 < m; s0 += 32) {
            const bool in = s0 + lane < m;
            const unsigned v = in ? __float_as_uint(col[(s0 + lane) * tr::kTileStride]) : 0u;
            c += bin_count(in, v, d, flip);
          }
          unsigned m_next;
          sel = choose_bin(c, lane, d, k, m_next);
          out = 0;
          k_or = 0;
          k_and = kNoKey;
          for (unsigned s0 = 0; s0 < m; s0 += 32) {
            const bool in = s0 + lane < m;
            const unsigned v = in ? __float_as_uint(col[(s0 + lane) * tr::kTileStride]) : 0u;
            append(in && (v & d.mask) == sel, v, col, lower_lanes, out, k_or, k_and);
          }
          __syncwarp();
          m = m_next;
          all_or = __reduce_or_sync(kFullMask, k_or);
          all_and = __reduce_and_sync(kFullMask, k_and);
        }
        cand = lane < m;
        u = cand ? __float_as_uint(col[lane * tr::kTileStride]) : 0u;
      }
      // Register rounds over at most 32 candidates, one per lane.
      while (all_or != all_and) {
        const Digit d(all_or ^ all_and);
        unsigned m;
        const unsigned sel = choose_bin(bin_count(cand, u, d, flip), lane, d, k, m);
        cand = cand && (u & d.mask) == sel;
        all_or = __reduce_or_sync(kFullMask, cand ? u : 0u);
        all_and = __reduce_and_sync(kFullMask, cand ? u : kNoKey);
      }
      lo = all_and;

      if (k_hi == k_lo) {
        hi = lo;
      } else if (k_hi < n_valid) {
        // Invalid slots hold kNoKey: never <= lo, and never the least key above it
        // while a valid one is.
        unsigned c_le = 0;
        unsigned nxt = kNoKey;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          c_le += key[i] <= lo;
          nxt = min(nxt, key[i] > lo ? key[i] : kNoKey);
        }
        c_le = __reduce_add_sync(kFullMask, c_le);
        nxt = __reduce_min_sync(kFullMask, nxt);
        hi = c_le > static_cast<unsigned>(k_hi) ? lo : nxt;
      }
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFullMask, total, off);
    }
    if (lane == 0) {
      const float lo_v = k_lo < n_valid ? from_order_key(lo) : CUDART_INF_F;
      const float hi_v = k_hi < n_valid ? from_order_key(hi) : CUDART_INF_F;
      medians[g] = count > 0 ? 0.5f * (lo_v + hi_v) : CUDART_INF_F;
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
