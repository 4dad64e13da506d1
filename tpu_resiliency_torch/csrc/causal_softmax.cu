// Causal scale-mask-softmax over attention scores on Hopper, forward and backward.
//
// Replaces no TPU kernel: the JAX package computes attention with einsums and a
// softmax outside any Pallas kernel. It was added because the port's train step spent
// most of its device time in the f32 elementwise chain between the two products of
// `_attention` (tpu_resiliency_torch/models/transformer.py): the bf16 scores cast to
// f32, divided by sqrt(dh), masked with -1e30 above the causal diagonal, a softmax in
// f32 and a cast back, and the same chain backward. Each of those passes reads and
// writes the whole [B, H, Tq, Tk] score tensor in f32.
//
// Layout. `scores` is [rows, Tk] of bf16 or fp16, contiguous, as the product
// Q [B, Hkv, G*Tq, dh] x K^T [B, Hkv, dh, Tk] leaves it; row r holds query position
// q = r % Tq, and its columns k <= q + causal_offset are unmasked: n = clamp(q +
// causal_offset + 1, 0, Tk) of them, a prefix of the row.
//
// Forward, per row, every rounding point of the plain chain kept:
//   x_k = f32(s_k) * inv_scale  (rounded; torch divides a CUDA tensor by a Python
//                                scalar as a product with the f32 reciprocal)
//   m   = max(x_k over k < n, and -1e30 if n < Tk)
//   l   = sum of expf(x_k - m) over k < n, plus (Tk - n) * expf(-1e30 - m)
//   p_k = expf(x_k - m) / l for k < n, expf(-1e30 - m) / l for k >= n
// written rounded to the scores' type, with m and l saved in f32 for the backward.
// The masked columns are never read: their value is one constant per row, exactly 0
// wherever the row's max lies above -1e30 + 104 (expf underflows), and 1 / Tk in a row
// with no unmasked column, as the plain softmax of an all -1e30 row gives. Scores that
// scale to -1e30 or below, inf and NaN are outside the contract.
//
// Backward, per row, from dP (the gradient of the probabilities), the saved scores,
// m and l: p_k is recomputed by the forward's own formula, so it is the f32 value the
// forward rounded; then with t_k = dp_k * p_k and c = sum of t_k over k < n (a masked
// column's p is 0),
//   ds_k = fma(-p_k, c, t_k) * inv_scale for k < n, 0 for k >= n,
// written rounded to the scores' type: the plain chain's softmax backward
// (t - p * c, with t computed first), the mask's zeros and the scale's derivative.
// A row with no unmasked column gets zeros. The reductions run in a fixed order, so a
// launch is deterministic.
//
// Bound. Bytes: the forward reads the unmasked half of the scores and writes the whole
// probability tensor; the backward reads the unmasked half of dP and of the scores and
// writes the whole gradient. At the train cell's layer, [3 * 32 * 4096, 4096] bf16,
// that is 1.6 + 3.2 GB forward and 3.2 + 3.2 GB backward, 1.44 + 1.92 ms a layer at
// 3.35 TB/s. The arithmetic comes close: expf and an IEEE division cost some 10
// instructions each, and each kernel needs p at every unmasked element twice, for a
// row sum and then for the write. So no element divides: the quotient by the row's sum
// l is q = e * r, with r = 1/l rounded once per row, corrected by Markstein's step
// q + fma(-q, l, e) * r, the correctly rounded e / l for any e >= 2^-100 (a smaller e
// divides in full).
//
// Design. One warp per row, 8 rows to a block of 256 threads: a row's reductions are
// shuffles, with no barrier, and 40 to 48 of the SM's 64 warp slots hold a row each (a
// block per row, its prefix held in registers across the passes, kept 4 rows in flight
// per SM and took 3.4 ms forward on an H100). Lane i takes the row's vectors i, i + 32, ...
// (16 bytes a load, a warp's load 512 consecutive bytes). Each pass reads the row's
// unmasked prefix again, from the caches after the first; the last pass loads with
// evict-first hints, and every store streams (st.global.cs), so the written tensor does
// not push the rows still to be re-read out of the caches. The masked columns are
// written first, as zeros (the forward writes a row's other constant over them at its
// end).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (tpu_resiliency_torch/ops/_build.py). Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kMask = -1e30f;
constexpr long long kMaxBlocks = 1LL << 30;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// VEC elements moved by one load or store (16 bytes at VEC = 8).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A streaming store (evict-first) and a last-use load of one pack.
template <typename T, int VEC>
__device__ __forceinline__ void store_streaming(Pack<T, VEC>* p, const Pack<T, VEC>& v) {
  if constexpr (VEC == 8) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
  } else {
    *p = v;
  }
}
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_last(const Pack<T, VEC>* p) {
  if constexpr (VEC == 8) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Pack<T, VEC>*>(&u);
  } else {
    return *p;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> filled(T value) {
  Pack<T, VEC> p;
#pragma unroll
  for (int j = 0; j < VEC; ++j) p.v[j] = value;
  return p;
}

// The same value in every lane of the warp, reduced in a fixed order.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The unmasked columns of the row at `row`: clamp(q + causal_offset + 1, 0, tk).
__device__ __forceinline__ int unmasked(long long row, long long tq, long long tk,
                                        long long causal_offset) {
  const long long n = row % tq + causal_offset + 1;
  return static_cast<int>(n < 0 ? 0 : (n > tk ? tk : n));
}

// x = f32(s) * inv_scale, rounded, as the plain chain scales.
template <typename T>
__device__ __forceinline__ float scaled(T s, float inv_scale) {
  return __fmul_rn(to_f32(s), inv_scale);
}

// e / l, correctly rounded, from r = 1/l correctly rounded (Markstein's theorem: q is
// within an ulp of e / l, the residual e - q * l is exact in an fma, and q plus the
// residual times r rounds to e / l). The residual stays normal for e >= 2^-100.
__device__ __forceinline__ float div_by_sum(float e, float l, float r) {
  if (e < 0x1p-100f) return __fdiv_rn(e, l);
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
causal_softmax_forward_kernel(const T* __restrict__ scores, T* __restrict__ probs,
                              float* __restrict__ row_max, float* __restrict__ row_sum,
                              long long rows, long long tq, long long tk,
                              long long causal_offset, float inv_scale) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int tk_vecs = static_cast<int>(tk / VEC);
  const long long step = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       row < rows; row += step) {
    const P* in = reinterpret_cast<const P*>(scores + row * tk);
    P* out = reinterpret_cast<P*>(probs + row * tk);
    const int n = unmasked(row, tq, tk, causal_offset);
    const int nvec = (n + VEC - 1) / VEC;
    const P zeros = filled<T, VEC>(from_f32<T>(0.0f));
    for (int v = nvec + lane; v < tk_vecs; v += 32) store_streaming(out + v, zeros);

    // The max, the -1e30 of the masked columns included.
    float m = n < tk ? kMask : -CUDART_INF_F;
#pragma unroll 2
    for (int v = lane; v < nvec; v += 32) {
      const P p = in[v];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (v * VEC + j < n) m = fmaxf(m, scaled(p.v[j], inv_scale));
      }
    }
    m = warp_max(m);

    // The sum of the exps, the masked columns' included.
    float l = 0.0f;
#pragma unroll 2
    for (int v = lane; v < nvec; v += 32) {
      const P p = in[v];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (v * VEC + j < n) l = __fadd_rn(l, expf(__fsub_rn(scaled(p.v[j], inv_scale), m)));
      }
    }
    l = warp_sum(l);
    const float masked_exp = n < tk ? expf(__fsub_rn(kMask, m)) : 0.0f;
    if (n < tk) l = __fadd_rn(l, __fmul_rn(static_cast<float>(tk - n), masked_exp));
    const float r = __frcp_rn(l);
    const T masked_p = from_f32<T>(__fdiv_rn(masked_exp, l));
    if (lane == 0) {
      row_max[row] = m;
      row_sum[row] = l;
    }

    // The probabilities of the unmasked prefix.
#pragma unroll 2
    for (int v = lane; v < nvec; v += 32) {
      const P p = load_last(in + v);
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float e = expf(__fsub_rn(scaled(p.v[j], inv_scale), m));
        o.v[j] = v * VEC + j < n ? from_f32<T>(div_by_sum(e, l, r)) : masked_p;
      }
      store_streaming(out + v, o);
    }
    if (masked_exp != 0.0f) {
      const P fill = filled<T, VEC>(masked_p);
      for (int v = nvec + lane; v < tk_vecs; v += 32) store_streaming(out + v, fill);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
causal_softmax_backward_kernel(const T* __restrict__ grad_probs, const T* __restrict__ scores,
                               const float* __restrict__ row_max,
                               const float* __restrict__ row_sum, T* __restrict__ grad_scores,
                               long long rows, long long tq, long long tk,
                               long long causal_offset, float inv_scale) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int tk_vecs = static_cast<int>(tk / VEC);
  const long long step = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       row < rows; row += step) {
    const P* dp_row = reinterpret_cast<const P*>(grad_probs + row * tk);
    const P* s_row = reinterpret_cast<const P*>(scores + row * tk);
    P* out = reinterpret_cast<P*>(grad_scores + row * tk);
    const int n = unmasked(row, tq, tk, causal_offset);
    const int nvec = (n + VEC - 1) / VEC;
    const P zeros = filled<T, VEC>(from_f32<T>(0.0f));
    for (int v = nvec + lane; v < tk_vecs; v += 32) store_streaming(out + v, zeros);
    if (n == 0) continue;
    const float m = row_max[row];
    const float l = row_sum[row];
    const float r = __frcp_rn(l);

    // c = the sum of dp * p over the unmasked columns, p by the forward's formula.
    float c = 0.0f;
#pragma unroll 2
    for (int v = lane; v < nvec; v += 32) {
      const P d = dp_row[v];
      const P s = s_row[v];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (v * VEC + j < n) {
          const float p = div_by_sum(expf(__fsub_rn(scaled(s.v[j], inv_scale), m)), l, r);
          c = __fadd_rn(c, __fmul_rn(to_f32(d.v[j]), p));
        }
      }
    }
    c = warp_sum(c);

    // The gradient of the unmasked prefix.
#pragma unroll 2
    for (int v = lane; v < nvec; v += 32) {
      const P d = load_last(dp_row + v);
      const P s = load_last(s_row + v);
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float ds = 0.0f;
        if (v * VEC + j < n) {
          const float p = div_by_sum(expf(__fsub_rn(scaled(s.v[j], inv_scale), m)), l, r);
          const float t = __fmul_rn(to_f32(d.v[j]), p);
          ds = __fmul_rn(__fmaf_rn(-p, c, t), inv_scale);
        }
        o.v[j] = from_f32<T>(ds);
      }
      store_streaming(out + v, o);
    }
  }
}

unsigned grid_for(long long rows) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool valid(long long rows, long long tq, long long tk, int vec) {
  return rows > 0 && tq > 0 && tk > 0 && tk <= INT_MAX && rows % tq == 0 &&
         (vec == 1 || vec == 8) && tk % vec == 0;
}

template <typename T, int VEC>
int forward_as(const void* scores, void* probs, float* row_max, float* row_sum,
               long long rows, long long tq, long long tk, long long causal_offset,
               float inv_scale, cudaStream_t stream) {
  causal_softmax_forward_kernel<T, VEC><<<grid_for(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<T*>(probs), row_max, row_sum, rows, tq, tk,
      causal_offset, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int backward_as(const void* grad_probs, const void* scores, const float* row_max,
                const float* row_sum, void* grad_scores, long long rows, long long tq,
                long long tk, long long causal_offset, float inv_scale, cudaStream_t stream) {
  causal_softmax_backward_kernel<T, VEC><<<grid_for(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(grad_probs), static_cast<const T*>(scores), row_max, row_sum,
      static_cast<T*>(grad_scores), rows, tq, tk, causal_offset, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `dtype` 0 is bf16, 1 is fp16. `vec` is 8 (tk % 8 == 0 and every pointer 16-byte
// aligned) or 1. Launches on `stream` and returns the CUDA error code of the launch
// (0 on success); the caller raises on anything else.
int tr_causal_softmax_forward(const void* scores, void* probs, float* row_max,
                              float* row_sum, long long rows, long long tq, long long tk,
                              long long causal_offset, float inv_scale, int dtype, int vec,
                              void* stream) {
  if (!valid(rows, tq, tk, vec) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec == 8 ? forward_as<__nv_bfloat16, 8>(scores, probs, row_max, row_sum, rows, tq,
                                                   tk, causal_offset, inv_scale, s)
                    : forward_as<__nv_bfloat16, 1>(scores, probs, row_max, row_sum, rows, tq,
                                                   tk, causal_offset, inv_scale, s);
  }
  return vec == 8 ? forward_as<__half, 8>(scores, probs, row_max, row_sum, rows, tq, tk,
                                          causal_offset, inv_scale, s)
                  : forward_as<__half, 1>(scores, probs, row_max, row_sum, rows, tq, tk,
                                          causal_offset, inv_scale, s);
}

int tr_causal_softmax_backward(const void* grad_probs, const void* scores,
                               const float* row_max, const float* row_sum, void* grad_scores,
                               long long rows, long long tq, long long tk,
                               long long causal_offset, float inv_scale, int dtype, int vec,
                               void* stream) {
  if (!valid(rows, tq, tk, vec) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec == 8 ? backward_as<__nv_bfloat16, 8>(grad_probs, scores, row_max, row_sum,
                                                    grad_scores, rows, tq, tk, causal_offset,
                                                    inv_scale, s)
                    : backward_as<__nv_bfloat16, 1>(grad_probs, scores, row_max, row_sum,
                                                    grad_scores, rows, tq, tk, causal_offset,
                                                    inv_scale, s);
  }
  return vec == 8 ? backward_as<__half, 8>(grad_probs, scores, row_max, row_sum, grad_scores,
                                           rows, tq, tk, causal_offset, inv_scale, s)
                  : backward_as<__half, 1>(grad_probs, scores, row_max, row_sum, grad_scores,
                                           rows, tq, tk, causal_offset, inv_scale, s);
}

const char* tr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
