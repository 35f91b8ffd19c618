// Shared by the GF(q) FFT-QSPA decoders (qspa.cu, K5; qspa_qc.cu, K6): the
// GF(q) tables, and the per-edge steps of the check-node update on one
// q-vector spread over a group of W lanes (W = 32 for K5, W = q for K6),
// R = q / W registers per lane: symbol y sits in lane y % W, register y / W.
//
// Arithmetic follows ops/nb_decode.py's `_qspa_cn_core` operation by
// operation (its docstring fixes every order): fp32 adds, subtracts,
// multiplies and divides through the __f*_rn intrinsics (nvcc cannot
// contract them into an FMA), expf/logf from the CUDA math library, no fast
// math.  Max, argmax and the GF tables are exact in any order.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace qspa {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-30f;  // pmf floor before the log (a normal float)
constexpr float kNeg = -1e30f;

// GF(q) with log/antilog tables: lg[a] = log_alpha(a) for a != 0, and ex
// doubled to 2(q - 1) entries so that no index needs a modulo.
static __device__ __forceinline__ int gf_mul(const int* lg, const int* ex,
                                             int a, int b) {
  return (a == 0 || b == 0) ? 0 : ex[lg[a] + lg[b]];
}

// y / h for h != 0: the symbol x with h * x = y.
static __device__ __forceinline__ int gf_div(const int* lg, const int* ex,
                                             int y, int h, int q) {
  return y == 0 ? 0 : ex[lg[y] + (q - 1) - lg[h]];
}

static __device__ __forceinline__ void load_gf_tables(
    int* lg, int* ex, const int* __restrict__ gf_log,
    const int* __restrict__ gf_exp, int q) {
  for (int i = threadIdx.x; i < q; i += blockDim.x) lg[i] = gf_log[i];
  for (int i = threadIdx.x; i < 2 * (q - 1); i += blockDim.x)
    ex[i] = gf_exp[i];
}

template <int R, int W>
static __device__ __forceinline__ float group_max(const float (&x)[R]) {
  float m = x[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = fmaxf(m, x[j]);
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o, W));
  return m;
}

// Sum in nb_decode._rtree_sum's order: symbol i with i + q/2, then again on
// the first half.  The register steps come first (their strides are the
// large ones), then the lane steps; the group's lane 0 ends with the sum.
template <int R, int W>
static __device__ __forceinline__ float group_rtree_sum(const float (&x)[R]) {
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = x[j];
#pragma unroll
  for (int h = R / 2; h > 0; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j) v[j] = __fadd_rn(v[j], v[j + h]);
  float s = v[0];
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, o, W));
  return __shfl_sync(kFull, s, 0, W);
}

// x -> softmax(x): max, exp(x - max), the pairwise sum, divide.
template <int R, int W>
static __device__ __forceinline__ void group_softmax(float (&x)[R]) {
  const float m = group_max<R, W>(x);
  float e[R];
#pragma unroll
  for (int j = 0; j < R; ++j) e[j] = expf(__fsub_rn(x[j], m));
  const float s = group_rtree_sum<R, W>(e);
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = __fdiv_rn(e[j], s);
}

// Unnormalised Walsh-Hadamard transform, nb_decode._wht's butterflies:
// strides 1, 2, ..., q/2 in that order, (a, c) -> (a + c, a - c).  Strides
// below W pair lanes (a shuffle), the others pair registers.
template <int R, int W>
static __device__ __forceinline__ void group_wht(float (&x)[R], int lane) {
#pragma unroll
  for (int s = 1; s < W; s <<= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float p = __shfl_xor_sync(kFull, x[j], s, W);
      x[j] = (lane & s) ? __fsub_rn(p, x[j]) : __fadd_rn(x[j], p);
    }
  }
#pragma unroll
  for (int sr = 1; sr < R; sr <<= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!(j & sr)) {
        const float a = x[j], c = x[j + sr];
        x[j] = __fadd_rn(a, c);
        x[j + sr] = __fsub_rn(a, c);
      }
    }
  }
}

// One edge's output from its exclusive spectral product: the inverse
// transform / q, log(max(p, eps)), minus the value at symbol 0.  In the y
// domain: the caller stores value y at VN symbol y / h, which is where
// nb_decode's out[k] = llr[h * k] puts it, and out[0] = llr[0].
template <int R, int W>
static __device__ __forceinline__ void group_cn_output(float (&x)[R],
                                                       int lane) {
  group_wht<R, W>(x, lane);
#pragma unroll
  for (int j = 0; j < R; ++j)
    x[j] = logf(fmaxf(__fdiv_rn(x[j], (float)(R * W)), kEps));
  const float l0 = __shfl_sync(kFull, x[0], 0, W);
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = __fsub_rn(x[j], l0);
}

// First maximum of a q-vector (the smallest symbol on ties, torch.argmax's
// rule), returned to every lane of the group.
template <int R, int W>
static __device__ __forceinline__ int group_argmax(const float (&x)[R],
                                                   int lane) {
  float best = x[0];
  int arg = lane;
#pragma unroll
  for (int j = 1; j < R; ++j)
    if (x[j] > best) {
      best = x[j];
      arg = lane + W * j;
    }
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o, W);
    const int oa = __shfl_xor_sync(kFull, arg, o, W);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

}  // namespace qspa
