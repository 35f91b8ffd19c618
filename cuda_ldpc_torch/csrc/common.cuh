// Shared by the binary decoders (minsum_flooding.cu, minsum_layered.cu,
// minsum_stream.cu): the device-side stop protocol, a frame's check, the
// hard-decision pass, and the check-node update of one (block row, lane)
// with either rule.
//
// Layout (ops/minsum.py's contract): T [B, L, Z] totals, R [B, E, Z] c2v
// messages, both float32, or bfloat16 where a kernel takes a storage type S
// (read as float32, rounded to nearest even on store: ops/minsum.py's
// msg_dtype), hard [B, L, Z] int8, ok [B] uint8.  A circulant shift is the
// index (r + s) % Z.  Offsets are 64-bit.
//
// Arithmetic follows ops/minsum.py operation by operation: fp32 adds,
// subtracts and multiplies through the __f*_rn intrinsics (nvcc cannot
// contract them into an FMA), no fast math, logf/tanhf from the CUDA math
// library for phi.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

// The kernels are static: each source that includes this gets its own copy.
// (An unnamed namespace here makes nvcc's generated launch stubs ambiguous.)
namespace ldpc {

constexpr int kCheckNone = 0;
constexpr int kCheckZero = 1;
constexpr int kCheckSyndrome = 2;
constexpr int kMaxRowDegree = 64;  // sign bits of one row fit a uint64_t

constexpr int kRuleMinsum = 0;
constexpr int kRuleBP = 1;
// minsum._cn_bp's clips: |q| to [kBpLo, kBpHi], the rest sum at kBpLo
constexpr float kBpLo = 1.4e-7f;
constexpr float kBpHi = 34.0f;

// ctl[0]: iterations run, ctl[1]: stop flag, ctl[2]: frames not ok in the
// latest check.
constexpr int kIters = 0;
constexpr int kStop = 1;
constexpr int kNotOk = 2;

static inline int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// A stored total or message read as float32, and a float32 rounded to the
// storage type.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename S>
__device__ __forceinline__ S to_store(float x);
template <>
__device__ __forceinline__ float to_store<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_store<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Layered's new total from the old one T, the new message rn and the old
// one ro, before it is rounded to the storage type S on store: float32's
// T + (rn - ro), bfloat16's (T + rn) - ro, the TPU kernel's order
// (pallas_minsum.py:226-227; ops/minsum.py's msg_dtype).
template <typename S>
__device__ __forceinline__ float layered_total(float t, float rn, float ro) {
  if constexpr (sizeof(S) == 4)
    return __fadd_rn(t, __fsub_rn(rn, ro));
  else
    return __fsub_rn(__fadd_rn(t, rn), ro);
}

// 1 when the frame whose totals are tb [L, Z] fails `check` (none: always),
// returned to every thread of the block; a barrier for the whole block
// unless check is none.  zero: a message bit (columns l < L - J come first)
// is 1; syndrome: some check row's XOR of the decisions is 1.
template <typename S>
static __device__ __forceinline__ int frame_bad(
    const S* tb, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_ptr,
    const int* __restrict__ row_edge, int check, int L, int J, int Z) {
  if (check == kCheckNone) return 1;
  int bad = 0;
  if (check == kCheckZero) {
    const int n = (L - J) * Z;
    for (int i = threadIdx.x; i < n && !bad; i += blockDim.x)
      bad = to_f32(tb[i]) < 0.f;
  } else {
    for (int i = threadIdx.x; i < J * Z && !bad; i += blockDim.x) {
      const int j = i / Z, r = i - j * Z;
      int par = 0;
      for (int k = row_ptr[j]; k < row_ptr[j + 1]; ++k) {
        const int e = row_edge[k];
        int z = r + edge_s[e];
        if (z >= Z) z -= Z;
        par ^= to_f32(tb[edge_l[e] * Z + z]) < 0.f;
      }
      bad = par;
    }
  }
  return __syncthreads_or(bad);
}

template <typename S>
static __global__ void check_kernel(const S* __restrict__ T,
                                    unsigned char* __restrict__ ok,
                                    const int* __restrict__ edge_l,
                                    const int* __restrict__ edge_s,
                                    const int* __restrict__ row_ptr,
                                    const int* __restrict__ row_edge, int* ctl,
                                    int check, int B, int L, int J, int Z) {
  if (ctl[kStop]) return;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const int bad = frame_bad(T + b * L * Z, edge_l, edge_s, row_ptr,
                              row_edge, check, L, J, Z);
    if (threadIdx.x == 0) {
      ok[b] = bad ? 0 : 1;
      if (bad) atomicAdd(&ctl[kNotOk], 1);
    }
  }
}

static __global__ void finish_kernel(int* ctl, int stop_when_ok) {
  if (ctl[kStop]) return;
  ctl[kIters] += 1;
  if (stop_when_ok && ctl[kNotOk] == 0) ctl[kStop] = 1;
}

template <typename S>
static __global__ void hard_kernel(const S* __restrict__ T,
                                   signed char* __restrict__ hard, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    hard[i] = to_f32(T[i]) < 0.f ? 1 : 0;
}

// phi(x) = -log(tanh(x / 2)) on a clipped magnitude.
__device__ __forceinline__ float phi(float x) {
  return -logf(tanhf(__fmul_rn(x, 0.5f)));
}

__device__ __forceinline__ float phi_of_message(float q) {
  return phi(fminf(fmaxf(fabsf(q), kBpLo), kBpHi));
}

// The check node of block row (edges row_edge[k0..k1)) at row lane r of one
// frame: tb is the frame's T [L, Z], rb its R [E, Z].
//
// Pass 1 reads every v2c message q = T - R of the row and keeps a two-min
// with a strict `<` (the first minimum wins) and the sign bits from
// `q < 0`.  Pass 2 writes each edge's new message: min2 on the
// first-minimum edge and min1 elsewhere; then beta, then alpha, then the
// sign.  kLayered also updates the total as T + (R_new - R_old).
//
// Within one block row each block column appears at most once and
// z = (r + s) % Z is a bijection, so every (l, z) of T and (e, z) of R that
// this call touches is touched by no other lane of the row: no atomics.
template <bool kLayered>
__device__ __forceinline__ void check_node_minsum(
    float* tb, float* rb, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_edge, int k0,
    int k1, int r, int Z,
    float alpha, int use_alpha, float beta, int use_beta) {
  float m1 = 0.f, m2 = FLT_MAX;
  int am = 0;
  uint64_t signs = 0;
  for (int k = k0; k < k1; ++k) {
    const int i = k - k0, e = row_edge[k];
    int z = r + edge_s[e];
    if (z >= Z) z -= Z;
    const float q = __fsub_rn(tb[edge_l[e] * Z + z], rb[(int64_t)e * Z + z]);
    if (q < 0.f) signs |= 1ull << i;
    const float mag = fabsf(q);
    if (i == 0) {
      m1 = mag;
    } else if (mag < m1) {
      m2 = m1;
      m1 = mag;
      am = i;
    } else if (mag < m2) {
      m2 = mag;
    }
  }
  const int parity = __popcll(signs) & 1;
  for (int k = k0; k < k1; ++k) {
    const int i = k - k0, e = row_edge[k];
    int z = r + edge_s[e];
    if (z >= Z) z -= Z;
    float* rp = rb + (int64_t)e * Z + z;
    float* tp = tb + edge_l[e] * Z + z;
    float out = i == am ? m2 : m1, t_old = 0.f, r_old = 0.f;
    if (kLayered) {
      t_old = *tp;
      r_old = *rp;
    }
    if (use_beta) {
      out = __fsub_rn(out, beta);
      if (out < 0.f) out = 0.f;
    }
    if (use_alpha) out = __fmul_rn(out, alpha);
    if (parity ^ (int)((signs >> i) & 1)) out = -out;
    if (kLayered) *tp = __fadd_rn(t_old, __fsub_rn(out, r_old));
    *rp = out;
  }
}

// The row degrees a bp check node keeps in registers: kDeg is a
// compile-time bound, picked per code by the host (bp_degree_bucket).
constexpr int kBpDegSmall = 8;     // J15_L30_Z1280 (7-8), the 4-8 edge rows
constexpr int kBpDegMid = 32;      // PON_LDPC (22-23), J10_L60_Z160 (23-24)
static_assert(kMaxRowDegree == 64, "the largest bucket is kMaxRowDegree");

static inline int bp_degree_bucket(int max_dc) {
  return max_dc <= kBpDegSmall ? kBpDegSmall
         : max_dc <= kBpDegMid ? kBpDegMid : kMaxRowDegree;
}

// The same check node with the exact sum-product rule, for rows of at most
// kDeg edges.  Pass 1 reads each q = T - R once, keeps phi_e = phi(clip|q|)
// per edge in registers (the loops are unrolled over kDeg, so the arrays
// are registers) and sums phi in row-edge order; layered also keeps T_old
// and R_old.  Pass 2 reads no T or R (only the small edge tables, to form
// the addresses it writes) and evaluates phi once per edge, for the output
// phi(max(sum - phi_e, kBpLo)); then beta, then alpha, then the sign.
// phi_e is one float, added to the sum and subtracted from it, so keeping
// it changes no bit of the result.  T and R are stored as S: float32, or
// bfloat16 read as float32 and rounded on store, with layered's total in
// layered_total's order for S.
template <bool kLayered, int kDeg, typename S = float>
__device__ __forceinline__ void check_node_bp(
    S* tb, S* rb, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_edge, int k0,
    int k1, int r, int Z,
    float alpha, int use_alpha, float beta, int use_beta) {
  constexpr int kKeep = kLayered ? kDeg : 1;
  float ph[kDeg], t_old[kKeep], r_old[kKeep];
  float phsum = 0.f;
  uint64_t signs = 0;
  const int dc = k1 - k0;
#pragma unroll
  for (int i = 0; i < kDeg; ++i) {
    if (i < dc) {
      const int e = row_edge[k0 + i];
      int z = r + edge_s[e];
      if (z >= Z) z -= Z;
      const float t = to_f32(tb[edge_l[e] * Z + z]);
      const float rr = to_f32(rb[(int64_t)e * Z + z]);
      const float q = __fsub_rn(t, rr);
      if (q < 0.f) signs |= 1ull << i;
      ph[i] = phi_of_message(q);
      phsum = __fadd_rn(phsum, ph[i]);
      if (kLayered) {
        t_old[i % kKeep] = t;
        r_old[i % kKeep] = rr;
      }
    }
  }
  const int parity = __popcll(signs) & 1;
#pragma unroll
  for (int i = 0; i < kDeg; ++i) {
    if (i < dc) {
      const int e = row_edge[k0 + i];
      int z = r + edge_s[e];
      if (z >= Z) z -= Z;
      float out = phi(fmaxf(__fsub_rn(phsum, ph[i]), kBpLo));
      if (use_beta) {
        out = __fsub_rn(out, beta);
        if (out < 0.f) out = 0.f;
      }
      if (use_alpha) out = __fmul_rn(out, alpha);
      if (parity ^ (int)((signs >> i) & 1)) out = -out;
      if (kLayered)
        tb[edge_l[e] * Z + z] = to_store<S>(
            layered_total<S>(t_old[i % kKeep], out, r_old[i % kKeep]));
      rb[(int64_t)e * Z + z] = to_store<S>(out);
    }
  }
}

// The check node with `kRule`; kDeg bounds the row degree for bp only.
template <int kRule, bool kLayered, int kDeg>
__device__ __forceinline__ void check_node(
    float* tb, float* rb, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_edge, int k0,
    int k1, int r, int Z,
    float alpha, int use_alpha, float beta, int use_beta) {
  if constexpr (kRule == kRuleBP)
    check_node_bp<kLayered, kDeg>(tb, rb, edge_l, edge_s, row_edge, k0, k1,
                                  r, Z, alpha, use_alpha, beta, use_beta);
  else
    check_node_minsum<kLayered>(tb, rb, edge_l, edge_s, row_edge, k0, k1, r,
                                Z, alpha, use_alpha, beta, use_beta);
}

}  // namespace ldpc
