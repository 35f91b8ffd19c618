// Shared by the binary decoders (minsum_flooding.cu, minsum_layered.cu):
// the device-side stop protocol, the hard-decision pass, and the check-node
// update of one (block row, lane) with either rule.
//
// Layout (ops/minsum.py's contract): T [B, L, Z] f32 totals, R [B, E, Z] f32
// c2v messages, hard [B, L, Z] int8, ok [B] uint8.  A circulant shift is the
// index (r + s) % Z.  Offsets are 64-bit.
//
// Arithmetic follows ops/minsum.py operation by operation: fp32 adds,
// subtracts and multiplies through the __f*_rn intrinsics (nvcc cannot
// contract them into an FMA), no fast math, logf/tanhf from the CUDA math
// library for phi.

#pragma once

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

static __global__ void check_kernel(const float* __restrict__ T,
                                    unsigned char* __restrict__ ok,
                                    const int* __restrict__ edge_l,
                                    const int* __restrict__ edge_s,
                                    const int* __restrict__ row_ptr,
                                    const int* __restrict__ row_edge, int* ctl,
                                    int check, int B, int L, int J, int Z) {
  if (ctl[kStop]) return;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const float* tb = T + b * L * Z;
    int bad = 0;
    if (check == kCheckZero) {
      const int n = (L - J) * Z;  // message columns l < L - J come first
      for (int i = threadIdx.x; i < n && !bad; i += blockDim.x)
        bad = tb[i] < 0.f;
    } else {
      for (int i = threadIdx.x; i < J * Z && !bad; i += blockDim.x) {
        const int j = i / Z, r = i - j * Z;
        int par = 0;
        for (int k = row_ptr[j]; k < row_ptr[j + 1]; ++k) {
          const int e = row_edge[k];
          int z = r + edge_s[e];
          if (z >= Z) z -= Z;
          par ^= tb[edge_l[e] * Z + z] < 0.f;
        }
        bad = par;
      }
    }
    bad = __syncthreads_or(bad);
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

static __global__ void hard_kernel(const float* __restrict__ T,
                                   signed char* __restrict__ hard, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    hard[i] = T[i] < 0.f ? 1 : 0;
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
// Pass 1 reads every v2c message q = T - R of the row.  Min-sum keeps a
// two-min with a strict `<` (the first minimum wins) and the sign bits from
// `q < 0`; bp sums phi(clip|q|) in row-edge order.  Pass 2 writes each
// edge's new message: min2 on the first-minimum edge and min1 elsewhere, or
// phi(max(sum - phi_e, kBpLo)); then beta, then alpha, then the sign.  bp
// recomputes q and phi_e from T and R, which no other thread touches at
// these addresses before this write, so it needs no per-edge array.
// kLayered also updates the total as T + (R_new - R_old).
//
// Within one block row each block column appears at most once and
// z = (r + s) % Z is a bijection, so every (l, z) of T and (e, z) of R that
// this call touches is touched by no other lane of the row: no atomics.
template <int kRule, bool kLayered>
__device__ __forceinline__ void check_node(
    float* tb, float* rb, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_edge, int k0,
    int k1, int r, int Z,
    float alpha, int use_alpha, float beta, int use_beta) {
  float m1 = 0.f, m2 = FLT_MAX, phsum = 0.f;
  int am = 0;
  uint64_t signs = 0;
  for (int k = k0; k < k1; ++k) {
    const int i = k - k0, e = row_edge[k];
    int z = r + edge_s[e];
    if (z >= Z) z -= Z;
    const float q = __fsub_rn(tb[edge_l[e] * Z + z], rb[(int64_t)e * Z + z]);
    if (q < 0.f) signs |= 1ull << i;
    if (kRule == kRuleBP) {
      phsum = __fadd_rn(phsum, phi_of_message(q));
    } else {
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
  }
  const int parity = __popcll(signs) & 1;
  for (int k = k0; k < k1; ++k) {
    const int i = k - k0, e = row_edge[k];
    int z = r + edge_s[e];
    if (z >= Z) z -= Z;
    float* rp = rb + (int64_t)e * Z + z;
    float* tp = tb + edge_l[e] * Z + z;
    float out, t_old = 0.f, r_old = 0.f;
    if (kRule == kRuleBP || kLayered) {
      t_old = *tp;
      r_old = *rp;
    }
    if (kRule == kRuleBP) {
      const float q = __fsub_rn(t_old, r_old);
      const float rest = __fsub_rn(phsum, phi_of_message(q));
      out = phi(fmaxf(rest, kBpLo));
    } else {
      out = i == am ? m2 : m1;
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

}  // namespace ldpc
