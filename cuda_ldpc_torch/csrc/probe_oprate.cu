// The op-rate probe (K11), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel of cuda_ldpc_tpu's tools/probe_oprate.py `_timed`
// (its pallas_call of `_chain(_builder(name), n_par, K)`): on an f32 tile
// x [rows, cols] (the min-sum tile [8, 1280], the probe's own), n_par
// independent chains x * (1 + 0.125 i) each take K dependent steps of one op
// class, and the chains are summed in order.  It computes what
// cuda_ldpc_torch/tools/probe_oprate.py's plain PyTorch `chain` computes,
// bit for bit: each step's fp32 arithmetic through the __f*_rn intrinsics
// (nvcc cannot contract `min`'s x * 1.0000001 + 1e-30 into an FMA), no fast
// math.  The op classes (`_builder`):
//
//   add         x + 1.0000001
//   min         fminf(x * 1.0000001 + 1e-30, 3.4e38)
//   cmp_sel     x < 1.5 ? x + 1.0000001 : x * 0.9999999
//   sel         x > 0 ? x + 1e-7 : x - 1e-7
//   bitand      float(bits(x) & 0x7FFFFFFF) + 1e-7
//   bitxor      float(bits(x) ^ 0x80000000)
//   roll        jnp.roll by 17 along the row: out[j] = x[(j - 17) mod cols]
//   minsum_mix  the min-sum CN's per-edge mix: q = roll(x - 0.001, 17);
//               mag = |q| by mask, sgn = sign bit of q; m2 = mag < x ? x :
//               min(mag, x); m1 = min(mag, x); float(bits(m2 + m1) ^ sgn)
//
// A block per row of a tile copy, two lanes a thread (j and j + cols / 2:
// 1280 lanes exceed the 1024 threads of a block), so a block has cols / 2
// threads.  The roll crosses warps, so it goes through shared memory with
// two barriers a step.  A grid of `copies` tiles gives the rate of a card
// full of such blocks.  The step loop is unrolled 8 times.
//
// bitxor is no chain to ptxas as written: it cancels two XORs by the same
// constant and merges any run of bitwise operations on at most three inputs
// into one LOP3, so eight unrolled sign flips by a constant compile to no
// instruction at all on sm_90a.  So each flip here is predicated, in
// inline PTX, on a per-step predicate `live` = (k != guard), with guard = -1
// passed at run time: true at every step, unknown to the compiler, and
// different from step to step, so no two flips cancel or merge.  That costs
// one integer compare a step, shared by every lane and chain of the thread.
// The SASS check (probe_oprate.sass_unfolded) counts each class's
// instruction in the unrolled loop.
//
// Bound: operations.  Per lane and step the ops the class needs
// (FUNCTION_OPS in probe_oprate.py) over the card's fp32 rate; roll does
// no arithmetic, so its bound is the tile's bytes.  A tile's 640-thread
// blocks already keep each SM's schedulers busy, so the measured time of a
// step grows with the instructions a step: the probe reads issue rates,
// per SM from the tile and per card from a full grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace oprate_probe {

constexpr int32_t kSign = INT32_MIN;  // 0x80000000
constexpr int32_t kMag = 0x7FFFFFFF;
constexpr int kShift = 17;

// `live` is the step's predicate; only bitxor reads it.
struct OpAdd {
  static constexpr bool kRoll = false;
  static __device__ __forceinline__ float step(float x, int) {
    return __fadd_rn(x, 1.0000001f);
  }
};
struct OpMin {
  static constexpr bool kRoll = false;
  static __device__ __forceinline__ float step(float x, int) {
    return fminf(__fadd_rn(__fmul_rn(x, 1.0000001f), 1e-30f), 3.4e38f);
  }
};
struct OpCmpSel {
  static constexpr bool kRoll = false;
  static __device__ __forceinline__ float step(float x, int) {
    return x < 1.5f ? __fadd_rn(x, 1.0000001f) : __fmul_rn(x, 0.9999999f);
  }
};
struct OpSel {
  static constexpr bool kRoll = false;
  static __device__ __forceinline__ float step(float x, int) {
    return x > 0.f ? __fadd_rn(x, 1e-7f) : __fsub_rn(x, 1e-7f);
  }
};
struct OpBitand {
  static constexpr bool kRoll = false;
  static __device__ __forceinline__ float step(float x, int) {
    return __fadd_rn(__int_as_float(__float_as_int(x) & kMag), 1e-7f);
  }
};
struct OpBitxor {
  static constexpr bool kRoll = false;
  static __device__ __forceinline__ float step(float x, int live) {
    int32_t v = __float_as_int(x);
    asm volatile("{ .reg .pred p; setp.ne.s32 p, %1, 0; @p xor.b32 %0, %0, %2; }"
                 : "+r"(v) : "r"(live), "r"(kSign));
    return __int_as_float(v);
  }
};
// The rolling classes: `pre` gives the value rolled, `post` the step's
// result from the rolled value r and the chain's own x.
struct OpRoll {
  static constexpr bool kRoll = true;
  static __device__ __forceinline__ float pre(float x) { return x; }
  static __device__ __forceinline__ float post(float r, float) { return r; }
};
struct OpMix {
  static constexpr bool kRoll = true;
  static __device__ __forceinline__ float pre(float x) {
    return __fsub_rn(x, 0.001f);
  }
  static __device__ __forceinline__ float post(float r, float x) {
    const int32_t w = __float_as_int(r);
    const float mag = __int_as_float(w & kMag);
    const int32_t sgn = w & kSign;
    const float m1 = fminf(mag, x);
    const float m2 = mag < x ? x : m1;
    return __int_as_float(__float_as_int(__fadd_rn(m2, m1)) ^ sgn);
  }
};

template <class Op, int NPAR>
static __global__ void chain_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int rows,
                                    int cols, int K, int guard) {
  extern __shared__ float buf[];  // [NPAR, cols], rolling classes only
  const int half = cols / 2;
  const int j[2] = {(int)threadIdx.x, (int)threadIdx.x + half};
  const float* xr = x + (int64_t)(blockIdx.x % rows) * cols;
  float v[NPAR][2];
#pragma unroll
  for (int i = 0; i < NPAR; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a) v[i][a] = __fmul_rn(xr[j[a]], 1.f + 0.125f * i);
  int src[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) src[a] = (j[a] - kShift + cols) % cols;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    if constexpr (Op::kRoll) {
#pragma unroll
      for (int i = 0; i < NPAR; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a) buf[i * cols + j[a]] = Op::pre(v[i][a]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NPAR; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          v[i][a] = Op::post(buf[i * cols + src[a]], v[i][a]);
      __syncthreads();
    } else {
#pragma unroll
      for (int i = 0; i < NPAR; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a) v[i][a] = Op::step(v[i][a], k != guard);
    }
  }
  float* o = out + (int64_t)blockIdx.x * cols;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float acc = v[0][a];
#pragma unroll
    for (int i = 1; i < NPAR; ++i) acc = __fadd_rn(acc, v[i][a]);
    o[j[a]] = acc;
  }
}

using Kernel = void (*)(const float*, float*, int, int, int, int);

// The kernel of op class `op` (the order of the header's table) with
// `n_par` chains, or null.
static Kernel kernel_for(int op, int n_par) {
#define PROBE_PAIR(OP)                                       \
  return n_par == 1   ? static_cast<Kernel>(chain_kernel<OP, 1>) \
         : n_par == 4 ? static_cast<Kernel>(chain_kernel<OP, 4>) \
                      : nullptr
  switch (op) {
    case 0: PROBE_PAIR(OpAdd);
    case 1: PROBE_PAIR(OpMin);
    case 2: PROBE_PAIR(OpCmpSel);
    case 3: PROBE_PAIR(OpSel);
    case 4: PROBE_PAIR(OpBitand);
    case 5: PROBE_PAIR(OpBitxor);
    case 6: PROBE_PAIR(OpRoll);
    case 7: PROBE_PAIR(OpMix);
    default: return nullptr;
  }
#undef PROBE_PAIR
}

static bool rolls(int op) { return op == 6 || op == 7; }

}  // namespace oprate_probe

extern "C" {

// Runs `copies` copies of the chain of op class `op` (0 add, 1 min,
// 2 cmp_sel, 3 sel, 4 bitand, 5 bitxor, 6 roll, 7 minsum_mix) with `n_par`
// (1 or 4) chains of 0 <= K < 2^31 steps on the tile x [rows, cols] into out
// [copies, rows, cols], on `stream` of CUDA device `device`; cols is even
// and at most 2048.  Returns 0 or the CUDA error met while enqueueing.
int ldpc_probe_oprate(const float* x, float* out, int rows, int cols,
                      int copies, int op, int n_par, long long K, int device,
                      void* stream) {
  using namespace oprate_probe;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  const Kernel kernel = kernel_for(op, n_par);
  if (!kernel || rows < 1 || copies < 1 || cols < 2 || cols % 2 ||
      cols > 2048 || K < 0 || K > INT32_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = rolls(op) ? (size_t)n_par * cols * sizeof(float) : 0;
  kernel<<<rows * copies, cols / 2, smem, (cudaStream_t)stream>>>(
      x, out, rows, cols, (int)K, -1);
  return cudaGetLastError();
}

// The blocks of the chain kernel (op, n_par) that fit on one SM at once for
// a tile of `cols` lanes, or -1 on a bad argument or a CUDA error.
int ldpc_probe_oprate_blocks_per_sm(int op, int n_par, int cols, int device) {
  using namespace oprate_probe;
  const Kernel kernel = kernel_for(op, n_par);
  if (!kernel || cols < 2 || cols % 2 || cols > 2048) return -1;
  if (cudaSetDevice(device)) return -1;
  const size_t smem = rolls(op) ? (size_t)n_par * cols * sizeof(float) : 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, cols / 2,
                                                    smem))
    return -1;
  return blocks;
}

}  // extern "C"
