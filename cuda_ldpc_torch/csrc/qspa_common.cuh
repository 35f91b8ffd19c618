// Shared by the GF(q) FFT-QSPA decoders (qspa.cu, K5; qspa_qc.cu, K6;
// qspa_stream.cu, K7) and the max-domain decoders (nbms.cu, K8): the GF(q)
// tables, the phases of one frame's pass on the adjacency codes (K5, K7 and
// K8), the row groups and row waves of K5, K7 and K8, and the per-edge steps
// of the check-node update on one q-vector spread over a group of W lanes
// (W = 32 for a warp an edge, 32 / dc' for K5's row on one warp, W = q for
// K6), R = q / W registers per lane: symbol y sits in lane y % W, register
// y / W.  The steps pair the same symbols in the same stride order at any W,
// so every layout gives the same bits.
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

template <int R, int W>
static __device__ __forceinline__ float group_min(const float (&x)[R]) {
  float m = x[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = fminf(m, x[j]);
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(kFull, m, o, W));
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

// First minimum of a q-vector (the smallest symbol on ties, torch.argmin's
// rule), returned to every lane of the group.
template <int R, int W>
static __device__ __forceinline__ int group_argmin(const float (&x)[R],
                                                   int lane) {
  float best = x[0];
  int arg = lane;
#pragma unroll
  for (int j = 1; j < R; ++j)
    if (x[j] < best) {
      best = x[j];
      arg = lane + W * j;
    }
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o, W);
    const int oa = __shfl_xor_sync(kFull, arg, o, W);
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

// ---- The phases of one frame's pass for the adjacency-code kernels (K5,
// qspa.cu; K7, qspa_stream.cu; K8, nbms.cu): one block per frame, the
// totals T [N, Q] in shared memory, the frame's c2v messages Cb [E, Q] in
// device memory; edge e of row m is row_ptr[m] + slot.

// Flooding totals T = L + (c2v summed over the VN's edges in slot order).
// L's load is issued before the sum's dependent loads (the serial designs
// of K5, K7 and K8 ran 7-9% faster for it, PERF.md).  The caller
// puts a barrier after it.
template <int Q>
static __device__ __forceinline__ void frame_totals(
    float* T, const float* L, const float* Cb, const int* __restrict__ col_ptr,
    const int* __restrict__ col_edge, int N) {
  for (int i = threadIdx.x; i < N * Q; i += blockDim.x) {
    const int n = i / Q, s = i - n * Q;
    const int k0 = col_ptr[n], k1 = col_ptr[n + 1];
    const float l = L[i];
    float acc = 0.f;
    if (k0 < k1) {
      acc = Cb[(int64_t)col_edge[k0] * Q + s];
      for (int k = k0 + 1; k < k1; ++k)
        acc = __fadd_rn(acc, Cb[(int64_t)col_edge[k] * Q + s]);
    }
    T[i] = __fadd_rn(l, acc);
  }
}

// The decisions hs[n] = argmax T[n] (argmin when kMin, the max-domain TMM
// decoders of nbms.cu), one warp per VN, then the GF syndrome: returns 1 to
// every thread when some row's XOR of h * x is not 0.
template <int R, bool kMin = false>
static __device__ __forceinline__ int frame_decide_check(
    const float* T, int* hs, const int* lg, const int* ex,
    const int* __restrict__ row_ptr, const int* __restrict__ edge_vn,
    const int* __restrict__ edge_h, int N, int M) {
  constexpr int Q = 32 * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int n = warp; n < N; n += nwarps) {
    float x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = T[n * Q + lane + 32 * j];
    const int arg =
        kMin ? group_argmin<R, 32>(x, lane) : group_argmax<R, 32>(x, lane);
    if (lane == 0) hs[n] = arg;
  }
  __syncthreads();
  int bad = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    int syn = 0;
    for (int k = row_ptr[m]; k < row_ptr[m + 1]; ++k)
      syn ^= gf_mul(lg, ex, edge_h[k], hs[edge_vn[k]]);
    bad |= syn != 0;
  }
  return __syncthreads_or(bad);
}

// ---- Phase clocks of K5, K7 and K8, compiled in only under NB_ROWS_PHASES
// (cuda_ldpc_torch/tools/nb_rows_phases.py): thread 0 adds the clock64()
// cycles since its previous stamp to the phase a stamp names.  Thread 0 is
// in group 0, so a row phase is group 0's, and a wait is its barrier's.
enum RowsPhase {
  kRpSetup = 0,   // tables, zero fill, the copy of the totals
  kRpTotals,      // flooding totals, with their barrier
  kRpDecide,      // decisions and syndrome, with their barriers
  kRpEdges,       // each warp's edge: v2c and its message (K5, K7:
                  // spectrum; K5's row on a warp: all the row's spectra)
  kRpEdgesWait,   // the group barrier after it
  kRpMins,        // TMM: min1, min2 and the column per eta
  kRpSearch,      // TMM: the 2-deviation search
  kRpMerge,       // TMM: the search's ranges merged, I and E
  kRpOutput,      // the row's output (EMS: the deviations too; K7: the
                  // products) and its write-back
  kRpRowWait,     // the group's other barriers in the row
  kRpWaveWait,    // the block barrier after a wave
  kRpExit,        // results written
  kRpCount
};

struct PhaseClock {
#ifdef NB_ROWS_PHASES
  unsigned long long* acc;  // shared [kRpCount], thread 0's
  unsigned long long last;
  __device__ __forceinline__ void stamp(int n) {
    if (threadIdx.x == 0) {
      const unsigned long long t = clock64();
      acc[n] += t - last;
      last = t;
    }
  }
#else
  __device__ __forceinline__ void stamp(int) const {}
#endif
};

#ifdef NB_ROWS_PHASES
#define ROWS_PHASE_CLOCK(pc)                                  \
  __shared__ unsigned long long _rp_acc[kRpCount];            \
  if (threadIdx.x == 0)                                       \
    for (int _i = 0; _i < kRpCount; ++_i) _rp_acc[_i] = 0;    \
  PhaseClock pc{_rp_acc, clock64()};
#define ROWS_PHASE_FLUSH(pc, dst)                             \
  if (threadIdx.x == 0)                                       \
    for (int _i = 0; _i < kRpCount; ++_i) atomicAdd(&(dst)[_i], pc.acc[_i]);
#else
#define ROWS_PHASE_CLOCK(pc) PhaseClock pc;
#define ROWS_PHASE_FLUSH(pc, dst)
#endif

// ---- Row groups and row waves (K5, qspa.cu; K7, qspa_stream.cu; K8,
// nbms.cu).  A block decoding one frame splits into `groups` groups of 32 *
// max_dc threads, one warp per edge of a row; each group runs one check row
// at a time with its own scratch and its own barrier, so that rows which
// share no VN run at once (K5's row on one warp walks the same waves with a
// warp as its group).  The host plan (ops/cuda_qspa.row_waves) lists the rows wave after
// wave: flooding one wave of every row (no row writes what another reads),
// layered the dependency levels (a row's wave is one more than the latest
// wave of an earlier row that shares a VN with it, so every pair of rows
// that share a VN keeps its serial order, and the rows of a wave touch
// disjoint VNs), the serial design one wave a row with one group.

// The most row groups a block holds.  A barrier named by a register makes
// ptxas reserve all 16 of a block's barriers, and an H100 SM then held 4
// such blocks (PERF.md); named by immediates 1..7 the block
// reserves 8.
constexpr int kMaxGroups = 7;
// The launch bounds of a kernel built for row groups: at most 512 threads
// a block and 3 blocks an SM, so ptxas keeps to 40 registers a thread
// (without them it takes up to 64, and an SM holds 32 warps; with 4
// blocks, 32 registers, it spills).  One group keeps 1024 threads and 1
// block (without the 1, ptxas chose 32 registers and spilled for some
// instantiations).  PERF.md.
constexpr int kGroupedThreads = 512, kGroupedBlocks = 3;

// bar.sync with an immediate id, so that ptxas counts the ids in use.
template <int kId>
static __device__ __forceinline__ void named_sync(int nth) {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "r"(nth) : "memory");
}

// A group's threads, its rank among them, and its barrier: id 0 is the
// whole block (__syncthreads, one group), ids 1 to kGroups the named
// barriers of the groups' nth threads.  kGroups = 1 is the serial design:
// the block is the one group and no named barrier is compiled in.
template <int kGroups>
struct RowGroup {
  int tid, nth, id;
  __device__ __forceinline__ void sync() const {
    static_assert(kGroups >= 1 && kGroups <= kMaxGroups, "row groups");
    if constexpr (kGroups == 1) {
      __syncthreads();
    } else {
      switch (id) {
        case 0: __syncthreads(); break;
        case 1: named_sync<1>(nth); break;
        case 2: if constexpr (kGroups >= 2) named_sync<2>(nth); break;
        case 3: if constexpr (kGroups >= 3) named_sync<3>(nth); break;
        case 4: if constexpr (kGroups >= 4) named_sync<4>(nth); break;
        case 5: if constexpr (kGroups >= 5) named_sync<5>(nth); break;
        case 6: if constexpr (kGroups >= 6) named_sync<6>(nth); break;
        default: if constexpr (kGroups >= 7) named_sync<7>(nth); break;
      }
    }
  }
};

// This thread's group of `groups` (at most kGroups).
template <int kGroups>
static __device__ __forceinline__ RowGroup<kGroups> row_group(int groups) {
  if (kGroups == 1 || groups == 1)
    return {(int)threadIdx.x, (int)blockDim.x, 0};
  const int nth = blockDim.x / groups, g = threadIdx.x / nth;
  return {(int)threadIdx.x - g * nth, nth, 1 + g};
}

// row(m) for every row of the plan, wave after wave: group g takes the
// wave's rows g, g + groups, ..., in the plan's (ascending) order; a block
// barrier closes each wave when there is more than one group (with one, the
// row's own closing barrier is the block's).
template <class Row>
static __device__ __forceinline__ void walk_waves(
    int groups, const int* __restrict__ wave_ptr,
    const int* __restrict__ wave_row, int nwaves, PhaseClock& pc,
    Row&& row) {
  const int g = groups == 1 ? 0 : threadIdx.x / (blockDim.x / groups);
  for (int w = 0; w < nwaves; ++w) {
    for (int i = wave_ptr[w] + g; i < wave_ptr[w + 1]; i += groups)
      row(wave_row[i]);
    if (groups > 1) {
      __syncthreads();
      pc.stamp(kRpWaveWait);
    }
  }
}

// One check row of FFT-QSPA on a row group (K5, K7), edges k0 .. k0 + dc -
// 1, a warp an edge: the group's warp w computes edge w's spectrum (v2c,
// softmax, transform) into the group's scratch S [max_dc, Q], then, after
// the group's barrier, its exclusive product over the row's other spectra
// in the JAX order, the inverse transform and the log; layered also updates
// the totals as T + (new - old).  Ends with the group's barrier.
template <int R, bool kLayered, int kGroups>
static __device__ __forceinline__ void cn_row(
    const RowGroup<kGroups>& grp, PhaseClock& pc, float* T, float* S, float* Cb,
    const int* lg, const int* ex, int k0, int dc,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int warp = grp.tid >> 5, lane = grp.tid & 31;
  const bool mine = warp < dc;
  float x[R];
  int addr[R];
  int vn = 0, h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + warp;
    h = edge_h[e];
    vn = edge_vn[e];
    cp = Cb + (int64_t)e * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      addr[j] = h ? gf_div(lg, ex, y, h, Q) : y;
      x[j] = __fsub_rn(T[vn * Q + addr[j]], cp[addr[j]]);
    }
    if (!h) {
      // coefficient 0: nb_decode puts the sum of v2c at y = 0 and 0
      // elsewhere (the JAX package's one-hot contraction does)
      const float s = group_rtree_sum<R, 32>(x);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = (lane + 32 * j) == 0 ? s : 0.f;
    }
    group_softmax<R, 32>(x);
    group_wht<R, 32>(x, lane);
#pragma unroll
    for (int j = 0; j < R; ++j) S[warp * Q + lane + 32 * j] = x[j];
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  if (mine) {
    // exclusive product: forward from edge 0, backward from the last edge,
    // each starting at 1 (nb_decode._qspa_cn_core's order)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      float f = 1.f, bw = 1.f;
      for (int i = 0; i < warp; ++i) f = __fmul_rn(f, S[i * Q + y]);
      for (int i = dc - 1; i > warp; --i) bw = __fmul_rn(bw, S[i * Q + y]);
      x[j] = __fmul_rn(f, bw);
    }
    if (h) {
      group_cn_output<R, 32>(x, lane);
    } else {  // out[k] = llr[0 * k] - llr[0] = 0
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (kLayered) {
        // total = T + (new - old), the jnp function's order
        float* tp = T + vn * Q + addr[j];
        *tp = __fadd_rn(*tp, __fsub_rn(x[j], cp[addr[j]]));
      }
      cp[addr[j]] = x[j];
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();  // the spectra are reused; layered: the totals
  pc.stamp(kRpRowWait);
}

}  // namespace qspa
