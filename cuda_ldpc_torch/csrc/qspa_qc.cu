// GF(q) FFT-QSPA decoder on the quasi-cyclic structure of a lifted code
// (Tanner_74_9_Z128_GF16: 74 x 9 block columns and rows, 185 circulant
// blocks of Z = 128, GF(16)), flooding and block-row layered, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_qspa_qc.py `_kernel`
// (:326).  It computes what ops/nb_decode.py's plain `decode_qspa` and its
// grouped-layered schedule (`decode_glayered_qspa`, whose conflict-free row
// groups are the block rows of a QC code) compute, operation for operation:
// decide, GF syndrome, per-frame stop and iteration count exactly as in
// qspa.cu (K5).
//
// Where the TPU kernel rotates discrete-log-ordered lanes by per-lane bits
// to multiply by a coefficient that varies along z inside a circulant
// (pallas_qspa_qc.py:15-27), each check row here reads its own coefficient
// from a [block edge, z] table and gathers its message at symbol y / h
// through the field's log/antilog tables.
//
// Two designs.  Both keep the state of one frame, T [N, q] (606,208 B on
// Tanner) and C [E, q] (1,515,520 B), in device memory (the caller's
// buffers [B, N, q] and [B, E, q], edge e = block edge * Z + z): it cannot
// sit in shared memory.  One block decodes one frame, all passes in one
// launch.  A group of q lanes takes a check row, one lane per symbol.
//
// `qspa_qc_kernel`, the staged design, is what the package runs.  A block
// of 256 threads takes a chunk of 256 / q check rows of one block row at a
// time.  For each of the row's block edges it copies into shared memory,
// with 16-byte cp.async, the chunk's totals rows (at most two runs, since
// a circulant wraps at most once: ops/cuda_qspa_qc.stage_runs) and its
// message rows, and the rows' coefficient logs.  Chunk i + 1's copies are
// in flight while chunk i computes; layered does not prefetch across a
// block row, whose totals the next block row reads.  A group takes four of
// its row's edges at once in the softmax/transform and in the output, so
// that one edge's shuffles wait while the others' issue.  Each spectrum
// overwrites its staged totals and the backward products the staged
// messages, so two stages of two [max_dc][256] f32 slabs hold everything
// (99 KB on Tanner: two frames an SM).  The frame's decisions stay in
// shared memory as bytes: flooding takes them in its totals step (the q
// lanes of a VN are one group), layered from the last block row of each
// VN's column.  The syndrome reads them there, and `hard` is written once,
// at exit.  The messages need no zero fill: the first pass reads none.
// `hz` is kept as log_alpha(h), so y / h is one subtraction and one table
// read; Z and q enter as shifts.
//
// Why (cuda_ldpc_torch/tools/qspa_qc_phases.py, thread 0's cycles, Tanner,
// B=256, 10 passes, NVIDIA H100): the global design spent 29% (flooding)
// and 36% (layered) of its time on its gathers, each edge's two dependent
// loads issued after the one before, 28% on the flooding totals and 10-12%
// re-reading the totals it had just written to decide.  The staged design
// waits 12-14% on its copies, and its check-row phase then moves about
// 1.7 TB/s, its totals step about 2.3.
//
// `qspa_qc_global_kernel`, the global design, is kept as the staged
// design's yardstick (chip_smoke.py and the card tests hold the two to
// each other bit for bit); nothing else runs it.  A block of 512 threads
// walks each check row's block edges in order, gathering each edge's total
// and message from device memory, keeping each edge's spectrum, and then
// the backward products, in its own columns of shared memory.  Flooding
// updates every check row of a pass in any order; layered runs the block
// rows in order behind a barrier, the Z check rows of one block row at
// once (they share no VN).
//
// Bound: at B=256 the messages (388 MB) and totals (155 MB) cross device
// memory several times per pass (about 1.9 GB for flooding, 0.55 ms at
// 3.35 TB/s) against about 120 instructions per edge and symbol, so
// device-memory bytes and the latency of the shuffle chains bound it.
//
// Built with -DQSPA_QC_PHASES (cuda_ldpc_torch/tools/qspa_qc_phases.py),
// thread 0 of every block adds the clock64() cycles between the phase
// boundaries PHASE(n) to a per-block counter in shared memory, flushed to
// g_qspa_qc_clk[design][n] when the block ends.

#include "qspa_common.cuh"

using namespace qspa;

// ---- phase counters (compiled in only under QSPA_QC_PHASES)
enum Phase {
  kPhSetup = 0,    // tables, zero fill or the copy of L
  kPhVn,           // flooding totals (the new design: with the decisions)
  kPhVnBarrier,
  kPhDecide,
  kPhDecideBarrier,
  kPhSyndrome,     // with its barrier
  kPhGather,       // the CN walk's gathers (new design: the wait for a chunk)
  kPhSpectra,      // softmax + transform
  kPhProducts,     // backward products
  kPhOutput,       // forward products, output, scatter
  kPhCnBarrier,    // after a block row (layered), a pass or a chunk
  kPhExit,         // results written
  kPhCount
};

#ifdef QSPA_QC_PHASES
__device__ unsigned long long g_qspa_qc_clk[2][kPhCount];
#define PHASE_DECL                                          \
  __shared__ unsigned long long _ph_acc[kPhCount];          \
  unsigned long long _ph_last = clock64();                  \
  if (threadIdx.x == 0)                                     \
    for (int _i = 0; _i < kPhCount; ++_i) _ph_acc[_i] = 0;
#define PHASE(n)                                            \
  if (threadIdx.x == 0) {                                   \
    const unsigned long long _t = clock64();                \
    _ph_acc[n] += _t - _ph_last;                            \
    _ph_last = _t;                                          \
  }
// the value v is computed (its loads have landed) before the stamp
#define PHASE_AFTER(n, v)                                   \
  asm volatile("" ::"f"(v));                                \
  PHASE(n)
#define PHASE_FLUSH(design)                                 \
  if (threadIdx.x == 0)                                     \
    for (int _i = 0; _i < kPhCount; ++_i)                   \
      atomicAdd(&g_qspa_qc_clk[design][_i], _ph_acc[_i]);
#else
#define PHASE_DECL
#define PHASE(n)
#define PHASE_AFTER(n, v)
#define PHASE_FLUSH(design)
#endif

// ---- the global design: the yardstick of qspa_qc_kernel

constexpr int kGlobalThreads = 512;

// Dynamic shared memory of one block: the spectra F and backward products
// Bw, [max_dc][kGlobalThreads] f32 each, then lg [Q] and ex [2(Q-1)] int.
static size_t global_smem_bytes(int q, int max_dc) {
  return sizeof(float) * 2 * (size_t)max_dc * kGlobalThreads +
         sizeof(int) * ((size_t)q + 2 * (q - 1));
}

template <int Q, bool kLayered>
static __global__ void __launch_bounds__(kGlobalThreads) qspa_qc_global_kernel(
    const float* __restrict__ chan, float* __restrict__ T,
    float* __restrict__ C, int* __restrict__ hard,
    unsigned char* __restrict__ ok, int* __restrict__ iters,
    const int* __restrict__ blk_ptr, const int* __restrict__ blk_c,
    const int* __restrict__ blk_s, const int* __restrict__ hz,
    const int* __restrict__ col_ptr, const int* __restrict__ col_eid,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp, int NB,
    int MB, int Z, int EB, int max_dc, int num_iters) {
  extern __shared__ float smem[];
  PHASE_DECL
  const int tid = threadIdx.x, nth = blockDim.x;
  float* Fs = smem;
  float* Bs = Fs + max_dc * nth;
  int* lg = reinterpret_cast<int*>(Bs + max_dc * nth);
  int* ex = lg + Q;
  const int N = NB * Z;
  const int64_t E = (int64_t)EB * Z;
  const int64_t b = blockIdx.x;
  const float* L = chan + b * N * Q;
  float* Tb = T + b * N * Q;
  float* Cb = C + b * E * Q;
  int* hb = hard + b * N;
  const int u = tid % Q, g = tid / Q, G = nth / Q;

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  for (int64_t i = tid; i < E * Q; i += nth) Cb[i] = 0.f;
  if (kLayered)
    for (int64_t i = tid; i < (int64_t)N * Q; i += nth) Tb[i] = L[i];
  __syncthreads();
  PHASE(kPhSetup)

  for (int t = 0;; ++t) {
    if (!kLayered) {
      // totals L + (c2v summed over the VN's edges in block-row order, the
      // slot order of the code's VN lists)
      for (int64_t i = tid; i < (int64_t)N * Q; i += nth) {
        const int n = (int)(i / Q), s = (int)(i % Q);
        const int c = n / Z, cz = n - c * Z;
        const int k0 = col_ptr[c], k1 = col_ptr[c + 1];
        float acc = 0.f;
        for (int k = k0; k < k1; ++k) {
          const int eid = col_eid[k];
          int z = cz - blk_s[eid];
          if (z < 0) z += Z;
          const float v = Cb[((int64_t)eid * Z + z) * Q + s];
          acc = k == k0 ? v : __fadd_rn(acc, v);
        }
        Tb[i] = __fadd_rn(L[i], acc);
      }
      PHASE(kPhVn)
      __syncthreads();
      PHASE(kPhVnBarrier)
    }
    // decide: one group of Q lanes per VN
    for (int n0 = 0; n0 < N; n0 += G) {
      const int n = n0 + g;
      float x[1] = {n < N ? Tb[(int64_t)n * Q + u] : 0.f};
      const int arg = group_argmax<1, Q>(x, u);
      if (n < N && u == 0) hb[n] = arg;
    }
    PHASE(kPhDecide)
    __syncthreads();
    PHASE(kPhDecideBarrier)
    int bad = 0;
    for (int m = tid; m < MB * Z; m += nth) {
      const int r = m / Z, z = m - r * Z;
      int syn = 0;
      for (int eid = blk_ptr[r]; eid < blk_ptr[r + 1]; ++eid) {
        int cz = z + blk_s[eid];
        if (cz >= Z) cz -= Z;
        syn ^= gf_mul(lg, ex, hz[(int64_t)eid * Z + z], hb[blk_c[eid] * Z + cz]);
      }
      bad |= syn != 0;
    }
    bad = __syncthreads_or(bad);
    PHASE(kPhSyndrome)
    if (!bad || t + 1 >= num_iters) {
      if (tid == 0) {
        ok[b] = bad ? 0 : 1;
        iters[b] = bad ? num_iters : t;
      }
      PHASE(kPhExit)
      PHASE_FLUSH(0)
      return;
    }
    for (int r = 0; r < MB; ++r) {
      const int k0 = blk_ptr[r], dc = blk_ptr[r + 1] - k0;
      for (int z0 = 0; z0 < Z; z0 += G) {
        // a group past the last row computes row 0 and stores nothing, so
        // that every lane of the warp takes part in the shuffles
        const bool live = z0 + g < Z;
        const int z = live ? z0 + g : 0;
        for (int d = 0; d < dc; ++d) {
          const int eid = k0 + d;
          int cz = z + blk_s[eid];
          if (cz >= Z) cz -= Z;
          const int vn = blk_c[eid] * Z + cz;
          const int a = gf_div(lg, ex, u, hz[(int64_t)eid * Z + z], Q);
          float x[1] = {__fsub_rn(Tb[(int64_t)vn * Q + a],
                                  Cb[((int64_t)eid * Z + z) * Q + a])};
          PHASE_AFTER(kPhGather, x[0])
          group_softmax<1, Q>(x);
          group_wht<1, Q>(x, u);
          Fs[d * nth + tid] = x[0];
          PHASE(kPhSpectra)
        }
        // exclusive products in nb_decode._qspa_cn_core's order: backward
        // from the last edge, forward from edge 0, each starting at 1
        float bw = 1.f;
        for (int d = dc - 1; d >= 0; --d) {
          Bs[d * nth + tid] = bw;
          bw = __fmul_rn(bw, Fs[d * nth + tid]);
        }
        PHASE_AFTER(kPhProducts, bw)
        float f = 1.f;
        for (int d = 0; d < dc; ++d) {
          float x[1] = {__fmul_rn(f, Bs[d * nth + tid])};
          f = __fmul_rn(f, Fs[d * nth + tid]);
          group_cn_output<1, Q>(x, u);
          const int eid = k0 + d;
          int cz = z + blk_s[eid];
          if (cz >= Z) cz -= Z;
          const int vn = blk_c[eid] * Z + cz;
          const int a = gf_div(lg, ex, u, hz[(int64_t)eid * Z + z], Q);
          float* cp = Cb + ((int64_t)eid * Z + z) * Q + a;
          if (live) {
            if (kLayered) {
              // total = T + (new - old), the jnp function's order
              float* tp = Tb + (int64_t)vn * Q + a;
              *tp = __fadd_rn(*tp, __fsub_rn(x[0], *cp));
            }
            *cp = x[0];
          }
        }
        PHASE(kPhOutput)
      }
      if (kLayered) __syncthreads();  // the next block row reads the totals
      PHASE(kPhCnBarrier)
    }
    __syncthreads();                  // the next pass reads the messages
    PHASE(kPhCnBarrier)
  }
}

template <int Q, bool kLayered>
static cudaError_t launch_global(const float* chan, float* T, float* C,
                                 int* hard, unsigned char* ok, int* iters,
                                 const int* blk_ptr, const int* blk_c,
                                 const int* blk_s, const int* hz,
                                 const int* col_ptr, const int* col_eid,
                                 const int* gf_log, const int* gf_exp, int B,
                                 int NB, int MB, int Z, int EB, int max_dc,
                                 int num_iters, cudaStream_t st) {
  auto kernel = qspa_qc_global_kernel<Q, kLayered>;
  const size_t smem = global_smem_bytes(Q, max_dc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, kGlobalThreads, smem, st>>>(
      chan, T, C, hard, ok, iters, blk_ptr, blk_c, blk_s, hz, col_ptr,
      col_eid, gf_log, gf_exp, NB, MB, Z, EB, max_dc, num_iters);
  return cudaGetLastError();
}

// ---- the staged design: the default kernel

constexpr int kThreads = 256;   // a chunk of kThreads / Q check rows
constexpr int kVnRows = 128;    // VNs of one flooding-totals step
constexpr int kEdges = 4;       // a group's edges in flight at once

// K edges' q-vectors at once, one register a lane each: on each vector
// exactly qspa_common.cuh's group_wht<1, Q> (and below group_softmax<1, Q>,
// group_cn_output<1, Q>), the same operations in the same order, the K
// vectors' steps interleaved so that one vector's shuffles wait while the
// others' issue.
template <int K, int Q>
static __device__ __forceinline__ void wht_k(float (&x)[K], int lane) {
#pragma unroll
  for (int s = 1; s < Q; s <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float p = __shfl_xor_sync(kFull, x[k], s, Q);
      x[k] = (lane & s) ? __fsub_rn(p, x[k]) : __fadd_rn(x[k], p);
    }
}

// softmax (max, exp(x - max), the pairwise sum, divide), then transform
template <int K, int Q>
static __device__ __forceinline__ void spectra_k(float (&x)[K], int lane) {
  float m[K], e[K], t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = x[k];
#pragma unroll
  for (int o = Q / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      m[k] = fmaxf(m[k], __shfl_xor_sync(kFull, m[k], o, Q));
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = e[k] = expf(__fsub_rn(x[k], m[k]));
#pragma unroll
  for (int o = Q / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      t[k] = __fadd_rn(t[k], __shfl_down_sync(kFull, t[k], o, Q));
#pragma unroll
  for (int k = 0; k < K; ++k)
    x[k] = __fdiv_rn(e[k], __shfl_sync(kFull, t[k], 0, Q));
  wht_k<K, Q>(x, lane);
}

// the inverse transform, / q, the floor, the log, minus the value at 0;
// x / q is taken as x * (1 / q), the same float for a power of two q (both
// round the same real number once)
template <int K, int Q>
static __device__ __forceinline__ void cn_output_k(float (&x)[K], int lane) {
  wht_k<K, Q>(x, lane);
#pragma unroll
  for (int k = 0; k < K; ++k)
    x[k] = logf(fmaxf(__fmul_rn(x[k], 1.0f / Q), kEps));
#pragma unroll
  for (int k = 0; k < K; ++k)
    x[k] = __fsub_rn(x[k], __shfl_sync(kFull, x[k], 0, Q));
}

// The symbol of the first maximum (the smallest symbol on ties, as
// group_argmax) of a q-vector whose lanes hold the symbols `sym`, a
// permutation of 0..Q-1.
template <int Q>
static __device__ __forceinline__ int group_argmax_at(float v, int sym) {
  float best = v;
  int arg = sym;
#pragma unroll
  for (int o = Q / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o, Q);
    const int oa = __shfl_xor_sync(kFull, arg, o, Q);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

// 16-byte (bypassing L1) and 4-byte asynchronous copies to shared memory.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
static __device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// Dynamic shared memory of one block, in this order: two stages of
// [max_dc][kThreads] f32 totals and messages (four slabs), two stages of
// [max_dc][G] coefficient logs (bytes), the frame's decisions [N] (bytes),
// then the int tables lg [Q], ex [2(Q-1)], blk_ptr [MB+1], blk_c, blk_s
// [EB], col_ptr [NB+1] and col_eid [EB].  ops/cuda_qspa_qc.py smem_bytes
// computes the same.
static size_t staged_smem_bytes(int q, int max_dc, int NB, int MB, int Z,
                                int EB) {
  const size_t G = kThreads / q;
  return sizeof(float) * 4 * (size_t)max_dc * kThreads +
         round16(2 * (size_t)max_dc * G) + round16((size_t)NB * Z) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + (MB + 1) + 2 * (size_t)EB +
                        (NB + 1) + EB);
}

// The shared-memory layout of one block.
template <int Q>
struct Staged {
  static constexpr int G = kThreads / Q;
  float* slab;             // [4][max_dc * kThreads]: stage k is 2k (T), 2k+1
  unsigned char* hlog;     // [2][max_dc * G]
  unsigned char* hs;       // [N]
  int *lg, *ex, *blk_ptr, *blk_c, *blk_s, *col_ptr, *col_eid;
  int slab_len;

  __device__ Staged(void* base, int max_dc, int N, int NB, int MB, int EB) {
    unsigned char* p = static_cast<unsigned char*>(base);
    slab = reinterpret_cast<float*>(p);
    slab_len = max_dc * kThreads;
    p += sizeof(float) * 4 * (size_t)slab_len;
    hlog = p;
    p += (2 * max_dc * G + 15) & ~15;
    hs = p;
    p += (N + 15) & ~15;
    lg = reinterpret_cast<int*>(p);
    ex = lg + Q;
    blk_ptr = ex + 2 * (Q - 1);
    blk_c = blk_ptr + MB + 1;
    blk_s = blk_c + EB;
    col_ptr = blk_s + EB;
    col_eid = col_ptr + NB + 1;
  }
};

// Issues the copies of chunk j of block row r (its check rows j*G .. j*G +
// G-1) into stage `buf`: for each of the row's dc block edges the G totals
// rows of its VNs (at most two runs, `runs`: first row, rows before the
// wrap, row after it, first message row), the G message rows (unless
// `first`: the messages are 0 on the first pass and are not read) and the
// G coefficient logs.  The caller commits the group.
template <int Q>
static __device__ __forceinline__ void stage_chunk(
    const Staged<Q>& sm, int buf, const float* Tb, const float* Cb,
    const unsigned char* __restrict__ lgh, const int4* __restrict__ runs,
    int r, int j, int lz, bool first) {
  constexpr int G = Staged<Q>::G, P = Q / 4, kRowPieces = G * P;  // 64
  const int k0 = sm.blk_ptr[r], dc = sm.blk_ptr[r + 1] - k0;
  const int4* run = runs + ((int64_t)k0 << lz) / G + j * dc;
  float* Ts = sm.slab + (2 * buf) * sm.slab_len;
  float* Cs = Ts + sm.slab_len;
  for (int p = threadIdx.x; p < dc * kRowPieces; p += kThreads) {
    const int d = p / kRowPieces, w = p - d * kRowPieces;
    const int row = w / P, part = w - row * P;
    const int4 rn = run[d];
    const int vrow = row < rn.y ? rn.x + row : rn.z + (row - rn.y);
    const int o = d * kThreads + row * Q + part * 4;
    cp_async16(Ts + o, Tb + (int64_t)vrow * Q + part * 4);
    if (!first) cp_async16(Cs + o, Cb + (int64_t)(rn.w + row) * Q + part * 4);
  }
  unsigned char* H = sm.hlog + buf * (sm.slab_len / Q);
  for (int p = threadIdx.x; p < dc * (G / 4); p += kThreads) {
    const int d = p / (G / 4), w = p - d * (G / 4);
    cp_async4(H + d * G + w * 4,
              lgh + ((int64_t)(k0 + d) << lz) + j * G + w * 4);
  }
}

// One group's chunk row, edges d .. d+K-1: v2c (the messages are 0 on the
// first pass), softmax and transform, each spectrum over its staged totals
// (Fs, lane u's own symbol, after its group has read the permuted ones:
// the shuffles order the two).
template <int K, int Q>
static __device__ __forceinline__ void spectra_at(
    float* Fs, const float* Bs, const unsigned char* H, const int* ex,
    int lgu, int u, int d, bool first) {
  constexpr int G = kThreads / Q;
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = u ? ex[lgu + (Q - 1) - H[(d + k) * G]] : 0;
    const int o = (d + k) * kThreads;
    x[k] = first ? Fs[o + a] : __fsub_rn(Fs[o + a], Bs[o + a]);
  }
  spectra_k<K, Q>(x, u);
#pragma unroll
  for (int k = 0; k < K; ++k) Fs[(d + k) * kThreads + u] = x[k];
}

// Edges d .. d+K-1 of check row z of the block row whose first block edge
// is k0: their outputs from the running forward product f and the backward
// products, scattered to the messages and, layered, to the totals as T +
// (new - old) in the jnp function's order; layered, the last edge of a
// VN's block column also decides the VN.
template <int K, int Q, bool kLayered>
static __device__ __forceinline__ void output_at(
    float& f, const float* Fs, const float* Bs, const unsigned char* H,
    const Staged<Q>& sm, float* Tb, float* Cb, int lgu, int u, int d, int k0,
    int z, int lz, bool first) {
  constexpr int G = kThreads / Q;
  float x[K], tv[K], old[K];
  int a[K];
  int64_t ce[K], vn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int eid = k0 + d + k;
    a[k] = u ? sm.ex[lgu + (Q - 1) - H[(d + k) * G]] : 0;
    ce[k] = (((int64_t)eid << lz) + z) * Q + a[k];
    vn[k] = (sm.blk_c[eid] << lz) + ((z + sm.blk_s[eid]) & ((1 << lz) - 1));
    // read before the arithmetic, so that their latency overlaps it
    tv[k] = kLayered ? Tb[vn[k] * Q + a[k]] : 0.f;
    old[k] = kLayered && !first ? Cb[ce[k]] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = __fmul_rn(f, Bs[(d + k) * kThreads + u]);
    f = __fmul_rn(f, Fs[(d + k) * kThreads + u]);
  }
  cn_output_k<K, Q>(x, u);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Cb[ce[k]] = x[k];
    if (kLayered) {
      const float nt = __fadd_rn(tv[k], __fsub_rn(x[k], old[k]));
      Tb[vn[k] * Q + a[k]] = nt;
      const int eid = k0 + d + k, c = sm.blk_c[eid];
      if (eid == sm.col_eid[sm.col_ptr[c + 1] - 1]) {
        const int arg = group_argmax_at<Q>(nt, a[k]);
        if (u == 0) sm.hs[vn[k]] = (unsigned char)arg;
      }
    }
  }
}

template <int Q, bool kLayered>
static __global__ void __launch_bounds__(kThreads, 2) qspa_qc_kernel(
    const float* __restrict__ chan, float* __restrict__ T,
    float* __restrict__ C, int* __restrict__ hard,
    unsigned char* __restrict__ ok, int* __restrict__ iters,
    const int* __restrict__ blk_ptr, const int* __restrict__ blk_c,
    const int* __restrict__ blk_s, const int* __restrict__ col_ptr,
    const int* __restrict__ col_eid, const unsigned char* __restrict__ lgh,
    const int4* __restrict__ runs, const int* __restrict__ gf_log,
    const int* __restrict__ gf_exp, int NB, int MB, int lz, int EB,
    int max_dc, int num_iters) {
  constexpr int G = Staged<Q>::G, U = kVnRows / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PHASE_DECL
  const int Z = 1 << lz, zmask = Z - 1, N = NB << lz;
  const Staged<Q> sm(smem_raw, max_dc, N, NB, MB, EB);
  const int tid = threadIdx.x, u = tid & (Q - 1), g = tid / Q;
  const int64_t b = blockIdx.x;
  const float* L = chan + b * N * Q;
  float* Tb = T + b * N * Q;
  float* Cb = C + b * ((int64_t)EB << lz) * Q;

  load_gf_tables(sm.lg, sm.ex, gf_log, gf_exp, Q);
  for (int i = tid; i <= MB; i += kThreads) sm.blk_ptr[i] = blk_ptr[i];
  for (int i = tid; i <= NB; i += kThreads) sm.col_ptr[i] = col_ptr[i];
  for (int i = tid; i < EB; i += kThreads) {
    sm.blk_c[i] = blk_c[i];
    sm.blk_s[i] = blk_s[i];
    sm.col_eid[i] = col_eid[i];
  }
  if (kLayered) {
    const float4* src = reinterpret_cast<const float4*>(L);
    float4* dst = reinterpret_cast<float4*>(Tb);
    for (int i = tid; i < N * Q / 4; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();
  // lane u's symbol y = u: its log, for a / h = ex[lg[u] + (Q-1) - lg[h]]
  const int lgu = sm.lg[u];
  PHASE(kPhSetup)

  for (int t = 0;; ++t) {
    const bool first = t == 0;
    if (!kLayered) {
      // totals L + (c2v summed over the VN's edges in block-row order) and
      // the decision, U VNs of one block column per lane and step (kVnRows
      // divides Z), their loads issued together; on the first pass every
      // message is 0 and the sum is +0 (0 + 0), as the plain version's
      for (int n0 = 0; n0 < N; n0 += kVnRows) {
        const int c = n0 >> lz;
        const int k0 = sm.col_ptr[c], k1 = sm.col_ptr[c + 1];
        float lv[U], acc[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          lv[i] = L[(int64_t)(n0 + g + G * i) * Q + u];
          acc[i] = 0.f;
        }
        if (!first) {
          for (int k = k0; k < k1; ++k) {
            const int eid = sm.col_eid[k], s = sm.blk_s[eid];
            const float* ce = Cb + ((int64_t)eid << lz) * Q + u;
#pragma unroll
            for (int i = 0; i < U; ++i) {
              const int z = ((n0 + g + G * i) - s) & zmask;
              const float v = ce[(int64_t)z * Q];
              acc[i] = k == k0 ? v : __fadd_rn(acc[i], v);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int n = n0 + g + G * i;
          float x[1] = {__fadd_rn(lv[i], acc[i])};
          Tb[(int64_t)n * Q + u] = x[0];
          const int arg = group_argmax<1, Q>(x, u);
          if (u == 0) sm.hs[n] = (unsigned char)arg;
        }
      }
      PHASE(kPhVn)
    } else if (first) {
      // the first decisions, from the totals (L); a later pass's come from
      // the last block row of each VN's column (output_at), and a VN of a
      // column without edges keeps this one
      for (int n0 = 0; n0 < N; n0 += kVnRows) {
        float x[U][1];
#pragma unroll
        for (int i = 0; i < U; ++i)
          x[i][0] = Tb[(int64_t)(n0 + g + G * i) * Q + u];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int arg = group_argmax<1, Q>(x[i], u);
          if (u == 0) sm.hs[n0 + g + G * i] = (unsigned char)arg;
        }
      }
      PHASE(kPhDecide)
    }
    __syncthreads();
    PHASE(kLayered ? kPhDecideBarrier : kPhVnBarrier)
    // GF syndrome from the decisions in shared memory: XOR is exact in any
    // order
    int bad = 0;
    for (int m = tid; m < MB << lz; m += kThreads) {
      const int r = m >> lz, z = m & zmask;
      int syn = 0;
      for (int eid = sm.blk_ptr[r]; eid < sm.blk_ptr[r + 1]; ++eid) {
        const int x = sm.hs[(sm.blk_c[eid] << lz) + ((z + sm.blk_s[eid]) & zmask)];
        const int lh = lgh[((int64_t)eid << lz) + z];
        syn ^= x ? sm.ex[lh + sm.lg[x]] : 0;
      }
      bad |= syn != 0;
    }
    bad = __syncthreads_or(bad);
    PHASE(kPhSyndrome)
    if (!bad || t + 1 >= num_iters) {
      int* hb = hard + b * N;
      for (int n = tid; n < N; n += kThreads) hb[n] = sm.hs[n];
      if (tid == 0) {
        ok[b] = bad ? 0 : 1;
        iters[b] = bad ? num_iters : t;
      }
      PHASE(kPhExit)
      PHASE_FLUSH(1)
      return;
    }
    // the check rows, a chunk of G rows of one block row at a time: chunk
    // i + 1's copies are in flight while chunk i computes (layered: not
    // across a block row, whose totals the next block row reads)
    const int nchunk = Z / G, total = MB * nchunk;
    stage_chunk<Q>(sm, 0, Tb, Cb, lgh, runs, 0, 0, lz, first);
    cp_async_commit();
    for (int i = 0; i < total; ++i) {
      const int r = i / nchunk, j = i - r * nchunk, buf = i & 1;
      const bool ahead = i + 1 < total && (!kLayered || j + 1 < nchunk);
      if (ahead) {
        stage_chunk<Q>(sm, buf ^ 1, Tb, Cb, lgh, runs, (i + 1) / nchunk,
                       (i + 1) % nchunk, lz, first);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      PHASE(kPhGather)
      const int k0 = sm.blk_ptr[r], dc = sm.blk_ptr[r + 1] - k0;
      const int z = j * G + g;
      // the spectra overwrite the staged totals and the backward products
      // the staged messages, each lane its own symbol's column after its
      // group has read the permuted ones (the shuffles order the two)
      float* Fs = sm.slab + (2 * buf) * sm.slab_len + g * Q;
      float* Bs = Fs + sm.slab_len;
      const unsigned char* H = sm.hlog + buf * (sm.slab_len / Q) + g;
      int d = 0;
      for (; d + kEdges <= dc; d += kEdges)
        spectra_at<kEdges, Q>(Fs, Bs, H, sm.ex, lgu, u, d, first);
      for (; d < dc; ++d) spectra_at<1, Q>(Fs, Bs, H, sm.ex, lgu, u, d, first);
      PHASE(kPhSpectra)
      // exclusive products in nb_decode._qspa_cn_core's order: backward
      // from the last edge, forward from edge 0, each starting at 1
      float bw = 1.f;
      for (int d = dc - 1; d >= 0; --d) {
        const float fd = Fs[d * kThreads + u];
        Bs[d * kThreads + u] = bw;
        bw = __fmul_rn(bw, fd);
      }
      PHASE_AFTER(kPhProducts, bw)
      float f = 1.f;
      for (d = 0; d + kEdges <= dc; d += kEdges)
        output_at<kEdges, Q, kLayered>(f, Fs, Bs, H, sm, Tb, Cb, lgu, u, d, k0,
                                       z, lz, first);
      for (; d < dc; ++d)
        output_at<1, Q, kLayered>(f, Fs, Bs, H, sm, Tb, Cb, lgu, u, d, k0, z,
                                  lz, first);
      PHASE(kPhOutput)
      __syncthreads();  // stage buf is refilled next; layered: the totals
      PHASE(kPhCnBarrier)
      if (kLayered && !ahead && i + 1 < total) {
        stage_chunk<Q>(sm, buf ^ 1, Tb, Cb, lgh, runs, (i + 1) / nchunk,
                       (i + 1) % nchunk, lz, first);
        cp_async_commit();
      }
    }
  }
}

template <int Q, bool kLayered>
static cudaError_t launch(const float* chan, float* T, float* C, int* hard,
                          unsigned char* ok, int* iters, const int* blk_ptr,
                          const int* blk_c, const int* blk_s,
                          const int* col_ptr, const int* col_eid,
                          const unsigned char* lgh, const int4* runs,
                          const int* gf_log, const int* gf_exp, int B, int NB,
                          int MB, int lz, int EB, int max_dc, int num_iters,
                          cudaStream_t st) {
  auto kernel = qspa_qc_kernel<Q, kLayered>;
  const size_t smem = staged_smem_bytes(Q, max_dc, NB, MB, 1 << lz, EB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, kThreads, smem, st>>>(chan, T, C, hard, ok, iters, blk_ptr,
                                    blk_c, blk_s, col_ptr, col_eid, lgh, runs,
                                    gf_log, gf_exp, NB, MB, lz, EB, max_dc,
                                    num_iters);
  return cudaGetLastError();
}

// Makes `device` current unless it already is.
static cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

extern "C" {

// Decodes the batch chan [B, NB*Z, q] (q in 4, 8, 16, 32; Z = 2^lz, at
// least kVnRows) of a QC code for at most `num_iters` >= 1
// passes on `stream` of CUDA device `device`: flooding, or block-row
// layered when `layered`.  T [B, N, q] and C [B, EB*Z, q] are the caller's
// scratch, neither read before it is written (C needs no zero fill); hard
// [B, N], ok [B] and iters [B] the outputs.  Block edge eid (block rows'
// edges contiguous, blk_ptr [MB+1]) joins check row r*Z + z to VN
// blk_c[eid]*Z + (z + blk_s[eid]) % Z with coefficient h, lgh[eid*Z + z] =
// log_alpha(h) (bytes); col_eid lists each block column's block edges in
// block-row order (col_ptr [NB+1]); runs [EB * Z / G] holds each chunk's
// staging runs (ops/cuda_qspa_qc.stage_runs).  Returns 0 or the first CUDA
// error met while enqueueing.
int ldpc_qspa_qc(const float* chan, float* T, float* C, int* hard,
                 unsigned char* ok, int* iters, const int* blk_ptr,
                 const int* blk_c, const int* blk_s, const int* col_ptr,
                 const int* col_eid, const unsigned char* lgh,
                 const void* runs, const int* gf_log, const int* gf_exp,
                 int B, int NB, int MB, int lz, int EB, int q, int max_dc,
                 int num_iters, int layered, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = use_device(device))) return err;
  if (max_dc < 1 || lz > 16 || (1 << lz) < kVnRows || (1 << lz) < kThreads / q)
    return cudaErrorInvalidValue;
  const int4* r4 = static_cast<const int4*>(runs);
#define QSPA_QC_LAUNCH(Q)                                                   \
  return (layered ? launch<Q, true> : launch<Q, false>)(                  \
      chan, T, C, hard, ok, iters, blk_ptr, blk_c, blk_s, col_ptr, col_eid, \
      lgh, r4, gf_log, gf_exp, B, NB, MB, lz, EB, max_dc, num_iters, st)
  switch (q) {
    case 4: QSPA_QC_LAUNCH(4);
    case 8: QSPA_QC_LAUNCH(8);
    case 16: QSPA_QC_LAUNCH(16);
    case 32: QSPA_QC_LAUNCH(32);
    default: return cudaErrorInvalidValue;
  }
#undef QSPA_QC_LAUNCH
}

// The global design.  Decodes the batch chan [B, NB*Z, q] (q in 4, 8, 16,
// 32) of a QC code for at most `num_iters` >= 1 passes on `stream` of CUDA
// device `device`: flooding, or block-row layered when `layered`.
// T [B, N, q] and C [B, EB*Z, q] are the caller's scratch; hard [B, N],
// ok [B] and iters [B] the outputs.  Block edge eid (block rows' edges
// contiguous, blk_ptr [MB+1]) joins check row r*Z + z to VN blk_c[eid]*Z +
// (z + blk_s[eid]) % Z with coefficient hz[eid*Z + z]; col_eid lists each
// block column's block edges in block-row order (col_ptr [NB+1]).  Returns
// 0 or the first CUDA error met while enqueueing.
int ldpc_qspa_qc_global(const float* chan, float* T, float* C, int* hard,
                        unsigned char* ok, int* iters, const int* blk_ptr,
                        const int* blk_c, const int* blk_s, const int* hz,
                        const int* col_ptr, const int* col_eid,
                        const int* gf_log, const int* gf_exp, int B, int NB,
                        int MB, int Z, int EB, int q, int max_dc,
                        int num_iters, int layered, int device,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = use_device(device))) return err;
  if (max_dc < 1) return cudaErrorInvalidValue;
#define QSPA_QC_LAUNCH(Q)                                                   \
  return (layered ? launch_global<Q, true> : launch_global<Q, false>)(    \
      chan, T, C, hard, ok, iters, blk_ptr, blk_c, blk_s, hz, col_ptr,      \
      col_eid, gf_log, gf_exp, B, NB, MB, Z, EB, max_dc, num_iters, st)
  switch (q) {
    case 4: QSPA_QC_LAUNCH(4);
    case 8: QSPA_QC_LAUNCH(8);
    case 16: QSPA_QC_LAUNCH(16);
    case 32: QSPA_QC_LAUNCH(32);
    default: return cudaErrorInvalidValue;
  }
#undef QSPA_QC_LAUNCH
}

#ifdef QSPA_QC_PHASES
// Copies the phase counters [2][kPhCount] (the global design, then the new
// one) into out and zeroes them.
int ldpc_qspa_qc_phase_clocks(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_qspa_qc_clk, sizeof(g_qspa_qc_clk));
  if (err) return err;
  unsigned long long zero[2][kPhCount] = {};
  return cudaMemcpyToSymbol(g_qspa_qc_clk, zero, sizeof(zero));
}
#endif

}  // extern "C"
