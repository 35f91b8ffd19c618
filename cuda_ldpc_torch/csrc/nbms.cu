// GF(q) max-domain decoders for codes given by their adjacency: flooding
// EMS (Nm = 2, Nc = 2, /1.2), flooding TMM (x0.8, accumulating totals) and
// row-layered TMM, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_nbms.py `_kernel`
// (:376).  It computes what ops/nb_decode.py's plain `decode` computes for
// 'ems' (nm = nc = 2), 'tmm' and 'layered_tmm', operation for operation
// (the order is fixed there): per pass, the totals (EMS: L + the c2v summed
// over the VN's edges in slot order; TMM: the state plus that sum; layered:
// the state as it stands), the decisions (argmax for EMS, argmin for TMM,
// the smallest symbol on ties), the true GF syndrome, then, if the frame
// goes on, every check row.  A frame whose syndrome passes at the entry of
// pass t reports t iterations; one that never passes reports num_iters
// with the decisions of the last pass.  TMM takes its channel already in
// the min domain (the wrapper applies nb_decode.to_min_domain).
//
// Design for the card, not a copy of the TPU tiles.  The TPU kernel runs
// each GF permutation and each per-frame XOR shift as [q, q] one-hot
// matmuls (and the TMM 2-deviation search through a [q, q, q] stack),
// because a lane gather serialises there.  Here both are index arithmetic
// on shared memory: lane y of an edge reads the VN-domain value at y / h (a
// division through the log/antilog tables) or the value at y ^ s, exactly.
// One block decodes one frame, all passes in one launch, and stops when its
// frame passes (per-frame freezing costs nothing, and the outputs equal a
// per-tile stop's).  The block holds `groups` row groups (qspa_common.cuh)
// of one warp per edge of a row; each group runs a row at a time, in a few
// phases separated by the group's own barrier, with its own scratch:
//   EMS: each warp computes its edge's CN-domain message U, its first
//   maximum c0, the delta profile W[y] = U[y ^ c0] - max and its best
//   non-zero offset; then warp `dout` takes the best single deviation of
//   the other edges at each offset (max over d != dout, the same values as
//   the JAX package's max1/max2/argmax trick), the pairs of other edges at
//   their best offsets, and writes c2v[k] = (D[h k ^ g0] - D[g0]) * f32(1/1.2).
//   TMM: each warp computes its edge's first minimum, Zn = h * argmin and
//   dU[eta] = U[eta ^ Zn] - min; the group takes min1/min2/column per eta,
//   then the 2-deviation search (for each output eta a scan over j of
//   max(min1[j], min1[eta ^ j]), strict < so the first j wins, split over
//   the group's threads in ordered j ranges and merged in order, so the
//   first j wins whatever the split); warp `dout` writes c2v[k] = 0.8 *
//   Lc2p[h k ^ syn ^ Zn]; layered also writes the totals T + (fma(x, 0.8,
//   v2c) - T), the plain version's order.
// The rows of a pass come from the host's wave plan (ops/cuda_qspa
// .row_waves): flooding (EMS, TMM) is one wave, every row at once over the
// groups (group g takes rows g, g + G, ...), since no row writes what
// another reads (EMS reads the totals, TMM accumulates them before the
// rows); layered TMM runs its dependency levels, the rows of a level over
// the groups and a block barrier between levels, so that every pair of rows
// that share a VN keeps its serial order and the result is the serial
// schedule's bit for bit.  The serial design (one group, a wave a row, the
// block barrier) is the same kernel under the serial plan
// (cuda_nbms.decode_*_serial), kept as the yardstick of the row groups.
// Measured on BDS.576.288.GF.64 (NVIDIA H100, PERF.md): the row groups
// take EMS from 8.1 to 6.1 ms, TMM only from 11.0 to 10.7 (its search
// keeps the SM's issue slots busy, whatever the rows in flight), and ran
// layered TMM slower, so the wrapper runs layered TMM on one group, in
// level order.
// The totals T [N, q] live in shared memory, the c2v messages C [E, q] in
// the caller's device buffer [B, E, q]: with C beside T in shared memory a
// BDS.576.288.GF.64 block took 79 KB in the serial design, which left room
// for 2 blocks an SM instead of 7, and it ran 1.8-2x slower on the H100;
// with 1, 2 or 4 row groups it ran slower too (PERF.md).
//
// Arithmetic: adds, subtracts and multiplies through the __f*_rn
// intrinsics (nvcc cannot contract them), the one fused multiply-add as
// __fmaf_rn; max, min and the GF tables are exact.
//
// Bound: on BDS.576.288.GF.64 the TMM function needs q(q - 1)/2 = 2,016
// unordered 2-deviation candidates of 4 fp32 operations per row, 48 rows a
// pass, per frame (chip_smoke.nbms_bound_ms); the search here scans all
// q^2 ordered ones, so it does about twice the candidates the function
// needs.  EMS needs a dozen operations per edge and symbol.  The bytes are
// the channel and the decisions once per call; so operations bound it, and
// in practice the latency of each row's barriers and shuffle chains, which
// the row groups overlap.
//
// Built with -DNB_ROWS_PHASES (cuda_ldpc_torch/tools/nb_rows_phases.py),
// thread 0 of every block adds the clock64() cycles of each phase to
// g_nbms_clk[method] when the block ends.

#include "qspa_common.cuh"

using namespace qspa;

namespace {

constexpr float kPos = 1e30f;
constexpr float kEmsScale = 0.833333313465118408203125f;  // f32(1 / 1.2)
constexpr float kTmmScale = 0.800000011920928955078125f;  // f32(0.8)

enum Method { kEms = 0, kTmm = 1, kLayeredTmm = 2 };

#ifdef NB_ROWS_PHASES
__device__ unsigned long long g_nbms_clk[3][kRpCount];
#endif

// Floats of one row group's scratch: X and Y [max_dc, Q], A [max(max_dc,
// 7), Q] and the per-edge scalars [3 * 32].
__host__ __device__ inline int group_floats(int q, int max_dc) {
  return (2 * max_dc + (max_dc > 7 ? max_dc : 7)) * q + 3 * 32;
}

// Dynamic shared memory of one block: T [N, Q], each group's scratch, the
// GF tables and the decisions.
size_t smem_bytes(int N, int q, int max_dc, int groups) {
  return sizeof(float) * ((size_t)N * q +
                          (size_t)groups * group_floats(q, max_dc)) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + N);
}

// One EMS check row (Nm = Nc = 2) on a row group; the group's warp w
// holds edge k0 + w.  Ends with the group's barrier.
template <int R, int kGroups>
__device__ __forceinline__ void ems_row(const RowGroup<kGroups>& grp,
                                        PhaseClock& pc,
                                        const float* T, float* Cb, float* X,
                                        float* Y, float* Dm, int* ei,
                                        float* ef, const int* lg,
                                        const int* ex, int k0, int dc,
                                        const int* __restrict__ edge_vn,
                                        const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int w = grp.tid >> 5, lane = grp.tid & 31;
  const bool mine = w < dc;
  int h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + w, vn = edge_vn[e];
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
    float u[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      const int a = h ? gf_div(lg, ex, y, h, Q) : y;
      u[j] = __fsub_rn(T[vn * Q + a], cp[a]);
    }
    if (!h) {  // coefficient 0: the sum of v2c at y = 0, 0 elsewhere
      const float s = group_rtree_sum<R, 32>(u);
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] = (lane + 32 * j) == 0 ? s : 0.f;
    }
    const float v0 = group_max<R, 32>(u);
    const int c0 = group_argmax<R, 32>(u, lane);
    float* xw = X + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) xw[lane + 32 * j] = u[j];
    __syncwarp();
    float wv[R], w0[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      wv[j] = __fsub_rn(xw[y ^ c0], v0);
      Y[w * Q + y] = wv[j];
      w0[j] = y == 0 ? kNeg : wv[j];
    }
    const float p1 = group_max<R, 32>(w0);
    const int o1 = group_argmax<R, 32>(w0, lane);
    if (lane == 0) {
      ei[w] = c0;
      ei[32 + w] = o1;
      ef[w] = p1;
    }
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  if (mine) {
    // conf(q,1): the best single deviation of the other edges
    float D[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      float m = kNeg;
      bool first = true;
      for (int d = 0; d < dc; ++d) {
        if (d == w) continue;
        const float x = Y[d * Q + y];
        m = first ? x : fmaxf(m, x);
        first = false;
      }
      D[j] = m;
    }
    // conf(2,2): every pair of other edges at their best non-zero offsets
    if (dc >= 3) {
      for (int a = 0; a < dc; ++a) {
        if (a == w) continue;
        for (int b = a + 1; b < dc; ++b) {
          if (b == w) continue;
          const float val = __fadd_rn(ef[a], ef[b]);
          const int off = ei[32 + a] ^ ei[32 + b];
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (lane + 32 * j == off) D[j] = fmaxf(D[j], val);
        }
      }
    }
    int g0 = 0;
    for (int d = 0; d < dc; ++d) g0 ^= ei[d];
    g0 ^= ei[w];
    float* dw = Dm + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) dw[lane + 32 * j] = D[j];
    __syncwarp();
    const float d0 = dw[g0];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int idx = (h ? gf_mul(lg, ex, h, k) : 0) ^ g0;
      cp[k] = __fmul_rn(__fsub_rn(dw[idx], d0), kEmsScale);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

// One TMM check row on a row group; the group's warp w holds edge k0 + w.
// Layered also writes the row's totals.  Ends with the group's barrier.
template <int R, bool kLayered, int kGroups>
__device__ __forceinline__ void tmm_row(const RowGroup<kGroups>& grp,
                                        PhaseClock& pc,
                                        float* T, float* Cb, float* X,
                                        float* Y, float* A, int* ei,
                                        const int* lg, const int* ex, int k0,
                                        int dc,
                                        const int* __restrict__ edge_vn,
                                        const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int tid = grp.tid, nth = grp.nth;
  const int w = tid >> 5, lane = tid & 31;
  const bool mine = w < dc;
  int h = 0, vn = 0, zn = 0;
  float* cp = Cb;
  float v[R];
  if (mine) {
    const int e = k0 + w;
    vn = edge_vn[e];
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      v[j] = __fsub_rn(T[vn * Q + y], cp[y]);
    }
    const float vmin = group_min<R, 32>(v);
    zn = h ? gf_mul(lg, ex, h, group_argmin<R, 32>(v, lane)) : 0;
    float* xw = X + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) xw[lane + 32 * j] = v[j];
    const float s = h ? 0.f : group_rtree_sum<R, 32>(v);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      // U[y ^ Zn] with U[y'] = v2c[y' / h]; coefficient 0: U[0] = the sum
      // of v2c, U[y' != 0] = 0, and Zn = 0
      const float uz = h ? xw[gf_div(lg, ex, y ^ zn, h, Q)]
                         : (y == 0 ? s : 0.f);
      Y[w * Q + y] = __fsub_rn(uz, vmin);
    }
    if (lane == 0) ei[w] = zn;
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  // min1, min2 and the first column of min1, per eta, over the row's edges
  float* min1 = A;
  float* min2 = A + Q;
  int* col = reinterpret_cast<int*>(A + 2 * Q);
  for (int eta = tid; eta < Q; eta += nth) {
    float m1 = Y[eta], m2 = kPos;
    int c = 0;
    for (int d = 1; d < dc; ++d) {
      const float x = Y[d * Q + eta];
      const bool lt = x < m1;
      m2 = lt ? m1 : fminf(m2, x);
      c = lt ? d : c;
      m1 = fminf(m1, x);
    }
    min1[eta] = m1;
    min2[eta] = m2;
    col[eta] = c;
  }
  pc.stamp(kRpMins);
  grp.sync();
  pc.stamp(kRpRowWait);
  // 2-deviation search: S ordered j ranges per output eta, in X (the best
  // value) and Y (its two columns, packed); X and Y are free now
  int S = 1;
  while (2 * S * Q <= nth && 2 * S <= Q) S *= 2;
  int* packed = reinterpret_cast<int*>(Y);
  for (int slot = tid; slot < S * Q; slot += nth) {
    const int i = slot % Q, part = slot / Q, span = Q / S;
    float I2 = kPos;
    int best = 0;
    for (int jj = part * span; jj < (part + 1) * span; ++jj) {
      const float vj = min1[jj], mk = min1[i ^ jj];
      const int cj = col[jj], ck = col[i ^ jj];
      const bool valid = cj != ck && vj != mk && i != jj;
      const float cand = valid ? fmaxf(vj, mk) : kPos;
      if (cand < I2) {
        I2 = cand;
        best = cj | (ck << 16);
      }
    }
    X[slot] = I2;
    packed[slot] = best;
  }
  pc.stamp(kRpSearch);
  grp.sync();
  pc.stamp(kRpRowWait);
  float* Iv = A + 3 * Q;
  float* Ev = A + 4 * Q;
  int* p1 = reinterpret_cast<int*>(A + 5 * Q);
  int* p2 = reinterpret_cast<int*>(A + 6 * Q);
  for (int i = tid; i < Q; i += nth) {
    float I2 = X[i];
    int best = packed[i];
    for (int part = 1; part < S; ++part)
      if (X[part * Q + i] < I2) {  // strict: the earlier j range wins ties
        I2 = X[part * Q + i];
        best = packed[part * Q + i];
      }
    const bool use2 = I2 < min1[i];
    Iv[i] = use2 ? I2 : min1[i];
    Ev[i] = use2 ? min1[i] : min2[i];
    p1[i] = use2 ? (best & 0xffff) : col[i];
    p2[i] = use2 ? (best >> 16) : col[i];
  }
  pc.stamp(kRpMerge);
  grp.sync();
  pc.stamp(kRpRowWait);
  if (mine) {
    int syn = 0;
    for (int d = 0; d < dc; ++d) syn ^= ei[d];
    const int beta = syn ^ zn;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int eta = (h ? gf_mul(lg, ex, h, k) : 0) ^ beta;
      const float x =
          eta == 0 ? 0.f
                   : ((p1[eta] == w || p2[eta] == w) ? Ev[eta] : Iv[eta]);
      if (kLayered) {
        float* tp = T + vn * Q + k;
        *tp = __fadd_rn(*tp, __fsub_rn(__fmaf_rn(x, kTmmScale, v[j]), *tp));
      }
      cp[k] = __fmul_rn(kTmmScale, x);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

template <int R, int kMethod, int kGroups>
__global__ void __launch_bounds__(kGroups == 1 ? 1024 : kGroupedThreads,
                                  kGroups == 1 ? 1 : kGroupedBlocks)
    nbms_kernel(
    const float* __restrict__ chan, float* __restrict__ C,
    int* __restrict__ hard, unsigned char* __restrict__ ok,
    int* __restrict__ iters, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edge,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp,
    const int* __restrict__ wave_ptr, const int* __restrict__ wave_row,
    int nwaves, int groups, int N, int M, int E, int max_dc,
    int num_iters) {
  constexpr int Q = 32 * R;
  extern __shared__ float smem[];
  const RowGroup<kGroups> grp = row_group<kGroups>(groups);
  const int gf = group_floats(Q, max_dc);
  float* T = smem;
  float* X = T + N * Q + (grp.id ? grp.id - 1 : 0) * gf;
  float* Y = X + max_dc * Q;
  float* A = Y + max_dc * Q;
  float* ef = A + (max_dc > 7 ? max_dc : 7) * Q;
  int* ei = reinterpret_cast<int*>(ef + 32);
  int* lg = reinterpret_cast<int*>(T + N * Q + groups * gf);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int64_t b = blockIdx.x;
  const float* L = chan + b * N * Q;
  float* Cb = C + b * E * Q;
  ROWS_PHASE_CLOCK(pc)

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  for (int i = tid; i < E * Q; i += nth) Cb[i] = 0.f;
  if (kMethod != kEms)
    for (int i = tid; i < N * Q; i += nth) T[i] = L[i];
  __syncthreads();
  pc.stamp(kRpSetup);

  for (int t = 0;; ++t) {
    if (kMethod == kEms) {
      frame_totals<Q>(T, L, Cb, col_ptr, col_edge, N);
      __syncthreads();
      pc.stamp(kRpTotals);
    } else if (kMethod == kTmm) {  // the state accumulates the c2v sum
      frame_totals<Q>(T, T, Cb, col_ptr, col_edge, N);
      __syncthreads();
      pc.stamp(kRpTotals);
    }
    const int bad = frame_decide_check<R, kMethod != kEms>(
        T, hs, lg, ex, row_ptr, edge_vn, edge_h, N, M);
    pc.stamp(kRpDecide);
    if (!bad || t + 1 >= num_iters) {
      for (int n = tid; n < N; n += nth) hard[b * N + n] = hs[n];
      if (tid == 0) {
        ok[b] = bad ? 0 : 1;
        iters[b] = bad ? num_iters : t;
      }
      pc.stamp(kRpExit);
      ROWS_PHASE_FLUSH(pc, g_nbms_clk[kMethod])
      return;
    }
    walk_waves(groups, wave_ptr, wave_row, nwaves, pc, [&](int m) {
      const int k0 = row_ptr[m], dc = row_ptr[m + 1] - k0;
      if (kMethod == kEms)
        ems_row<R, kGroups>(grp, pc, T, Cb, X, Y, A, ei, ef, lg, ex, k0, dc,
                            edge_vn, edge_h);
      else
        tmm_row<R, kMethod == kLayeredTmm, kGroups>(
            grp, pc, T, Cb, X, Y, A, ei, lg, ex, k0, dc, edge_vn, edge_h);
    });
  }
}

// The kernel for R, the method and the number of groups: the serial
// instantiation (no named barrier) for one group, else kMaxGroups'.
template <int R>
auto kernel_for(int method, int groups) {
  const bool one = groups == 1;
  return method == kEms
             ? (one ? nbms_kernel<R, kEms, 1> : nbms_kernel<R, kEms, kMaxGroups>)
         : method == kTmm
             ? (one ? nbms_kernel<R, kTmm, 1> : nbms_kernel<R, kTmm, kMaxGroups>)
             : (one ? nbms_kernel<R, kLayeredTmm, 1>
                    : nbms_kernel<R, kLayeredTmm, kMaxGroups>);
}

template <int R>
cudaError_t launch(const float* chan, float* C, int* hard, unsigned char* ok,
                   int* iters, const int* row_ptr, const int* edge_vn,
                   const int* edge_h, const int* col_ptr, const int* col_edge,
                   const int* gf_log, const int* gf_exp, const int* wave_ptr,
                   const int* wave_row, int nwaves, int groups, int B, int N,
                   int M, int E, int max_dc, int num_iters, int method,
                   cudaStream_t st) {
  auto kernel = kernel_for<R>(method, groups);
  const size_t smem = smem_bytes(N, 32 * R, max_dc, groups);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, 32 * max_dc * groups, smem, st>>>(
      chan, C, hard, ok, iters, row_ptr, edge_vn, edge_h, col_ptr, col_edge,
      gf_log, gf_exp, wave_ptr, wave_row, nwaves, groups, N, M, E, max_dc,
      num_iters);
  return cudaGetLastError();
}

// Blocks an SM holds of the kernel for R, the method and the groups.
template <int R>
int blocks_per_sm(int method, int groups, int N, int max_dc) {
  auto kernel = kernel_for<R>(method, groups);
  const size_t smem = smem_bytes(N, 32 * R, max_dc, groups);
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, 32 * max_dc * groups, smem))
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

// Decodes the batch chan [B, N, q] (q in 32, 64, 128, 256; 2 <= max_dc <=
// 32 edges per row) for at most `num_iters` >= 1 passes on `stream` of CUDA
// device `device`, with `method` 0 = EMS (positive-domain LLRs), 1 = TMM,
// 2 = layered TMM (min-domain LLRs), on `groups` row groups (1 to 7; one
// group at most 1024 threads, more at most 512) walking the rows of the wave plan wave_ptr
// [nwaves + 1], wave_row [M] (ops/cuda_qspa.row_waves).  C [B, E, q] is
// the caller's scratch; hard [B, N], ok [B] and iters [B] the outputs.  The
// tables are those of ldpc_qspa.  Returns 0 or the first CUDA error met
// while enqueueing.
int ldpc_nbms(const float* chan, float* C, int* hard, unsigned char* ok,
              int* iters, const int* row_ptr, const int* edge_vn,
              const int* edge_h, const int* col_ptr, const int* col_edge,
              const int* gf_log, const int* gf_exp, const int* wave_ptr,
              const int* wave_row, int nwaves, int groups, int B, int N,
              int M, int E, int q, int max_dc, int num_iters, int method,
              int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (max_dc < 2 || max_dc > 32 || method < 0 || method > 2 || groups < 1 ||
      groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads))
    return cudaErrorInvalidValue;
#define NBMS_LAUNCH(R)                                                    \
  return launch<R>(chan, C, hard, ok, iters, row_ptr, edge_vn, edge_h,    \
                   col_ptr, col_edge, gf_log, gf_exp, wave_ptr, wave_row, \
                   nwaves, groups, B, N, M, E, max_dc, num_iters, method, \
                   st)
  switch (q) {
    case 32: NBMS_LAUNCH(1);
    case 64: NBMS_LAUNCH(2);
    case 128: NBMS_LAUNCH(4);
    case 256: NBMS_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef NBMS_LAUNCH
}

// Blocks of the kernel an SM of CUDA device `device` holds for q, the
// method, the groups, N and max_dc (as ldpc_nbms takes them); -1 on a bad
// argument or a CUDA error.
int ldpc_nbms_blocks_per_sm(int q, int method, int groups, int N, int max_dc,
                            int device) {
  if (cudaSetDevice(device) || max_dc < 2 || max_dc > 32 || method < 0 ||
      method > 2 || groups < 1 || groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads))
    return -1;
  switch (q) {
    case 32: return blocks_per_sm<1>(method, groups, N, max_dc);
    case 64: return blocks_per_sm<2>(method, groups, N, max_dc);
    case 128: return blocks_per_sm<4>(method, groups, N, max_dc);
    case 256: return blocks_per_sm<8>(method, groups, N, max_dc);
    default: return -1;
  }
}

#ifdef NB_ROWS_PHASES
// Copies the phase counters [3][kRpCount] (EMS, TMM, layered TMM) into out
// and zeroes them.
int ldpc_nbms_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_nbms_clk, sizeof(g_nbms_clk));
  if (err) return err;
  unsigned long long zero[3][kRpCount] = {};
  return cudaMemcpyToSymbol(g_nbms_clk, zero, sizeof(zero));
}
#endif

}  // extern "C"
