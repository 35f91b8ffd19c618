// GF(q) FFT-QSPA decoder for codes given by their adjacency (the GF(64) and
// GF(256) files), flooding and serial-row layered, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_qspa.py `_kernel` (:302).
// It computes what ops/nb_decode.py's plain `decode_qspa` and
// `decode_layered_qspa` compute, operation for operation (the order is
// fixed there): per pass, decide (argmax of the totals, the smallest symbol
// on ties), check the true GF syndrome, stop the frame if it passes, else
// update every check row.  A frame whose syndrome passes at the entry of
// pass t reports t iterations; a frame that never passes reports num_iters,
// with the decisions of the last pass.
//
// Design for the card, not a copy of the TPU tiles.  The TPU kernel folds
// each GF permutation into a row-permuted Hadamard matrix (or rotates
// discrete-log-ordered lanes) because a lane gather serialises there.  Here
// the permutation is free: the lane that holds symbol y of an edge reads the
// VN-domain message at symbol y / h from shared memory (a GF division
// through log/antilog tables) and writes its output back to the same
// address.  The transform is log2(q) butterflies: shuffles for the strides
// below a lane group's width, register pairs above.
//
// One block decodes one frame, all passes in one launch, and stops when its
// frame passes, so per-frame freezing costs nothing and `iters` is per
// frame.  The totals T [N, q] of the frame live in shared memory; the c2v
// messages C [E, q] live in device memory, in the caller's buffer [B, E, q]:
// with them LDPC_N576_K480_GF256_exp's state is 221,184 B a frame, more
// than the 227 KB a block may use leaves beside the row scratch, and each
// message is read and written only once or twice per pass.  The phases of a
// pass (totals, decide and check) live in qspa_common.cuh, shared with K7
// (qspa_stream.cu) and K8 (nbms.cu).
//
// The check rows of a pass run at once, walking the host's wave plan
// (ops/cuda_qspa.row_waves): flooding one wave of every row (the totals are
// built before the rows and no row reads what another writes), layered the
// dependency levels (the rows of a level touch disjoint VNs, so T + (new -
// old) needs no atomics, and every pair of rows that share a VN keeps its
// serial order), so the result is the serial schedule's bit for bit.  A
// block barrier closes each wave.  The host picks one of two layouts of a
// row (ops/cuda_qspa.row_layout):
//   * a row on one warp (`qspa_warp_kernel`) where dc' q <= 256, dc' the
//     largest row degree rounded up to a power of two; built for the
//     registry's such codes, BDS.576.288.GF.64 and
//     LDPC_N576_K288_GF64_d1_exp (dc' = 4, q = 64).  Lane group d, W = 32 /
//     dc' lanes, holds edge d, q / W symbols a lane (symbol l + W j in lane
//     l's register j): the transform's strides below W are shuffles of
//     width W, the others pair registers; softmax's max and pairwise sum take
//     log2(W) shuffles; the exclusive products read the other edges' spectra
//     with __shfl_sync across the row's lane groups.  The row needs no
//     spectra scratch and no barrier; each warp walks its own rows of a wave.
//     A block of cuda_qspa.warps warps.  Flooding keeps the frame's C in
//     shared memory, so the totals and the rows read it there: 8 frames an
//     SM put C (49 KB a frame) at about L2's size, and the flooding totals
//     waited on it (45% of the cycles).  Layered, with no totals phase,
//     keeps C in device memory and 8 frames an SM.  The other two pairings
//     lost (PERF.md) and are not built.  See the launch bounds below.
//   * a warp an edge on row groups (`qspa_kernel`, K7's cn_row and
//     walk_waves), elsewhere (the GF(256) codes, on one group: G > 1
//     spills there): G groups of max_dc warps a block, each with its own
//     spectra scratch and named barrier (G from cuda_qspa.groups).  On BDS
//     the row groups (4 flooding, 2 layered) are the yardstick the row on
//     one warp beat, kept for chip_smoke.py's turns.
// The serial design (one group, a wave a row: the first port's schedule)
// is `qspa_kernel` under the serial plan, kept as the yardstick
// (cuda_qspa.decode_flooding_serial / decode_layered_serial).
//
// Bound: on BDS.576.288.GF.64 at B=4096 the function's fp32 operations
// (about 40 per edge, symbol and pass, an expf and a logf among them, 2
// GFLOP a pass) bound it at 0.18 ms; C [B, E, q] (201 MB) crosses device
// memory and L2 two or three times a pass, and the rows' shuffle chains are
// what the kernel waits on (PERF.md §5).
//
// Built with -DNB_ROWS_PHASES (cuda_ldpc_torch/tools/nb_rows_phases.py),
// thread 0 of every block adds the clock64() cycles of each phase to
// g_qspa_clk[layered] when the block ends.

#include "qspa_common.cuh"

using namespace qspa;

#ifdef NB_ROWS_PHASES
__device__ unsigned long long g_qspa_clk[2][kRpCount];
#endif

// The launch bounds of the row-a-warp kernel, flooding (C on chip) and
// layered (C in device memory): at most [0] threads a block and [1] blocks
// an SM, so ptxas keeps to 65,536 / ([0] [1]) registers a thread: 56 and 64
// (no spill for BDS's shape but layered's 28 bytes in device memory,
// -Xptxas -v).  On BDS.576.288.GF.64 a flooding block holds 74.9 KB of
// shared memory, 3 to an SM (12 warps, 36 warps an SM), a layered one 26.7
// KB, 8 to an SM (4 warps, 32 warps an SM): the fastest of the sweep of
// warps a block, bounds and the place of C (PERF.md).
constexpr int kWarpBounds[2][2] = {{384, 3}, {256, 4}};

// Dynamic shared memory of one block: T [N*Q] f32, each row group's
// spectra S [max_dc*Q] f32 (none in the row-a-warp layout, groups = 0), lg
// [Q] and ex [2(Q-1)] int, the decisions [N] int, and the frame's C [E*Q]
// f32 when it lives on chip.
static size_t smem_bytes(int N, int q, int max_dc, int groups, int E = 0) {
  return sizeof(float) * ((size_t)N * q + (size_t)groups * max_dc * q +
                          (size_t)E * q) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + N);
}

// One frame, block b: set-up, then per pass the totals (flooding), the
// decisions and the check, and rows() for the check rows of the pass,
// until the frame passes or num_iters passes have decided; then the
// results.  Cb [E*Q] is the frame's c2v messages (in device memory or in
// shared memory); lg, ex and hs are the block's shared tables.
template <int Q, bool kLayered, class Rows>
static __device__ __forceinline__ void run_frame(
    const float* __restrict__ chan, float* Cb,
    int* __restrict__ hard, unsigned char* __restrict__ ok,
    int* __restrict__ iters, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edge,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp, float* T,
    int* lg, int* ex, int* hs, int N, int M, int E, int num_iters,
    PhaseClock& pc, Rows&& rows) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int64_t b = blockIdx.x;
  const float* L = chan + b * N * Q;

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  for (int64_t i = tid; i < (int64_t)E * Q; i += nth) Cb[i] = 0.f;
  if (kLayered)
    for (int i = tid; i < N * Q; i += nth) T[i] = L[i];
  __syncthreads();
  pc.stamp(kRpSetup);

  for (int t = 0;; ++t) {
    if (!kLayered) {
      frame_totals<Q>(T, L, Cb, col_ptr, col_edge, N);
      __syncthreads();
      pc.stamp(kRpTotals);
    }
    const int bad = frame_decide_check<Q / 32>(T, hs, lg, ex, row_ptr,
                                               edge_vn, edge_h, N, M);
    pc.stamp(kRpDecide);
    if (!bad || t + 1 >= num_iters) {
      for (int n = tid; n < N; n += nth) hard[b * N + n] = hs[n];
      if (tid == 0) {
        ok[b] = bad ? 0 : 1;
        iters[b] = bad ? num_iters : t;
      }
      pc.stamp(kRpExit);
      ROWS_PHASE_FLUSH(pc, g_qspa_clk[kLayered])
      return;
    }
    rows();
  }
}

// ---- A warp an edge, on row groups (and the serial design).

template <int R, bool kLayered, int kGroups>
static __global__ void __launch_bounds__(
    kGroups == 1 ? 1024 : kGroupedThreads, kGroups == 1 ? 1 : kGroupedBlocks)
    qspa_kernel(const float* __restrict__ chan, float* __restrict__ C,
                int* __restrict__ hard, unsigned char* __restrict__ ok,
                int* __restrict__ iters, const int* __restrict__ row_ptr,
                const int* __restrict__ edge_vn,
                const int* __restrict__ edge_h,
                const int* __restrict__ col_ptr,
                const int* __restrict__ col_edge,
                const int* __restrict__ gf_log,
                const int* __restrict__ gf_exp,
                const int* __restrict__ wave_ptr,
                const int* __restrict__ wave_row, int nwaves, int groups,
                int N, int M, int E, int max_dc, int num_iters) {
  constexpr int Q = 32 * R;
  extern __shared__ float smem[];
  const RowGroup<kGroups> grp = row_group<kGroups>(groups);
  float* T = smem;
  float* S = T + N * Q + (grp.id ? grp.id - 1 : 0) * max_dc * Q;
  int* lg = reinterpret_cast<int*>(T + N * Q + groups * max_dc * Q);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  float* Cb = C + (int64_t)blockIdx.x * E * Q;
  ROWS_PHASE_CLOCK(pc)
  run_frame<Q, kLayered>(
      chan, Cb, hard, ok, iters, row_ptr, edge_vn, edge_h, col_ptr, col_edge,
      gf_log, gf_exp, T, lg, ex, hs, N, M, E, num_iters, pc, [&] {
        walk_waves(groups, wave_ptr, wave_row, nwaves, pc, [&](int m) {
          cn_row<R, kLayered, kGroups>(grp, pc, T, S, Cb, lg, ex, row_ptr[m],
                                       row_ptr[m + 1] - row_ptr[m], edge_vn,
                                       edge_h);
        });
      });
}

// ---- A row on one warp.

// One check row, edges k0 .. k0 + dc - 1 (dc <= kDc), on the calling warp:
// lane group d (lanes d W .. d W + W - 1, W = 32 / kDc) takes edge d, and
// its lane l holds symbols l + W j, j < RL.  cn_row's operations in cn_row's
// order: the v2c gather, softmax, transform, the exclusive product in the
// JAX order, the inverse transform and the log, the write-back (layered:
// T + (new - old), the old message kept in registers, not read again).
// Every lane runs every shuffle; a lane group past the row's degree
// computes on zeros and writes nothing.  No barrier.
template <int RL, int kDc, bool kLayered>
static __device__ __forceinline__ void warp_row(
    PhaseClock& pc, float* T, float* Cb, const int* lg, const int* ex, int k0,
    int dc, const int* __restrict__ edge_vn, const int* __restrict__ edge_h) {
  constexpr int W = 32 / kDc, Q = RL * W;
  const int lane = threadIdx.x & 31, d = lane / W, l = lane % W;
  const bool mine = d < dc;
  float x[RL], c[RL];
  int addr[RL];
  int vn = 0, h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + d;
    h = edge_h[e];
    vn = edge_vn[e];
    cp = Cb + (int64_t)e * Q;
  }
#pragma unroll
  for (int j = 0; j < RL; ++j) {
    const int y = l + W * j;
    addr[j] = h ? gf_div(lg, ex, y, h, Q) : y;
    c[j] = mine ? cp[addr[j]] : 0.f;
    x[j] = mine ? __fsub_rn(T[vn * Q + addr[j]], c[j]) : 0.f;
  }
  if (__any_sync(kFull, mine && !h)) {
    // coefficient 0: nb_decode puts the sum of v2c at y = 0 and 0
    // elsewhere (the JAX package's one-hot contraction does)
    const float s = group_rtree_sum<RL, W>(x);
    if (!h) {
#pragma unroll
      for (int j = 0; j < RL; ++j) x[j] = (l + W * j) == 0 ? s : 0.f;
    }
  }
  group_softmax<RL, W>(x);
  group_wht<RL, W>(x, l);
  pc.stamp(kRpEdges);
  // exclusive product: forward from edge 0, backward from the last edge,
  // each starting at 1 (nb_decode._qspa_cn_core's order); edge i's
  // spectrum at this lane's symbol is in lane i W + l, same register
#pragma unroll
  for (int j = 0; j < RL; ++j) {
    float v[kDc];
#pragma unroll
    for (int i = 0; i < kDc; ++i) v[i] = __shfl_sync(kFull, x[j], i * W + l);
    float f = 1.f, bw = 1.f;
#pragma unroll
    for (int i = 0; i < kDc; ++i)
      if (i < d) f = __fmul_rn(f, v[i]);
#pragma unroll
    for (int i = kDc - 1; i > 0; --i)
      if (i > d && i < dc) bw = __fmul_rn(bw, v[i]);
    x[j] = __fmul_rn(f, bw);
  }
  group_cn_output<RL, W>(x, l);
  if (mine) {
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      if (!h) x[j] = 0.f;  // out[k] = llr[0 * k] - llr[0] = 0
      if (kLayered) {
        // total = T + (new - old), the jnp function's order
        float* tp = T + vn * Q + addr[j];
        *tp = __fadd_rn(*tp, __fsub_rn(x[j], c[j]));
      }
      cp[addr[j]] = x[j];
    }
  }
  pc.stamp(kRpOutput);
}

// W = 32 / kDc lanes an edge, RL = q / W symbols a lane; a block of
// `warps` >= 2 warps walks the waves with each warp as a row group.  The
// frame's C lives in shared memory for flooding (the caller's buffer is
// then left untouched), in the caller's buffer for layered.
template <int RL, int kDc, bool kLayered>
static __global__ void __launch_bounds__(kWarpBounds[kLayered][0],
                                         kWarpBounds[kLayered][1])
    qspa_warp_kernel(const float* __restrict__ chan, float* __restrict__ C,
                     int* __restrict__ hard, unsigned char* __restrict__ ok,
                     int* __restrict__ iters,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ edge_vn,
                     const int* __restrict__ edge_h,
                     const int* __restrict__ col_ptr,
                     const int* __restrict__ col_edge,
                     const int* __restrict__ gf_log,
                     const int* __restrict__ gf_exp,
                     const int* __restrict__ wave_ptr,
                     const int* __restrict__ wave_row, int nwaves, int warps,
                     int N, int M, int E, int max_dc, int num_iters) {
  constexpr int Q = RL * (32 / kDc);
  extern __shared__ float smem[];
  float* T = smem;
  int* lg = reinterpret_cast<int*>(T + N * Q);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  float* Cb = kLayered ? C + (int64_t)blockIdx.x * E * Q
                       : reinterpret_cast<float*>(hs + N);
  ROWS_PHASE_CLOCK(pc)
  run_frame<Q, kLayered>(
      chan, Cb, hard, ok, iters, row_ptr, edge_vn, edge_h, col_ptr, col_edge,
      gf_log, gf_exp, T, lg, ex, hs, N, M, E, num_iters, pc, [&] {
        walk_waves(warps, wave_ptr, wave_row, nwaves, pc, [&](int m) {
          warp_row<RL, kDc, kLayered>(pc, T, Cb, lg, ex, row_ptr[m],
                                      row_ptr[m + 1] - row_ptr[m], edge_vn,
                                      edge_h);
        });
      });
}

// ---- Dispatch.

using Kernel = void (*)(const float*, float*, int*, unsigned char*, int*,
                        const int*, const int*, const int*, const int*,
                        const int*, const int*, const int*, const int*,
                        const int*, int, int, int, int, int, int, int);

// A warp an edge: the serial instantiation (no named barrier) for one
// group, else kMaxGroups'.
template <int R>
static Kernel groups_kernel(bool layered, int groups) {
  const bool one = groups == 1;
  return layered ? (one ? qspa_kernel<R, true, 1>
                        : qspa_kernel<R, true, kMaxGroups>)
                 : (one ? qspa_kernel<R, false, 1>
                        : qspa_kernel<R, false, kMaxGroups>);
}

// The kernel of a layout (0: a warp an edge on `width` row groups; 1: a row
// a warp, `width` warps a block) for q, dc' (max_dc rounded up to a power
// of two) and the schedule, its threads a block and its shared memory; null
// when it does not take them.
static Kernel kernel_for(int layout, int width, int q, int N, int E,
                         int max_dc, bool layered, int* threads,
                         size_t* smem) {
  if (max_dc < 1 || max_dc > 32 || width < 1) return nullptr;
  if (layout == 0) {
    if (width > kMaxGroups ||
        32 * max_dc * width > (width == 1 ? 1024 : kGroupedThreads))
      return nullptr;
    *threads = 32 * max_dc * width;
    *smem = smem_bytes(N, q, max_dc, width);
    switch (q) {
      case 32: return groups_kernel<1>(layered, width);
      case 64: return groups_kernel<2>(layered, width);
      case 128: return groups_kernel<4>(layered, width);
      case 256: return groups_kernel<8>(layered, width);
      default: return nullptr;
    }
  }
  if (layout != 1 || width < 2 || 32 * width > kWarpBounds[layered][0])
    return nullptr;
  *threads = 32 * width;
  *smem = smem_bytes(N, q, max_dc, 0, layered ? 0 : E);
  // built for GF(64) rows of 3 or 4 edges: dc' = 4, 8 symbols a lane
  if (q != 64 || max_dc <= 2 || max_dc > 4) return nullptr;
  return layered ? qspa_warp_kernel<8, 4, true>
                 : qspa_warp_kernel<8, 4, false>;
}

extern "C" {

// Decodes the batch chan [B, N, q] (q in 32, 64, 128, 256; 1 <= max_dc <=
// 32 edges per row) for at most `num_iters` >= 1 passes on `stream` of CUDA
// device `device`: flooding, or serial-row layered when `layered`, walking
// the wave plan wave_ptr [nwaves + 1], wave_row [M] (ops/cuda_qspa
// .row_waves).  `layout` 0: a warp an edge on `width` row groups (1 to 7;
// one group at most 1024 threads, more at most 512); 1: a row on one warp,
// `width` >= 2 warps a block (q = 64, 3 or 4 edges a row; flooding keeps
// each frame's C in shared memory).  C [B, E, q] is the caller's scratch
// (flooding's layout 1 leaves it untouched); hard [B, N], ok [B] and iters
// [B] the outputs.  Edge e
// of row m is row_ptr[m] + slot, at VN edge_vn[e] with coefficient
// edge_h[e]; col_edge lists each VN's edges in its slot order.  gf_log [q]
// and gf_exp [2(q-1)] are the field's tables.  Returns 0 or the first CUDA
// error met while enqueueing.
int ldpc_qspa(const float* chan, float* C, int* hard, unsigned char* ok,
              int* iters, const int* row_ptr, const int* edge_vn,
              const int* edge_h, const int* col_ptr, const int* col_edge,
              const int* gf_log, const int* gf_exp, const int* wave_ptr,
              const int* wave_row, int nwaves, int layout, int width, int B,
              int N, int M, int E, int q, int max_dc, int num_iters,
              int layered, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  int threads = 0;
  size_t smem = 0;
  Kernel kernel = kernel_for(layout, width, q, N, E, max_dc, layered != 0,
                             &threads, &smem);
  if (!kernel) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, threads, smem, st>>>(chan, C, hard, ok, iters, row_ptr,
                                   edge_vn, edge_h, col_ptr, col_edge,
                                   gf_log, gf_exp, wave_ptr, wave_row,
                                   nwaves, width, N, M, E, max_dc, num_iters);
  return cudaGetLastError();
}

// Blocks an SM of CUDA device `device` holds of the kernel for the layout
// and width, q, the schedule, N, E and max_dc (as ldpc_qspa takes them); -1
// on a bad argument or a CUDA error.
int ldpc_qspa_blocks_per_sm(int q, int layered, int layout, int width, int N,
                            int E, int max_dc, int device) {
  int threads = 0, blocks = 0;
  size_t smem = 0;
  Kernel kernel = kernel_for(layout, width, q, N, E, max_dc, layered != 0,
                             &threads, &smem);
  if (cudaSetDevice(device) || !kernel ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem))
    return -1;
  return blocks;
}

#ifdef NB_ROWS_PHASES
// Copies the phase counters [2][kRpCount] (flooding, layered) into out and
// zeroes them.
int ldpc_qspa_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_qspa_clk, sizeof(g_qspa_clk));
  if (err) return err;
  unsigned long long zero[2][kRpCount] = {};
  return cudaMemcpyToSymbol(g_qspa_clk, zero, sizeof(zero));
}
#endif

}  // extern "C"
