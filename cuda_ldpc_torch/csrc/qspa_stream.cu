// Stateful step of the GF(q) continuous-batching (stream) engine on the
// adjacency codes, FFT-QSPA flooding or serial-row layered, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_qspa_stream.py
// `_stream_kernel` (:136).  It computes what ops/qspa_stream.py's plain
// `stream_step` computes, operation for operation: up to k passes over
// persistent per-slot state, each pass
//   decide   flooding: totals L + (c2v summed in slot order); layered: the
//            totals are the state; argmax per VN, the smallest symbol on ties
//   check    the GF syndrome
//   account  a slot that was running finishes when its syndrome passes or
//            its count t has reached max_iters (okf records the syndrome); a
//            slot that goes on counts one more iteration
//   update   every check row in series for a slot that goes on
// hard holds the decisions of the slot's last pass (zeros for a slot that
// was finished on entry), layered writes its totals back, and a slot that is
// finished leaves with its c2v messages zeroed, so that the engine refills
// only its channel.
//
// It is K5's warp-an-edge design (qspa.cu's qspa_kernel) with its state
// carried across calls: one block per slot, the same phases from
// qspa_common.cuh (frame_totals, frame_decide_check, and cn_row, the
// serial row on a row group), hence the same arithmetic order.  The
// differences: C [B, E, q] is read from the previous call instead of
// zeroed; layered seeds T from `chan`, which carries the running totals,
// and writes them back; the slot's count t, finished flag and check flag
// come in and go out; and the check rows
// run on `groups` row groups (qspa_common.cuh), each with its own spectra
// scratch and barrier, walking the host's wave plan (ops/cuda_qspa
// .row_waves): flooding every row of a pass at once (the totals are built
// before the rows and no row reads what another writes), layered by
// dependency level (the rows of a level touch disjoint VNs, and every pair
// of rows that share a VN keeps its serial order), so the result is the
// serial schedule's bit for bit.  The serial design (one group, a wave a
// row: K5's schedule) is the same kernel under the serial plan
// (cuda_qspa_stream.stream_step_serial), kept as the yardstick.  C stays
// in device memory: in shared memory for the call (49 KB a slot on
// BDS.576.288.GF.64) a block left 2-3 blocks an SM and the step ran slower
// at 1, 2 and 4 groups (PERF.md).  A
// finished slot's block stops looping, which is the per-slot freeze.  The
// TPU's lane padding, discrete-log lane order and one-hot hard are not
// needed here: hard is [B, N] int32 symbols.
//
// Built with -DNB_ROWS_PHASES (cuda_ldpc_torch/tools/nb_rows_phases.py),
// thread 0 of every block adds the clock64() cycles of each phase to
// g_qspa_stream_clk[layered] when the block ends.

#include "qspa_common.cuh"

using namespace qspa;

#ifdef NB_ROWS_PHASES
__device__ unsigned long long g_qspa_stream_clk[2][kRpCount];
#endif

// Dynamic shared memory of one block: T [N*Q] f32, each group's spectra S
// [max_dc*Q] f32, lg [Q] and ex [2(Q-1)] int, the decisions [N] (one
// group: K5's).
static size_t smem_bytes(int N, int q, int max_dc, int groups) {
  return sizeof(float) * ((size_t)N * q + (size_t)groups * max_dc * q) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + N);
}

template <int R, bool kLayered, int kGroups>
static __global__ void __launch_bounds__(
    kGroups == 1 ? 1024 : kGroupedThreads, kGroups == 1 ? 1 : kGroupedBlocks)
    qspa_stream_kernel(
    float* chan, float* __restrict__ C, int* __restrict__ hard,
    int* __restrict__ t_io, int* __restrict__ done_io,
    int* __restrict__ okf_io, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edge,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp,
    const int* __restrict__ wave_ptr, const int* __restrict__ wave_row,
    int nwaves, int groups, int N, int M, int E, int max_dc, int k,
    int max_iters) {
  constexpr int Q = 32 * R;
  extern __shared__ float smem[];
  const RowGroup<kGroups> grp = row_group<kGroups>(groups);
  float* T = smem;
  float* S = T + N * Q + (grp.id ? grp.id - 1 : 0) * max_dc * Q;
  int* lg = reinterpret_cast<int*>(T + N * Q + groups * max_dc * Q);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int64_t b = blockIdx.x;
  float* L = chan + b * N * Q;
  float* Cb = C + b * E * Q;
  int t = t_io[b], done = done_io[b], okf = okf_io[b];
  ROWS_PHASE_CLOCK(pc)

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  if (kLayered)
    for (int i = tid; i < N * Q; i += nth) T[i] = L[i];
  __syncthreads();
  pc.stamp(kRpSetup);

  const bool ran = !done && k > 0;
  for (int pass = 0; ran && pass < k; ++pass) {
    if (!kLayered) {
      frame_totals<Q>(T, L, Cb, col_ptr, col_edge, N);
      __syncthreads();
      pc.stamp(kRpTotals);
    }
    const int bad = frame_decide_check<R>(T, hs, lg, ex, row_ptr, edge_vn,
                                          edge_h, N, M);
    pc.stamp(kRpDecide);
    if (!bad || t >= max_iters) {
      okf = !bad;
      done = 1;
      break;
    }
    t += 1;
    walk_waves(groups, wave_ptr, wave_row, nwaves, pc, [&](int m) {
      cn_row<R, kLayered, kGroups>(grp, pc, T, S, Cb, lg, ex, row_ptr[m],
                                   row_ptr[m + 1] - row_ptr[m], edge_vn,
                                   edge_h);
    });
  }
  for (int n = tid; n < N; n += nth) hard[b * N + n] = ran ? hs[n] : 0;
  if (kLayered)
    for (int i = tid; i < N * Q; i += nth) L[i] = T[i];
  if (done)
    for (int64_t i = tid; i < (int64_t)E * Q; i += nth) Cb[i] = 0.f;
  if (tid == 0) {
    t_io[b] = t;
    done_io[b] = done;
    okf_io[b] = okf;
  }
  pc.stamp(kRpExit);
  ROWS_PHASE_FLUSH(pc, g_qspa_stream_clk[kLayered])
}

// The kernel for R, the schedule and the number of groups: the serial
// instantiation (no named barrier) for one group, else kMaxGroups'.
template <int R>
static auto kernel_for(bool layered, int groups) {
  const bool one = groups == 1;
  return layered ? (one ? qspa_stream_kernel<R, true, 1>
                        : qspa_stream_kernel<R, true, kMaxGroups>)
                 : (one ? qspa_stream_kernel<R, false, 1>
                        : qspa_stream_kernel<R, false, kMaxGroups>);
}

template <int R>
static cudaError_t launch(float* chan, float* C, int* hard, int* t, int* done,
                          int* okf, const int* row_ptr, const int* edge_vn,
                          const int* edge_h, const int* col_ptr,
                          const int* col_edge, const int* gf_log,
                          const int* gf_exp, const int* wave_ptr,
                          const int* wave_row, int nwaves, int groups, int B,
                          int N, int M, int E, int max_dc, int k,
                          int max_iters, bool layered, cudaStream_t st) {
  auto kernel = kernel_for<R>(layered, groups);
  const size_t smem = smem_bytes(N, 32 * R, max_dc, groups);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, 32 * max_dc * groups, smem, st>>>(
      chan, C, hard, t, done, okf, row_ptr, edge_vn, edge_h, col_ptr,
      col_edge, gf_log, gf_exp, wave_ptr, wave_row, nwaves, groups, N, M, E,
      max_dc, k, max_iters);
  return cudaGetLastError();
}

// Blocks an SM holds of the kernel for R, the schedule and the groups.
template <int R>
static int blocks_per_sm(bool layered, int groups, int N, int max_dc) {
  auto kernel = kernel_for<R>(layered, groups);
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

extern "C" {

// Runs up to `k` passes of the stream step on the slots of chan [B, N, q]
// (q in 32, 64, 128, 256; 1 <= max_dc <= 32 edges per row) on `stream` of
// CUDA device `device`: flooding, or serial-row layered when `layered`, in
// which case chan carries the running totals; on `groups` row groups (1 to
// 7; one group at most 1024 threads, more at most 512) walking the wave
// plan wave_ptr [nwaves + 1], wave_row [M] (ops/cuda_qspa.row_waves).
// chan (layered), C [B, E, q], t, done and okf [B] are updated in place;
// hard [B, N] is written.  The tables are K5's (ldpc_qspa).  Returns 0 or
// the CUDA error of the launch.
int ldpc_qspa_stream(float* chan, float* C, int* hard, int* t, int* done,
                     int* okf, const int* row_ptr, const int* edge_vn,
                     const int* edge_h, const int* col_ptr,
                     const int* col_edge, const int* gf_log,
                     const int* gf_exp, const int* wave_ptr,
                     const int* wave_row, int nwaves, int groups, int B,
                     int N, int M, int E, int q, int max_dc, int k,
                     int max_iters, int layered, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (max_dc < 1 || max_dc > 32 || groups < 1 || groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads))
    return cudaErrorInvalidValue;
#define QSPA_STREAM_LAUNCH(R)                                             \
  return launch<R>(chan, C, hard, t, done, okf, row_ptr, edge_vn, edge_h, \
                   col_ptr, col_edge, gf_log, gf_exp, wave_ptr, wave_row, \
                   nwaves, groups, B, N, M, E, max_dc, k, max_iters,      \
                   layered != 0, st)
  switch (q) {
    case 32: QSPA_STREAM_LAUNCH(1);
    case 64: QSPA_STREAM_LAUNCH(2);
    case 128: QSPA_STREAM_LAUNCH(4);
    case 256: QSPA_STREAM_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef QSPA_STREAM_LAUNCH
}

// Blocks of the kernel an SM of CUDA device `device` holds for q, the
// schedule, the groups, N and max_dc (as ldpc_qspa_stream takes them); -1
// on a bad argument or a CUDA error.
int ldpc_qspa_stream_blocks_per_sm(int q, int layered, int groups, int N,
                                   int max_dc, int device) {
  if (cudaSetDevice(device) || max_dc < 1 || max_dc > 32 || groups < 1 ||
      groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads))
    return -1;
  switch (q) {
    case 32: return blocks_per_sm<1>(layered != 0, groups, N, max_dc);
    case 64: return blocks_per_sm<2>(layered != 0, groups, N, max_dc);
    case 128: return blocks_per_sm<4>(layered != 0, groups, N, max_dc);
    case 256: return blocks_per_sm<8>(layered != 0, groups, N, max_dc);
    default: return -1;
  }
}

#ifdef NB_ROWS_PHASES
// Copies the phase counters [2][kRpCount] (flooding, layered) into out and
// zeroes them.
int ldpc_qspa_stream_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_qspa_stream_clk,
                                         sizeof(g_qspa_stream_clk));
  if (err) return err;
  unsigned long long zero[2][kRpCount] = {};
  return cudaMemcpyToSymbol(g_qspa_stream_clk, zero, sizeof(zero));
}
#endif

}  // extern "C"
