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
// It is K5 (qspa.cu) with its state carried across calls: one block per
// slot, the same phases from qspa_common.cuh (frame_totals,
// frame_decide_check, frame_cn_rows), hence the same arithmetic order.
// The differences: C [B, E, q] is read from the previous call instead of
// zeroed; layered seeds T from `chan`, which carries the running totals, and
// writes them back; the slot's count t, finished flag and check flag come in
// and go out.  A finished slot's block stops looping, which is the per-slot
// freeze.  The TPU's lane padding, discrete-log lane order and one-hot hard
// are not needed here: hard is [B, N] int32 symbols.

#include "qspa_common.cuh"

using namespace qspa;

// Dynamic shared memory of one block, as K5's: T [N*Q] f32, the row's
// spectra S [max_dc*Q] f32, lg [Q] and ex [2(Q-1)] int, the decisions [N].
static size_t smem_bytes(int N, int q, int max_dc) {
  return sizeof(float) * ((size_t)N * q + (size_t)max_dc * q) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + N);
}

template <int R, bool kLayered>
static __global__ void __launch_bounds__(1024) qspa_stream_kernel(
    float* chan, float* __restrict__ C, int* __restrict__ hard,
    int* __restrict__ t_io, int* __restrict__ done_io,
    int* __restrict__ okf_io, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edge,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp, int N,
    int M, int E, int max_dc, int k, int max_iters) {
  constexpr int Q = 32 * R;
  extern __shared__ float smem[];
  float* T = smem;
  float* S = T + N * Q;
  int* lg = reinterpret_cast<int*>(S + max_dc * Q);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int64_t b = blockIdx.x;
  float* L = chan + b * N * Q;
  float* Cb = C + b * E * Q;
  int t = t_io[b], done = done_io[b], okf = okf_io[b];

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  if (kLayered)
    for (int i = tid; i < N * Q; i += nth) T[i] = L[i];
  __syncthreads();

  const bool ran = !done && k > 0;
  for (int pass = 0; ran && pass < k; ++pass) {
    if (!kLayered) {
      frame_totals<Q>(T, L, Cb, col_ptr, col_edge, N);
      __syncthreads();
    }
    const int bad = frame_decide_check<R>(T, hs, lg, ex, row_ptr, edge_vn,
                                          edge_h, N, M);
    if (!bad || t >= max_iters) {
      okf = !bad;
      done = 1;
      break;
    }
    t += 1;
    frame_cn_rows<R, kLayered>(T, S, Cb, lg, ex, row_ptr, edge_vn, edge_h, M);
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
}

template <int R, bool kLayered>
static cudaError_t launch(float* chan, float* C, int* hard, int* t, int* done,
                          int* okf, const int* row_ptr, const int* edge_vn,
                          const int* edge_h, const int* col_ptr,
                          const int* col_edge, const int* gf_log,
                          const int* gf_exp, int B, int N, int M, int E,
                          int max_dc, int k, int max_iters, cudaStream_t st) {
  auto kernel = qspa_stream_kernel<R, kLayered>;
  const size_t smem = smem_bytes(N, 32 * R, max_dc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, 32 * max_dc, smem, st>>>(chan, C, hard, t, done, okf, row_ptr,
                                       edge_vn, edge_h, col_ptr, col_edge,
                                       gf_log, gf_exp, N, M, E, max_dc, k,
                                       max_iters);
  return cudaGetLastError();
}

extern "C" {

// Runs up to `k` passes of the stream step on the slots of chan [B, N, q]
// (q in 32, 64, 128, 256; 1 <= max_dc <= 32 edges per row) on `stream` of
// CUDA device `device`: flooding, or serial-row layered when `layered`, in
// which case chan carries the running totals.  chan (layered), C [B, E, q],
// t, done and okf [B] are updated in place; hard [B, N] is written.  The
// tables are K5's (ldpc_qspa).  Returns 0 or the CUDA error of the launch.
int ldpc_qspa_stream(float* chan, float* C, int* hard, int* t, int* done,
                     int* okf, const int* row_ptr, const int* edge_vn,
                     const int* edge_h, const int* col_ptr,
                     const int* col_edge, const int* gf_log,
                     const int* gf_exp, int B, int N, int M, int E, int q,
                     int max_dc, int k, int max_iters, int layered,
                     int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (max_dc < 1 || max_dc > 32) return cudaErrorInvalidValue;
#define QSPA_STREAM_LAUNCH(R)                                             \
  return (layered ? launch<R, true> : launch<R, false>)(                  \
      chan, C, hard, t, done, okf, row_ptr, edge_vn, edge_h, col_ptr,     \
      col_edge, gf_log, gf_exp, B, N, M, E, max_dc, k, max_iters, st)
  switch (q) {
    case 32: QSPA_STREAM_LAUNCH(1);
    case 64: QSPA_STREAM_LAUNCH(2);
    case 128: QSPA_STREAM_LAUNCH(4);
    case 256: QSPA_STREAM_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef QSPA_STREAM_LAUNCH
}

}  // extern "C"
