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
// the permutation is free: lane y of an edge reads the VN-domain message at
// symbol y / h from shared memory (a GF division through log/antilog tables)
// and writes its output back to the same address.  The transform is log2(q)
// butterflies: shuffles for strides below 32, register pairs above.
//
// One block decodes one frame, all passes in one launch, and stops when its
// frame passes, so per-frame freezing costs nothing and `iters` is per
// frame.  The totals T [N, q] of the frame live in shared memory; the c2v
// messages C [E, q] live in device memory, in the caller's buffer [B, E, q]:
// with them LDPC_N576_K480_GF256_exp's state is 221,184 B a frame, which
// leaves no room for the row's spectra under the 227 KB a block may use, and
// each message is read and written only once or twice per pass.  A check
// row is updated by one warp per edge: each warp computes its edge's
// spectrum (v2c, softmax, transform) into shared memory, then, after a
// barrier, its exclusive product over the row's other spectra in the JAX
// order, the inverse transform and the log.  Rows run in series with two
// barriers each (layered needs the order; flooding only the scratch).  The
// phases of a pass (totals, decide and check, the rows) live in
// qspa_common.cuh, shared with the stream step K7 (qspa_stream.cu).
//
// Bound: on BDS.576.288.GF.64 at B=4096 the c2v messages (201 MB) cross
// device memory two or three times per pass (0.18 ms at 3.35 TB/s), while
// the CN update costs about 40 fp32 operations per edge and symbol plus an
// expf and a logf, 2 GFLOP per pass, so the shuffle and barrier latency of
// the serial rows is what bounds it in practice.

#include "qspa_common.cuh"

using namespace qspa;

// Dynamic shared memory of one block: T [N*Q] f32, the row's spectra
// S [max_dc*Q] f32, lg [Q] and ex [2(Q-1)] int, the decisions [N] int.
static size_t smem_bytes(int N, int q, int max_dc) {
  return sizeof(float) * ((size_t)N * q + (size_t)max_dc * q) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + N);
}

template <int R, bool kLayered>
static __global__ void __launch_bounds__(1024) qspa_kernel(
    const float* __restrict__ chan, float* __restrict__ C,
    int* __restrict__ hard, unsigned char* __restrict__ ok,
    int* __restrict__ iters, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edge,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp, int N,
    int M, int E, int max_dc, int num_iters) {
  constexpr int Q = 32 * R;
  extern __shared__ float smem[];
  float* T = smem;
  float* S = T + N * Q;
  int* lg = reinterpret_cast<int*>(S + max_dc * Q);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int64_t b = blockIdx.x;
  const float* L = chan + b * N * Q;
  float* Cb = C + b * E * Q;

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  for (int64_t i = tid; i < (int64_t)E * Q; i += nth) Cb[i] = 0.f;
  if (kLayered)
    for (int i = tid; i < N * Q; i += nth) T[i] = L[i];
  __syncthreads();

  for (int t = 0;; ++t) {
    if (!kLayered) {
      frame_totals<Q>(T, L, Cb, col_ptr, col_edge, N);
      __syncthreads();
    }
    const int bad = frame_decide_check<R>(T, hs, lg, ex, row_ptr, edge_vn,
                                          edge_h, N, M);
    if (!bad || t + 1 >= num_iters) {
      for (int n = tid; n < N; n += nth) hard[b * N + n] = hs[n];
      if (tid == 0) {
        ok[b] = bad ? 0 : 1;
        iters[b] = bad ? num_iters : t;
      }
      return;
    }
    frame_cn_rows<R, kLayered>(T, S, Cb, lg, ex, row_ptr, edge_vn, edge_h, M);
  }
}

template <int R, bool kLayered>
static cudaError_t launch(const float* chan, float* C, int* hard,
                          unsigned char* ok, int* iters, const int* row_ptr,
                          const int* edge_vn, const int* edge_h,
                          const int* col_ptr, const int* col_edge,
                          const int* gf_log, const int* gf_exp, int B, int N,
                          int M, int E, int max_dc, int num_iters,
                          cudaStream_t st) {
  auto kernel = qspa_kernel<R, kLayered>;
  const size_t smem = smem_bytes(N, 32 * R, max_dc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, 32 * max_dc, smem, st>>>(chan, C, hard, ok, iters, row_ptr,
                                       edge_vn, edge_h, col_ptr, col_edge,
                                       gf_log, gf_exp, N, M, E, max_dc,
                                       num_iters);
  return cudaGetLastError();
}

extern "C" {

// Decodes the batch chan [B, N, q] (q in 32, 64, 128, 256; 1 <= max_dc <=
// 32 edges per row) for at most `num_iters` >= 1 passes on `stream` of CUDA
// device `device`: flooding, or serial-row layered when `layered`.  C
// [B, E, q] is the caller's scratch; hard [B, N], ok [B] and iters [B] the
// outputs.  Edge e of row m is row_ptr[m] + slot, at VN edge_vn[e] with
// coefficient edge_h[e]; col_edge lists each VN's edges in its slot order.
// gf_log [q] and gf_exp [2(q-1)] are the field's tables.  Returns 0 or the
// first CUDA error met while enqueueing.
int ldpc_qspa(const float* chan, float* C, int* hard, unsigned char* ok,
              int* iters, const int* row_ptr, const int* edge_vn,
              const int* edge_h, const int* col_ptr, const int* col_edge,
              const int* gf_log, const int* gf_exp, int B, int N, int M,
              int E, int q, int max_dc, int num_iters, int layered,
              int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (max_dc < 1 || max_dc > 32) return cudaErrorInvalidValue;
#define QSPA_LAUNCH(R)                                                      \
  return (layered ? launch<R, true> : launch<R, false>)(                  \
      chan, C, hard, ok, iters, row_ptr, edge_vn, edge_h, col_ptr,          \
      col_edge, gf_log, gf_exp, B, N, M, E, max_dc, num_iters, st)
  switch (q) {
    case 32: QSPA_LAUNCH(1);
    case 64: QSPA_LAUNCH(2);
    case 128: QSPA_LAUNCH(4);
    case 256: QSPA_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef QSPA_LAUNCH
}

}  // extern "C"
