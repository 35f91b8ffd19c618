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
// The state of one frame, T [N, q] (606,208 B) and C [E, q] (1,515,520 B),
// cannot sit in shared memory, so both live in device memory (the caller's
// buffers [B, N, q] and [B, E, q], edge e = block edge * Z + z) and L2.  One
// block decodes one frame, all passes in one launch.  A group of q lanes
// takes a check row, one lane per symbol: it walks the row's block edges in
// order, keeping each edge's spectrum, and then the backward products, in
// its own columns of shared memory, so the exclusive products need no
// exchange between threads.  Flooding updates every check row of a pass in
// any order; layered runs the block rows in order behind a barrier, the Z
// check rows of one block row at once (they share no VN).
//
// Bound: at B=256 the messages (388 MB) and totals (155 MB) cross device
// memory several times per pass (about 1.3 GB, 0.4 ms at 3.35 TB/s) against
// about 35 fp32 operations per edge and symbol (3.4 GFLOP per pass), so
// device-memory bytes and the latency of the serial edge walk bound it.

#include "qspa_common.cuh"

using namespace qspa;

constexpr int kThreads = 512;

// Dynamic shared memory of one block: the spectra F and backward products
// Bw, [max_dc][kThreads] f32 each, then lg [Q] and ex [2(Q-1)] int.
static size_t smem_bytes(int q, int max_dc) {
  return sizeof(float) * 2 * (size_t)max_dc * kThreads +
         sizeof(int) * ((size_t)q + 2 * (q - 1));
}

template <int Q, bool kLayered>
static __global__ void __launch_bounds__(kThreads) qspa_qc_kernel(
    const float* __restrict__ chan, float* __restrict__ T,
    float* __restrict__ C, int* __restrict__ hard,
    unsigned char* __restrict__ ok, int* __restrict__ iters,
    const int* __restrict__ blk_ptr, const int* __restrict__ blk_c,
    const int* __restrict__ blk_s, const int* __restrict__ hz,
    const int* __restrict__ col_ptr, const int* __restrict__ col_eid,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp, int NB,
    int MB, int Z, int EB, int max_dc, int num_iters) {
  extern __shared__ float smem[];
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
      __syncthreads();
    }
    // decide: one group of Q lanes per VN
    for (int n0 = 0; n0 < N; n0 += G) {
      const int n = n0 + g;
      float x[1] = {n < N ? Tb[(int64_t)n * Q + u] : 0.f};
      const int arg = group_argmax<1, Q>(x, u);
      if (n < N && u == 0) hb[n] = arg;
    }
    __syncthreads();
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
    if (!bad || t + 1 >= num_iters) {
      if (tid == 0) {
        ok[b] = bad ? 0 : 1;
        iters[b] = bad ? num_iters : t;
      }
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
          group_softmax<1, Q>(x);
          group_wht<1, Q>(x, u);
          Fs[d * nth + tid] = x[0];
        }
        // exclusive products in nb_decode._qspa_cn_core's order: backward
        // from the last edge, forward from edge 0, each starting at 1
        float bw = 1.f;
        for (int d = dc - 1; d >= 0; --d) {
          Bs[d * nth + tid] = bw;
          bw = __fmul_rn(bw, Fs[d * nth + tid]);
        }
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
      }
      if (kLayered) __syncthreads();  // the next block row reads the totals
    }
    __syncthreads();                  // the next pass reads the messages
  }
}

template <int Q, bool kLayered>
static cudaError_t launch(const float* chan, float* T, float* C, int* hard,
                          unsigned char* ok, int* iters, const int* blk_ptr,
                          const int* blk_c, const int* blk_s, const int* hz,
                          const int* col_ptr, const int* col_eid,
                          const int* gf_log, const int* gf_exp, int B, int NB,
                          int MB, int Z, int EB, int max_dc, int num_iters,
                          cudaStream_t st) {
  auto kernel = qspa_qc_kernel<Q, kLayered>;
  const size_t smem = smem_bytes(Q, max_dc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<B, kThreads, smem, st>>>(chan, T, C, hard, ok, iters, blk_ptr,
                                    blk_c, blk_s, hz, col_ptr, col_eid,
                                    gf_log, gf_exp, NB, MB, Z, EB, max_dc,
                                    num_iters);
  return cudaGetLastError();
}

extern "C" {

// Decodes the batch chan [B, NB*Z, q] (q in 4, 8, 16, 32) of a QC code for
// at most `num_iters` >= 1 passes on `stream` of CUDA device `device`:
// flooding, or block-row layered when `layered`.  T [B, N, q] and
// C [B, EB*Z, q] are the caller's scratch; hard [B, N], ok [B] and
// iters [B] the outputs.  Block edge eid (block rows' edges contiguous,
// blk_ptr [MB+1]) joins check row r*Z + z to VN blk_c[eid]*Z + (z +
// blk_s[eid]) % Z with coefficient hz[eid*Z + z]; col_eid lists each block
// column's block edges in block-row order (col_ptr [NB+1]).  Returns 0 or
// the first CUDA error met while enqueueing.
int ldpc_qspa_qc(const float* chan, float* T, float* C, int* hard,
                 unsigned char* ok, int* iters, const int* blk_ptr,
                 const int* blk_c, const int* blk_s, const int* hz,
                 const int* col_ptr, const int* col_eid, const int* gf_log,
                 const int* gf_exp, int B, int NB, int MB, int Z, int EB,
                 int q, int max_dc, int num_iters, int layered, int device,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (max_dc < 1) return cudaErrorInvalidValue;
#define QSPA_QC_LAUNCH(Q)                                                   \
  return (layered ? launch<Q, true> : launch<Q, false>)(                  \
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

}  // extern "C"
