// Row-layered decoder for binary QC-LDPC codes, min-sum or exact
// sum-product, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_minsum.py
// `_layered_kernel` (:299), both of its rules ('bp' is
// `_cn_phase(rule='bp')`, :165-180 and 210-212) and both of its storage
// types (float32, and bfloat16 T and R with float32 compute,
// `_kernel_dtype`, :344-352).  It computes what ops/minsum.py's plain
// PyTorch `decode_layered` computes: bit for bit for min-sum, the same
// operations with logf/tanhf for bp.  In float32 the total is updated as
// T + (R_new - R_old), the order of the JAX package's jnp function
// (minsum.py:340); in bfloat16 as bf16((T + R_new) - R_old), the TPU
// kernel's order (:226-227), as the plain version does.  Early stop is
// batch-global, as in minsum_flooding.cu: hard and ok come from the totals
// after the iteration at which the whole batch stops.
//
// Min-sum (`ldpc_minsum_layered`): each frame's T [L, Z] and its R,
// compressed per check node, stay in shared memory for all its iterations
// (onchip.cuh's `onchip_batch_kernel`, shared with K1; a cluster of two
// blocks for J15_L30_Z1280, each block row's lanes spread over the cluster
// with a barrier after each row).  Entry reads chan into T (R starts at
// zero), exit writes hard; with early stop each frame saves its compressed
// state and its totals where it stops, for onchip.cuh's exact batch-wide
// stop protocol.  Bound: chan in and hard out; what holds the kernel is
// each message's instructions in the rows and, on a cluster, the barrier
// after each of the J rows (as K4's layered step).
//
// bp (`ldpc_bp_layered`): T [B, L, Z] of the storage type S starts as
// S(chan) and holds the running totals, R [B, E, Z] (S) the c2v messages,
// both in device memory.  Dependencies run only from one block row to the
// next, within one frame.  Within a block row every (l, z) of T is written
// by exactly one lane r (each block column appears at most once per row,
// and z = (r + s) % Z is a bijection), so one block takes one frame, its
// threads run over r, and the J block rows follow one another with a
// __syncthreads() between them.  Blocks walk the frames in a grid-stride
// loop.  Per iteration, three launches on the caller's stream: `layered`
// (all J block rows of every frame), then common.cuh's `check` and `finish`:
// a device-side stop flag.  Each iteration reads and writes R (589 KB a
// J15_L30_Z1280 frame in float32, 294 KB in bfloat16) once and T once per
// edge.  bp adds two logf and two tanhf per edge and keeps phi_e, T_old and
// R_old in registers between its two passes; its time is held by each
// row's round trips to device memory more than by phi.

#include "onchip.cuh"

using namespace ldpc;

template <int kDeg, typename S>
static __global__ void layered_kernel(S* T, S* R,
                                      const int* __restrict__ edge_l,
                                      const int* __restrict__ edge_s,
                                      const int* __restrict__ row_ptr,
                                      const int* __restrict__ row_edge,
                                      int* ctl, int B, int L, int J, int E,
                                      int Z, float alpha, int use_alpha,
                                      float beta, int use_beta) {
  if (ctl[kStop]) return;
  // No other thread touches the count until the check launch that follows.
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[kNotOk] = 0;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    S* tb = T + b * L * Z;
    S* rb = R + b * E * Z;
    for (int j = 0; j < J; ++j) {
      for (int r = threadIdx.x; r < Z; r += blockDim.x)
        check_node_bp<true, kDeg, S>(tb, rb, edge_l, edge_s, row_edge,
                                     row_ptr[j], row_ptr[j + 1], r, Z, alpha,
                                     use_alpha, beta, use_beta);
      __syncthreads();  // the next block row reads these totals
    }
  }
}

// T = S(chan), the layered start.
template <typename S>
static __global__ void start_kernel(const float* __restrict__ chan,
                                    S* __restrict__ T, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    T[i] = to_store<S>(chan[i]);
}

// The bp layered decode with T and R stored as S (the entry below).
template <typename S>
static int bp_layered(const float* chan, S* T, S* R, signed char* hard,
                      unsigned char* ok, int* ctl, const int* edge_l,
                      const int* edge_s, const int* row_ptr,
                      const int* row_edge, int B, int L, int J, int E, int Z,
                      int num_iters, float alpha, int use_alpha, float beta,
                      int use_beta, int check, int early_stop, int max_dc,
                      int device, cudaStream_t st) {
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if ((err = cudaMemsetAsync(ctl, 0, 3 * sizeof(int), st))) return err;
  if ((err = cudaMemsetAsync(R, 0, (size_t)B * E * Z * sizeof(S), st)))
    return err;
  if ((err = cudaMemsetAsync(ok, 0, (size_t)B, st))) return err;

  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return err;
  const int64_t n = (int64_t)B * L * Z;
  const int flat_grid = (int)min64((n + 255) / 256, (int64_t)sms * 32);
  start_kernel<S><<<flat_grid, 256, 0, st>>>(chan, T, n);
  const int threads = Z >= 256 ? 256 : ((Z + 31) / 32) * 32;
  const int grid = (int)min64(B, (int64_t)sms * 16);
  const int stop_when_ok = early_stop && check != kCheckNone;
  const int deg = bp_degree_bucket(max_dc);
  auto layered = deg == kBpDegSmall ? layered_kernel<kBpDegSmall, S>
                 : deg == kBpDegMid ? layered_kernel<kBpDegMid, S>
                                    : layered_kernel<kMaxRowDegree, S>;

  for (int it = 0; it < num_iters; ++it) {
    layered<<<grid, threads, 0, st>>>(T, R, edge_l, edge_s, row_ptr, row_edge,
                                      ctl, B, L, J, E, Z, alpha, use_alpha,
                                      beta, use_beta);
    if (check != kCheckNone)
      check_kernel<S><<<grid, 256, 0, st>>>(T, ok, edge_l, edge_s, row_ptr,
                                            row_edge, ctl, check, B, L, J, Z);
    finish_kernel<<<1, 1, 0, st>>>(ctl, stop_when_ok);
    if ((err = cudaGetLastError())) return err;
  }
  hard_kernel<S><<<flat_grid, 256, 0, st>>>(T, hard, n);
  return cudaGetLastError();
}

extern "C" {

// Decodes `num_iters` >= 1 layered iterations of the batch `chan` with the
// bp rule (`max_dc` is the code's largest row degree), T and R stored as
// bfloat16 when `bf16` (else float32), on `stream` of CUDA device `device`.
// T, R (of the storage type), hard, ok and ctl (3 ints) are the caller's
// buffers; ctl ends holding the iteration count in ctl[0].  Returns 0 or
// the first CUDA error met while enqueueing.
int ldpc_bp_layered(const float* chan, void* T, void* R, signed char* hard,
                    unsigned char* ok, int* ctl, const int* edge_l,
                    const int* edge_s, const int* row_ptr,
                    const int* row_edge, int B, int L, int J, int E, int Z,
                    int num_iters, float alpha, int use_alpha, float beta,
                    int use_beta, int check, int early_stop, int max_dc,
                    int bf16, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return bp_layered(chan, static_cast<__nv_bfloat16*>(T),
                      static_cast<__nv_bfloat16*>(R), hard, ok, ctl, edge_l,
                      edge_s, row_ptr, row_edge, B, L, J, E, Z, num_iters,
                      alpha, use_alpha, beta, use_beta, check, early_stop,
                      max_dc, device, st);
  return bp_layered(chan, static_cast<float*>(T), static_cast<float*>(R),
                    hard, ok, ctl, edge_l, edge_s, row_ptr, row_edge, B, L, J,
                    E, Z, num_iters, alpha, use_alpha, beta, use_beta, check,
                    early_stop, max_dc, device, st);
}

// Decodes the batch `chan` with layered min-sum, each frame's state on
// chip: onchip.cuh's `onchip_batch` (arguments there; tsave [B, L, Z] of
// the storage type holds the saved totals).
int ldpc_minsum_layered(
    const float* chan, void* tsave, signed char* hard, unsigned char* ok,
    int* kb, void* sv, void* sm, int* ctl, const int* edge_l,
    const int* edge_s, const int* row_ptr, const int* row_edge,
    const int* col_ptr, const int* col_edge, const int* edge_row,
    const int* edge_pos, const int* plan, int B, int L, int J, int E, int Z,
    int num_iters, float alpha, int use_alpha, float beta, int use_beta,
    int check, int early_stop, int cluster, int smem_bytes, int wide,
    int threads, int bf16, int device, void* stream) {
  return onchip_batch<true>(
      chan, tsave, hard, ok, kb, sv, sm, ctl, edge_l, edge_s, row_ptr,
      row_edge, col_ptr, col_edge, edge_row, edge_pos, plan, B, L, J, E, Z,
      num_iters, alpha, use_alpha, beta, use_beta, check, early_stop, cluster,
      smem_bytes, wide, threads, bf16, device, stream);
}

}  // extern "C"
