// Row-layered decoder for binary QC-LDPC codes, min-sum or exact
// sum-product, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_minsum.py
// `_layered_kernel` (:299), both of its rules ('bp' is
// `_cn_phase(rule='bp')`, :165-180 and 210-212).  It computes what
// ops/minsum.py's plain PyTorch `decode_layered` computes: bit for bit for
// min-sum, the same operations with logf/tanhf for bp.  The total is updated
// as T + (R_new - R_old), the order of the JAX package's jnp function
// (minsum.py:340); the TPU kernel's (T + R_new) - R_old rounds differently.
// Early stop is batch-global, as in minsum_flooding.cu: hard and ok come
// from the totals after the iteration at which the whole batch stops.
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
// bp, and min-sum in the earlier global-memory design
// (`ldpc_minsum_layered_global`, kept only as the yardstick): T [B, L, Z]
// f32 starts as chan and holds the running totals, R [B, E, Z] f32 the c2v
// messages.  Dependencies run only from one block row to the next, within
// one frame.  Within a block row every (l, z) of T is written by exactly
// one lane r (each block column appears at most once per row, and
// z = (r + s) % Z is a bijection), so one block takes one frame, its
// threads run over r, and the J block rows follow one another with a
// __syncthreads() between them.  Blocks walk the frames in a grid-stride
// loop.  Per iteration, three launches on the caller's stream: `layered`
// (all J block rows of every frame), then common.cuh's `check` and `finish`:
// a device-side stop flag.  Each iteration reads and writes R (589 KB a
// J15_L30_Z1280 frame, in device memory) once and T once per edge.  bp adds
// two logf and two tanhf per edge and keeps phi_e, T_old and R_old in
// registers between its two passes; its time is held by each row's round
// trips to device memory more than by phi.

#include "onchip.cuh"

using namespace ldpc;

template <int kRule, int kDeg>
static __global__ void layered_kernel(float* T, float* R,
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
    float* tb = T + b * L * Z;
    float* rb = R + b * E * Z;
    for (int j = 0; j < J; ++j) {
      for (int r = threadIdx.x; r < Z; r += blockDim.x)
        check_node<kRule, true, kDeg>(tb, rb, edge_l, edge_s, row_edge,
                                      row_ptr[j], row_ptr[j + 1], r, Z,
                                      alpha, use_alpha, beta, use_beta);
      __syncthreads();  // the next block row reads these totals
    }
  }
}

extern "C" {

// Decodes `num_iters` >= 1 layered iterations of the batch `chan` with
// `rule` (0 min-sum, 1 bp; `max_dc` is the code's largest row degree) in the
// global-memory design on `stream` of CUDA device `device`.  T, R, hard, ok
// and ctl (3 ints) are the caller's buffers; ctl ends holding the iteration
// count in ctl[0].  Returns 0 or the first CUDA error met while enqueueing.
int ldpc_minsum_layered_global(
    const float* chan, float* T, float* R, signed char* hard,
    unsigned char* ok, int* ctl, const int* edge_l, const int* edge_s,
    const int* row_ptr, const int* row_edge, int B, int L, int J, int E,
    int Z, int num_iters, float alpha, int use_alpha, float beta,
    int use_beta, int check, int early_stop, int rule, int max_dc,
    int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if ((err = cudaMemsetAsync(ctl, 0, 3 * sizeof(int), st))) return err;
  if ((err = cudaMemsetAsync(R, 0, (size_t)B * E * Z * sizeof(float), st)))
    return err;
  if ((err = cudaMemsetAsync(ok, 0, (size_t)B, st))) return err;
  if ((err = cudaMemcpyAsync(T, chan, (size_t)B * L * Z * sizeof(float),
                             cudaMemcpyDeviceToDevice, st)))
    return err;

  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return err;
  const int threads = Z >= 256 ? 256 : ((Z + 31) / 32) * 32;
  const int grid = (int)min64(B, (int64_t)sms * 16);
  const int stop_when_ok = early_stop && check != kCheckNone;
  auto layered = layered_kernel<kRuleMinsum, 0>;
  if (rule == kRuleBP) {
    const int deg = bp_degree_bucket(max_dc);
    layered = deg == kBpDegSmall ? layered_kernel<kRuleBP, kBpDegSmall>
              : deg == kBpDegMid ? layered_kernel<kRuleBP, kBpDegMid>
                                 : layered_kernel<kRuleBP, kMaxRowDegree>;
  }

  for (int it = 0; it < num_iters; ++it) {
    layered<<<grid, threads, 0, st>>>(T, R, edge_l, edge_s, row_ptr, row_edge,
                                      ctl, B, L, J, E, Z, alpha, use_alpha,
                                      beta, use_beta);
    if (check != kCheckNone)
      check_kernel<<<grid, 256, 0, st>>>(T, ok, edge_l, edge_s, row_ptr,
                                         row_edge, ctl, check, B, L, J, Z);
    finish_kernel<<<1, 1, 0, st>>>(ctl, stop_when_ok);
    if ((err = cudaGetLastError())) return err;
  }
  const int64_t n = (int64_t)B * L * Z;
  const int hard_grid = (int)min64((n + 255) / 256, (int64_t)sms * 32);
  hard_kernel<<<hard_grid, 256, 0, st>>>(T, hard, n);
  return cudaGetLastError();
}

// Decodes the batch `chan` with layered min-sum, each frame's state on
// chip: onchip.cuh's `onchip_batch` (arguments there; tsave [B, L, Z] f32
// holds the saved totals).
int ldpc_minsum_layered(
    const float* chan, float* tsave, signed char* hard, unsigned char* ok,
    int* kb, float* sv, void* sm, int* ctl, const int* edge_l,
    const int* edge_s, const int* row_ptr, const int* row_edge,
    const int* col_ptr, const int* col_edge, const int* edge_row,
    const int* edge_pos, const int* plan, int B, int L, int J, int E, int Z,
    int num_iters, float alpha, int use_alpha, float beta, int use_beta,
    int check, int early_stop, int cluster, int smem_bytes, int wide,
    int threads, int device, void* stream) {
  return onchip_batch<true>(
      chan, tsave, hard, ok, kb, sv, sm, ctl, edge_l, edge_s, row_ptr,
      row_edge, col_ptr, col_edge, edge_row, edge_pos, plan, B, L, J, E, Z,
      num_iters, alpha, use_alpha, beta, use_beta, check, early_stop, cluster,
      smem_bytes, wide, threads, device, stream);
}

}  // extern "C"
