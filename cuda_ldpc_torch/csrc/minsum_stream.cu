// Stateful step of the binary continuous-batching (stream) engine, flooding
// or row-layered, min-sum or exact sum-product, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_minsum_stream.py
// `_stream_kernel` (:54, with `_body_accounting` :40).  It computes what
// ops/minsum_stream.py's plain `stream_step` computes, bit for bit for
// min-sum and with logf/tanhf for bp (common.cuh's check_node, as in K1-K3):
// up to k passes over persistent per-slot state, each pass
//   decide   flooding: T = chan + R[e0] + R[e1] + ... (col_edges order);
//            layered: T is the state itself
//   check    the slot's zero or syndrome check on T
//   account  a slot that was running finishes when its check passes or its
//            count t has reached max_iters (okf records the check); a slot
//            that goes on counts one more iteration
//   update   the check-node phase for a slot that goes on: flooding rewrites
//            R, layered rewrites R and T row by row as T + (R_new - R_old)
// then hard = T < 0 from the slot's last decide (flooding) or its totals
// (layered), and a slot that is finished leaves with its R zeroed, so that
// the engine refills only its channel.
//
// Design: one block per slot, all k passes in one launch (the layered
// decoder's shape, minsum_layered.cu).  A finished slot's block simply stops
// looping, which is the per-slot freeze: its R, T and t are untouched for
// the rest of the call.  Flooding puts a block barrier between the VN totals
// and the check-node phase and another before the next pass's totals; the
// check's __syncthreads_or makes the finish decision block-uniform.  K1's
// other design, batch-wide VN/CN launches with a per-slot mask and k rounds
// of launches per call, would read every slot's state k times whether it
// runs or not.
//
// Layout (the plain version's contract): chan [B, L, Z] f32 (flooding: the
// channel values; layered: the running totals, updated), T [B, L, Z] f32
// scratch (flooding only), R [B, E, Z] f32, hard [B, L, Z] int8, t / done /
// okf [B] int32.  Offsets are 64-bit.
//
// Bound: as for K1/K2, R's bytes (589 KB a slot on J15_L30_Z1280) cross
// device memory every pass; a slot's first pass reads its R from the last
// call, which is the only traffic the TPU kernel pays per call.

#include "common.cuh"

using namespace ldpc;

template <int kRule, bool kLayered>
static __global__ void stream_kernel(
    float* chan, float* T, float* R, signed char* __restrict__ hard,
    int* t_io, int* done_io, int* okf_io, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_ptr,
    const int* __restrict__ row_edge, const int* __restrict__ col_ptr,
    const int* __restrict__ col_edge, int B, int L, int J, int E, int Z,
    int k, int max_iters, float alpha, int use_alpha, float beta,
    int use_beta, int check) {
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    float* cb = chan + b * L * Z;
    float* tb = kLayered ? cb : T + b * L * Z;
    float* rb = R + b * E * Z;
    int t = t_io[b], done = done_io[b], okf = okf_io[b];
    for (int pass = 0; pass < k; ++pass) {
      if (!kLayered) {
        for (int i = threadIdx.x; i < L * Z; i += blockDim.x) {
          const int l = i / Z, z = i - l * Z;
          float v = cb[i];
          for (int c = col_ptr[l]; c < col_ptr[l + 1]; ++c)
            v = __fadd_rn(v, rb[(int64_t)col_edge[c] * Z + z]);
          tb[i] = v;
        }
        __syncthreads();  // the check and the CN read every column
      }
      const int bad =
          frame_bad(tb, edge_l, edge_s, row_ptr, row_edge, check, L, J, Z);
      if (!done && (!bad || t >= max_iters)) {
        okf = !bad;
        done = 1;
      }
      if (done) break;
      t += 1;
      for (int j = 0; j < J; ++j) {
        for (int r = threadIdx.x; r < Z; r += blockDim.x)
          check_node<kRule, kLayered>(tb, rb, edge_l, edge_s, row_edge,
                                      row_ptr[j], row_ptr[j + 1], r, Z, alpha,
                                      use_alpha, beta, use_beta);
        if (kLayered) __syncthreads();  // the next row reads these totals
      }
      if (!kLayered) __syncthreads();   // the next totals read R, write T
    }
    signed char* hb = hard + b * L * Z;
    for (int i = threadIdx.x; i < L * Z; i += blockDim.x)
      hb[i] = tb[i] < 0.f ? 1 : 0;
    if (done)
      for (int64_t i = threadIdx.x; i < (int64_t)E * Z; i += blockDim.x)
        rb[i] = 0.f;
    if (threadIdx.x == 0) {
      t_io[b] = t;
      done_io[b] = done;
      okf_io[b] = okf;
    }
  }
}

extern "C" {

// Runs up to `k` >= 1 passes of the stream step on the slots of chan
// [B, L, Z] with `rule` (0 min-sum, 1 bp), flooding or layered, on `stream`
// of CUDA device `device`.  chan (layered), R, t, done and okf are updated
// in place; hard is written; T is the caller's flooding scratch (unused when
// layered).  Returns 0 or the CUDA error of the launch.
int ldpc_minsum_stream(float* chan, float* T, float* R, signed char* hard,
                       int* t, int* done, int* okf, const int* edge_l,
                       const int* edge_s, const int* row_ptr,
                       const int* row_edge, const int* col_ptr,
                       const int* col_edge, int B, int L, int J, int E, int Z,
                       int k, int max_iters, float alpha, int use_alpha,
                       float beta, int use_beta, int check, int rule,
                       int layered, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return err;
  const int threads = Z >= 256 ? 256 : ((Z + 31) / 32) * 32;
  const int grid = (int)min64(B, (int64_t)sms * 16);
  auto kernel =
      rule == kRuleBP
          ? (layered ? stream_kernel<kRuleBP, true>
                     : stream_kernel<kRuleBP, false>)
          : (layered ? stream_kernel<kRuleMinsum, true>
                     : stream_kernel<kRuleMinsum, false>);
  kernel<<<grid, threads, 0, st>>>(chan, T, R, hard, t, done, okf, edge_l,
                                   edge_s, row_ptr, row_edge, col_ptr,
                                   col_edge, B, L, J, E, Z, k, max_iters,
                                   alpha, use_alpha, beta, use_beta, check);
  return cudaGetLastError();
}

}  // extern "C"
