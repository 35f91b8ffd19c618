// Stateful step of the binary continuous-batching (stream) engine, flooding
// or row-layered, min-sum or exact sum-product, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_minsum_stream.py
// `_stream_kernel` (:54, with `_body_accounting` :40).  It computes what
// ops/minsum_stream.py's plain `stream_step` computes, bit for bit for
// min-sum and with logf/tanhf for bp (common.cuh's check nodes, as in K1-K3):
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
// Layout (the plain version's contract, at the call's boundaries): chan
// [B, L, Z] f32 (flooding: the channel values; layered: the running totals,
// updated), R [B, E, Z] f32, hard [B, L, Z] int8, t / done / okf [B] int32.
// Offsets are 64-bit.
//
// Min-sum (`onchip_kernel`): the slot's working state stays on chip for all
// k passes, as the TPU kernel keeps its tile's R in VMEM: T [L, Z] and R
// compressed per check node (v1, v2, first-minimum index, sign bits; R bit
// for bit) in shared memory, on a thread-block cluster where one block is
// too small (J15_L30_Z1280: 153,600 + 230,400 bytes).  onchip.cuh holds the
// representation, the layout and the phases, shared with the batch kernels
// K1 and K2; this kernel places its barriers between them.
//   entry   each slot's R is read once and compressed (the first-minimum
//           edge is the one whose magnitude differs from the rest; when all
//           agree any index serves), so a state written by the plain
//           version or by a checkpoint is taken as it is
//   passes  T and the compressed state live in shared memory; nothing of R
//           touches device memory.  Flooding reads chan from shared memory
//           when it fits beside them, else from device memory
//   exit    R is expanded and written once (zeros for a finished slot),
//           hard once, layered's totals once
// The grid is persistent: as many clusters as can be resident, each walking
// over slots; each slot ends on a barrier, so no block moves on (or exits)
// while a peer can still read its shared memory.
//
// Bound: one read and one write of R, chan (and, layered, the totals) and
// hard per call, which is what chip_smoke.stream_bound_ms counts, plus the
// flooding chan read per pass where chan stays in device memory (J15:
// 153.6 KB a slot a pass).  What holds the kernel instead is the issue and
// latency of the instructions each message takes a phase (its state's
// addresses, the expansion, the two-min), in the VN and CN phases, and for
// a cluster the barriers (tools/stream_phases.py splits a call by phase).
//
// bp (`stream_kernel`, the global-memory design): phi's outputs take more
// than two values, so bp keeps R [B, E, Z] and a T scratch in device memory,
// one block per slot, with common.cuh's check_node_bp (phi_e kept per edge).
// The same kernel with the min-sum rule is the earlier min-sum design,
// exported as ldpc_minsum_stream_global for comparison only.

#include "onchip.cuh"

using namespace ldpc;

// ---------------------------------------------------------------------------
// The global-memory design: one block per slot, R and T in device memory.

template <int kRule, bool kLayered, int kDeg>
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
          check_node<kRule, kLayered, kDeg>(tb, rb, edge_l, edge_s, row_edge,
                                            row_ptr[j], row_ptr[j + 1], r, Z,
                                            alpha, use_alpha, beta, use_beta);
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

// ---------------------------------------------------------------------------
// The on-chip min-sum design, built from onchip.cuh's phases.

// kLocal: a cluster of one block, every address this block's own.
template <bool kLayered, typename Meta, bool kLocal, int kThreads>
static __global__ void __launch_bounds__(kThreads)
    onchip_kernel(float* chan, float* R, signed char* __restrict__ hard,
                  int* t_io, int* done_io, int* okf_io,
                  const int* __restrict__ edge_l,
                  const int* __restrict__ edge_s,
                  const int* __restrict__ row_ptr,
                  const int* __restrict__ row_edge,
                  const int* __restrict__ col_ptr,
                  const int* __restrict__ col_edge,
                  const int* __restrict__ edge_row,
                  const int* __restrict__ edge_pos,
                  const int* __restrict__ plan, int B, int L, int J, int E,
                  int Z, int k, int max_iters, float alpha, int use_alpha,
                  float beta, int use_beta, int check) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const OnChip<Meta, kLocal> oc(smem, me, cs, edge_l, edge_s, row_ptr,
                                row_edge, col_ptr, col_edge, edge_row,
                                edge_pos, plan, L, J, E, Z);

  const int64_t n_clusters = gridDim.x / cs;
  for (int64_t b = blockIdx.x / cs; b < B; b += n_clusters) {
    float* cb = chan + b * L * Z;
    float* rb = R + b * E * Z;
    int t = t_io[b], done = done_io[b], okf = okf_io[b];

    // entry: chan (layered: the totals) of my columns, my rows' R compressed
    if (kLayered || oc.keep_chan) oc.load_cols(cb, kLayered);
    oc.compress_rows(rb, row_edge);
    sync_all<kLocal>(cluster);

    // the zero check of a flooding pass rides on its VN phase: each thread
    // tests the message bits it writes, and the blocks' ORs cross the
    // cluster with the barrier that ends the phase
    const bool zero_in_vn = !kLayered && check == kCheckZero;
    for (int pass = 0; pass < k; ++pass) {
      int bad = 1, mine = 0;
      if (!kLayered) {
        // VN totals of my columns from the compressed messages
        mine = oc.vn_phase(cb, zero_in_vn);
        if (zero_in_vn) publish_bad<kLocal>(cluster, oc.h, me, cs, &mine);
        sync_all<kLocal>(cluster);  // the check and the CN read every column
        if (zero_in_vn) bad = gather_bad<kLocal>(oc.h, cs, mine);
      }

      // the check, OR-ed over the cluster
      if (check != kCheckNone && !zero_in_vn) {
        mine = oc.check_phase(check);
        publish_bad<kLocal>(cluster, oc.h, me, cs, &mine);
        if (!kLocal) cluster.sync();
        bad = gather_bad<kLocal>(oc.h, cs, mine);
      }
      if (!done && (!bad || t >= max_iters)) {
        okf = !bad;
        done = 1;
      }
      if (done) break;
      t += 1;

      if (!kLayered) {
        // the check nodes of my rows, state in place
        oc.cn_phase(alpha, use_alpha, beta, use_beta);
        sync_all<kLocal>(cluster);  // the next totals read every row's state
      } else {
        for (int j = 0; j < J; ++j) {
          oc.layered_row(j, alpha, use_alpha, beta, use_beta);
          sync_all<kLocal>(cluster);  // the next row reads these totals
        }
      }
    }

    // exit: hard (and layered's totals) of my columns, my rows' R expanded
    oc.store_cols(hard + b * L * Z, kLayered ? cb : nullptr);
    oc.expand_rows(rb, row_edge, done);
    if (me == 0 && oc.tid == 0) {
      t_io[b] = t;
      done_io[b] = done;
      okf_io[b] = okf;
    }
    sync_all<kLocal>(cluster);  // no block reuses its memory while a peer reads
  }
}

extern "C" {

// Runs up to `k` >= 1 passes of the stream step with `rule` (0 min-sum,
// 1 bp), flooding or layered, in the global-memory design (R and the
// flooding scratch T [B, L, Z] in device memory, one block per slot) on
// `stream` of CUDA device `device`; `max_dc` is the code's largest row
// degree.  chan (layered), R, t, done and okf are updated in place; hard is
// written.  The stream engine's bp runs here; its min-sum runs
// ldpc_minsum_stream, and this min-sum path is kept only to compare the two.
// Returns 0 or the CUDA error of the launch.
int ldpc_minsum_stream_global(float* chan, float* T, float* R,
                              signed char* hard, int* t, int* done, int* okf,
                              const int* edge_l, const int* edge_s,
                              const int* row_ptr, const int* row_edge,
                              const int* col_ptr, const int* col_edge, int B,
                              int L, int J, int E, int Z, int k, int max_iters,
                              float alpha, int use_alpha, float beta,
                              int use_beta, int check, int rule, int layered,
                              int max_dc, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return err;
  const int threads = Z >= 256 ? 256 : ((Z + 31) / 32) * 32;
  const int grid = (int)min64(B, (int64_t)sms * 16);
  auto kernel = layered ? stream_kernel<kRuleMinsum, true, 0>
                        : stream_kernel<kRuleMinsum, false, 0>;
  if (rule == kRuleBP) {
    const int deg = bp_degree_bucket(max_dc);
    if (deg == kBpDegSmall)
      kernel = layered ? stream_kernel<kRuleBP, true, kBpDegSmall>
                       : stream_kernel<kRuleBP, false, kBpDegSmall>;
    else if (deg == kBpDegMid)
      kernel = layered ? stream_kernel<kRuleBP, true, kBpDegMid>
                       : stream_kernel<kRuleBP, false, kBpDegMid>;
    else
      kernel = layered ? stream_kernel<kRuleBP, true, kMaxRowDegree>
                       : stream_kernel<kRuleBP, false, kMaxRowDegree>;
  }
  kernel<<<grid, threads, 0, st>>>(chan, T, R, hard, t, done, okf, edge_l,
                                   edge_s, row_ptr, row_edge, col_ptr,
                                   col_edge, B, L, J, E, Z, k, max_iters,
                                   alpha, use_alpha, beta, use_beta, check);
  return cudaGetLastError();
}

// Runs up to `k` >= 1 min-sum passes of the stream step, flooding or
// layered, with the slots' working state on chip: a persistent grid of
// clusters of `cluster` blocks of `threads` (512 or 1024) threads, each with
// `smem_bytes` of dynamic shared memory laid out by `plan` (see the kernel),
// 64-bit check-node words when `wide`.  edge_row / edge_pos give each
// edge's block row and its position in the row.  chan (layered), R, t, done
// and okf are updated in place; hard is written.  Returns 0 or the first
// CUDA error.
int ldpc_minsum_stream(float* chan, float* R, signed char* hard, int* t,
                       int* done, int* okf, const int* edge_l,
                       const int* edge_s, const int* row_ptr,
                       const int* row_edge, const int* col_ptr,
                       const int* col_edge, const int* edge_row,
                       const int* edge_pos, const int* plan, int B, int L,
                       int J, int E, int Z, int k, int max_iters, float alpha,
                       int use_alpha, float beta, int use_beta, int check,
                       int layered, int cluster, int smem_bytes, int wide,
                       int threads, int device, void* stream) {
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
#define ONCHIP_PICK(T)                                                      \
  (cluster == 1                                                           \
       ? (layered ? (wide ? onchip_kernel<true, uint64_t, true, T>        \
                          : onchip_kernel<true, uint32_t, true, T>)       \
                  : (wide ? onchip_kernel<false, uint64_t, true, T>       \
                          : onchip_kernel<false, uint32_t, true, T>))     \
       : (layered ? (wide ? onchip_kernel<true, uint64_t, false, T>       \
                          : onchip_kernel<true, uint32_t, false, T>)      \
                  : (wide ? onchip_kernel<false, uint64_t, false, T>      \
                          : onchip_kernel<false, uint32_t, false, T>)))
  auto kernel = threads == 512 ? ONCHIP_PICK(512) : ONCHIP_PICK(1024);
#undef ONCHIP_PICK
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  if ((err = onchip_grid(kernel, cluster, threads, smem_bytes, B,
                         (cudaStream_t)stream, attr, &cfg)))
    return err;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, chan, R, hard, t, done, okf,
                                edge_l, edge_s, row_ptr, row_edge, col_ptr,
                                col_edge, edge_row, edge_pos, plan, B, L, J,
                                E, Z, k, max_iters, alpha, use_alpha, beta,
                                use_beta, check)))
    return err;
  return cudaGetLastError();
}

}  // extern "C"
