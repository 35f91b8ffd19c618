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
// k passes, as the TPU kernel keeps its tile's R in VMEM.  A min-sum check
// node's outputs take two magnitudes, v1 = f(min1) on every edge but the
// first minimum and v2 = f(min2) on that edge (f: beta, then alpha), and a
// sign each, so (v1, v2, first-minimum index, the outputs' own sign bits)
// is the row's R bit for bit, -0.0 included.  That is 12 bytes a check node
// (16 when a row has more than 26 edges) against 4 a message.
//   entry   each slot's R is read once and compressed (the first-minimum
//           edge is the one whose magnitude differs from the rest; when all
//           agree any index serves), so a state written by the plain
//           version or by a checkpoint is taken as it is
//   passes  T [L, Z] and the compressed state live in shared memory;
//           nothing of R touches device memory.  Flooding reads chan from
//           shared memory when it fits beside them, else from device memory
//   exit    R is expanded and written once (zeros for a finished slot),
//           hard once, layered's totals once
// Where T and the state exceed one block's shared memory (J15_L30_Z1280:
// 153,600 + 230,400 bytes), a thread-block cluster holds them in
// distributed shared memory: each block owns some of T's block columns
// (and their chan) and some block rows' states, and reads its peers'
// through 32-bit shared::cluster addresses (mapa, ld.shared::cluster).  The
// host's plan (ops/cuda_minsum_stream.onchip_plan) picks the cluster size,
// gives each block an even share of columns and rows with few edges
// between blocks, and lays out the bytes.  Work follows ownership: the VN
// totals of a column and the flooding check node of a row run on their
// owner, so only reads cross blocks; a layered row spreads its lanes over
// the whole cluster.  The grid is persistent: as many clusters as can be
// resident, each walking over slots.  Barriers separate the phases, one per
// block row when layered: a block barrier for a cluster of one, else a
// cluster barrier, which costs many times more (tools/stream_phases.py
// times both); a flooding pass's zero check rides on its VN phase, and its
// OR crosses the cluster as a flag each block writes into every peer,
// read after the barrier that ends the phase; each slot ends on a barrier,
// so no block moves on (or exits) while a peer can still read its shared
// memory.  A thread issues the loads of up to kChunk edges before it uses
// them, keeping the VN sum and the two-min in edge order, and the flooding
// phases give it two lanes that share the edge tables.
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

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
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
// The on-chip min-sum design.

constexpr int kMaxCluster = 8;
// Edges whose loads a thread issues together before it uses them: the VN
// sum and the two-min stay in edge order, but a column's or a row's reads
// (many of them in a peer's shared memory) are in flight at once.  The
// flooding phases give each thread two lanes, z (or r) and z + ceil(Z / 2),
// which share the edge tables, with half the chunk each; a layered row has
// only Z lanes to spread over the threads, so one each.
constexpr int kChunk = 8;

// The plan's int32 table (ops/cuda_minsum_stream.onchip_plan writes it):
// col_start[kMaxCluster + 1], row_start[kMaxCluster + 1], col_order[L],
// row_order[J] (block c owns the block columns col_order[col_start[c] ..
// col_start[c + 1]) and the block rows row_order[row_start[c] ..
// row_start[c + 1])), then col_rank[L], col_off[L], chan_off[L] (-1: chan
// stays in device memory), row_rank[J], row_off[J], offsets in bytes from
// the start of the owner's dynamic shared memory.
//
// Each block's dynamic shared memory starts with a header (onchip_plan's
// `header_bytes`): flags[kMaxCluster] (int, 32 bytes); vn[E] (u64, the
// column-ordered edges: the address of the edge's row state | (shift |
// position in its row << 16) << 32); cn[E] (u64, the row-ordered edges: the
// address of the edge's T column | shift << 32); col_t[L], col_c[L] (chan's
// columns, ~0 when chan stays in device memory) and row_st[J] (u32
// addresses); col_ptr[L + 1], row_ptr[J + 1], col_order[L] and
// row_order[J].  The data follow at the plan's offsets.  An address is
// 32-bit shared memory: this block's own (shared::cta) for what it owns, a
// peer's shared::cluster address (mapa) for the rest, so that one
// ld.shared::cluster reads either.
constexpr int kPlanColStart = 0;
constexpr int kPlanRowStart = kMaxCluster + 1;
constexpr int kPlanItems = 2 * (kMaxCluster + 1);
constexpr int kFlagBytes = 32;
constexpr unsigned kNone = ~0u;

// The check node's packed word: the outputs' sign bits in bits
// [0, kAmShift), the first-minimum index above them (6 bits).
template <typename Meta>
struct MetaBits;
template <>
struct MetaBits<uint32_t> {
  static constexpr int kAmShift = 26;
};
template <>
struct MetaBits<uint64_t> {
  static constexpr int kAmShift = 58;
};

// Shared-memory loads and stores at a 32-bit address: this block's
// (ld.shared) when kLocal, else any block's of the cluster.
template <bool kLocal>
__device__ __forceinline__ float ld_f32(unsigned a) {
  float v;
  if constexpr (kLocal)
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  else
    asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

template <bool kLocal>
__device__ __forceinline__ float2 ld_f32x2(unsigned a) {
  float2 v;
  if constexpr (kLocal)
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x), "=f"(v.y) : "r"(a));
  else
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

template <bool kLocal, typename Meta>
__device__ __forceinline__ Meta ld_meta(unsigned a) {
  if constexpr (sizeof(Meta) == 4) {
    unsigned v;
    if constexpr (kLocal)
      asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
    else
      asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
  } else {
    unsigned long long v;
    if constexpr (kLocal)
      asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a));
    else
      asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(a));
    return v;
  }
}

template <bool kLocal>
__device__ __forceinline__ void st_f32(unsigned a, float v) {
  if constexpr (kLocal)
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
  else
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v)
                 : "memory");
}

template <bool kLocal>
__device__ __forceinline__ void st_f32x2(unsigned a, float2 v) {
  if constexpr (kLocal)
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(v.x),
                 "f"(v.y)
                 : "memory");
  else
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(a),
                 "f"(v.x), "f"(v.y)
                 : "memory");
}

template <bool kLocal, typename Meta>
__device__ __forceinline__ void st_meta(unsigned a, Meta v) {
  if constexpr (sizeof(Meta) == 4) {
    if constexpr (kLocal)
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
    else
      asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v)
                   : "memory");
  } else {
    if constexpr (kLocal)
      asm volatile("st.shared.u64 [%0], %1;" ::"r"(a),
                   "l"((unsigned long long)v)
                   : "memory");
    else
      asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(a),
                   "l"((unsigned long long)v)
                   : "memory");
  }
}

// A block row's state at address a: float2 (v1, v2)[Z], then Meta[Z].
template <typename Meta>
__device__ __forceinline__ unsigned meta_at(unsigned a, int Z, int r) {
  return a + 8u * Z + (unsigned)sizeof(Meta) * r;
}

// Edge i's message from a compressed check node.
template <typename Meta>
__device__ __forceinline__ float expand(float2 v, Meta m, int i) {
  const int am = (int)(m >> MetaBits<Meta>::kAmShift);
  const float mag = i == am ? v.y : v.x;
  return __uint_as_float(__float_as_uint(mag) |
                         ((unsigned)((m >> i) & 1) << 31));
}

__device__ __forceinline__ float post(float x, float alpha, int use_alpha,
                                      float beta, int use_beta) {
  if (use_beta) {
    x = __fsub_rn(x, beta);
    if (x < 0.f) x = 0.f;
  }
  if (use_alpha) x = __fmul_rn(x, alpha);
  return x;
}

// i = q * Z + rem for 0 <= i < 2^24, Z < 2^16, with a float reciprocal and
// one correction instead of an integer division.
__device__ __forceinline__ int divmod(int i, int Z, float inv_z, int* rem) {
  int q = __float2int_rz(__int2float_rz(i) * inv_z);
  int rm = i - q * Z;
  if (rm < 0) {
    q -= 1;
    rm += Z;
  } else if (rm >= Z) {
    q += 1;
    rm -= Z;
  }
  *rem = rm;
  return q;
}

// A barrier over the cluster, with its memory ordering; a cluster of one
// block takes the cheaper block barrier.
template <bool kLocal>
__device__ __forceinline__ void sync_all(cg::cluster_group& cluster) {
  if constexpr (kLocal)
    __syncthreads();
  else
    cluster.sync();
}

// The block's view of the header.
struct Header {
  int* flags;
  unsigned long long* vn;
  unsigned long long* cn;
  unsigned* col_t;
  unsigned* col_c;
  unsigned* row_st;
  int* col_ptr;
  int* row_ptr;
  int* col_order;
  int* row_order;
  __device__ __forceinline__ Header(unsigned char* smem, int L, int J,
                                    int E) {
    flags = reinterpret_cast<int*>(smem);
    vn = reinterpret_cast<unsigned long long*>(smem + kFlagBytes);
    cn = vn + E;
    col_t = reinterpret_cast<unsigned*>(cn + E);
    col_c = col_t + L;
    row_st = col_c + L;
    col_ptr = reinterpret_cast<int*>(row_st + J);
    row_ptr = col_ptr + L + 1;
    col_order = row_ptr + J + 1;
    row_order = col_order + L;
  }
};

// A check's OR over the cluster: publish_bad ORs `*mine` over the block
// (a block barrier) and writes it into every peer's flags; after a cluster
// barrier gather_bad ORs the flags.  A cluster of one needs no flags.
template <bool kLocal>
__device__ __forceinline__ void publish_bad(cg::cluster_group& cluster,
                                            const Header& h, int me, int cs,
                                            int* mine) {
  *mine = __syncthreads_or(*mine);
  if (!kLocal && (int)threadIdx.x < cs)
    *cluster.map_shared_rank(h.flags + me, threadIdx.x) = *mine;
}

template <bool kLocal>
__device__ __forceinline__ int gather_bad(const Header& h, int cs, int mine) {
  if (kLocal) return mine;
  int bad = 0;
  for (int c = 0; c < cs; ++c) bad |= h.flags[c];
  return bad;
}

// The strict-`<` two-min of a check node's |q| with the sign bits of q,
// edge by edge in row order (common.cuh's check_node_minsum).
template <typename Meta>
struct TwoMin {
  float m1 = 0.f, m2 = FLT_MAX;
  int am = 0;
  Meta signs = 0;

  __device__ __forceinline__ void add(float q, int i) {
    if (q < 0.f) signs |= (Meta)1 << i;
    const float mag = fabsf(q);
    if (i == 0) {
      m1 = mag;
    } else if (mag < m1) {
      m2 = m1;
      m1 = mag;
      am = i;
    } else if (mag < m2) {
      m2 = mag;
    }
  }

  // The new state of a check node of dc edges: beta, then alpha; edge i's
  // output is negative when the parity of the other signs is odd.
  __device__ __forceinline__ void result(int dc, float alpha, int use_alpha,
                                         float beta, int use_beta,
                                         float2* nv, Meta* nm) const {
    const Meta all = ((Meta)1 << dc) - 1;
    const int parity = __popcll((unsigned long long)signs) & 1;
    *nv = make_float2(post(m1, alpha, use_alpha, beta, use_beta),
                      post(m2, alpha, use_alpha, beta, use_beta));
    *nm = (parity ? signs ^ all : signs) |
          ((Meta)am << MetaBits<Meta>::kAmShift);
  }
};

// The min-sum update of the check nodes at lanes r[0..kLanes) of one block
// row (row-ordered edges k0..k1) from the totals and their old states (ov,
// om): q = T - R_old, then TwoMin.  The lanes share the edge tables.
template <bool kLocal, typename Meta, int kLanes>
__device__ __forceinline__ void cn_update(
    const Header& h, const float2* ov, const Meta* om, int k0, int k1,
    const int* r, int Z, float alpha, int use_alpha, float beta,
    int use_beta, float2* nv, Meta* nm) {
  constexpr int kC = kChunk / kLanes;
  TwoMin<Meta> tm[kLanes];
  for (int kc = k0; kc < k1; kc += kC) {
    float t[kC][kLanes];
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      if (kc + u < k1) {
        const unsigned long long w = h.cn[kc + u];
#pragma unroll
        for (int x = 0; x < kLanes; ++x) {
          int z = r[x] + (int)(w >> 32);
          if (z >= Z) z -= Z;
          t[u][x] = ld_f32<kLocal>((unsigned)w + 4u * z);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      if (kc + u < k1) {
        const int i = kc + u - k0;
#pragma unroll
        for (int x = 0; x < kLanes; ++x)
          tm[x].add(__fsub_rn(t[u][x], expand(ov[x], om[x], i)), i);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < kLanes; ++x)
    tm[x].result(k1 - k0, alpha, use_alpha, beta, use_beta, &nv[x], &nm[x]);
}

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
  const int tid = threadIdx.x, nt = blockDim.x;
  const float inv_z = 1.f / Z;

  // the header: addresses in this block's or its peers' shared memory
  const Header h(smem, L, J, E);
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  auto at = [&](int rank, int off) -> unsigned {
    unsigned a = base + off;
    if (rank != me)
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(a) : "r"(a), "r"(rank));
    return a;
  };
  const int* col_rank = plan + kPlanItems + L + J;
  const int* col_off = col_rank + L;
  const int* chan_off = col_off + L;
  const int* row_rank = chan_off + L;
  const int* row_off = row_rank + J;
  for (int l = tid; l < L; l += nt) {
    h.col_t[l] = at(col_rank[l], col_off[l]);
    h.col_c[l] = chan_off[l] < 0 ? kNone : at(col_rank[l], chan_off[l]);
  }
  for (int j = tid; j < J; j += nt) h.row_st[j] = at(row_rank[j], row_off[j]);
  for (int l = tid; l <= L; l += nt) h.col_ptr[l] = col_ptr[l];
  for (int j = tid; j <= J; j += nt) h.row_ptr[j] = row_ptr[j];
  for (int l = tid; l < L; l += nt) h.col_order[l] = plan[kPlanItems + l];
  for (int j = tid; j < J; j += nt)
    h.row_order[j] = plan[kPlanItems + L + j];
  for (int c = tid; c < E; c += nt) {
    const int e = col_edge[c], f = row_edge[c];
    h.vn[c] = at(row_rank[edge_row[e]], row_off[edge_row[e]]) |
              (unsigned long long)(edge_s[e] | (edge_pos[e] << 16)) << 32;
    h.cn[c] = at(col_rank[edge_l[f]], col_off[edge_l[f]]) |
              (unsigned long long)edge_s[f] << 32;
  }
  const int c0 = plan[kPlanColStart + me], c1 = plan[kPlanColStart + me + 1];
  const int j0 = plan[kPlanRowStart + me], j1 = plan[kPlanRowStart + me + 1];
  const int my_cols = (c1 - c0) * Z, my_cns = (j1 - j0) * Z;
  const bool keep_chan = chan_off[0] >= 0;
  // the flooding phases' lane pairs (p, p + half); p + half == Z (odd Z)
  // is no lane
  const int half = (Z + 1) / 2;
  const float inv_half = 1.f / half;
  const int my_col_pairs = (c1 - c0) * half, my_cn_pairs = (j1 - j0) * half;
  // a layered row's lanes, one a thread (a row has only Z), split over the
  // cluster
  const int lane_chunk = (Z + cs - 1) / cs;
  const int lane0 = me * lane_chunk;
  const int lane1 = min(Z, lane0 + lane_chunk);
  __syncthreads();

  const int64_t n_clusters = gridDim.x / cs;
  for (int64_t b = blockIdx.x / cs; b < B; b += n_clusters) {
    float* cb = chan + b * L * Z;
    float* rb = R + b * E * Z;
    int t = t_io[b], done = done_io[b], okf = okf_io[b];

    // entry: chan (layered: the totals) of my columns, my rows' R compressed
    if (kLayered || keep_chan)
      for (int i = tid; i < my_cols; i += nt) {
        int z;
        const int l = h.col_order[c0 + divmod(i, Z, inv_z, &z)];
        st_f32<true>((kLayered ? h.col_t : h.col_c)[l] + 4u * z,
                     cb[l * Z + z]);
      }
    for (int i = tid; i < my_cns; i += nt) {
      int r;
      const int j = h.row_order[j0 + divmod(i, Z, inv_z, &r)];
      const int k0 = h.row_ptr[j], k1 = h.row_ptr[j + 1];
      float mag0 = 0.f, mag1 = 0.f, mag2 = 0.f, magd = 0.f;
      int diff = -1;
      Meta signs = 0;
      for (int kc = k0; kc < k1; kc += kChunk) {
        float x[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (kc + u < k1) {
            int z = r + (int)(h.cn[kc + u] >> 32);
            if (z >= Z) z -= Z;
            x[u] = rb[(int64_t)__ldg(&row_edge[kc + u]) * Z + z];
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int ii = kc + u - k0;
          if (kc + u < k1) {
            signs |= (Meta)(__float_as_uint(x[u]) >> 31) << ii;
            const float mag = fabsf(x[u]);
            if (ii == 0) mag0 = mag;
            if (ii == 1) mag1 = mag;
            if (ii == 2) mag2 = mag;
            if (ii > 0 && diff < 0 && mag != mag0) {
              diff = ii;
              magd = mag;
            }
          }
        }
      }
      // (v1 on every edge but am, v2 on am)
      int am = 0;
      float v1 = mag0, v2 = mag0;
      if (diff >= 2) {          // edges 0 and 1 agree: diff is the odd one
        am = diff;
        v2 = magd;
      } else if (diff == 1) {   // edge 0 or edge 1 is the odd one
        if (k1 - k0 >= 3 && mag2 == mag1) {
          v1 = mag1;
        } else {
          am = 1;
          v2 = mag1;
        }
      }
      const unsigned st = h.row_st[j];
      st_f32x2<true>(st + 8u * r, make_float2(v1, v2));
      st_meta<true, Meta>(meta_at<Meta>(st, Z, r),
                          signs | ((Meta)am << MetaBits<Meta>::kAmShift));
    }
    sync_all<kLocal>(cluster);

    // the zero check of a flooding pass rides on its VN phase: each thread
    // tests the message bits it writes, and the blocks' ORs cross the
    // cluster with the barrier that ends the phase
    const bool zero_in_vn = !kLayered && check == kCheckZero;
    for (int pass = 0; pass < k; ++pass) {
      int bad = 1, mine = 0;
      if (!kLayered) {
        // VN totals of my columns from the compressed messages
        for (int i = tid; i < my_col_pairs; i += nt) {
          int za;
          const int l = h.col_order[c0 + divmod(i, half, inv_half, &za)];
          const bool two = za + half < Z;
          const int zb = two ? za + half : za;
          const int e0 = h.col_ptr[l], e1 = h.col_ptr[l + 1];
          float va = keep_chan ? ld_f32<true>(h.col_c[l] + 4u * za)
                               : __ldg(&cb[l * Z + za]);
          float vb = keep_chan ? ld_f32<true>(h.col_c[l] + 4u * zb)
                               : __ldg(&cb[l * Z + zb]);
          constexpr int kC = kChunk / 2;
          for (int c = e0; c < e1; c += kC) {
            float2 xa[kC], xb[kC];
            Meta ma[kC], mb[kC];
            int pos[kC];
#pragma unroll
            for (int u = 0; u < kC; ++u) {
              if (c + u < e1) {
                const unsigned long long w = h.vn[c + u];
                const unsigned st = (unsigned)w;
                const int info = (int)(w >> 32);
                int ra = za - (info & 0xffff);
                if (ra < 0) ra += Z;
                int rb = ra + (zb - za);
                if (rb >= Z) rb -= Z;
                pos[u] = info >> 16;
                xa[u] = ld_f32x2<kLocal>(st + 8u * ra);
                ma[u] = ld_meta<kLocal, Meta>(meta_at<Meta>(st, Z, ra));
                xb[u] = ld_f32x2<kLocal>(st + 8u * rb);
                mb[u] = ld_meta<kLocal, Meta>(meta_at<Meta>(st, Z, rb));
              }
            }
#pragma unroll
            for (int u = 0; u < kC; ++u) {
              if (c + u < e1) {
                va = __fadd_rn(va, expand(xa[u], ma[u], pos[u]));
                vb = __fadd_rn(vb, expand(xb[u], mb[u], pos[u]));
              }
            }
          }
          st_f32<true>(h.col_t[l] + 4u * za, va);
          if (two) st_f32<true>(h.col_t[l] + 4u * zb, vb);
          if (zero_in_vn && l < L - J)
            mine |= va < 0.f || (two && vb < 0.f);
        }
        if (zero_in_vn) publish_bad<kLocal>(cluster, h, me, cs, &mine);
        sync_all<kLocal>(cluster);  // the check and the CN read every column
        if (zero_in_vn) bad = gather_bad<kLocal>(h, cs, mine);
      }

      // the check, OR-ed over the cluster
      if (check != kCheckNone && !zero_in_vn) {
        if (check == kCheckZero) {
          // the message columns l < L - J among mine
          for (int i = tid; i < my_cols && !mine; i += nt) {
            int z;
            const int l = h.col_order[c0 + divmod(i, Z, inv_z, &z)];
            mine = l < L - J && ld_f32<true>(h.col_t[l] + 4u * z) < 0.f;
          }
        } else {
          for (int i = tid; i < my_cns && !mine; i += nt) {
            int r;
            const int j = h.row_order[j0 + divmod(i, Z, inv_z, &r)];
            int par = 0;
            for (int kk = h.row_ptr[j]; kk < h.row_ptr[j + 1]; ++kk) {
              const unsigned long long w = h.cn[kk];
              int z = r + (int)(w >> 32);
              if (z >= Z) z -= Z;
              par ^= ld_f32<kLocal>((unsigned)w + 4u * z) < 0.f;
            }
            mine = par;
          }
        }
        publish_bad<kLocal>(cluster, h, me, cs, &mine);
        if (!kLocal) cluster.sync();
        bad = gather_bad<kLocal>(h, cs, mine);
      }
      if (!done && (!bad || t >= max_iters)) {
        okf = !bad;
        done = 1;
      }
      if (done) break;
      t += 1;

      if (!kLayered) {
        // the check nodes of my rows, state in place
        for (int i = tid; i < my_cn_pairs; i += nt) {
          int ra;
          const int j = h.row_order[j0 + divmod(i, half, inv_half, &ra)];
          const bool two = ra + half < Z;
          const int rb = two ? ra + half : ra;
          const unsigned st = h.row_st[j];
          const int r[2] = {ra, rb};
          const unsigned mp[2] = {meta_at<Meta>(st, Z, ra),
                                  meta_at<Meta>(st, Z, rb)};
          const float2 ov[2] = {ld_f32x2<true>(st + 8u * ra),
                                ld_f32x2<true>(st + 8u * rb)};
          const Meta om[2] = {ld_meta<true, Meta>(mp[0]),
                              ld_meta<true, Meta>(mp[1])};
          float2 nv[2];
          Meta nm[2];
          cn_update<kLocal, Meta, 2>(h, ov, om, h.row_ptr[j], h.row_ptr[j + 1],
                                     r, Z, alpha, use_alpha, beta, use_beta,
                                     nv, nm);
          st_f32x2<true>(st + 8u * ra, nv[0]);
          st_meta<true, Meta>(mp[0], nm[0]);
          if (two) {
            st_f32x2<true>(st + 8u * rb, nv[1]);
            st_meta<true, Meta>(mp[1], nm[1]);
          }
        }
        sync_all<kLocal>(cluster);  // the next totals read every row's state
      } else {
        for (int j = 0; j < J; ++j) {
          const int k0 = h.row_ptr[j], k1 = h.row_ptr[j + 1];
          const unsigned st = h.row_st[j];
          for (int r = lane0 + tid; r < lane1; r += nt) {
            const unsigned mp = meta_at<Meta>(st, Z, r);
            const float2 ov = ld_f32x2<kLocal>(st + 8u * r);
            const Meta om = ld_meta<kLocal, Meta>(mp);
            float2 nv;
            Meta nm;
            cn_update<kLocal, Meta, 1>(h, &ov, &om, k0, k1, &r, Z, alpha,
                                       use_alpha, beta, use_beta, &nv, &nm);
            // T + (R_new - R_old), a chunk of totals read at once
            for (int kc = k0; kc < k1; kc += kChunk) {
              unsigned ta[kChunk];
              float tv[kChunk];
#pragma unroll
              for (int u = 0; u < kChunk; ++u) {
                if (kc + u < k1) {
                  const unsigned long long w = h.cn[kc + u];
                  int z = r + (int)(w >> 32);
                  if (z >= Z) z -= Z;
                  ta[u] = (unsigned)w + 4u * z;
                  tv[u] = ld_f32<kLocal>(ta[u]);
                }
              }
#pragma unroll
              for (int u = 0; u < kChunk; ++u) {
                const int i = kc + u - k0;
                if (kc + u < k1)
                  st_f32<kLocal>(ta[u],
                                 __fadd_rn(tv[u],
                                           __fsub_rn(expand(nv, nm, i),
                                                     expand(ov, om, i))));
              }
            }
            st_f32x2<kLocal>(st + 8u * r, nv);
            st_meta<kLocal, Meta>(mp, nm);
          }
          sync_all<kLocal>(cluster);  // the next row reads these totals
        }
      }
    }

    // exit: hard (and layered's totals) of my columns, my rows' R expanded
    signed char* hb = hard + b * L * Z;
    for (int i = tid; i < my_cols; i += nt) {
      int z;
      const int l = h.col_order[c0 + divmod(i, Z, inv_z, &z)];
      const float v = ld_f32<true>(h.col_t[l] + 4u * z);
      hb[l * Z + z] = v < 0.f ? 1 : 0;
      if (kLayered) cb[l * Z + z] = v;
    }
    for (int i = tid; i < my_cns; i += nt) {
      int r;
      const int j = h.row_order[j0 + divmod(i, Z, inv_z, &r)];
      const unsigned st = h.row_st[j];
      const float2 v = ld_f32x2<true>(st + 8u * r);
      const Meta m = ld_meta<true, Meta>(meta_at<Meta>(st, Z, r));
      const int k0 = h.row_ptr[j];
      for (int kk = k0; kk < h.row_ptr[j + 1]; ++kk) {
        int z = r + (int)(h.cn[kk] >> 32);
        if (z >= Z) z -= Z;
        rb[(int64_t)__ldg(&row_edge[kk]) * Z + z] =
            done ? 0.f : expand(v, m, kk - k0);
      }
    }
    if (me == 0 && tid == 0) {
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
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  if (threads != 512 && threads != 1024) return cudaErrorInvalidValue;
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
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes)))
    return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg)))
    return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(min64(clusters, B) * cluster), 1, 1);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, chan, R, hard, t, done, okf,
                                edge_l, edge_s, row_ptr, row_edge, col_ptr,
                                col_edge, edge_row, edge_pos, plan, B, L, J,
                                E, Z, k, max_iters, alpha, use_alpha, beta,
                                use_beta, check)))
    return err;
  return cudaGetLastError();
}

}  // extern "C"
