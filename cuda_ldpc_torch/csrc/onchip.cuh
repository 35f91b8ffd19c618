// The on-chip min-sum machinery, CUDA C++ for sm_90a: one frame's (or one
// stream slot's) totals T [L, Z] and its c2v messages, compressed per check
// node, held in shared memory for as many iterations as it runs, spread over
// a thread-block cluster where one block's shared memory is too small.  The
// stream step K4 (minsum_stream.cu, `onchip_kernel`) and the min-sum batch
// decoders K1 (minsum_flooding.cu) and K2 (minsum_layered.cu), both the
// `onchip_batch_kernel` below, are built from it.
//
// The representation.  A min-sum check node's outputs take two magnitudes,
// v1 = f(min1) on every edge but the first minimum and v2 = f(min2) on that
// edge (f: beta, then alpha), and a sign each, so (v1, v2, first-minimum
// index, the outputs' own sign bits) is the row's R bit for bit, -0.0
// included.  That is 12 bytes a check node (16 when a row has more than 26
// edges) against 4 a message.  ops/minsum_stream's compress_messages and
// expand_messages are its plain form.
//
// The layout.  Each block owns some of T's block columns (and their chan,
// when the plan keeps it on chip) and some block rows' states, and reads its
// peers' through 32-bit shared::cluster addresses (mapa,
// ld.shared::cluster).  The host's plan (ops/onchip.onchip_plan) picks the
// cluster size, gives each block an even share of columns and rows with few
// edges between blocks, and lays out the bytes.  Work follows ownership:
// the VN totals of a column and the flooding check node of a row run on
// their owner, so only reads cross blocks; a layered row spreads its lanes
// over the whole cluster.  Barriers separate the phases, one per block row
// when layered: a block barrier for a cluster of one, else a cluster
// barrier, which costs many times more (tools/stream_phases.py times both).
// A flooding pass's zero check can ride on its VN phase; a check's OR
// crosses the cluster as a flag each block writes into every peer, read
// after the barrier that ends the phase.  A thread issues the loads of up to
// kChunk edges before it uses them, keeping the VN sum and the two-min in
// edge order, and the flooding phases give it two lanes that share the edge
// tables.
//
// Arithmetic follows ops/minsum.py operation by operation (common.cuh).

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace ldpc {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;
// Edges whose loads a thread issues together before it uses them: the VN
// sum and the two-min stay in edge order, but a column's or a row's reads
// (many of them in a peer's shared memory) are in flight at once.  The
// flooding phases give each thread two lanes, z (or r) and z + ceil(Z / 2),
// which share the edge tables, with half the chunk each; a layered row has
// only Z lanes to spread over the threads, so one each.
constexpr int kChunk = 8;

// The plan's int32 table (ops/onchip.onchip_plan writes it):
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

// One block's share of a frame on chip: the header it fills, the columns
// and rows it owns, and the phases over them.  kLocal: a cluster of one
// block, every address this block's own.  The caller places the barriers
// between the phases.
template <typename Meta, bool kLocal>
struct OnChip {
  Header h;
  int me, cs, tid, nt, L, J, Z;
  float inv_z;
  int c0, j0, my_cols, my_cns;
  bool keep_chan;
  // the flooding phases' lane pairs (p, p + half); p + half == Z (odd Z)
  // is no lane
  int half;
  float inv_half;
  int my_col_pairs, my_cn_pairs;
  // a layered row's lanes, one a thread (a row has only Z), split over the
  // cluster
  int lane0, lane1;

  // Fills the header from the code's tables and the plan; ends on a block
  // barrier.
  __device__ __forceinline__ OnChip(
      unsigned char* smem, int me_, int cs_, const int* __restrict__ edge_l,
      const int* __restrict__ edge_s, const int* __restrict__ row_ptr,
      const int* __restrict__ row_edge, const int* __restrict__ col_ptr,
      const int* __restrict__ col_edge, const int* __restrict__ edge_row,
      const int* __restrict__ edge_pos, const int* __restrict__ plan, int L_,
      int J_, int E, int Z_)
      : h(smem, L_, J_, E),
        me(me_),
        cs(cs_),
        tid(threadIdx.x),
        nt(blockDim.x),
        L(L_),
        J(J_),
        Z(Z_),
        inv_z(1.f / Z_) {
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
    c0 = plan[kPlanColStart + me];
    const int c1 = plan[kPlanColStart + me + 1];
    j0 = plan[kPlanRowStart + me];
    const int j1 = plan[kPlanRowStart + me + 1];
    my_cols = (c1 - c0) * Z;
    my_cns = (j1 - j0) * Z;
    keep_chan = chan_off[0] >= 0;
    half = (Z + 1) / 2;
    inv_half = 1.f / half;
    my_col_pairs = (c1 - c0) * half;
    my_cn_pairs = (j1 - j0) * half;
    const int lane_chunk = (Z + cs - 1) / cs;
    lane0 = me * lane_chunk;
    lane1 = min(Z, lane0 + lane_chunk);
    __syncthreads();
  }

  // My columns of the frame array src [L, Z] into T (to_t) or chan.
  __device__ __forceinline__ void load_cols(const float* src,
                                            bool to_t) const {
    for (int i = tid; i < my_cols; i += nt) {
      int z;
      const int l = h.col_order[c0 + divmod(i, Z, inv_z, &z)];
      st_f32<true>((to_t ? h.col_t : h.col_c)[l] + 4u * z, src[l * Z + z]);
    }
  }

  // My rows' R, read from rb [E, Z] and compressed: the first-minimum edge
  // is the one whose magnitude differs from the rest (when all agree any
  // index serves), so a state written by the plain version or by a
  // checkpoint is taken as it is.
  __device__ __forceinline__ void compress_rows(
      const float* rb, const int* __restrict__ row_edge) const {
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
  }

  // My rows' states: all zero (R = +0.0), or read from / written to a
  // frame's saved state sv [J, Z] (v1, v2) and sm [J, Z].
  __device__ __forceinline__ void zero_rows() const {
    for (int i = tid; i < my_cns; i += nt) {
      int r;
      const unsigned st = h.row_st[h.row_order[j0 + divmod(i, Z, inv_z, &r)]];
      st_f32x2<true>(st + 8u * r, make_float2(0.f, 0.f));
      st_meta<true, Meta>(meta_at<Meta>(st, Z, r), (Meta)0);
    }
  }

  __device__ __forceinline__ void load_rows(const float2* sv,
                                            const Meta* sm) const {
    for (int i = tid; i < my_cns; i += nt) {
      int r;
      const int j = h.row_order[j0 + divmod(i, Z, inv_z, &r)];
      const unsigned st = h.row_st[j];
      st_f32x2<true>(st + 8u * r, sv[j * Z + r]);
      st_meta<true, Meta>(meta_at<Meta>(st, Z, r), sm[j * Z + r]);
    }
  }

  __device__ __forceinline__ void save_rows(float2* sv, Meta* sm) const {
    for (int i = tid; i < my_cns; i += nt) {
      int r;
      const int j = h.row_order[j0 + divmod(i, Z, inv_z, &r)];
      const unsigned st = h.row_st[j];
      sv[j * Z + r] = ld_f32x2<true>(st + 8u * r);
      sm[j * Z + r] = ld_meta<true, Meta>(meta_at<Meta>(st, Z, r));
    }
  }

  // Flooding VN: the totals of my columns from chan (on chip, or cb [L, Z]
  // in device memory) and the compressed messages.  With zero_in_vn,
  // returns whether a message bit of mine is 1 (this thread's view).
  __device__ __forceinline__ int vn_phase(const float* cb,
                                          bool zero_in_vn) const {
    int mine = 0;
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
      if (zero_in_vn && l < L - J) mine |= va < 0.f || (two && vb < 0.f);
    }
    return mine;
  }

  // The zero or syndrome check on T, this thread's share of my columns (the
  // message columns l < L - J among them) or my rows: 1 when it fails.
  __device__ __forceinline__ int check_phase(int check) const {
    int mine = 0;
    if (check == kCheckZero) {
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
    return mine;
  }

  // Flooding CN: the check nodes of my rows, state in place.
  __device__ __forceinline__ void cn_phase(float alpha, int use_alpha,
                                           float beta, int use_beta) const {
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
                                 r, Z, alpha, use_alpha, beta, use_beta, nv,
                                 nm);
      st_f32x2<true>(st + 8u * ra, nv[0]);
      st_meta<true, Meta>(mp[0], nm[0]);
      if (two) {
        st_f32x2<true>(st + 8u * rb, nv[1]);
        st_meta<true, Meta>(mp[1], nm[1]);
      }
    }
  }

  // Layered: this block's lanes of block row j, the totals updated as
  // T + (R_new - R_old).
  __device__ __forceinline__ void layered_row(int j, float alpha,
                                              int use_alpha, float beta,
                                              int use_beta) const {
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
                           __fadd_rn(tv[u], __fsub_rn(expand(nv, nm, i),
                                                      expand(ov, om, i))));
        }
      }
      st_f32x2<kLocal>(st + 8u * r, nv);
      st_meta<kLocal, Meta>(mp, nm);
    }
  }

  // hard [L, Z] = T < 0 of my columns, and the totals into tout [L, Z]
  // unless it is null.
  __device__ __forceinline__ void store_cols(signed char* hb,
                                             float* tout) const {
    for (int i = tid; i < my_cols; i += nt) {
      int z;
      const int l = h.col_order[c0 + divmod(i, Z, inv_z, &z)];
      const float v = ld_f32<true>(h.col_t[l] + 4u * z);
      hb[l * Z + z] = v < 0.f ? 1 : 0;
      if (tout) tout[l * Z + z] = v;
    }
  }

  // My rows' R expanded into rb [E, Z] (zeros when `zero`).
  __device__ __forceinline__ void expand_rows(
      float* rb, const int* __restrict__ row_edge, bool zero) const {
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
            zero ? 0.f : expand(v, m, kk - k0);
      }
    }
  }
};

// A persistent grid for an on-chip kernel: as many clusters of `cluster`
// blocks of `threads` threads, each block with `smem_bytes` of dynamic
// shared memory, as the card holds at once, and at most `work` of them.
// Fills cfg (with its cluster attribute, attr[1]) for cudaLaunchKernelEx.
template <typename Kernel>
static inline cudaError_t onchip_grid(Kernel kernel, int cluster,
                                      int threads, int smem_bytes,
                                      int64_t work, cudaStream_t st,
                                      cudaLaunchAttribute* attr,
                                      cudaLaunchConfig_t* cfg) {
  cudaError_t err;
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  if (threads != 512 && threads != 1024) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes)))
    return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, cfg)))
    return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg->gridDim = dim3((unsigned)(min64(clusters, work) * cluster), 1, 1);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The min-sum batch decoders K1 (flooding) and K2 (layered) with each
// frame's state on chip, and their batch-wide early stop.
//
// ops/minsum.decode_flooding / decode_layered stop the whole batch at the
// first iteration K* at which every frame's check passes (or at num_iters),
// and report every frame's hard and ok at K*.  Frames are independent, so a
// frame's trajectory does not depend on when it is run.  The protocol, all
// of it enqueued at once with no host wait:
//   first   one launch runs each frame from R = 0 until its own check first
//           passes at iteration k_b, or to num_iters; it writes hard, ok and
//           k_b, raises the device maximum K = max k_b and, when early stop
//           is on, saves the frame's state: the compressed R that fed
//           iteration k_b's VN phase (flooding resumes with that
//           iteration's CN phase, after recomputing its totals from chan
//           and R, which gives the same bits), and for layered also the
//           totals T [L, Z].  Without early stop (or with check none) every
//           frame runs num_iters iterations and nothing is saved.
//   resume  one launch runs each frame with k_b < K from its saved state on
//           to K, rewrites its hard and ok and saves its state at K; every
//           frame not ok at K is counted.
//   step    while some frame fails at the batch's iteration (it passed
//           earlier and failed again) and num_iters is not reached: one
//           launch runs every frame one iteration on from its saved state.
// After each resume or step launch a one-thread launch sets the batch's
// count and the stop flag (ctl); num_iters - 1 step launches are enqueued,
// and those after the stop return at once.

// ctl: common.cuh's kIters, kStop and kNotOk, then K.
constexpr int kMaxK = 3;
constexpr int kCtlInts = 4;
constexpr int kRunFirst = 0;
constexpr int kRunResume = 1;
constexpr int kRunStep = 2;

static __global__ void onchip_finish(int* ctl, int num_iters, int from_k) {
  if (ctl[kStop]) return;
  ctl[kIters] = from_k ? ctl[kMaxK] : ctl[kIters] + 1;
  if (ctl[kNotOk] == 0 || ctl[kIters] >= num_iters) ctl[kStop] = 1;
  ctl[kNotOk] = 0;
}

// One launch of the protocol (`mode`), a persistent grid of clusters, each
// walking over frames.  chan, hard [B, L, Z]; ok, kb [B]; the saved states
// sv [B, J, Z] float2 and sm [B, J, Z] Meta, and (layered) tsave [B, L, Z]
// f32, touched only when stop_when_ok.
template <bool kLayered, typename Meta, bool kLocal, int kThreads>
static __global__ void __launch_bounds__(kThreads) onchip_batch_kernel(
    const float* __restrict__ chan, float* tsave,
    signed char* __restrict__ hard, unsigned char* __restrict__ ok, int* kb,
    float2* sv, void* sm_io, int* ctl, const int* __restrict__ edge_l,
    const int* __restrict__ edge_s, const int* __restrict__ row_ptr,
    const int* __restrict__ row_edge, const int* __restrict__ col_ptr,
    const int* __restrict__ col_edge, const int* __restrict__ edge_row,
    const int* __restrict__ edge_pos, const int* __restrict__ plan, int B,
    int L, int J, int E, int Z, int num_iters, float alpha, int use_alpha,
    float beta, int use_beta, int check, int stop_when_ok, int mode) {
  if (mode != kRunFirst && ctl[kStop]) return;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const OnChip<Meta, kLocal> oc(smem, me, cs, edge_l, edge_s, row_ptr,
                                row_edge, col_ptr, col_edge, edge_row,
                                edge_pos, plan, L, J, E, Z);
  Meta* sm = static_cast<Meta*>(sm_io);
  const int K = ctl[kMaxK], now = ctl[kIters];
  // flooding: the zero check rides on the VN phase
  const bool zero_in_vn = !kLayered && check == kCheckZero;
  const int64_t n_clusters = gridDim.x / cs;
  for (int64_t b = blockIdx.x / cs; b < B; b += n_clusters) {
    const float* cb = chan + b * L * Z;
    int it = 0, target = num_iters;
    if (mode == kRunResume) {
      it = kb[b];
      if (it >= K) {             // it stopped at K: its outputs stand
        if (me == 0 && oc.tid == 0 && !ok[b]) atomicAdd(&ctl[kNotOk], 1);
        continue;
      }
      target = K;
    } else if (mode == kRunStep) {
      it = now;
      target = now + 1;
    }

    // entry: chan (layered: the totals) of my columns, my rows' state
    if (kLayered)
      oc.load_cols(mode == kRunFirst ? cb : tsave + b * L * Z, true);
    else if (oc.keep_chan)
      oc.load_cols(cb, false);
    if (mode == kRunFirst)
      oc.zero_rows();
    else
      oc.load_rows(sv + b * J * Z, sm + b * J * Z);
    sync_all<kLocal>(cluster);
    if (!kLayered && mode != kRunFirst) {
      oc.vn_phase(cb, false);    // the saved iteration's totals
      sync_all<kLocal>(cluster);
    }

    int bad = 1;
    for (;;) {
      int mine = 0;
      if (kLayered) {
        for (int j = 0; j < J; ++j) {
          oc.layered_row(j, alpha, use_alpha, beta, use_beta);
          sync_all<kLocal>(cluster);  // the next row reads these totals
        }
      } else {
        if (it > 0) {            // the previous iteration's CN phase
          oc.cn_phase(alpha, use_alpha, beta, use_beta);
          sync_all<kLocal>(cluster);  // the VN reads every row's state
        }
        mine = oc.vn_phase(cb, zero_in_vn);
        if (zero_in_vn) publish_bad<kLocal>(cluster, oc.h, me, cs, &mine);
        sync_all<kLocal>(cluster);    // the check and the CN read every column
        if (zero_in_vn) bad = gather_bad<kLocal>(oc.h, cs, mine);
      }
      if (check != kCheckNone && !zero_in_vn) {
        mine = oc.check_phase(check);
        publish_bad<kLocal>(cluster, oc.h, me, cs, &mine);
        if (!kLocal) cluster.sync();
        bad = gather_bad<kLocal>(oc.h, cs, mine);
      }
      ++it;
      if (it >= target || (mode == kRunFirst && stop_when_ok && !bad)) break;
    }

    // exit: hard of my columns; with early stop my rows' state (and the
    // layered totals) saved
    oc.store_cols(hard + b * L * Z,
                  kLayered && stop_when_ok ? tsave + b * L * Z : nullptr);
    if (stop_when_ok) oc.save_rows(sv + b * J * Z, sm + b * J * Z);
    if (me == 0 && oc.tid == 0) {
      ok[b] = bad ? 0 : 1;
      if (mode == kRunFirst) {
        if (stop_when_ok) kb[b] = it;
        atomicMax(&ctl[kMaxK], it);
      } else if (bad) {
        atomicAdd(&ctl[kNotOk], 1);
      }
    }
    sync_all<kLocal>(cluster);  // no block reuses its memory while a peer reads
  }
}

// Decodes the batch `chan` with min-sum, flooding or (kLayered) layered, by
// the protocol above on `stream` of CUDA device `device`: a persistent grid
// of clusters of `cluster` blocks of `threads` (512 or 1024) threads, each
// with `smem_bytes` of dynamic shared memory laid out by `plan`, 64-bit
// check-node words when `wide`.  edge_row / edge_pos give each edge's block
// row and its position in the row.  hard, ok and ctl (kCtlInts ints; the
// batch's count ends in ctl[kIters]) are written; kb, sv, sm and (layered)
// tsave are the caller's scratch, used only with early stop and a check.
// Returns 0 or the first CUDA error met while enqueueing.
template <bool kLayered>
static inline int onchip_batch(
    const float* chan, float* tsave, signed char* hard, unsigned char* ok,
    int* kb, float* sv, void* sm, int* ctl, const int* edge_l,
    const int* edge_s, const int* row_ptr, const int* row_edge,
    const int* col_ptr, const int* col_edge, const int* edge_row,
    const int* edge_pos, const int* plan, int B, int L, int J, int E, int Z,
    int num_iters, float alpha, int use_alpha, float beta, int use_beta,
    int check, int early_stop, int cluster, int smem_bytes, int wide,
    int threads, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
#define BATCH_PICK(T)                                                        \
  (cluster == 1                                                              \
       ? (wide ? onchip_batch_kernel<kLayered, uint64_t, true, T>            \
               : onchip_batch_kernel<kLayered, uint32_t, true, T>)           \
       : (wide ? onchip_batch_kernel<kLayered, uint64_t, false, T>           \
               : onchip_batch_kernel<kLayered, uint32_t, false, T>))
  auto kernel = threads == 512 ? BATCH_PICK(512) : BATCH_PICK(1024);
#undef BATCH_PICK
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  if ((err = onchip_grid(kernel, cluster, threads, smem_bytes, B, st, attr,
                         &cfg)))
    return err;
  const int stop_when_ok = early_stop && check != kCheckNone;
  auto launch = [&](int mode) {
    return cudaLaunchKernelEx(
        &cfg, kernel, chan, tsave, hard, ok, kb,
        reinterpret_cast<float2*>(sv), sm, ctl, edge_l, edge_s, row_ptr,
        row_edge, col_ptr, col_edge, edge_row, edge_pos, plan, B, L, J, E, Z,
        num_iters, alpha, use_alpha, beta, use_beta, check, stop_when_ok,
        mode);
  };
  if ((err = cudaMemsetAsync(ctl, 0, kCtlInts * sizeof(int), st))) return err;
  if ((err = launch(kRunFirst))) return err;
  if (stop_when_ok) {
    if ((err = launch(kRunResume))) return err;
  }
  onchip_finish<<<1, 1, 0, st>>>(ctl, num_iters, 1);
  if (stop_when_ok) {
    for (int i = 1; i < num_iters; ++i) {
      if ((err = launch(kRunStep))) return err;
      onchip_finish<<<1, 1, 0, st>>>(ctl, num_iters, 0);
    }
  }
  return cudaGetLastError();
}

}  // namespace ldpc
