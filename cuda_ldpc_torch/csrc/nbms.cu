// GF(q) max-domain decoders for codes given by their adjacency: flooding
// EMS (Nm = 2, Nc = 2, /1.2), flooding EMS at any other (Nm, Nc), flooding
// full EMS (every configuration, /1.2), flooding TMM (x0.8, accumulating
// totals), row-layered TMM and grouped-layered TMM, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_nbms.py `_kernel`
// (:376), which compiles EMS 2/2, TMM and layered TMM; full EMS (the
// reference's decoder_method 2), EMS at other (Nm, Nc) and grouped-layered
// TMM have no TPU kernel: the JAX package runs them in jnp
// (cuda_ldpc_tpu/ops/nb_decode.py :371 `_ems_full_cn_core`, :223
// `_ems_cn_core`, :603 the grouped-layered step).  It computes what
// ops/nb_decode.py's plain `decode` computes for 'ems' (any nm, nc the
// plain version takes), 'ems_full', 'tmm', 'layered_tmm' and
// 'glayered_tmm', operation for operation (the order is fixed there): per
// pass, the totals (EMS, full EMS: L + the c2v summed over the VN's edges
// in slot order; TMM: the state plus that sum; layered: the state as it
// stands), the decisions (argmax for EMS, argmin for TMM, the smallest
// symbol on ties), the true GF syndrome, then, if the frame goes on, every
// check row.  A frame whose syndrome passes at the entry of pass t reports
// t iterations; one that never passes reports num_iters with the decisions
// of the last pass.  TMM takes its channel already in the min domain (the
// wrapper applies nb_decode.to_min_domain).
//
// Design for the card, not a copy of the TPU tiles.  The TPU kernel runs
// each GF permutation and each per-frame XOR shift as [q, q] one-hot
// matmuls (and the TMM 2-deviation search through a [q, q, q] stack),
// because a lane gather serialises there.  Here both are index arithmetic
// on shared memory: lane y of an edge reads the VN-domain value at y / h (a
// division through the log/antilog tables) or the value at y ^ s, exactly.
// One block decodes one frame, all passes in one launch, and stops when its
// frame passes (per-frame freezing costs nothing, and the outputs equal a
// per-tile stop's).  The block holds `groups` row groups (qspa_common.cuh)
// of one warp per edge of a row; each group runs a row at a time, in a few
// phases separated by the group's own barrier, with its own scratch:
//   EMS: each warp computes its edge's CN-domain message U, its first
//   maximum c0, the delta profile W[y] = U[y ^ c0] - max and its best
//   non-zero offset; then warp `dout` takes the best single deviation of
//   the other edges at each offset (max over d != dout, the same values as
//   the JAX package's max1/max2/argmax trick), the pairs of other edges at
//   their best offsets, and writes c2v[k] = (D[h k ^ g0] - D[g0]) * f32(1/1.2).
//   EMS at (Nm, Nc) (ems_nmnc_row): the same U, W and single deviations,
//   then the branch the plain version takes (ems_branch): the set of each
//   edge's top Nm - 1 non-zero offsets in jax.lax.top_k's order (larger
//   first, ties by index; a coefficient-0 edge's W is mostly ties), as
//   first maxima or as the complement of the last ones, then for Nc = 2
//   the pairs of other edges over those offsets, for Nc >= dc - 1 full
//   EMS's chains over the clipped messages, for 3 <= Nc <= dc - 2 the
//   chains budgeted by deviation count, F_d[c] = max(F_{d-1}[c],
//   maxconv(F_{d-1}[c-1], dev_d)), whose states [2, dc, Nc + 1, q] (132 KB
//   a chain at q = 256, dc = 12, Nc = 10, beside the 74 KB of totals) live
//   in device memory: the wrapper launches as many blocks as the card
//   holds and gives each a set, and each block decodes every grid-th frame.
//   TMM: each warp computes its edge's first minimum, Zn = h * argmin and
//   dU[eta] = U[eta ^ Zn] - min; the group takes min1/min2/column per eta,
//   then the 2-deviation search (for each output eta a scan over j of
//   max(min1[j], min1[eta ^ j]), strict < so the first j wins, split over
//   the group's threads in ordered j ranges and merged in order, so the
//   first j wins whatever the split); warp `dout` writes c2v[k] = 0.8 *
//   Lc2p[h k ^ syn ^ Zn]; layered also writes the totals T + (fma(x, 0.8,
//   v2c) - T), the plain version's order.
// The rows of a pass come from the host's wave plan (ops/cuda_qspa
// .row_waves): flooding (the EMS modes, TMM) is one wave, every row at
// once over the groups (group g takes rows g, g + G, ...), since no row
// writes what another reads (EMS reads the totals, TMM accumulates them
// before the rows); layered TMM runs its dependency levels, the rows of a
// level over the groups and a block barrier between levels, so that every
// pair of rows that share a VN keeps its serial order and the result is
// the serial schedule's bit for bit; grouped-layered TMM is the same
// layered mode on the greedy row groups of nb_decode.row_groups (4 waves
// on BDS against 8 levels), whose rows share no VN, so the result is the
// plain grouped-layered step's bit for bit.  Measured on BDS.576.288.GF.64
// (NVIDIA H100, PERF.md), against one group running one row at a time:
// the row groups take EMS from 8.1 to 6.1 ms, TMM only from 11.0 to 10.7
// (its search keeps the SM's issue slots busy, whatever the rows in
// flight), and ran layered TMM slower, so the wrapper runs layered TMM on
// one group, in level order, and grouped-layered TMM too (9.80 ms on
// one group against 10.32 on 2 and 10.31 on 4).
// The totals T [N, q] live in shared memory, the c2v messages C [E, q] in
// the caller's device buffer [B, E, q]: with C beside T in shared memory a
// BDS.576.288.GF.64 block took 79 KB in the serial design, which left room
// for 2 blocks an SM instead of 7, and it ran 1.8-2x slower on the H100;
// with 1, 2 or 4 row groups it ran slower too (PERF.md).
//
// Arithmetic: adds, subtracts and multiplies through the __f*_rn
// intrinsics (nvcc cannot contract them), the one fused multiply-add as
// __fmaf_rn; max, min and the GF tables are exact.  So a (max,+) term is
// one __fadd_rn whatever split computes it; and in EMS's pairs, where the
// kernel adds an edge's offset to the other edge's whole clipped message,
// the terms the plain version does not form are NEG + a delta (~ -1e30),
// below every finite conf(q,1) value they meet, so no maximum changes.
//
// Bound: on BDS.576.288.GF.64 the TMM function needs q(q - 1)/2 = 2,016
// unordered 2-deviation candidates of 4 fp32 operations per row, 48 rows a
// pass, per frame (chip_smoke.nbms_bound_ms); the search here scans all
// q^2 ordered ones, so it does about twice the candidates the function
// needs.  EMS needs a dozen operations per edge and symbol; full EMS 3 dc
// - 6 convolutions of 2 q^2 operations per row (the kernel does 3 dc - 2,
// those with the identity too).  EMS at (Nm, Nc) needs a top-(Nm - 1)
// selection per edge (a tournament's q + (k - 1) log2 q compares, k =
// min(Nm - 1, q - Nm + 1); the kernel's k rounds cost a warp reduction
// each), the pairs' (Nm - 1)^2 terms per pair of edges, and chains whose
// messages hold Nm non-NEG values (2 q Nm operations a step: the kernel
// does 2 q^2, every u).  The budgeted chains need no level that equals
// another (a state of s messages is the same at every level >= s) and no
// term another dominates (the levels rise): an inner edge needs only its
// terms with nc - (dc - 1 - d) <= c <= d, 2 of the nc + 1 at nc = 10, dc
// = 12; the kernel computes every level and term.  The bytes are the
// channel and the decisions once per call; so operations bound it, and in
// practice the latency of each row's barriers and shuffle chains, which
// the row groups overlap.
//
// Built with -DNB_ROWS_PHASES (cuda_ldpc_torch/tools/nb_rows_phases.py),
// thread 0 of every block adds the clock64() cycles of each phase to
// g_nbms_clk[method] when the block ends (full EMS: its chains under
// kRpSearch, its exclusive convolutions under kRpMerge; EMS at (Nm, Nc):
// the single deviations and the selection under kRpMins, the pairs or the
// chains under kRpSearch, the exclusive convolutions under kRpMerge).

#include "qspa_common.cuh"

using namespace qspa;

namespace {

constexpr float kPos = 1e30f;
constexpr float kEmsScale = 0.833333313465118408203125f;  // f32(1 / 1.2)
constexpr float kTmmScale = 0.800000011920928955078125f;  // f32(0.8)

enum Method { kEms = 0, kTmm = 1, kLayeredTmm = 2, kEmsFull = 3,
              kEmsNmNc = 4 };
constexpr int kMethods = 5;

// The branch of nb_decode._ems_cn_core that EMS at (nm, nc) takes on rows
// of dc edges: conf(q,1) only; conf(q,1) and conf(nm,2) (the pairs); or
// conf(q,1) and conf(nm,nc) through (max,+) chains, unbudgeted for nc >=
// dc - 1, else budgeted by deviation count.
enum EmsBranch { kConf1 = 0, kPairs = 1, kChains = 2, kBudget = 3 };

__host__ __device__ inline int ems_branch(int nm, int nc, int dc) {
  if (nc < 2 || nm < 2 || dc < 3) return kConf1;
  if (nc == 2) return kPairs;
  return nc >= dc - 1 ? kChains : kBudget;
}

// Floats of one row group's budget states in device memory: the forward
// and backward chains F and Bk [dc, nc + 1, Q].
__host__ __device__ inline int64_t budget_floats(int q, int dc, int nc) {
  return 2LL * dc * (nc + 1) * q;
}

#ifdef NB_ROWS_PHASES
__device__ unsigned long long g_nbms_clk[kMethods][kRpCount];
#endif

// The last minimum of a q-vector spread over a warp (the largest symbol on
// ties), returned to every lane: the offset jax.lax.top_k ranks last.
template <int R>
__device__ __forceinline__ int group_arglast(const float (&x)[R], int lane) {
  float best = x[0];
  int arg = lane;
#pragma unroll
  for (int j = 1; j < R; ++j)
    if (x[j] <= best) {
      best = x[j];
      arg = lane + 32 * j;
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oa = __shfl_xor_sync(kFull, arg, o);
    if (ob < best || (ob == best && oa > arg)) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

// Floats of one row group's scratch: X and Y [max_dc, Q], A [max(max_dc,
// 7), Q] and the per-edge scalars [3 * 32] (full EMS: U, fwd and bwd [dc,
// Q] in X, Y and A).
__host__ __device__ inline int group_floats(int q, int max_dc) {
  return (2 * max_dc + (max_dc > 7 ? max_dc : 7)) * q + 3 * 32;
}

// Dynamic shared memory of one block: T [N, Q], each group's scratch, the
// GF tables and the decisions.
size_t smem_bytes(int N, int q, int max_dc, int groups) {
  return sizeof(float) * ((size_t)N * q +
                          (size_t)groups * group_floats(q, max_dc)) +
         sizeof(int) * ((size_t)q + 2 * (q - 1) + N);
}

// This lane's symbols y = lane + 32 j of an edge's v2c message in the CN
// domain: U[y] = (T - C)[vn][y / h]; a coefficient 0 puts the sum of the
// v2c at y = 0 and 0 elsewhere (nb_decode._to_cn_domain).  EMS and full
// EMS.
template <int R>
__device__ __forceinline__ void cn_domain_v2c(const float* T, const float* cp,
                                              int vn, int h, const int* lg,
                                              const int* ex, int lane,
                                              float (&u)[R]) {
  constexpr int Q = 32 * R;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int y = lane + 32 * j;
    const int a = h ? gf_div(lg, ex, y, h, Q) : y;
    u[j] = __fsub_rn(T[vn * Q + a], cp[a]);
  }
  if (!h) {
    const float s = group_rtree_sum<R, 32>(u);
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = (lane + 32 * j) == 0 ? s : 0.f;
  }
}

// One EMS check row (Nm = Nc = 2) on a row group; the group's warp w
// holds edge k0 + w.  Ends with the group's barrier.
template <int R, int kGroups>
__device__ __forceinline__ void ems_row(const RowGroup<kGroups>& grp,
                                        PhaseClock& pc,
                                        const float* T, float* Cb, float* X,
                                        float* Y, float* Dm, int* ei,
                                        float* ef, const int* lg,
                                        const int* ex, int k0, int dc,
                                        const int* __restrict__ edge_vn,
                                        const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int w = grp.tid >> 5, lane = grp.tid & 31;
  const bool mine = w < dc;
  int h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + w, vn = edge_vn[e];
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
    float u[R];
    cn_domain_v2c<R>(T, cp, vn, h, lg, ex, lane, u);
    const float v0 = group_max<R, 32>(u);
    const int c0 = group_argmax<R, 32>(u, lane);
    float* xw = X + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) xw[lane + 32 * j] = u[j];
    __syncwarp();
    float wv[R], w0[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      wv[j] = __fsub_rn(xw[y ^ c0], v0);
      Y[w * Q + y] = wv[j];
      w0[j] = y == 0 ? kNeg : wv[j];
    }
    const float p1 = group_max<R, 32>(w0);
    const int o1 = group_argmax<R, 32>(w0, lane);
    if (lane == 0) {
      ei[w] = c0;
      ei[32 + w] = o1;
      ef[w] = p1;
    }
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  if (mine) {
    // conf(q,1): the best single deviation of the other edges
    float D[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      float m = kNeg;
      bool first = true;
      for (int d = 0; d < dc; ++d) {
        if (d == w) continue;
        const float x = Y[d * Q + y];
        m = first ? x : fmaxf(m, x);
        first = false;
      }
      D[j] = m;
    }
    // conf(2,2): every pair of other edges at their best non-zero offsets
    if (dc >= 3) {
      for (int a = 0; a < dc; ++a) {
        if (a == w) continue;
        for (int b = a + 1; b < dc; ++b) {
          if (b == w) continue;
          const float val = __fadd_rn(ef[a], ef[b]);
          const int off = ei[32 + a] ^ ei[32 + b];
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (lane + 32 * j == off) D[j] = fmaxf(D[j], val);
        }
      }
    }
    int g0 = 0;
    for (int d = 0; d < dc; ++d) g0 ^= ei[d];
    g0 ^= ei[w];
    float* dw = Dm + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) dw[lane + 32 * j] = D[j];
    __syncwarp();
    const float d0 = dw[g0];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int idx = (h ? gf_mul(lg, ex, h, k) : 0) ^ g0;
      cp[k] = __fmul_rn(__fsub_rn(dw[idx], d0), kEmsScale);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

// out[x] = max_u A[u] + B[u ^ x] (x, u < Q) for `njobs` convolutions at
// once on a group's threads; operands(j, A, B, O) names job j's inputs and
// output, in shared or device memory, 16-byte aligned, O apart from A and
// B.  With kPrev, operands(j, A, B, O, P) also names P, and out[x] =
// max(P[x], max_u A[u] + B[u ^ x]); P may be O (each output tile is read
// and then written by the same lanes).  A unit
// is a tile of 4 outputs x0 + k of one job and one of S interleaved parts
// of the 4-symbol u tiles: for u = u0 + i, u ^ x = (u0 ^ x0) + (i ^ k), so
// one 16-byte load of A and one of B give 16 terms.  S, a power of 2 up to
// 32, uses threads that would idle; the S partial maxima of a tile sit on
// neighbouring lanes and meet by shuffles.  Each term is one add and the
// maxima are exact, so every split gives the plain version's bits.  All
// the group's threads call it (the shuffles need whole warps).
template <int Q, bool kPrev = false, class Operands>
__device__ __forceinline__ void maxconvs(int tid, int nth, int njobs,
                                         Operands&& operands) {
  constexpr int kTiles = Q / 4;
  int S = 1;
  while (2 * S <= 32 && 2 * S <= kTiles && 2 * S * njobs * kTiles <= nth)
    S *= 2;
  const int units = njobs * kTiles * S;
  for (int base = 0; base < units; base += nth) {  // the same trips a group
    const int unit = base + tid;
    const bool live = unit < units;
    const int part = unit % S, tile = (unit / S) % kTiles;
    const float ninf = -__int_as_float(0x7f800000);  // max's identity
    float acc[4] = {ninf, ninf, ninf, ninf};
    const float* A = nullptr;
    const float* B = nullptr;
    float* O = nullptr;
    if (live) {
      if constexpr (kPrev) {
        const float* P = nullptr;
        operands(unit / (S * kTiles), A, B, O, P);
        const float4 p4 = *reinterpret_cast<const float4*>(P + 4 * tile);
        acc[0] = p4.x;
        acc[1] = p4.y;
        acc[2] = p4.z;
        acc[3] = p4.w;
      } else {
        operands(unit / (S * kTiles), A, B, O);
      }
      const int x0 = 4 * tile;
      for (int t = part; t < kTiles; t += S) {
        const float4 a4 = *reinterpret_cast<const float4*>(A + 4 * t);
        const float4 b4 = *reinterpret_cast<const float4*>(B + ((4 * t) ^ x0));
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[k] = fmaxf(acc[k], __fadd_rn(a[i], b[i ^ k]));
      }
    }
    for (int o = S / 2; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = fmaxf(acc[k], __shfl_xor_sync(kFull, acc[k], o));
    if (live && part == 0)
      *reinterpret_cast<float4*>(O + 4 * tile) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// One full-EMS check row on a row group (nb_decode._ems_full_cn_core): the
// group's warp w holds edge k0 + w; U [dc, Q] in X, then excl over it; fwd
// [dc, Q] in Y, bwd [dc, Q] in A.  Ends with the group's barrier.
template <int R, int kGroups>
__device__ __forceinline__ void ems_full_row(const RowGroup<kGroups>& grp,
                                             PhaseClock& pc, const float* T,
                                             float* Cb, float* X, float* Y,
                                             float* A, const int* lg,
                                             const int* ex, int k0, int dc,
                                             const int* __restrict__ edge_vn,
                                             const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int tid = grp.tid, nth = grp.nth;
  const int w = tid >> 5, lane = tid & 31;
  const bool mine = w < dc;
  int h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + w;
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
    float u[R];
    cn_domain_v2c<R>(T, cp, edge_vn[e], h, lg, ex, lane, u);
#pragma unroll
    for (int j = 0; j < R; ++j) X[w * Q + lane + 32 * j] = u[j];
  }
  for (int y = tid; y < Q; y += nth) {  // fwd[0] and bwd[dc - 1]: identity
    const float id = y == 0 ? 0.f : kNeg;
    Y[y] = id;
    A[(dc - 1) * Q + y] = id;
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  for (int s = 0; s + 1 < dc; ++s) {
    const int d = dc - 1 - s;
    maxconvs<Q>(tid, nth, 2, [&](int job, const float*& a, const float*& b,
                                 float*& o) {
      if (job == 0) {  // fwd[s + 1] = maxconv(fwd[s], U[s])
        a = Y + s * Q;
        b = X + s * Q;
        o = Y + (s + 1) * Q;
      } else {         // bwd[d - 1] = maxconv(bwd[d], U[d])
        a = A + d * Q;
        b = X + d * Q;
        o = A + (d - 1) * Q;
      }
    });
    pc.stamp(kRpSearch);
    grp.sync();
    pc.stamp(kRpRowWait);
  }
  // excl[d] = maxconv(fwd[d], bwd[d]), over U[d]
  maxconvs<Q>(tid, nth, dc, [&](int job, const float*& a, const float*& b,
                                float*& o) {
    a = Y + job * Q;
    b = A + job * Q;
    o = X + job * Q;
  });
  pc.stamp(kRpMerge);
  grp.sync();
  pc.stamp(kRpRowWait);
  if (mine) {
    const float* xw = X + w * Q;
    const float e0 = xw[0];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int idx = h ? gf_mul(lg, ex, h, k) : 0;
      cp[k] = __fmul_rn(__fsub_rn(xw[idx], e0), kEmsScale);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

// One EMS check row at any (nm, nc) on a row group (nb_decode._ems_cn_core,
// the branch ems_branch names); the group's warp w holds edge k0 + w, and
// St is the group's budget states in device memory (kBudget only).
//   1. each warp: U (into X), c0 and W[y] = U[y ^ c0] - max (into Y);
//   2. each warp: D = conf(q,1) for its output, in registers (as ems_row),
//      and, but for kConf1, the set of the top K = nm - 1 offsets of W0 (W
//      with offset 0 at NEG) in jax.lax.top_k's order (value down, index
//      up): K first maxima of the offsets not taken yet, or, for K >
//      Q / 2, the offsets but the Q - K last (smallest value, largest
//      index);
//      dev[y] = W0[y] where taken, NEG elsewhere, into A (kChains: max(dev,
//      identity)), and for kPairs the taken offsets listed in index order
//      (into X, as ints; only the set matters to the pairs' maxima);
//   3. kPairs: for each pair a < b of other edges and each listed offset o
//      of a, D[x] = max(D[x], dev_a[o] + dev_b[o ^ x]): where o ^ x is
//      taken this is the plain version's P_a + P_b at offset x, and where
//      it is not, dev_b = NEG and the term (~ -1e30) cannot reach D[x],
//      a finite conf(q,1) value, so the maximum is the plain version's;
//      kChains: ems_full_row's chains and exclusive convolutions over the
//      messages in A (fwd in Y, bwd in X, excl into A); kBudget: F_d[c] =
//      max(F_{d-1}[c], maxconv(F_{d-1}[c-1], dev_d)) for c = 1 .. nc, both
//      chains a step a phase in St, then excl[d] = the max over c of
//      maxconv(F_d[c], Bk_d[nc - c]), c = 0 upwards, into X; then D =
//      max(D, excl);
//   4. c2v[k] = (D[h k ^ g0] - D[g0]) * f32(1/1.2), as ems_row.
// Each term is one __fadd_rn and every maximum is exact, so any split of
// the terms gives the plain version's bits.  Ends with the group's
// barrier.
template <int R, int kGroups>
__device__ __forceinline__ void ems_nmnc_row(
    const RowGroup<kGroups>& grp, PhaseClock& pc, const float* T, float* Cb,
    float* X, float* Y, float* A, int* ei, const int* lg, const int* ex,
    int k0, int dc, int nm, int nc, float* St,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int tid = grp.tid, nth = grp.nth;
  const int w = tid >> 5, lane = tid & 31;
  const bool mine = w < dc;
  const int branch = ems_branch(nm, nc, dc);
  const int K = nm - 1;
  int h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + w;
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
    float u[R];
    cn_domain_v2c<R>(T, cp, edge_vn[e], h, lg, ex, lane, u);
    const float v0 = group_max<R, 32>(u);
    const int c0 = group_argmax<R, 32>(u, lane);
    float* xw = X + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) xw[lane + 32 * j] = u[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      Y[w * Q + y] = __fsub_rn(xw[y ^ c0], v0);
    }
    if (lane == 0) ei[w] = c0;
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  float D[R];
  if (mine) {
    // conf(q,1): the best single deviation of the other edges
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      float m = kNeg;
      bool first = true;
      for (int d = 0; d < dc; ++d) {
        if (d == w) continue;
        const float x = Y[d * Q + y];
        m = first ? x : fmaxf(m, x);
        first = false;
      }
      D[j] = m;
    }
    if (branch != kConf1) {
      const float* yw = Y + w * Q;
      float v[R];
      bool taken[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int y = lane + 32 * j;
        v[j] = y == 0 ? kNeg : yw[y];
        taken[j] = K >= Q;
      }
      // top_k's order is (value down, index up); the top K are found as K
      // first maxima or, for K > Q / 2, as all but the Q - K last
      // (smallest value, largest index), a warp reduction a round
      if (K < Q) {
        const int rounds = K < Q - K ? K : Q - K;
        const bool up = K <= Q - K;
        const float gone = up ? -__int_as_float(0x7f800000)
                              : __int_as_float(0x7f800000);
        float cur[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          cur[j] = v[j];
          taken[j] = !up;
        }
        for (int k = 0; k < rounds; ++k) {
          const int o = up ? group_argmax<R, 32>(cur, lane)
                           : group_arglast<R>(cur, lane);
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (lane + 32 * j == o) {
              cur[j] = gone;
              taken[j] = up;
            }
        }
      }
      int* ow = reinterpret_cast<int*>(X + w * Q);
      int listed = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int y = lane + 32 * j;
        const float dv = taken[j] ? v[j] : kNeg;
        A[w * Q + y] = branch == kChains ? fmaxf(dv, y == 0 ? 0.f : kNeg)
                                         : dv;
        // the pairs' list: the taken offsets in index order
        const unsigned m = __ballot_sync(kFull, taken[j]);
        if (branch == kPairs && taken[j])
          ow[listed + __popc(m & ((1u << lane) - 1))] = y;
        listed += __popc(m);
      }
    }
  }
  pc.stamp(kRpMins);
  float* dw = X + w * Q;  // where the warp puts D for its output's gather
  if (branch != kConf1) {
    grp.sync();
    pc.stamp(kRpRowWait);
  }
  if (branch == kPairs) {
    if (mine) {
      for (int a = 0; a < dc; ++a) {
        if (a == w) continue;
        const int* oa = reinterpret_cast<const int*>(X + a * Q);
        const float* da = A + a * Q;
        for (int b = a + 1; b < dc; ++b) {
          if (b == w) continue;
          const float* db = A + b * Q;
          for (int ka = 0; ka < K; ++ka) {
            const int o = oa[ka];
            const float p = da[o];
#pragma unroll
            for (int j = 0; j < R; ++j)
              D[j] = fmaxf(D[j], __fadd_rn(p, db[o ^ (lane + 32 * j)]));
          }
        }
      }
    }
    dw = Y + w * Q;
    pc.stamp(kRpSearch);
  } else if (branch == kChains) {
    for (int y = tid; y < Q; y += nth) {  // fwd[0] and bwd[dc - 1]
      const float id = y == 0 ? 0.f : kNeg;
      Y[y] = id;
      X[(dc - 1) * Q + y] = id;
    }
    grp.sync();
    pc.stamp(kRpRowWait);
    for (int s = 0; s + 1 < dc; ++s) {
      const int d = dc - 1 - s;
      maxconvs<Q>(tid, nth, 2, [&](int job, const float*& a, const float*& b,
                                   float*& o) {
        if (job == 0) {  // fwd[s + 1] = maxconv(fwd[s], msg[s])
          a = Y + s * Q;
          b = A + s * Q;
          o = Y + (s + 1) * Q;
        } else {         // bwd[d - 1] = maxconv(bwd[d], msg[d])
          a = X + d * Q;
          b = A + d * Q;
          o = X + (d - 1) * Q;
        }
      });
      pc.stamp(kRpSearch);
      grp.sync();
      pc.stamp(kRpRowWait);
    }
    maxconvs<Q>(tid, nth, dc, [&](int job, const float*& a, const float*& b,
                                  float*& o) {
      a = Y + job * Q;
      b = X + job * Q;
      o = A + job * Q;
    });
    pc.stamp(kRpMerge);
    grp.sync();
    pc.stamp(kRpRowWait);
    dw = A + w * Q;
  } else if (branch == kBudget) {
    const int L1 = nc + 1;
    float* F = St;
    float* Bk = St + (int64_t)dc * L1 * Q;
    // level 0 of every position, and every level of F[0] and Bk[dc - 1],
    // is the identity
    for (int i = tid; i < dc * L1 * Q; i += nth) {
      const int y = i % Q, c = (i / Q) % L1, d = i / (Q * L1);
      const float id = y == 0 ? 0.f : kNeg;
      if (d == 0 || c == 0) F[i] = id;
      if (d == dc - 1 || c == 0) Bk[i] = id;
    }
    grp.sync();
    pc.stamp(kRpRowWait);
    for (int s = 0; s + 1 < dc; ++s) {
      const int d = dc - 1 - s;
      maxconvs<Q, true>(tid, nth, 2 * nc,
                        [&](int job, const float*& a, const float*& b,
                            float*& o, const float*& p) {
        if (job < nc) {  // F[s + 1][c], c = job + 1
          const int c = job + 1;
          a = F + (s * L1 + c - 1) * Q;
          b = A + s * Q;
          o = F + ((s + 1) * L1 + c) * Q;
          p = F + (s * L1 + c) * Q;
        } else {         // Bk[d - 1][c], c = job - nc + 1
          const int c = job - nc + 1;
          a = Bk + (d * L1 + c - 1) * Q;
          b = A + d * Q;
          o = Bk + ((d - 1) * L1 + c) * Q;
          p = Bk + (d * L1 + c) * Q;
        }
      });
      pc.stamp(kRpSearch);
      grp.sync();
      pc.stamp(kRpRowWait);
    }
    maxconvs<Q>(tid, nth, dc, [&](int job, const float*& a, const float*& b,
                                  float*& o) {
      a = F + job * L1 * Q;
      b = Bk + (job * L1 + nc) * Q;
      o = X + job * Q;
    });
    pc.stamp(kRpMerge);
    grp.sync();
    pc.stamp(kRpRowWait);
    for (int c = 1; c <= nc; ++c) {
      maxconvs<Q, true>(tid, nth, dc,
                        [&](int job, const float*& a, const float*& b,
                            float*& o, const float*& p) {
        a = F + (job * L1 + c) * Q;
        b = Bk + (job * L1 + nc - c) * Q;
        o = X + job * Q;
        p = o;
      });
      pc.stamp(kRpMerge);
      grp.sync();
      pc.stamp(kRpRowWait);
    }
  }
  if (mine) {
    if (branch == kChains || branch == kBudget)
#pragma unroll
      for (int j = 0; j < R; ++j) D[j] = fmaxf(D[j], dw[lane + 32 * j]);
    int g0 = 0;
    for (int d = 0; d < dc; ++d) g0 ^= ei[d];
    g0 ^= ei[w];
#pragma unroll
    for (int j = 0; j < R; ++j) dw[lane + 32 * j] = D[j];
    __syncwarp();
    const float d0 = dw[g0];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int idx = (h ? gf_mul(lg, ex, h, k) : 0) ^ g0;
      cp[k] = __fmul_rn(__fsub_rn(dw[idx], d0), kEmsScale);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

// One TMM check row on a row group; the group's warp w holds edge k0 + w.
// Layered also writes the row's totals.  Ends with the group's barrier.
template <int R, bool kLayered, int kGroups>
__device__ __forceinline__ void tmm_row(const RowGroup<kGroups>& grp,
                                        PhaseClock& pc,
                                        float* T, float* Cb, float* X,
                                        float* Y, float* A, int* ei,
                                        const int* lg, const int* ex, int k0,
                                        int dc,
                                        const int* __restrict__ edge_vn,
                                        const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int tid = grp.tid, nth = grp.nth;
  const int w = tid >> 5, lane = tid & 31;
  const bool mine = w < dc;
  int h = 0, vn = 0, zn = 0;
  float* cp = Cb;
  float v[R];
  if (mine) {
    const int e = k0 + w;
    vn = edge_vn[e];
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      v[j] = __fsub_rn(T[vn * Q + y], cp[y]);
    }
    const float vmin = group_min<R, 32>(v);
    zn = h ? gf_mul(lg, ex, h, group_argmin<R, 32>(v, lane)) : 0;
    float* xw = X + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j) xw[lane + 32 * j] = v[j];
    const float s = h ? 0.f : group_rtree_sum<R, 32>(v);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = lane + 32 * j;
      // U[y ^ Zn] with U[y'] = v2c[y' / h]; coefficient 0: U[0] = the sum
      // of v2c, U[y' != 0] = 0, and Zn = 0
      const float uz = h ? xw[gf_div(lg, ex, y ^ zn, h, Q)]
                         : (y == 0 ? s : 0.f);
      Y[w * Q + y] = __fsub_rn(uz, vmin);
    }
    if (lane == 0) ei[w] = zn;
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  // min1, min2 and the first column of min1, per eta, over the row's edges
  float* min1 = A;
  float* min2 = A + Q;
  int* col = reinterpret_cast<int*>(A + 2 * Q);
  for (int eta = tid; eta < Q; eta += nth) {
    float m1 = Y[eta], m2 = kPos;
    int c = 0;
    for (int d = 1; d < dc; ++d) {
      const float x = Y[d * Q + eta];
      const bool lt = x < m1;
      m2 = lt ? m1 : fminf(m2, x);
      c = lt ? d : c;
      m1 = fminf(m1, x);
    }
    min1[eta] = m1;
    min2[eta] = m2;
    col[eta] = c;
  }
  pc.stamp(kRpMins);
  grp.sync();
  pc.stamp(kRpRowWait);
  // 2-deviation search: S ordered j ranges per output eta, in X (the best
  // value) and Y (its two columns, packed); X and Y are free now
  int S = 1;
  while (2 * S * Q <= nth && 2 * S <= Q) S *= 2;
  int* packed = reinterpret_cast<int*>(Y);
  for (int slot = tid; slot < S * Q; slot += nth) {
    const int i = slot % Q, part = slot / Q, span = Q / S;
    float I2 = kPos;
    int best = 0;
    for (int jj = part * span; jj < (part + 1) * span; ++jj) {
      const float vj = min1[jj], mk = min1[i ^ jj];
      const int cj = col[jj], ck = col[i ^ jj];
      const bool valid = cj != ck && vj != mk && i != jj;
      const float cand = valid ? fmaxf(vj, mk) : kPos;
      if (cand < I2) {
        I2 = cand;
        best = cj | (ck << 16);
      }
    }
    X[slot] = I2;
    packed[slot] = best;
  }
  pc.stamp(kRpSearch);
  grp.sync();
  pc.stamp(kRpRowWait);
  float* Iv = A + 3 * Q;
  float* Ev = A + 4 * Q;
  int* p1 = reinterpret_cast<int*>(A + 5 * Q);
  int* p2 = reinterpret_cast<int*>(A + 6 * Q);
  for (int i = tid; i < Q; i += nth) {
    float I2 = X[i];
    int best = packed[i];
    for (int part = 1; part < S; ++part)
      if (X[part * Q + i] < I2) {  // strict: the earlier j range wins ties
        I2 = X[part * Q + i];
        best = packed[part * Q + i];
      }
    const bool use2 = I2 < min1[i];
    Iv[i] = use2 ? I2 : min1[i];
    Ev[i] = use2 ? min1[i] : min2[i];
    p1[i] = use2 ? (best & 0xffff) : col[i];
    p2[i] = use2 ? (best >> 16) : col[i];
  }
  pc.stamp(kRpMerge);
  grp.sync();
  pc.stamp(kRpRowWait);
  if (mine) {
    int syn = 0;
    for (int d = 0; d < dc; ++d) syn ^= ei[d];
    const int beta = syn ^ zn;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int eta = (h ? gf_mul(lg, ex, h, k) : 0) ^ beta;
      const float x =
          eta == 0 ? 0.f
                   : ((p1[eta] == w || p2[eta] == w) ? Ev[eta] : Iv[eta]);
      if (kLayered) {
        float* tp = T + vn * Q + k;
        *tp = __fadd_rn(*tp, __fsub_rn(__fmaf_rn(x, kTmmScale, v[j]), *tp));
      }
      cp[k] = __fmul_rn(kTmmScale, x);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

template <int R, int kMethod, int kGroups>
__global__ void __launch_bounds__(kGroups == 1 ? 1024 : kGroupedThreads,
                                  kGroups == 1 ? 1 : kGroupedBlocks)
    nbms_kernel(
    const float* __restrict__ chan, float* __restrict__ C,
    int* __restrict__ hard, unsigned char* __restrict__ ok,
    int* __restrict__ iters, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edge,
    const int* __restrict__ gf_log, const int* __restrict__ gf_exp,
    const int* __restrict__ wave_ptr, const int* __restrict__ wave_row,
    int nwaves, int groups, int B, int N, int M, int E, int max_dc,
    int num_iters, int nm, int nc, float* St) {
  constexpr int Q = 32 * R;
  // the EMS modes: positive-domain LLRs, the totals from L each pass
  constexpr bool kEmsLike =
      kMethod == kEms || kMethod == kEmsFull || kMethod == kEmsNmNc;
  extern __shared__ __align__(16) float smem[];
  const RowGroup<kGroups> grp = row_group<kGroups>(groups);
  const int gf = group_floats(Q, max_dc);
  float* T = smem;
  float* X = T + N * Q + (grp.id ? grp.id - 1 : 0) * gf;
  float* Y = X + max_dc * Q;
  float* A = Y + max_dc * Q;
  float* ef = A + (max_dc > 7 ? max_dc : 7) * Q;
  int* ei = reinterpret_cast<int*>(ef + 32);
  int* lg = reinterpret_cast<int*>(T + N * Q + groups * gf);
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  const int tid = threadIdx.x, nth = blockDim.x;
  // EMS at (nm, nc), budgeted: this block's group's chains in device memory
  float* Sg = kMethod == kEmsNmNc && St
                  ? St + ((int64_t)blockIdx.x * groups +
                          (grp.id ? grp.id - 1 : 0)) *
                             budget_floats(Q, max_dc, nc)
                  : nullptr;
  ROWS_PHASE_CLOCK(pc)

  load_gf_tables(lg, ex, gf_log, gf_exp, Q);
  // One frame, all its passes; returns when the frame stops.
  auto frame = [&](int64_t b) {
    const float* L = chan + b * N * Q;
    float* Cb = C + b * E * Q;
    for (int i = tid; i < E * Q; i += nth) Cb[i] = 0.f;
    if (!kEmsLike)
      for (int i = tid; i < N * Q; i += nth) T[i] = L[i];
    __syncthreads();
    pc.stamp(kRpSetup);

    for (int t = 0;; ++t) {
      if (kEmsLike) {
        frame_totals<Q>(T, L, Cb, col_ptr, col_edge, N);
        __syncthreads();
        pc.stamp(kRpTotals);
      } else if (kMethod == kTmm) {  // the state accumulates the c2v sum
        frame_totals<Q>(T, T, Cb, col_ptr, col_edge, N);
        __syncthreads();
        pc.stamp(kRpTotals);
      }
      const int bad = frame_decide_check<R, !kEmsLike>(
          T, hs, lg, ex, row_ptr, edge_vn, edge_h, N, M);
      pc.stamp(kRpDecide);
      if (!bad || t + 1 >= num_iters) {
        for (int n = tid; n < N; n += nth) hard[b * N + n] = hs[n];
        if (tid == 0) {
          ok[b] = bad ? 0 : 1;
          iters[b] = bad ? num_iters : t;
        }
        pc.stamp(kRpExit);
        return;
      }
      walk_waves(groups, wave_ptr, wave_row, nwaves, pc, [&](int m) {
        const int k0 = row_ptr[m], dc = row_ptr[m + 1] - k0;
        if (kMethod == kEms)
          ems_row<R, kGroups>(grp, pc, T, Cb, X, Y, A, ei, ef, lg, ex, k0,
                              dc, edge_vn, edge_h);
        else if (kMethod == kEmsFull)
          ems_full_row<R, kGroups>(grp, pc, T, Cb, X, Y, A, lg, ex, k0, dc,
                                   edge_vn, edge_h);
        else if (kMethod == kEmsNmNc)
          ems_nmnc_row<R, kGroups>(grp, pc, T, Cb, X, Y, A, ei, lg, ex, k0,
                                   dc, nm, nc, Sg, edge_vn, edge_h);
        else
          tmm_row<R, kMethod == kLayeredTmm, kGroups>(
              grp, pc, T, Cb, X, Y, A, ei, lg, ex, k0, dc, edge_vn, edge_h);
      });
    }
  };
  if constexpr (kMethod == kEmsNmNc) {
    // a grid of up to B blocks: frames blockIdx.x, + gridDim.x, ...
    for (int64_t b = blockIdx.x; b < B; b += gridDim.x) frame(b);
  } else {
    frame(blockIdx.x);  // a block a frame
  }
  ROWS_PHASE_FLUSH(pc, g_nbms_clk[kMethod])
}

// The kernel for R, the method and the number of groups: the one-group
// instantiation (no named barrier) for one group, else kMaxGroups'.
template <int R>
auto kernel_for(int method, int groups) {
  const bool one = groups == 1;
  return method == kEms
             ? (one ? nbms_kernel<R, kEms, 1> : nbms_kernel<R, kEms, kMaxGroups>)
         : method == kEmsFull
             ? (one ? nbms_kernel<R, kEmsFull, 1>
                    : nbms_kernel<R, kEmsFull, kMaxGroups>)
         : method == kEmsNmNc
             ? (one ? nbms_kernel<R, kEmsNmNc, 1>
                    : nbms_kernel<R, kEmsNmNc, kMaxGroups>)
         : method == kTmm
             ? (one ? nbms_kernel<R, kTmm, 1> : nbms_kernel<R, kTmm, kMaxGroups>)
             : (one ? nbms_kernel<R, kLayeredTmm, 1>
                    : nbms_kernel<R, kLayeredTmm, kMaxGroups>);
}

template <int R>
cudaError_t launch(const float* chan, float* C, int* hard, unsigned char* ok,
                   int* iters, const int* row_ptr, const int* edge_vn,
                   const int* edge_h, const int* col_ptr, const int* col_edge,
                   const int* gf_log, const int* gf_exp, const int* wave_ptr,
                   const int* wave_row, int nwaves, int groups, int B, int N,
                   int M, int E, int max_dc, int num_iters, int method,
                   int nm, int nc, float* scratch, int grid,
                   cudaStream_t st) {
  auto kernel = kernel_for<R>(method, groups);
  const size_t smem = smem_bytes(N, 32 * R, max_dc, groups);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<grid, 32 * max_dc * groups, smem, st>>>(
      chan, C, hard, ok, iters, row_ptr, edge_vn, edge_h, col_ptr, col_edge,
      gf_log, gf_exp, wave_ptr, wave_row, nwaves, groups, B, N, M, E, max_dc,
      num_iters, nm, nc, scratch);
  return cudaGetLastError();
}

// Blocks an SM holds of the kernel for R, the method and the groups.
template <int R>
int blocks_per_sm(int method, int groups, int N, int max_dc) {
  auto kernel = kernel_for<R>(method, groups);
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

}  // namespace

extern "C" {

// Decodes the batch chan [B, N, q] (q in 32, 64, 128, 256; 2 <= max_dc <=
// 32 edges per row) for at most `num_iters` >= 1 passes on `stream` of CUDA
// device `device`, with `method` 0 = EMS (nm = nc = 2), 3 = full EMS, 4 =
// EMS at (nm, nc) (positive-domain LLRs), 1 = TMM, 2 = layered TMM
// (min-domain LLRs; serial-row or grouped, by the wave plan), on `groups`
// row groups (1 to 7; one group at most 1024 threads, more at most 512)
// walking the rows of the wave plan wave_ptr [nwaves + 1], wave_row [M]
// (ops/cuda_qspa.row_waves), with `grid` blocks
// (1 to B), block i decoding frames i, i + grid, ....  C [B, E, q] is the
// caller's scratch; hard [B, N], ok [B] and iters [B] the outputs; method
// 4 takes nc >= 1 and, where its rows take the top nm - 1 offsets of an
// edge (nc >= 2, nm >= 2, max_dc >= 3), nm - 1 <= q, and where they are
// budgeted (3 <= nc <= max_dc - 2) `scratch`, grid * groups *
// budget_floats(q, max_dc, nc) floats of device memory.  nm, nc and
// scratch are ignored by the other methods.  The tables are those of
// ldpc_qspa.  Returns 0 or the first CUDA error met while enqueueing.
int ldpc_nbms(const float* chan, float* C, int* hard, unsigned char* ok,
              int* iters, const int* row_ptr, const int* edge_vn,
              const int* edge_h, const int* col_ptr, const int* col_edge,
              const int* gf_log, const int* gf_exp, const int* wave_ptr,
              const int* wave_row, int nwaves, int groups, int B, int N,
              int M, int E, int q, int max_dc, int num_iters, int method,
              int nm, int nc, float* scratch, int grid, int device,
              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (max_dc < 2 || max_dc > 32 || method < 0 || method >= kMethods ||
      groups < 1 || groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads) ||
      grid < 1 || grid > B)
    return cudaErrorInvalidValue;
  if (method == kEmsNmNc) {
    const int branch = ems_branch(nm, nc, max_dc);
    if (nc < 1 || (branch != kConf1 && nm - 1 > q) ||
        (branch == kBudget && !scratch))
      return cudaErrorInvalidValue;
  } else {
    scratch = nullptr;
  }
#define NBMS_LAUNCH(R)                                                    \
  return launch<R>(chan, C, hard, ok, iters, row_ptr, edge_vn, edge_h,    \
                   col_ptr, col_edge, gf_log, gf_exp, wave_ptr, wave_row, \
                   nwaves, groups, B, N, M, E, max_dc, num_iters, method, \
                   nm, nc, scratch, grid, st)
  switch (q) {
    case 32: NBMS_LAUNCH(1);
    case 64: NBMS_LAUNCH(2);
    case 128: NBMS_LAUNCH(4);
    case 256: NBMS_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef NBMS_LAUNCH
}

// Blocks of the kernel an SM of CUDA device `device` holds for q, the
// method, the groups, N and max_dc (as ldpc_nbms takes them); -1 on a bad
// argument or a CUDA error.
int ldpc_nbms_blocks_per_sm(int q, int method, int groups, int N, int max_dc,
                            int device) {
  if (cudaSetDevice(device) || max_dc < 2 || max_dc > 32 || method < 0 ||
      method >= kMethods || groups < 1 || groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads))
    return -1;
  switch (q) {
    case 32: return blocks_per_sm<1>(method, groups, N, max_dc);
    case 64: return blocks_per_sm<2>(method, groups, N, max_dc);
    case 128: return blocks_per_sm<4>(method, groups, N, max_dc);
    case 256: return blocks_per_sm<8>(method, groups, N, max_dc);
    default: return -1;
  }
}

#ifdef NB_ROWS_PHASES
// Copies the phase counters [kMethods][kRpCount] (by method id) into out
// and zeroes them.
int ldpc_nbms_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_nbms_clk, sizeof(g_nbms_clk));
  if (err) return err;
  unsigned long long zero[kMethods][kRpCount] = {};
  return cudaMemcpyToSymbol(g_nbms_clk, zero, sizeof(zero));
}
#endif

}  // extern "C"
