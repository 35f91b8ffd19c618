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
//   Full EMS (ems_full_row): each warp its edge's U; the forward and
//   backward (max,+) chains a step of each a phase, then the inner edges'
//   exclusive convolutions (chains).  A convolution with the identity (0
//   at symbol 0, NEG elsewhere) has one term above NEG, 0 + B[x] (every
//   other is NEG plus a value far below ulp(NEG) / 2 ~ 3.8e22, which rounds
//   to NEG or below), so fwd[1], bwd[dc - 2] and the end edges' exclusive
//   values are copies, 0 + B[x] (B's bits, a -0 made +0 as the plain
//   version's add makes it): 3 dc - 6 convolutions a row, not 3 dc - 2, and
//   no phase for step 0.
//   EMS at (Nm, Nc) (ems_nmnc_row): the same U, W and single deviations,
//   then the branch the plain version takes (ems_branch): the set of each
//   edge's top Nm - 1 non-zero offsets in jax.lax.top_k's order (larger
//   first, ties by index; a coefficient-0 edge's W is mostly ties), as
//   first maxima or as the complement of the last ones, each a round of
//   two redux.sync reductions (top_offsets), then for Nc = 2 the pairs of
//   other edges over those offsets, for Nc >= dc - 1 full EMS's chains
//   over the clipped messages, for 3 <= Nc <= dc - 2 the chains budgeted
//   by deviation count, F_d[c] = max(F_{d-1}[c], maxconv(F_{d-1}[c-1],
//   dev_d)) (budget_chains).  A clipped message is NEG but at its Nm - 1
//   taken offsets (and, unbudgeted, offset 0): where those n entries are
//   few (4 n <= q) a chain's step runs over them, 2 q n operations against
//   2 q^2 (listed_convs, exact: the terms left out are at most NEG).  The
//   budgeted states keep only the levels the function reads, max(1, nc -
//   (dc - 1 - s)) .. min(s, nc) of a state of s messages (a state equals
//   its level s above it, and no step or exclusive term reads lower), and
//   each inner edge convolves only its terms nc - (dc - 1 - d) <= c <= d
//   (the others are equal or dominated: the levels rise), those at c = 0
//   and c = nc copies: at q = 256, dc = 12 the two chains take 40 to 72
//   vectors (20 to 36 KB each), so they live in the group's shared memory
//   beside the 111 KB block (156-189 KB at Nc 3 to 10), a block a frame.
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
// - 6 convolutions of 2 q^2 operations per row, the kernel's count (its
// earlier design, kEmsFullDense, did 3 dc - 2, those with the identity
// too).  EMS at (Nm, Nc) needs a top-(Nm - 1) selection per edge (a
// tournament's q + (k - 1) log2 q compares, k = min(Nm - 1, q - Nm + 1);
// the kernel's k rounds cost two warp reductions each, the earlier
// design's a 5-shuffle argmax each), the pairs' (Nm - 1)^2 terms per pair
// of edges, and chains whose messages hold Nm non-NEG values (2 q Nm
// operations a step: the kernel's listed steps do that where 4 Nm <= q,
// else 2 q^2, every u, as the earlier design always did).  The budgeted
// chains need only the levels and terms above, which is what the kernel
// computes (the earlier design computed every level and term).  The bytes
// are the channel and the decisions once per call; so operations bound
// it, and in practice the latency of each row's barriers and shuffle
// chains, which the row groups overlap.
//
// Built with -DNB_ROWS_PHASES (cuda_ldpc_torch/tools/nb_rows_phases.py),
// thread 0 of every block adds the clock64() cycles of each phase to
// g_nbms_clk[method] when the block ends (full EMS: its chains under
// kRpSearch, its exclusive convolutions under kRpMerge; EMS at (Nm, Nc):
// the single deviations and the selection under kRpMins, the pairs or the
// chains under kRpSearch, the exclusive convolutions under kRpMerge; the
// yardstick's modes under their own method ids, 5 and 6).

#include "qspa_common.cuh"

using namespace qspa;

namespace {

constexpr float kPos = 1e30f;
constexpr float kEmsScale = 0.833333313465118408203125f;  // f32(1 / 1.2)
constexpr float kTmmScale = 0.800000011920928955078125f;  // f32(0.8)

// kEmsFullDense and kEmsNmNcDense are the earlier designs of kEmsFull and
// kEmsNmNc (every convolution, the identity's too; every budget level and
// term, in device memory), kept as the yardstick the new ones are timed
// and held against; nothing on the decode path launches them.
// kEmsNmNcListed is not a method of the API: it is the instantiation the
// launch picks for kEmsNmNc when the rows' chains take listed messages
// (listed_entries), so that neither instantiation carries the other's
// steps, and the budgeted chains are compiled into one-group blocks only
// (the wrapper runs them on one group).  On BDS.576.288.GF.64 (B=4096,
// 10 passes; NVIDIA H100, tools/nb_rows_phases.py, PERF.md) the same rows
// built as one instantiation for every branch took 64/3 19.65 ms and 8/3
// 17.90, split 15.91 and 12.93: the grouped blocks' 40 registers spilled
// more around the code of the branches a launch does not take.
enum Method { kEms = 0, kTmm = 1, kLayeredTmm = 2, kEmsFull = 3,
              kEmsNmNc = 4, kEmsFullDense = 5, kEmsNmNcDense = 6,
              kEmsNmNcListed = 7 };
constexpr int kMethods = 7;  // the API's methods, 0 .. kEmsNmNcDense

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

// Entries n of a message whose chains' steps run over its listed offsets,
// where they are few (4 n <= q): the unbudgeted chains' offset 0 and nm -
// 1 taken offsets, the budgeted chains' nm - 1; 0 where the rows take
// dense steps or no chains.
__host__ __device__ inline int listed_entries(int nm, int nc, int q,
                                              int dc) {
  const int branch = ems_branch(nm, nc, dc);
  const int n = branch == kChains ? nm : nm - 1;
  return (branch == kChains || branch == kBudget) && 4 * n <= q ? n : 0;
}

// The budgeted chains keep, of a state of s messages (s = 1 .. dc - 1, F_s
// forward, Bk_{dc - 1 - s} backward), only its levels level_lo .. level_hi:
// F_s[c] = F_s[s] for c > s, level 0 is the identity, and no exclusive
// term or later step reads a level below nc - (dc - 1 - s).
__host__ __device__ inline int level_lo(int s, int nc, int dc) {
  return nc - (dc - 1 - s) > 1 ? nc - (dc - 1 - s) : 1;
}
__host__ __device__ inline int level_hi(int s, int nc) {
  return s < nc ? s : nc;
}
// Vectors [Q] before state s's first kept level: the sum over s' < s of
// level_hi - level_lo + 1, in closed form (sum min(s', nc) less the
// triangle of the levels below level_lo).
__host__ __device__ inline int level_base(int s, int nc, int dc) {
  const int n = s - 1, m = s + nc - dc - 1;
  const int mins = n <= nc ? n * (n + 1) / 2
                           : nc * (nc + 1) / 2 + (n - nc) * nc;
  return mins - (m > 0 ? m * (m + 1) / 2 : 0);
}

// Floats of one row group's budget region in shared memory (kEmsNmNc): the
// identity [Q], then F's and Bk's kept levels [level_base(dc), Q] each.
__host__ __device__ inline int budget_floats(int q, int dc, int nc) {
  return (1 + 2 * level_base(dc, nc, dc)) * q;
}

// Floats of one row group's budget states in device memory (kEmsNmNcDense):
// the forward and backward chains F and Bk [dc, nc + 1, Q].
__host__ __device__ inline int64_t dense_budget_floats(int q, int dc,
                                                       int nc) {
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

// A float's order as an unsigned key: a larger value has a larger key, and
// -0 and +0 share one (the add turns -0 into +0), as == has them.  No
// float maps to 0 or ~0u (both are NaN patterns).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// taken[j]: symbol lane + 32 j of a q-vector spread over a warp is among
// the top K of v in jax.lax.top_k's order (value down, index up).  Found
// in min(K, Q - K) rounds, as the first maxima (smallest index on ties) of
// the symbols not taken yet or, for K > Q / 2, as all but the Q - K last
// minima (largest index on ties); a round is two warp reductions by
// redux.sync, of the keys and of the indices at the best key.
template <int R>
__device__ __forceinline__ void top_offsets(const float (&v)[R], int K,
                                            int lane, bool (&taken)[R]) {
  constexpr int Q = 32 * R;
  const bool up = K <= Q - K;
  unsigned key[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    key[j] = order_key(v[j]);
    taken[j] = K >= Q || !up;
  }
  if (K >= Q) return;
  const unsigned gone = up ? 0u : ~0u;  // out of the race
  const int rounds = up ? K : Q - K;
  for (int k = 0; k < rounds; ++k) {
    unsigned best = key[0];
#pragma unroll
    for (int j = 1; j < R; ++j)
      best = up ? max(best, key[j]) : min(best, key[j]);
    best = up ? __reduce_max_sync(kFull, best)
              : __reduce_min_sync(kFull, best);
    unsigned at = up ? ~0u : 0u;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (key[j] == best) {
        const unsigned y = lane + 32 * j;
        at = up ? min(at, y) : max(at, y);
      }
    at = up ? __reduce_min_sync(kFull, at) : __reduce_max_sync(kFull, at);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (lane + 32 * j == (int)at) {
        key[j] = gone;
        taken[j] = up;
      }
  }
}

// Floats of one row group's scratch: X and Y [max_dc, Q], A [max(max_dc,
// 7), Q] and the per-edge scalars [3 * 32] (full EMS: U, fwd and bwd [dc,
// Q] in X, Y and A).
__host__ __device__ inline int group_floats(int q, int max_dc) {
  return (2 * max_dc + (max_dc > 7 ? max_dc : 7)) * q + 3 * 32;
}

// Floats of each row group's budget region: budget_floats for kEmsNmNc
// where its rows take the budgeted chains, else none.
__host__ __device__ inline int group_budget(int method, int q, int max_dc,
                                            int nm, int nc) {
  return (method == kEmsNmNc || method == kEmsNmNcListed) &&
                 ems_branch(nm, nc, max_dc) == kBudget
             ? budget_floats(q, max_dc, nc)
             : 0;
}

// Dynamic shared memory of one block: T [N, Q], each group's scratch and
// budget region, the GF tables and the decisions.
size_t smem_bytes(int N, int q, int max_dc, int groups, int budget) {
  return sizeof(float) * ((size_t)N * q +
                          (size_t)groups * (group_floats(q, max_dc) + budget)) +
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

// The (max,+) terms of one unit of the convolutions below: acc[k] =
// max(acc[k], A[u] + B[u ^ x]) for the 4 outputs x = x0 + k and u over
// the 4-symbol tiles t = part, part + S, ...: for u = 4 t + i, u ^ x =
// ((4 t) ^ x0) + (i ^ k), so one 16-byte load of A and one of B give 16
// terms.
template <int Q>
__device__ __forceinline__ void tile_terms(float (&acc)[4], const float* A,
                                           const float* B, int x0, int part,
                                           int S) {
  for (int t = part; t < Q / 4; t += S) {
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

// out[x] = max(P0[x], P1[x], max over the job's terms i of max_u A_i[u] +
// B_i[u ^ x]) (x, u < Q) for `njobs` jobs at once on a group's threads;
// job(j, i, A, B, O, P0, P1) names job j's output O, the vectors P0 and P1
// it starts from (nullptr: none) and its term i's operands A and B, and
// returns its number of terms (0 or more; called with i = 0 first, then
// with i = 1, 2, ... for the other terms), all in shared or device memory,
// 16-byte aligned, O apart from every A and B (P0 or P1 may be O: each
// output tile is read and then written by the same lanes).  A unit is a
// tile of 4 outputs x0 + k of one job and one of S interleaved parts of
// the 4-symbol u tiles (tile_terms).  S, a power of 2 up to 32, uses
// threads that would idle; the S partial maxima of a tile sit on
// neighbouring lanes and meet by shuffles.  Each term is one add and the
// maxima are exact, so every split gives the plain version's bits.  All
// the group's threads call it (the shuffles need whole warps).
template <int Q, class Job>
__device__ __forceinline__ void maxconv_terms(int tid, int nth, int njobs,
                                              Job&& job) {
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
    float* O = nullptr;
    if (live) {
      const int j = unit / (S * kTiles);
      const float* A = nullptr;
      const float* B = nullptr;
      const float* P[2] = {nullptr, nullptr};
      const int n = job(j, 0, A, B, O, P[0], P[1]);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (P[k]) {
          const float4 p4 = *reinterpret_cast<const float4*>(P[k] + 4 * tile);
          acc[0] = fmaxf(acc[0], p4.x);
          acc[1] = fmaxf(acc[1], p4.y);
          acc[2] = fmaxf(acc[2], p4.z);
          acc[3] = fmaxf(acc[3], p4.w);
        }
      for (int i = 0; i < n; ++i) {
        if (i) job(j, i, A, B, O, P[0], P[1]);
        tile_terms<Q>(acc, A, B, 4 * tile, part, S);
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

// out[x] = max_u A[u] + B[u ^ x] for `njobs` convolutions at once
// (maxconv_terms, one term a job); operands(j, A, B, O) names job j's
// inputs and output.  With kPrev, operands(j, A, B, O, P) also names P,
// and out[x] = max(P[x], max_u A[u] + B[u ^ x]).
template <int Q, bool kPrev = false, class Operands>
__device__ __forceinline__ void maxconvs(int tid, int nth, int njobs,
                                         Operands&& operands) {
  maxconv_terms<Q>(tid, nth, njobs,
                   [&](int j, int, const float*& a, const float*& b,
                       float*& o, const float*& p0, const float*& p1) {
    p1 = nullptr;
    if constexpr (kPrev) {
      operands(j, a, b, o, p0);
    } else {
      p0 = nullptr;
      operands(j, a, b, o);
    }
    return 1;
  });
}

// out[x] = max(P[x], max over the n entries (t, v) of L of A[t ^ x] + v)
// for `njobs` jobs at once, a thread an output: the convolution of A with
// a message that is NEG but at its n listed offsets.  operands(j, A, L, O,
// P) names job j's operands (P nullptr: none; O apart from A and P).  The
// terms this leaves out, A[u] + NEG, are at most NEG (A <= 0 here), and
// the caller's P or a listed term is at least NEG, so the maximum is the
// whole convolution's, bit for bit.  A warp's lanes take one job (Q is a
// multiple of 32), so an entry is one broadcast load.
template <int Q, class Operands>
__device__ __forceinline__ void listed_convs(int tid, int nth, int njobs,
                                             int n, Operands&& operands) {
  for (int i = tid; i < njobs * Q; i += nth) {
    const int x = i % Q;
    const float* A = nullptr;
    const float2* L = nullptr;
    float* O = nullptr;
    const float* P = nullptr;
    operands(i / Q, A, L, O, P);
    float acc = P ? P[x] : -__int_as_float(0x7f800000);
    for (int k = 0; k < n; ++k) {
      const float2 e = L[k];
      acc = fmaxf(acc, __fadd_rn(A[__float_as_int(e.x) ^ x], e.y));
    }
    O[x] = acc;
  }
}

// The forward and backward (max,+) chains over a row's dc messages and
// its inner edges' exclusive values, on a group (full EMS, and EMS's
// unbudgeted chains): fwd(1) and bwd(dc - 2), the convolutions of the
// identity with message 0 and message dc - 1, are in place (copies: the
// caller wrote 0 + the message); for s = 1 .. dc - 2, fwd(s + 1) =
// maxconv(fwd(s), msg(s)) and bwd(d - 1) = maxconv(bwd(d), msg(d)), d = dc
// - 1 - s, one step of each chain a phase; then excl(d) = maxconv(fwd(d),
// bwd(d)) for d = 1 .. dc - 2 in one phase.  The end edges' values, bwd(0)
// and fwd(dc - 1) (a convolution with the identity), are the caller's.  A
// message is dense (msg(d), Q floats) or, with kListed, `listed` (offset,
// value) entries at msg(d) (listed_convs).  Each phase ends with the
// group's barrier.
template <int Q, bool kListed, int kGroups, class Fwd, class Bwd, class Msg,
          class Excl>
__device__ __forceinline__ void chains(const RowGroup<kGroups>& grp,
                                       PhaseClock& pc, int dc, int listed,
                                       Fwd&& fwd, Bwd&& bwd, Msg&& msg,
                                       Excl&& excl) {
  const int tid = grp.tid, nth = grp.nth;
  for (int s = 1; s + 1 < dc; ++s) {
    const int d = dc - 1 - s;
    auto step = [&](int job, const float*& a, float*& o) -> const float* {
      a = job ? bwd(d) : fwd(s);
      o = job ? bwd(d - 1) : fwd(s + 1);
      return msg(job ? d : s);
    };
    if constexpr (kListed)
      listed_convs<Q>(tid, nth, 2, listed,
                      [&](int job, const float*& a, const float2*& l,
                          float*& o, const float*& p) {
        l = reinterpret_cast<const float2*>(step(job, a, o));
        p = nullptr;
      });
    else
      maxconvs<Q>(tid, nth, 2, [&](int job, const float*& a,
                                   const float*& b, float*& o) {
        b = step(job, a, o);
      });
    pc.stamp(kRpSearch);
    grp.sync();
    pc.stamp(kRpRowWait);
  }
  if (dc > 2) {
    maxconvs<Q>(tid, nth, dc - 2, [&](int job, const float*& a,
                                      const float*& b, float*& o) {
      a = fwd(job + 1);
      b = bwd(job + 1);
      o = excl(job + 1);
    });
    pc.stamp(kRpMerge);
    grp.sync();
    pc.stamp(kRpRowWait);
  }
}

// The chains budgeted by deviation count on a group (EMS at 3 <= nc <= dc
// - 2): F_{s+1}[c] = max(F_s[c], maxconv(F_s[c - 1], dev_s)) from F_0 = the
// identity at every level, Bk likewise from the right (Bk_{d-1} from Bk_d
// and dev_d), each state kept at its levels level_lo .. level_hi in the
// group's budget region (F_s's level c at F + (level_base(s) + c -
// level_lo(s)) Q, Bk_d's at Bk with s = dc - 1 - d; a level above
// level_hi reads level_hi, level 0 the identity `id`).  F_1[1] and the
// Bk state of one message are in place (the caller's, from dev_0 and
// dev_{dc - 1}).  For s = 1 .. dc - 2 one step of both chains a phase,
// over their kept levels, against the message msg(d) (dense, or with
// kListed `listed` entries); then, in one phase, each inner edge d's
// exclusive value, the max over nc - (dc - 1 - d) <= c <= d of
// maxconv(F_d[c], Bk_d[nc - c]), into excl(d): the terms at c = 0 and c =
// nc convolve with the identity, so they are F_d[nc] and Bk_d[nc]
// themselves (no state holds a -0, so adding 0 would change no bit); the
// terms outside are equal or dominated (levels rise).  Each phase ends
// with the group's barrier.
template <int Q, bool kListed, int kGroups, class Msg, class Excl>
__device__ __forceinline__ void budget_chains(
    const RowGroup<kGroups>& grp, PhaseClock& pc, int dc, int nc, int listed,
    const float* id, float* F, float* Bk, Msg&& msg, Excl&& excl) {
  const int tid = grp.tid, nth = grp.nth;
  auto lev = [&](float* chain, int s, int c) {
    const int top = level_hi(s, nc);
    return chain + (level_base(s, nc, dc) + (c < top ? c : top) -
                    level_lo(s, nc, dc)) * Q;
  };
  auto at = [&](float* chain, int s, int c) -> const float* {
    return c ? lev(chain, s, c) : id;
  };
  for (int s = 1; s + 1 < dc; ++s) {
    const int lo = level_lo(s + 1, nc, dc);
    const int nl = level_hi(s + 1, nc) - lo + 1;
    auto step = [&](int job, const float*& a, float*& o,
                    const float*& p) -> const float* {
      float* chain = job < nl ? F : Bk;
      const int c = lo + job % nl;
      a = at(chain, s, c - 1);
      p = at(chain, s, c);
      o = lev(chain, s + 1, c);
      return msg(job < nl ? s : dc - 1 - s);
    };
    if constexpr (kListed)
      listed_convs<Q>(tid, nth, 2 * nl, listed,
                      [&](int job, const float*& a, const float2*& l,
                          float*& o, const float*& p) {
        l = reinterpret_cast<const float2*>(step(job, a, o, p));
      });
    else
      maxconvs<Q, true>(tid, nth, 2 * nl,
                        [&](int job, const float*& a, const float*& b,
                            float*& o, const float*& p) {
        b = step(job, a, o, p);
      });
    pc.stamp(kRpSearch);
    grp.sync();
    pc.stamp(kRpRowWait);
  }
  maxconv_terms<Q>(tid, nth, dc - 2,
                   [&](int job, int i, const float*& a, const float*& b,
                       float*& o, const float*& p0, const float*& p1) {
    const int d = job + 1, r = dc - 1 - d;
    const int lo = nc - r > 0 ? nc - r : 0, hi = d < nc ? d : nc;
    const int c = (lo > 1 ? lo : 1) + i;  // the dense terms, 0 < c < nc
    o = excl(d);
    p0 = lo == 0 ? at(Bk, r, nc) : nullptr;
    p1 = hi == nc ? at(F, d, nc) : nullptr;
    a = at(F, d, c);
    b = at(Bk, r, nc - c);
    const int last = hi < nc - 1 ? hi : nc - 1;
    return last - (lo > 1 ? lo : 1) + 1;
  });
  pc.stamp(kRpMerge);
  grp.sync();
  pc.stamp(kRpRowWait);
}

// One full-EMS check row on a row group (nb_decode._ems_full_cn_core): the
// group's warp w holds edge k0 + w; U [dc, Q] in X (U[0] and U[dc - 1]
// only as fwd[1] = 0 + U[0] in Y and bwd[dc - 2] = 0 + U[dc - 1] in A: the
// convolution with the identity, whose one term above NEG is 0 + U[x]),
// fwd [dc, Q] in Y, bwd [dc, Q] in A, the inner edges' exclusive values
// over U (chains); the end edges' are bwd[0] and fwd[dc - 1] plus 0, taken
// in the output.  3 dc - 6 convolutions a row.  Ends with the group's
// barrier.
template <int R, int kGroups>
__device__ __forceinline__ void ems_full_row(const RowGroup<kGroups>& grp,
                                             PhaseClock& pc, const float* T,
                                             float* Cb, float* X, float* Y,
                                             float* A, const int* lg,
                                             const int* ex, int k0, int dc,
                                             const int* __restrict__ edge_vn,
                                             const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int w = grp.tid >> 5, lane = grp.tid & 31;
  const bool mine = w < dc;
  int h = 0;
  float* cp = Cb;
  if (mine) {
    const int e = k0 + w;
    h = edge_h[e];
    cp = Cb + (int64_t)e * Q;
    float u[R];
    cn_domain_v2c<R>(T, cp, edge_vn[e], h, lg, ex, lane, u);
    const bool end = w == 0 || w == dc - 1;
    float* dst = w == 0 ? Y + Q : w == dc - 1 ? A + (dc - 2) * Q : X + w * Q;
#pragma unroll
    for (int j = 0; j < R; ++j)
      dst[lane + 32 * j] = end ? __fadd_rn(0.f, u[j]) : u[j];
  }
  pc.stamp(kRpEdges);
  grp.sync();
  pc.stamp(kRpEdgesWait);
  chains<Q, false>(grp, pc, dc, 0, [&](int s) { return Y + s * Q; },
            [&](int d) { return A + d * Q; },
            [&](int d) -> const float* { return X + d * Q; },
            [&](int d) { return X + d * Q; });
  if (mine) {
    // excl[w]; adding 0 makes the end edges' copies the plain version's
    // 0 + x and changes no bit of an inner edge's (no chain value is -0)
    const float* xw = w == 0 ? A : w == dc - 1 ? Y + (dc - 1) * Q : X + w * Q;
    const float e0 = __fadd_rn(0.f, xw[0]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = lane + 32 * j;
      const int idx = h ? gf_mul(lg, ex, h, k) : 0;
      cp[k] = __fmul_rn(__fsub_rn(__fadd_rn(0.f, xw[idx]), e0), kEmsScale);
    }
  }
  pc.stamp(kRpOutput);
  grp.sync();
  pc.stamp(kRpRowWait);
}

// kEmsFullDense, the earlier design of ems_full_row (the yardstick): the
// group's warp w holds edge k0 + w; U [dc, Q] in X, then excl over it; fwd
// [dc, Q] in Y, bwd [dc, Q] in A, each chain from the identity, all 3 dc -
// 2 convolutions.  Ends with the group's barrier.
template <int R, int kGroups>
__device__ __forceinline__ void ems_full_row_dense(const RowGroup<kGroups>& grp,
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
// Sb is the group's budget region in shared memory (kBudget only: the
// identity [Q], then F's and Bk's kept levels, budget_chains).  kListed:
// the rows' chains take listed messages (listed_entries > 0), so no other
// branch is compiled in; without it, dense ones.  The budgeted chains are
// compiled in for one group only.
//   1. each warp: U (into X), c0 and W[y] = U[y ^ c0] - max (into Y);
//   2. each warp: D = conf(q,1) for its output, in registers (as ems_row),
//      and, but for kConf1, the set of the top K = nm - 1 offsets of W0 (W
//      with offset 0 at NEG) by top_offsets; dev[y] = W0[y] where taken,
//      NEG elsewhere.  kPairs: dev into A and the taken offsets listed in
//      index order into X (as ints; only the set matters to the pairs'
//      maxima).  The chains: the message of an inner edge into A, dense
//      (kChains: max(dev, identity)) or, where its entries n (kChains:
//      offset 0 and the K taken ones; kBudget: the K taken ones) are few
//      (4 n <= Q), as n (offset, value) pairs; an end edge's message enters
//      only its chain's first state, written here: kChains fwd[1] = 0 +
//      msg[0] into A[0] and bwd[dc - 2] = 0 + msg[dc - 1] into A[dc - 1],
//      kBudget F_1[1] and Bk's state of one message, max(identity, 0 +
//      dev), into the budget region;
//   3. kPairs: for each pair a < b of other edges and each listed offset o
//      of a, D[x] = max(D[x], dev_a[o] + dev_b[o ^ x]): where o ^ x is
//      taken this is the plain version's P_a + P_b at offset x, and where
//      it is not, dev_b = NEG and the term (~ -1e30) cannot reach D[x],
//      a finite conf(q,1) value, so the maximum is the plain version's;
//      kChains: chains (fwd in A[0] then Y, bwd in X then A[dc - 1], the
//      inner edges' exclusive values into A; the end edges' are bwd[0]
//      and fwd[dc - 1] plus 0); kBudget: budget_chains (the inner edges'
//      exclusive values into X; the end edges' are Bk_0[nc] and
//      F_{dc - 1}[nc]); then D = max(D, excl);
//   4. c2v[k] = (D[h k ^ g0] - D[g0]) * f32(1/1.2), as ems_row.
// Each term is one __fadd_rn and every maximum is exact, so any split of
// the terms gives the plain version's bits.  Ends with the group's
// barrier.
template <int R, int kGroups, bool kListed>
__device__ __forceinline__ void ems_nmnc_row(
    const RowGroup<kGroups>& grp, PhaseClock& pc, const float* T, float* Cb,
    float* X, float* Y, float* A, int* ei, const int* lg, const int* ex,
    int k0, int dc, int nm, int nc, float* Sb,
    const int* __restrict__ edge_vn, const int* __restrict__ edge_h) {
  constexpr int Q = 32 * R;
  const int tid = grp.tid;
  const int w = tid >> 5, lane = tid & 31;
  const bool mine = w < dc, inner = w > 0 && w < dc - 1;
  const int branch = ems_branch(nm, nc, dc);
  const int K = nm - 1;
  const bool chained = branch == kChains || branch == kBudget;
  const int listed = kListed ? listed_entries(nm, nc, Q, dc) : 0;
  // the budget states (kBudget): F's levels, then Bk's
  float* F = branch == kBudget ? Sb + Q : nullptr;
  float* Bk = branch == kBudget ? F + level_base(dc, nc, dc) * Q : nullptr;
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
      }
      top_offsets<R>(v, K, lane, taken);
      int* ow = reinterpret_cast<int*>(X + w * Q);
      float2* lw = reinterpret_cast<float2*>(A + w * Q);
      int count = 0;  // entries listed so far
      if (branch == kChains && listed && inner) {
        if (lane == 0) lw[0] = make_float2(__int_as_float(0), 0.f);
        count = 1;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int y = lane + 32 * j;
        const float dv = taken[j] ? v[j] : kNeg;
        const float id = y == 0 ? 0.f : kNeg;
        const unsigned m = __ballot_sync(kFull, taken[j]);
        const int slot = count + __popc(m & ((1u << lane) - 1));
        count += __popc(m);
        if (!kListed && branch == kPairs) {
          A[w * Q + y] = dv;
          if (taken[j]) ow[slot] = y;
        } else if (chained && !inner) {
          float* first = branch == kChains ? A + (w ? dc - 1 : 0) * Q
                                           : (w ? Bk : F);
          first[y] = branch == kChains ? __fadd_rn(0.f, fmaxf(dv, id))
                                       : fmaxf(id, __fadd_rn(0.f, dv));
        } else if (chained && !kListed) {
          A[w * Q + y] = branch == kChains ? fmaxf(dv, id) : dv;
        } else if (chained && taken[j]) {
          lw[slot] = make_float2(__int_as_float(y), dv);
        }
      }
    }
  }
  pc.stamp(kRpMins);
  float* dw = X + w * Q;      // where the warp puts D for its output's gather
  const float* ev = nullptr;  // the warp's exclusive values, plus 0
  if (branch != kConf1) {
    grp.sync();
    pc.stamp(kRpRowWait);
  }
  if (!kListed && branch == kPairs) {
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
    chains<Q, kListed>(grp, pc, dc, listed,
              [&](int s) { return s == 1 ? A : Y + s * Q; },
              [&](int d) { return d == dc - 2 ? A + (dc - 1) * Q : X + d * Q; },
              [&](int d) -> const float* { return A + d * Q; },
              [&](int d) { return A + d * Q; });
    ev = w == 0 ? X : w == dc - 1 ? Y + (dc - 1) * Q : A + w * Q;
    dw = A + w * Q;
  } else if (kGroups == 1 && branch == kBudget) {
    budget_chains<Q, kListed>(grp, pc, dc, nc, listed, Sb, F, Bk,
                     [&](int d) -> const float* { return A + d * Q; },
                     [&](int d) { return X + d * Q; });
    // the state of dc - 1 messages keeps the one level nc
    const int top = level_base(dc - 1, nc, dc) * Q;
    ev = w == 0 ? Bk + top : w == dc - 1 ? F + top : X + w * Q;
  }
  if (mine) {
    if (ev)
#pragma unroll
      for (int j = 0; j < R; ++j)
        D[j] = fmaxf(D[j], __fadd_rn(0.f, ev[lane + 32 * j]));
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

// kEmsNmNcDense, the earlier design of ems_nmnc_row (the yardstick): the
// selection in min(K, Q - K) rounds of group_argmax / group_arglast, the
// chains over every u from the identity, the budgeted chains at every level
// and exclusive term in device memory St (a set per group of each resident
// block).  In its steps:
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
__device__ __forceinline__ void ems_nmnc_row_dense(
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
  constexpr bool kEmsLike = kMethod == kEms || kMethod == kEmsFull ||
                           kMethod == kEmsNmNc || kMethod == kEmsFullDense ||
                           kMethod == kEmsNmNcDense ||
                           kMethod == kEmsNmNcListed;
  extern __shared__ __align__(16) float smem[];
  const RowGroup<kGroups> grp = row_group<kGroups>(groups);
  const int g = grp.id ? grp.id - 1 : 0;
  const int gf = group_floats(Q, max_dc);
  const int gb = group_budget(kMethod, Q, max_dc, nm, nc);
  constexpr bool kNmNc = kMethod == kEmsNmNc || kMethod == kEmsNmNcListed;
  float* T = smem;
  float* X = T + N * Q + g * gf;
  float* Y = X + max_dc * Q;
  float* A = Y + max_dc * Q;
  float* ef = A + (max_dc > 7 ? max_dc : 7) * Q;
  int* ei = reinterpret_cast<int*>(ef + 32);
  // EMS at (nm, nc), budgeted: this group's states in shared memory, or,
  // for the earlier design, in device memory
  float* Sb = gb ? T + N * Q + groups * gf + g * gb : nullptr;
  float* Sg = kMethod == kEmsNmNcDense && St
                  ? St + ((int64_t)blockIdx.x * groups + g) *
                             dense_budget_floats(Q, max_dc, nc)
                  : nullptr;
  int* lg = reinterpret_cast<int*>(T + N * Q + groups * (gf + gb));
  int* ex = lg + Q;
  int* hs = ex + 2 * (Q - 1);
  const int tid = threadIdx.x, nth = blockDim.x;
  ROWS_PHASE_CLOCK(pc)

  if (Sb)  // the identity, level 0 of every budget state
    for (int y = grp.tid; y < Q; y += grp.nth) Sb[y] = y ? kNeg : 0.f;
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
        else if (kNmNc)
          ems_nmnc_row<R, kGroups, kMethod == kEmsNmNcListed>(
              grp, pc, T, Cb, X, Y, A, ei, lg, ex, k0, dc, nm, nc, Sb,
              edge_vn, edge_h);
        else if (kMethod == kEmsFullDense)
          ems_full_row_dense<R, kGroups>(grp, pc, T, Cb, X, Y, A, lg, ex,
                                         k0, dc, edge_vn, edge_h);
        else if (kMethod == kEmsNmNcDense)
          ems_nmnc_row_dense<R, kGroups>(grp, pc, T, Cb, X, Y, A, ei, lg,
                                         ex, k0, dc, nm, nc, Sg, edge_vn,
                                         edge_h);
        else
          tmm_row<R, kMethod == kLayeredTmm, kGroups>(
              grp, pc, T, Cb, X, Y, A, ei, lg, ex, k0, dc, edge_vn, edge_h);
      });
    }
  };
  if constexpr (kMethod == kEmsNmNcDense) {
    // a grid of up to B blocks: frames blockIdx.x, + gridDim.x, ...
    for (int64_t b = blockIdx.x; b < B; b += gridDim.x) frame(b);
  } else {
    frame(blockIdx.x);  // a block a frame
  }
  // the listed instantiation counts under its method, kEmsNmNc
  ROWS_PHASE_FLUSH(pc, g_nbms_clk[kMethod == kEmsNmNcListed ? kEmsNmNc
                                                            : kMethod])
}

// The kernel for R, the method (kEmsNmNcListed for kEmsNmNc where
// `listed`) and the number of groups: the one-group instantiation (no named
// barrier) for one group, else kMaxGroups'.
template <int R>
auto kernel_for(int method, int groups, bool listed) {
  const bool one = groups == 1;
  if (method == kEmsNmNc && listed) method = kEmsNmNcListed;
  return method == kEms
             ? (one ? nbms_kernel<R, kEms, 1> : nbms_kernel<R, kEms, kMaxGroups>)
         : method == kEmsFull
             ? (one ? nbms_kernel<R, kEmsFull, 1>
                    : nbms_kernel<R, kEmsFull, kMaxGroups>)
         : method == kEmsNmNc
             ? (one ? nbms_kernel<R, kEmsNmNc, 1>
                    : nbms_kernel<R, kEmsNmNc, kMaxGroups>)
         : method == kEmsFullDense
             ? (one ? nbms_kernel<R, kEmsFullDense, 1>
                    : nbms_kernel<R, kEmsFullDense, kMaxGroups>)
         : method == kEmsNmNcDense
             ? (one ? nbms_kernel<R, kEmsNmNcDense, 1>
                    : nbms_kernel<R, kEmsNmNcDense, kMaxGroups>)
         : method == kEmsNmNcListed
             ? (one ? nbms_kernel<R, kEmsNmNcListed, 1>
                    : nbms_kernel<R, kEmsNmNcListed, kMaxGroups>)
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
  auto kernel = kernel_for<R>(method, groups,
                             listed_entries(nm, nc, 32 * R, max_dc) > 0);
  const size_t smem = smem_bytes(N, 32 * R, max_dc, groups,
                                 group_budget(method, 32 * R, max_dc, nm, nc));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<grid, 32 * max_dc * groups, smem, st>>>(
      chan, C, hard, ok, iters, row_ptr, edge_vn, edge_h, col_ptr, col_edge,
      gf_log, gf_exp, wave_ptr, wave_row, nwaves, groups, B, N, M, E, max_dc,
      num_iters, nm, nc, scratch);
  return cudaGetLastError();
}

// Blocks an SM holds of the kernel for R, the method, the groups and EMS's
// (nm, nc).
template <int R>
int blocks_per_sm(int method, int groups, int N, int max_dc, int nm,
                  int nc) {
  auto kernel = kernel_for<R>(method, groups,
                             listed_entries(nm, nc, 32 * R, max_dc) > 0);
  const size_t smem = smem_bytes(N, 32 * R, max_dc, groups,
                                 group_budget(method, 32 * R, max_dc, nm, nc));
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
// (min-domain LLRs; serial-row or grouped, by the wave plan), 5 and 6 the
// earlier designs of 3 and 4 (the yardstick), on `groups` row groups (1 to
// 7; one group at most 1024 threads, more at most 512) walking the rows of
// the wave plan wave_ptr [nwaves + 1], wave_row [M] (ops/cuda_qspa
// .row_waves), with `grid` blocks: B, a block a frame, but for method 6,
// which takes 1 to B, block i decoding frames i, i + grid, ....  C [B, E,
// q] is the caller's scratch; hard [B, N], ok [B] and iters [B] the
// outputs; methods 4 and 6 take nc >= 1 and, where their rows take the top
// nm - 1 offsets of an edge (nc >= 2, nm >= 2, max_dc >= 3), nm - 1 <= q;
// where they are budgeted (3 <= nc <= max_dc - 2) method 4 runs on one
// group and keeps its states in shared memory (budget_floats) and method 6
// in
// `scratch`, grid * groups * dense_budget_floats(q, max_dc, nc) floats of
// device memory.  nm and nc are ignored by the other methods, scratch by
// all but 6.  The tables are those of ldpc_qspa.  Returns 0 or the first
// CUDA error met while enqueueing.
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
  if (method == kEmsNmNc || method == kEmsNmNcDense) {
    const int branch = ems_branch(nm, nc, max_dc);
    if (nc < 1 || (branch != kConf1 && nm - 1 > q) ||
        (method == kEmsNmNc && branch == kBudget && groups != 1) ||
        (method == kEmsNmNcDense && branch == kBudget && !scratch))
      return cudaErrorInvalidValue;
  }
  if (method != kEmsNmNcDense) scratch = nullptr;
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
// method, the groups, N, max_dc, nm and nc (as ldpc_nbms takes them); -1
// on a bad argument or a CUDA error.
int ldpc_nbms_blocks_per_sm(int q, int method, int groups, int N, int max_dc,
                            int nm, int nc, int device) {
  if (cudaSetDevice(device) || max_dc < 2 || max_dc > 32 || method < 0 ||
      method >= kMethods || groups < 1 || groups > kMaxGroups ||
      32 * max_dc * groups > (groups == 1 ? 1024 : kGroupedThreads))
    return -1;
  switch (q) {
    case 32: return blocks_per_sm<1>(method, groups, N, max_dc, nm,
                                            nc);
    case 64: return blocks_per_sm<2>(method, groups, N, max_dc, nm,
                                            nc);
    case 128: return blocks_per_sm<4>(method, groups, N, max_dc, nm,
                                            nc);
    case 256: return blocks_per_sm<8>(method, groups, N, max_dc, nm,
                                            nc);
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
