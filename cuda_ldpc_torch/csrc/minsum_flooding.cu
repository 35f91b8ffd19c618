// Flooding min-sum decoder for binary QC-LDPC codes, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel cuda_ldpc_tpu/ops/pallas_minsum.py `_kernel`
// (with its helpers `_cn_phase(rule='minsum')`, `_frame_ok`, `_epilogue`).
// It computes what ops/minsum.py's plain PyTorch `decode_flooding` computes,
// bit for bit: fp32 adds, compares and one optional multiply, no fast math,
// and the `__f*_rn` intrinsics so that nvcc cannot contract anything into
// an FMA.
//
// Layout (the plain version's contract): chan, T [B, L, Z] f32, R [B, E, Z]
// f32, hard [B, L, Z] int8, ok [B] uint8.  Threads run over z, which is
// contiguous, so a circulant shift is the index (r + s) % Z and costs
// nothing: the TPU's 128-lane padding and two-roll rotation are not needed.
// Offsets are 64-bit (B * E * Z passes 2^31 at B = 16384 on J15_L30_Z1280).
//
// Per iteration, four launches on the caller's stream:
//   vn      T = chan + R[e0] + R[e1] + ...   (col_edges order, one add at a time)
//   check   per-frame ok from T (zero: message columns only; syndrome: XOR
//           over each row's edges), and a device count of frames not ok
//   finish  one thread: iteration count += 1, raise the stop flag when early
//           stop is on and every frame is ok
//   cn      q_e = T[l_e, (r+s_e)%Z] - R[e, (r+s_e)%Z]; two-min with a strict
//           `<` (first minimum wins), sign product from `q < 0`, then
//           out = max(out - beta, 0) * alpha; each (row, r) writes its own
//           edges' messages in place, so no atomics.  Skipped on the last
//           iteration, whose messages would be discarded.
// After the stop flag is raised every later launch returns at once, so the
// host never waits on the device between iterations.  The grids are capped
// and walk their rows in grid-stride loops, so such an empty launch costs a
// few microseconds however large the batch.
//
// Early stop is batch-global, like ops/minsum.decode_flooding: hard and ok
// come from the last VN phase, iters is the batch's count.  (The TPU kernel
// stops per 8-frame tile and reports the maximum over tiles.)
//
// Bound: global-memory bytes.  R is 589 KB per frame on J15_L30_Z1280 -- more
// than a block's 227 KB of shared memory -- so it lives in device memory and
// L2, read twice (vn, cn) and written once (cn) per iteration.  A later
// change stores each check node's (min1, min2, argmin, sign bits) instead of
// every edge message, which cuts those bytes by about the row degree.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kCheckNone = 0;
constexpr int kCheckZero = 1;
constexpr int kCheckSyndrome = 2;
constexpr int kMaxRowDegree = 64;  // sign bits of one row fit a uint64_t

// ctl[0]: iterations run, ctl[1]: stop flag, ctl[2]: frames not ok in the
// latest check.
constexpr int kIters = 0;
constexpr int kStop = 1;
constexpr int kNotOk = 2;

__global__ void vn_kernel(const float* __restrict__ chan,
                          const float* __restrict__ R, float* __restrict__ T,
                          const int* __restrict__ col_ptr,
                          const int* __restrict__ col_edge, int* ctl, int B,
                          int L, int E, int Z) {
  if (ctl[kStop]) return;
  // No other thread touches the count until the check launch that follows.
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[kNotOk] = 0;
  const int64_t rows = (int64_t)B * L;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t b = row / L;
    const int l = (int)(row - b * L);
    const int k0 = col_ptr[l], k1 = col_ptr[l + 1];
    const float* rb = R + b * E * Z;
    for (int z = threadIdx.x; z < Z; z += blockDim.x) {
      float t = chan[row * Z + z];
      for (int k = k0; k < k1; ++k)
        t = __fadd_rn(t, rb[(int64_t)col_edge[k] * Z + z]);
      T[row * Z + z] = t;
    }
  }
}

__global__ void check_kernel(const float* __restrict__ T,
                             unsigned char* __restrict__ ok,
                             const int* __restrict__ edge_l,
                             const int* __restrict__ edge_s,
                             const int* __restrict__ row_ptr,
                             const int* __restrict__ row_edge, int* ctl,
                             int check, int B, int L, int J, int Z) {
  if (ctl[kStop]) return;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const float* tb = T + b * L * Z;
    int bad = 0;
    if (check == kCheckZero) {
      const int n = (L - J) * Z;  // message columns l < L - J come first
      for (int i = threadIdx.x; i < n && !bad; i += blockDim.x)
        bad = tb[i] < 0.f;
    } else {
      for (int i = threadIdx.x; i < J * Z && !bad; i += blockDim.x) {
        const int j = i / Z, r = i - j * Z;
        int par = 0;
        for (int k = row_ptr[j]; k < row_ptr[j + 1]; ++k) {
          const int e = row_edge[k];
          int z = r + edge_s[e];
          if (z >= Z) z -= Z;
          par ^= tb[edge_l[e] * Z + z] < 0.f;
        }
        bad = par;
      }
    }
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      ok[b] = bad ? 0 : 1;
      if (bad) atomicAdd(&ctl[kNotOk], 1);
    }
  }
}

__global__ void finish_kernel(int* ctl, int stop_when_ok) {
  if (ctl[kStop]) return;
  ctl[kIters] += 1;
  if (stop_when_ok && ctl[kNotOk] == 0) ctl[kStop] = 1;
}

__global__ void cn_kernel(const float* __restrict__ T, float* __restrict__ R,
                          const int* __restrict__ edge_l,
                          const int* __restrict__ edge_s,
                          const int* __restrict__ row_ptr,
                          const int* __restrict__ row_edge, int* ctl, int B,
                          int L, int J, int E, int Z, float alpha,
                          int use_alpha, float beta, int use_beta) {
  if (ctl[kStop]) return;
  const int64_t rows = (int64_t)B * J;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t b = row / J;
    const int j = (int)(row - b * J);
    const int k0 = row_ptr[j], k1 = row_ptr[j + 1];
    const float* tb = T + b * L * Z;
    float* rb = R + b * E * Z;
    for (int r = threadIdx.x; r < Z; r += blockDim.x) {
      float m1 = 0.f, m2 = FLT_MAX;
      int am = 0;
      uint64_t signs = 0;
      for (int k = k0; k < k1; ++k) {
        const int i = k - k0, e = row_edge[k];
        int z = r + edge_s[e];
        if (z >= Z) z -= Z;
        const float q = __fsub_rn(tb[edge_l[e] * Z + z], rb[(int64_t)e * Z + z]);
        if (q < 0.f) signs |= 1ull << i;
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
      const int parity = __popcll(signs) & 1;
      for (int k = k0; k < k1; ++k) {
        const int i = k - k0, e = row_edge[k];
        int z = r + edge_s[e];
        if (z >= Z) z -= Z;
        float out = i == am ? m2 : m1;
        if (use_beta) {
          out = __fsub_rn(out, beta);
          if (out < 0.f) out = 0.f;
        }
        if (use_alpha) out = __fmul_rn(out, alpha);
        rb[(int64_t)e * Z + z] = (parity ^ (int)((signs >> i) & 1)) ? -out : out;
      }
    }
  }
}

__global__ void hard_kernel(const float* __restrict__ T,
                            signed char* __restrict__ hard, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    hard[i] = T[i] < 0.f ? 1 : 0;
}

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

}  // namespace

extern "C" {

int ldpc_max_row_degree() { return kMaxRowDegree; }

const char* ldpc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Decodes `num_iters` >= 1 flooding iterations of the batch `chan` on
// `stream` of CUDA device `device`.  T, R, hard, ok and ctl (3 ints) are the caller's buffers; ctl
// ends holding the iteration count in ctl[0].  Returns 0 or the first CUDA
// error met while enqueueing.
int ldpc_minsum_flooding(const float* chan, float* T, float* R,
                         signed char* hard, unsigned char* ok, int* ctl,
                         const int* edge_l, const int* edge_s,
                         const int* row_ptr, const int* row_edge,
                         const int* col_ptr, const int* col_edge, int B, int L,
                         int J, int E, int Z, int num_iters, float alpha,
                         int use_alpha, float beta, int use_beta, int check,
                         int early_stop, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if ((err = cudaMemsetAsync(ctl, 0, 3 * sizeof(int), st))) return err;
  if ((err = cudaMemsetAsync(R, 0, (size_t)B * E * Z * sizeof(float), st)))
    return err;
  if ((err = cudaMemsetAsync(ok, 0, (size_t)B, st))) return err;

  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return err;
  // One block per (frame, column) or (frame, block row), threads over z.
  const int threads = Z >= 256 ? 256 : ((Z + 31) / 32) * 32;
  const int cap = sms * 16;
  const int vn_grid = (int)min64((int64_t)B * L, cap);
  const int cn_grid = (int)min64((int64_t)B * J, cap);
  const int check_grid = (int)min64(B, cap);
  const int stop_when_ok = early_stop && check != kCheckNone;

  for (int it = 0; it < num_iters; ++it) {
    vn_kernel<<<vn_grid, threads, 0, st>>>(chan, R, T, col_ptr, col_edge, ctl,
                                           B, L, E, Z);
    if (check != kCheckNone)
      check_kernel<<<check_grid, 256, 0, st>>>(T, ok, edge_l, edge_s, row_ptr,
                                               row_edge, ctl, check, B, L, J,
                                               Z);
    finish_kernel<<<1, 1, 0, st>>>(ctl, stop_when_ok);
    if (it + 1 < num_iters)
      cn_kernel<<<cn_grid, threads, 0, st>>>(T, R, edge_l, edge_s, row_ptr,
                                             row_edge, ctl, B, L, J, E, Z,
                                             alpha, use_alpha, beta, use_beta);
    if ((err = cudaGetLastError())) return err;
  }
  const int64_t n = (int64_t)B * L * Z;
  const int hard_grid = (int)min64((n + 255) / 256, (int64_t)sms * 32);
  hard_kernel<<<hard_grid, 256, 0, st>>>(T, hard, n);
  return cudaGetLastError();
}

}  // extern "C"
