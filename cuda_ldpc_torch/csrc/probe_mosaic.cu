// The tile-operation probe (K10), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of cuda_ldpc_tpu's tools/probe_mosaic.py `run`
// (its pallas_call): the nine ops the QC GF(q) QSPA kernel was designed
// from, `k_slice_concat` to `k_rowstack`, on an f32 tile x [Q, TB, Z] (the
// probe's own is [16, 2, 128]).  Each computes what
// cuda_ldpc_torch/tools/probe_mosaic.py's plain PyTorch version computes,
// with h = Q / 2 (8 in the probe):
//
//   0 slice_concat    [x[0], x[h:Q], x[1:h]] along the leading axis
//   1 iota0           -x on the rows q with q & 4, x elsewhere
//   2 dot3            out[u] = sum over k of m[u, k] x[k], k ascending from
//                     0.0f, one rounding a product and a sum (__f*_rn: no
//                     FMA), m [Q, Q] the extra input
//   3 roll2           jnp.roll by 37 along Z: out[z] = x[(z - 37) mod Z]
//   4 reduce0         x - the leading-axis maximum, taken by halving
//   5 reduce0_native  x - the leading-axis maximum, taken in row order
//   6 trans           logf(expf(x) + 1) where x[0, t, 0] > 0.5, else x
//   7 lanemask        -x on the lanes z where mask[z] != 0, the extra input
//   8 rowstack        out[i] = x[0] + (+-1) x[i mod h], minus on odd i
//
// A block per t, a thread per lane z, the block's [Q, Z] slice in shared
// memory (the roll crosses warps).  Maxima, selects, negations and the
// products by +-1 are exact; dot3's sum and trans's expf/logf are the only
// places where another order or another math library could differ.
//
// Bound: bytes (the tile in and out once: 32 KB for [16, 2, 128]); at this
// size the launch itself is the time.

#include <cuda_runtime.h>

#include <cstdint>

namespace mosaic_probe {

enum Fn {
  kSliceConcat = 0, kIota0, kDot3, kRoll2, kReduce0, kReduce0Native, kTrans,
  kLanemask, kRowstack, kFnCount
};

static __global__ void mosaic_kernel(const float* __restrict__ x,
                                     const float* __restrict__ extra,
                                     float* __restrict__ out, int Q, int TB,
                                     int Z, int fn) {
  extern __shared__ float smem[];
  float* X = smem;           // [Q, Z]: the slice x[:, t, :]
  float* Y = smem + Q * Z;   // [Q, Z]: the halving maxima
  const int t = blockIdx.x, z = threadIdx.x, h = Q / 2;
  for (int q = 0; q < Q; ++q) X[q * Z + z] = x[((int64_t)q * TB + t) * Z + z];
  __syncthreads();
  auto at = [&](int q) { return ((int64_t)q * TB + t) * Z + z; };
  switch (fn) {
    case kSliceConcat:
      for (int q = 0; q < Q; ++q) {
        const int src = q == 0 ? 0 : q <= Q - h ? h + q - 1 : q - (Q - h);
        out[at(q)] = X[src * Z + z];
      }
      break;
    case kIota0:
      for (int q = 0; q < Q; ++q)
        out[at(q)] = (q & 4) ? -X[q * Z + z] : X[q * Z + z];
      break;
    case kDot3:
      for (int u = 0; u < Q; ++u) {
        float acc = 0.f;
        for (int k = 0; k < Q; ++k)
          acc = __fadd_rn(acc, __fmul_rn(extra[u * Q + k], X[k * Z + z]));
        out[at(u)] = acc;
      }
      break;
    case kRoll2: {
      const int src = ((z - 37) % Z + Z) % Z;
      for (int q = 0; q < Q; ++q) out[at(q)] = X[q * Z + src];
      break;
    }
    case kReduce0:
    case kReduce0Native: {
      float m;
      if (fn == kReduce0) {
        for (int q = 0; q < Q; ++q) Y[q * Z + z] = X[q * Z + z];
        for (int w = h; w >= 1; w /= 2)
          for (int q = 0; q < w; ++q)
            Y[q * Z + z] = fmaxf(Y[q * Z + z], Y[(q + w) * Z + z]);
        m = Y[z];
      } else {
        m = X[z];
        for (int q = 1; q < Q; ++q) m = fmaxf(m, X[q * Z + z]);
      }
      for (int q = 0; q < Q; ++q) out[at(q)] = __fsub_rn(X[q * Z + z], m);
      break;
    }
    case kTrans: {
      const bool cont = X[0] > 0.5f;
      for (int q = 0; q < Q; ++q) {
        const float v = X[q * Z + z];
        out[at(q)] = cont ? logf(__fadd_rn(expf(v), 1.f)) : v;
      }
      break;
    }
    case kLanemask:
      for (int q = 0; q < Q; ++q)
        out[at(q)] = extra[z] != 0.f ? -X[q * Z + z] : X[q * Z + z];
      break;
    case kRowstack:
      for (int q = 0; q < Q; ++q) {
        const float r = X[(q % h) * Z + z];
        out[at(q)] = __fadd_rn(X[z], (q & 1) ? -r : r);
      }
      break;
  }
}

}  // namespace mosaic_probe

extern "C" {

// Runs function `fn` (0-8, the order above) of the probe on x [Q, TB, Z]
// into out, on `stream` of CUDA device `device`; `extra` is m [Q, Q] for
// dot3, the lane mask [Z] for lanemask and unread otherwise.  Q is even and
// at least 2 (a power of two for reduce0), Z at most 1024.  Returns 0 or the
// CUDA error met while enqueueing.
int ldpc_probe_mosaic(const float* x, const float* extra, float* out, int Q,
                      int TB, int Z, int fn, int device, void* stream) {
  using namespace mosaic_probe;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (Q < 2 || Q % 2 || TB < 1 || Z < 1 || Z > 1024 || fn < 0 ||
      fn >= kFnCount || (fn == kReduce0 && (Q & (Q - 1))))
    return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)Q * Z * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  mosaic_kernel<<<TB, Z, smem, (cudaStream_t)stream>>>(x, extra, out, Q, TB,
                                                        Z, fn);
  return cudaGetLastError();
}

}  // extern "C"
