// The sign-bit algebra probe (K9), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of cuda_ldpc_tpu's tools/probe_bitops.py `run`
// (its pallas_call): `k_signmag`, `k_intcmp` and `k_mixed`, the IEEE
// sign-bit forms of the min-sum check-node step on an f32 tile [rows, cols]
// (the probe's own is [8, 256]).  It computes what
// cuda_ldpc_torch/tools/probe_bitops.py's plain PyTorch versions compute, bit
// for bit: integer and bitwise operations are exact, the one float minimum
// sees no NaN, and the int -> float conversion rounds to nearest even in
// both.
//
//   signmag  v = bits(x); min(mag, roll(mag, 1)) | (sign ^ roll(sign, 1)),
//            bits back to f32 (mag = v & 0x7FFFFFFF, sign = v & 0x80000000)
//   intcmp   float(roll(mag, 3) < mag ? min(mag, roll(mag, 3)) : mag)
//   mixed    fminf(magf, roll(magf, 1)) with the sign OR'd back on
//
// "roll" is jnp.roll's: out[j] = in[(j - s) mod cols] along a row.  A row
// spans several warps, so the roll goes through shared memory: a block per
// row, a thread per lane.  The masks commute with the roll, so each function
// rolls the word once and masks after.
//
// Bound: bytes (the tile in and out once: 16 KB for [8, 256]); at this size
// the launch itself is the time.

#include <cuda_runtime.h>

#include <cstdint>

namespace bitops_probe {

constexpr int32_t kSign = INT32_MIN;  // 0x80000000
constexpr int32_t kMag = 0x7FFFFFFF;

enum Fn { kSignmag = 0, kIntcmp = 1, kMixed = 2 };

static __device__ __forceinline__ int rolled(int j, int s, int n) {
  const int k = (j - s) % n;
  return k < 0 ? k + n : k;
}

static __global__ void bitops_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int cols,
                                     int fn) {
  extern __shared__ int32_t row[];
  const int j = threadIdx.x;
  const int64_t at = (int64_t)blockIdx.x * cols + j;
  const int32_t v = __float_as_int(x[at]);
  const int32_t mag = v & kMag, sign = v & kSign;
  row[j] = fn == kIntcmp ? mag : v;
  __syncthreads();
  const int32_t r = row[rolled(j, fn == kIntcmp ? 3 : 1, cols)];
  float o;
  if (fn == kSignmag) {
    o = __int_as_float(min(mag, r & kMag) | (sign ^ (r & kSign)));
  } else if (fn == kIntcmp) {
    o = __int2float_rn(r < mag ? min(mag, r) : mag);
  } else {
    const float m1 = fminf(__int_as_float(mag), __int_as_float(r & kMag));
    o = __int_as_float(__float_as_int(m1) | sign);
  }
  out[at] = o;
}

}  // namespace bitops_probe

extern "C" {

// Runs function `fn` (0 signmag, 1 intcmp, 2 mixed) of the probe on the tile
// x [rows, cols] into out, on `stream` of CUDA device `device`; cols is at
// most 1024 (a thread per lane).  Returns 0 or the CUDA error met while
// enqueueing.
int ldpc_probe_bitops(const float* x, float* out, int rows, int cols, int fn,
                      int device, void* stream) {
  using namespace bitops_probe;
  cudaError_t err;
  if ((err = cudaSetDevice(device))) return err;
  if (rows < 1 || cols < 1 || cols > 1024 || fn < kSignmag || fn > kMixed)
    return cudaErrorInvalidValue;
  bitops_kernel<<<rows, cols, cols * sizeof(int32_t), (cudaStream_t)stream>>>(
      x, out, cols, fn);
  return cudaGetLastError();
}

}  // extern "C"
