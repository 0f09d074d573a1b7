// Hand-written Hopper (sm_90a) kernel for the Noise Injection Unit (paper
// SS VI): one NIU round over an int8 weight tile.
//
// It replaces the Pallas TPU kernel src/repro/kernels/niu.py::niu_refresh
// (_niu_kernel).  For each element, a stateless counter hash (lowbias32) of
// (row * C + col) ^ lowbias32(seed), two Box-Muller Gaussians, then
//   w' = drift * (w + prog * (0.25|w| + 0.05 w_max) * g) + read * w_max * g'
// requantized to int8 with half-to-even rounding (rintf, like jnp.round).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// and loaded through ctypes; the entry point launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// Numerics.  The hash is native uint32 arithmetic.  The float path is f32
// with logf, cosf and sqrtf (no --use_fast_math), and every multiply and
// add rounds on its own (-fmad=false and the _rn intrinsics: no FMA
// contraction), in XLA's order, with each Python float constant rounded to
// f32 first.  The scale 2^e and w_max come from device memory, computed by
// the wrapper before the launch (w_max is a reduction over the whole
// tile), so the kernel and the plain version use the very same values.
// logf / cosf may still differ from the CPU's by an ulp, which can flip a
// rounding; chip_smoke.py gates the kernel on a mismatch rate.
//
// Bound: one byte read and one written per element, and about 43 float
// operations (two Gaussians and the noise model); the bytes at 3.35 TB/s
// and the float operations at the H100's 67 TFLOP/s float32 rate take
// about the same time.  One thread per element, a grid over the flat
// tile: the Pallas (block_r x block_c) tiling and its padding are gone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLo = (float)1e-7;                  // clip of the uniform draw
constexpr float kHi = (float)(1.0 - 1e-7);
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kInv2p32 = 2.3283064365386963e-10f;  // 2^-32, exact
constexpr uint32_t kSaltProg = 0x1234567u, kSaltRead = 0x7654321u, kSaltStep = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix(uint32_t x) {  // lowbias32
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t counter, uint32_t salt) {
  const float u = __fmul_rn(__uint2float_rn(mix(counter ^ salt)), kInv2p32);
  return fminf(fmaxf(u, kLo), kHi);
}

__device__ __forceinline__ float gaussian(uint32_t counter, uint32_t salt) {
  const float u1 = uniform(counter, salt);
  const float u2 = uniform(counter, salt + kSaltStep);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
}

__global__ void niu_kernel(const int8_t* __restrict__ q, int8_t* __restrict__ out,
                           const float* __restrict__ scale_p, const int* __restrict__ seed_p,
                           const float* __restrict__ wmax_p, int n, float prog, float read,
                           float drift, int apply_drift, int apply_read) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float scale = *scale_p, w_max = *wmax_p;
  // i == row * C + col for a contiguous (R, C) tile
  const uint32_t counter = (uint32_t)i ^ mix((uint32_t)*seed_p);
  const float w = __fmul_rn((float)q[i], scale);
  const float g = gaussian(counter, kSaltProg);
  const float sigma =
      __fmul_rn(prog, __fadd_rn(__fmul_rn(0.25f, fabsf(w)), __fmul_rn((float)0.05, w_max)));
  float wn = __fadd_rn(w, __fmul_rn(sigma, g));
  if (apply_drift) wn = __fmul_rn(wn, drift);
  if (apply_read) {
    const float g2 = gaussian(counter, kSaltRead);
    wn = __fadd_rn(wn, __fmul_rn(__fmul_rn(read, w_max), g2));
  }
  const float r = rintf(__fdiv_rn(wn, scale));
  out[i] = (int8_t)fminf(fmaxf(r, -128.0f), 127.0f);
}

}  // namespace

extern "C" {

// out (R, C) int8 <- one NIU round over q (R, C) int8.
int repro_niu_refresh(const void* q, void* out, const void* scale, const void* seed,
                      const void* wmax, int R, int C, float prog, float read, float drift,
                      int apply_drift, int apply_read, void* stream) {
  if (R <= 0 || C <= 0 || (long long)R * C > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int n = R * C;
  const int threads = 256;
  niu_kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)q, (int8_t*)out, (const float*)scale, (const int*)seed,
      (const float*)wmax, n, prog, read, drift, apply_drift, apply_read);
  return (int)cudaGetLastError();
}

}  // extern "C"
