// Hand-written Hopper (sm_90a) kernels for the Noise Injection Unit (paper
// SS VI): one NIU round over every weight matrix of a model in one launch.
//
// niu_refresh_kernel replaces the Pallas TPU kernel
// src/repro/kernels/niu.py::niu_refresh (_niu_kernel).  For each element,
// a stateless counter hash (lowbias32) of (row * C + col) ^ lowbias32(seed),
// two Box-Muller Gaussians, then
//   w' = drift * (w + prog * (0.25|w| + 0.05 w_max) * g) + read * w_max * g'
// requantized to int8 with half-to-even rounding (rintf, like jnp.round).
// niu_absmax_kernel computes each matrix's max |q| once, when a plan is
// built (repro_torch/kernels/niu.py::niu_plan): the pristine weights never
// change, and the hardware NIU's range is programmed once too.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// and loaded through ctypes; each entry point launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// Numerics.  The hash is native uint32 arithmetic.  The float path is f32
// with logf, cosf and sqrtf (no --use_fast_math), and every multiply and
// add rounds on its own (-fmad=false and the _rn intrinsics: no FMA
// contraction), in XLA's order, with each Python float constant rounded to
// f32 first.  scale = 2^e is exact (ldexpf), and w_max = max|q| * scale is
// the very value the plain version's max |q * scale| gives: multiplying by
// a power of two keeps the order of the values.
//
// The plan.  A table holds one entry per matrix (input and output
// pointers, element count, first block); the exponents, the max |q| and
// the seeds are arrays beside it.  Matrix m owns blocks [first[m],
// first[m+1]), each block 256 threads x 16 consecutive elements; a block
// finds its matrix by a binary search over the first blocks, staged in
// shared memory.  A thread moves its 16 bytes with one 16-byte load and one
// 16-byte store where the matrix's pointers are 16-byte aligned and all 16
// elements lie inside it, else a byte at a time.  One grid covers every
// matrix, so a round has one launch and one wave tail.
//
// Bound: one byte read and one written per element, and the instructions of
// the float path (two precise logf / cosf / sqrtf, a division): the
// instruction issue rate bounds it, not the bytes (chip_smoke.py counts
// the instructions per element from this library's SASS,
// tools/niu_sass.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                            // elements per thread
constexpr int kBlockElems = kThreads * kPer;        // elements per block
constexpr int kMaxMats = 8192;                      // first blocks staged in shared memory

constexpr float kLo = (float)1e-7;                  // clip of the uniform draw
constexpr float kHi = (float)(1.0 - 1e-7);
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kInv2p32 = 2.3283064365386963e-10f;  // 2^-32, exact
constexpr uint32_t kSaltProg = 0x1234567u, kSaltRead = 0x7654321u, kSaltStep = 0x9E3779B9u;

struct NiuMat {              // one weight matrix of a plan (niu.py::NiuPlan.table)
  const int8_t* q;           // pristine payload
  int8_t* out;               // noisy payload
  long long n;               // elements
  long long first;           // first block
};

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

// The noise model on one element; i is its flat index in the matrix.
template <bool kDrift, bool kRead>
__device__ __forceinline__ int8_t niu_element(int8_t q, uint32_t i, uint32_t mixed_seed,
                                              float scale, float w_max, float prog, float read,
                                              float drift) {
  const uint32_t counter = i ^ mixed_seed;
  const float w = __fmul_rn((float)q, scale);
  const float g = gaussian(counter, kSaltProg);
  const float sigma =
      __fmul_rn(prog, __fadd_rn(__fmul_rn(0.25f, fabsf(w)), __fmul_rn((float)0.05, w_max)));
  float wn = __fadd_rn(w, __fmul_rn(sigma, g));
  if (kDrift) wn = __fmul_rn(wn, drift);
  if (kRead) {
    const float g2 = gaussian(counter, kSaltRead);
    wn = __fadd_rn(wn, __fmul_rn(__fmul_rn(read, w_max), g2));
  }
  const float r = rintf(__fdiv_rn(wn, scale));
  return (int8_t)fminf(fmaxf(r, -128.0f), 127.0f);
}

// The matrix that owns this block: the last m with first[m] <= blockIdx.x.
__device__ __forceinline__ int find_matrix(const NiuMat* __restrict__ table, int n_mats,
                                           int* s_first) {
  for (int m = threadIdx.x; m < n_mats; m += blockDim.x) s_first[m] = (int)table[m].first;
  __syncthreads();
  int lo = 0, hi = n_mats - 1;
  const int b = blockIdx.x;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_first[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Grid: one block per 4096 elements of every matrix of the plan.
template <bool kDrift, bool kRead>
__global__ void __launch_bounds__(kThreads)
niu_refresh_kernel(const NiuMat* __restrict__ table, const int* __restrict__ exps,
                   const int* __restrict__ amax, const int* __restrict__ seeds,
                   uint32_t seed, int n_mats, float prog, float read, float drift) {
  extern __shared__ int s_first[];
  const int m = find_matrix(table, n_mats, s_first);
  const NiuMat mat = table[m];
  const float scale = ldexpf(1.0f, exps[m]);
  const float w_max = __fmul_rn((float)amax[m], scale);
  const uint32_t mixed = mix(seeds != nullptr ? (uint32_t)seeds[m] : seed);
  const long long i0 = (blockIdx.x - mat.first) * (long long)kBlockElems + threadIdx.x * kPer;
  if (i0 >= mat.n) return;
  if (i0 + kPer <= mat.n && aligned16(mat.q) && aligned16(mat.out)) {
    const uint4 v = *reinterpret_cast<const uint4*>(mat.q + i0);
    const int8_t* in = reinterpret_cast<const int8_t*>(&v);
    uint4 o;
    int8_t* res = reinterpret_cast<int8_t*>(&o);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      res[j] = niu_element<kDrift, kRead>(in[j], (uint32_t)(i0 + j), mixed, scale, w_max, prog,
                                          read, drift);
    *reinterpret_cast<uint4*>(mat.out + i0) = o;
  } else {
    for (long long i = i0; i < mat.n && i < i0 + kPer; ++i)
      mat.out[i] = niu_element<kDrift, kRead>(mat.q[i], (uint32_t)i, mixed, scale, w_max, prog,
                                              read, drift);
  }
}

// amax[m] = max |q| over matrix m (amax zero on entry); the same grid.
__global__ void __launch_bounds__(kThreads)
niu_absmax_kernel(const NiuMat* __restrict__ table, int* __restrict__ amax, int n_mats) {
  extern __shared__ int s_first[];
  __shared__ int s_warp[kThreads / 32];
  const int m = find_matrix(table, n_mats, s_first);
  const NiuMat mat = table[m];
  const long long i0 = (blockIdx.x - mat.first) * (long long)kBlockElems + threadIdx.x * kPer;
  int a = 0;
  if (i0 + kPer <= mat.n && aligned16(mat.q)) {
    const uint4 v = *reinterpret_cast<const uint4*>(mat.q + i0);
    const int8_t* in = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) a = max(a, abs((int)in[j]));
  } else {
    for (long long i = i0; i < mat.n && i < i0 + kPer; ++i) a = max(a, abs((int)mat.q[i]));
  }
  a = __reduce_max_sync(0xffffffffu, a);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) a = max(a, s_warp[w]);
    atomicMax(amax + m, a);
  }
}

bool bad_plan(const void* table, int n_mats, int blocks) {
  return table == nullptr || n_mats <= 0 || n_mats > kMaxMats || blocks <= 0;
}

}  // namespace

extern "C" {

// amax[m] <- max |q| of every matrix of the plan (amax zero on entry).
int repro_niu_absmax(const void* table, void* amax, int n_mats, int blocks, void* stream) {
  if (bad_plan(table, n_mats, blocks) || amax == nullptr) return (int)cudaErrorInvalidValue;
  niu_absmax_kernel<<<blocks, kThreads, n_mats * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>((const NiuMat*)table, (int*)amax,
                                                           n_mats);
  return (int)cudaGetLastError();
}

// One NIU round over every matrix of the plan: out <- noisy q.  seeds holds
// one int32 seed per matrix, or is null and every matrix takes `seed`.
int repro_niu_refresh(const void* table, const void* exps, const void* amax, const void* seeds,
                      unsigned seed, int n_mats, int blocks, float prog, float read, float drift,
                      int apply_drift, int apply_read, void* stream) {
  if (bad_plan(table, n_mats, blocks) || exps == nullptr || amax == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = n_mats * sizeof(int);
#define REPRO_NIU(D, R)                                                                 \
  niu_refresh_kernel<D, R><<<blocks, kThreads, smem, s>>>(                             \
      (const NiuMat*)table, (const int*)exps, (const int*)amax, (const int*)seeds, seed, \
      n_mats, prog, read, drift)
  if (apply_drift) {
    if (apply_read) REPRO_NIU(true, true);
    else REPRO_NIU(true, false);
  } else {
    if (apply_read) REPRO_NIU(false, true);
    else REPRO_NIU(false, false);
  }
#undef REPRO_NIU
  return (int)cudaGetLastError();
}

}  // extern "C"
