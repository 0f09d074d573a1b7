// Hand-written Hopper (sm_90a) kernels for the paper's INT8 PU datapath:
// the systolic-array GEMM with its fused post-processing, and IM2COL.
//
// They replace two Pallas TPU kernels:
//   int8_gemm_kernel  <- src/repro/kernels/int8_gemm.py::int8_gemm (_gemm_kernel)
//   im2col_*_kernel   <- src/repro/kernels/im2col.py::im2col (_im2col_kernel)
// and equal their oracles (repro.kernels.ref) bit for bit.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// int8_gemm.  out[p, n] = post(sum_k A[p, k] * B[n, k] + bias[n]) with
// A (P, M) the patch matrix exactly as im2col writes it and B (N, M) the
// weight matrix, both contiguous in k.  The output (P, N) is then already
// the HWC feature map (OH, OW, Cout) and the residual is read in HWC, so
// conv-as-GEMM needs none of the transposes the TPU version makes around
// its (N, M) @ (M, P) product; the public (N, M) @ (M, P) -> (N, P)
// wrapper transposes its operands instead (repro_torch/kernels/int8_gemm.py).
// The Pallas kernel walks a sequential (N/bn, P/bp, M/bm) grid and carries
// the int32 sum in VMEM scratch; here each block owns a 64 x 64 output tile
// and loops over k itself, so nothing crosses blocks.  Tiles of 64 bytes of
// k go through shared memory as packed int8x4 words; each thread keeps a
// 4 x 4 tile of int32 sums and accumulates with __dp4a.  The int32 sum
// wraps, as XLA's does.  The epilogue runs in registers: bias, shift_round
// (half away from zero; a negative shift is a left shift), clip, residual,
// clip, ReLU, int8 store.  `shift` is read from device memory, so a forward
// never syncs to the host per layer.
// Bound: counted once, a ResNet-50 GEMM moves more bytes than the H100's
// int8 tensor cores need time for (its operands are read once at 3.35
// TB/s in longer than 2*P*N*M operations take at 1979 TOP/s), so the least
// time is set by bytes.  This simple version does not reach it: __dp4a
// runs on the CUDA cores at a small fraction of the tensor rate, and the
// operands are re-read from L2 once per 64-wide tile.  mma.sync / wgmma on
// int8 with TMA-fed tiles is the later, fast version.
//
// im2col.  Patch matrix (OH*OW, k*k*C) of a zero-padded HWC map, columns
// ordered (ki, kj) outer, C inner.  Pure data movement: bound by bytes.
// Where a pixel's C channels fill whole 16-byte chunks (C * elt_size a
// multiple of 16: every ResNet layer but conv1), each thread copies one
// 16-byte chunk of a patch row; otherwise (conv1, C = 3) one element.
// Outside the map the value is 0, as jnp.pad writes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // output rows (p) and columns (n) per block
constexpr int kTK = 64;                // bytes of k per shared-memory step
constexpr int kTKW = kTK / 4;          // int8x4 words of k per step
constexpr int kRowW = kTKW + 1;        // padded row stride: conflict-free B reads
constexpr int kGemmThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ int pack4(const int8_t* src, int valid) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < valid) w |= (uint32_t)(uint8_t)src[b] << (8 * b);
  return (int)w;
}

// One 16-byte chunk of k (bytes [c, c + 16) of row r) of a (rows, M) int8
// matrix into 4 shared-memory words, zero past either edge.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const int8_t* __restrict__ src, int rows, int M,
                                           int r, int c, int* dst) {
  if (kVec) {  // M % 16 == 0: a chunk is wholly inside or wholly outside
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows && c < M) v = *reinterpret_cast<const int4*>(src + (size_t)r * M + c);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    const int8_t* row = src + (size_t)r * M;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int k = c + 4 * w;
      dst[w] = (r < rows && k < M) ? pack4(row + k, M - k) : 0;
    }
  }
}

// XLA's int32 semantics of quant.shift_round: wrapping adds, a left shift
// by >= 32 gives 0, an arithmetic right shift by >= 32 fills with the sign.
__device__ __forceinline__ int shift_round(int acc, int s) {
  if (s < 0) {
    const uint32_t ls = 0u - (uint32_t)s;
    return ls >= 32 ? 0 : (int)((uint32_t)acc << ls);
  }
  const int half = (s == 0 || s > 32) ? 0 : (int)(1u << (s - 1));   // s == 32: INT_MIN
  const int sh = s > 31 ? 31 : s;
  if (acc >= 0) return (int)((uint32_t)acc + (uint32_t)half) >> sh;
  const int t = (int)((0u - (uint32_t)acc) + (uint32_t)half);
  return (int)(0u - (uint32_t)(t >> sh));
}

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const int* __restrict__ bias, const int* __restrict__ shift,
                 const int8_t* __restrict__ res, int8_t* __restrict__ out,
                 int P, int N, int M, int relu) {
  __shared__ int As[kTile][kRowW];
  __shared__ int Bs[kTile][kRowW];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int p0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int lr = threadIdx.x / 4, lc = threadIdx.x % 4;   // loader: row, 16-byte chunk
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < M; k0 += kTK) {
    load_chunk<kVec>(A, P, M, p0 + lr, k0 + 16 * lc, &As[lr][4 * lc]);
    load_chunk<kVec>(B, N, M, n0 + lr, k0 + 16 * lc, &Bs[lr][4 * lc]);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kTKW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int s = *shift;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      int v = acc[i][j];
      if (bias) v = (int)((uint32_t)v + (uint32_t)bias[n]);
      v = min(max(shift_round(v, s), -128), 127);
      const size_t o = (size_t)p * N + n;
      if (res) v = min(max(v + (int)res[o], -128), 127);
      if (relu) v = max(v, 0);
      out[o] = (int8_t)v;
    }
  }
}

// One 16-byte chunk of a patch row per thread; cw = C * elt_size / 16.
__global__ void im2col_vec_kernel(const uint4* __restrict__ img, uint4* __restrict__ out,
                                  int H, int W, int cw, int k, int stride, int pad, int OW,
                                  long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int row_chunks = k * k * cw;
  const long long p = t / row_chunks;
  const int r = (int)(t - p * row_chunks);
  const int seg = r / cw, c = r - seg * cw;
  const int ki = seg / k, kj = seg - ki * k;
  const int oh = (int)(p / OW), ow = (int)(p - (long long)oh * OW);
  const int ih = oh * stride + ki - pad, iw = ow * stride + kj - pad;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (ih >= 0 && ih < H && iw >= 0 && iw < W) v = img[((long long)ih * W + iw) * cw + c];
  out[t] = v;
}

// One element of a patch row per thread.
template <typename T>
__global__ void im2col_elem_kernel(const T* __restrict__ img, T* __restrict__ out, int H,
                                   int W, int C, int k, int stride, int pad, int OW,
                                   long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int row = k * k * C;
  const long long p = t / row;
  const int r = (int)(t - p * row);
  const int seg = r / C, c = r - seg * C;
  const int ki = seg / k, kj = seg - ki * k;
  const int oh = (int)(p / OW), ow = (int)(p - (long long)oh * OW);
  const int ih = oh * stride + ki - pad, iw = ow * stride + kj - pad;
  T v = T(0);
  if (ih >= 0 && ih < H && iw >= 0 && iw < W) v = img[((long long)ih * W + iw) * C + c];
  out[t] = v;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// out (P, N) int8 <- post(A (P, M) . B (N, M)^T + bias); bias and res may be null.
int repro_int8_gemm(const void* A, const void* B, const void* bias, const void* shift,
                    const void* res, void* out, int P, int N, int M, int relu,
                    void* stream) {
  if (P <= 0 || N <= 0 || M <= 0 || shift == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = M % 16 == 0 && aligned16(A) && aligned16(B);
#define REPRO_GEMM(V)                                                                  \
  int8_gemm_kernel<V><<<grid, kGemmThreads, 0, s>>>(                                   \
      (const int8_t*)A, (const int8_t*)B, (const int*)bias, (const int*)shift,         \
      (const int8_t*)res, (int8_t*)out, P, N, M, relu)
  if (vec) REPRO_GEMM(true); else REPRO_GEMM(false);
#undef REPRO_GEMM
  return (int)cudaGetLastError();
}

// out (OH*OW, k*k*C) <- patches of img (H, W, C), elements of esize bytes.
int repro_im2col(const void* img, void* out, int H, int W, int C, int esize, int k,
                 int stride, int pad, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || k <= 0 || stride <= 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  const int OH = (H + 2 * pad - k) / stride + 1, OW = (W + 2 * pad - k) / stride + 1;
  if (H + 2 * pad < k || W + 2 * pad < k) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long P = (long long)OH * OW;
  const int threads = 256;
  if ((C * esize) % 16 == 0 && aligned16(img) && aligned16(out)) {
    const int cw = C * esize / 16;
    const long long total = P * k * k * cw;
    im2col_vec_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
        (const uint4*)img, (uint4*)out, H, W, cw, k, stride, pad, OW, total);
    return (int)cudaGetLastError();
  }
  const long long total = P * k * k * C;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
#define REPRO_IM2COL(T)                                                                \
  im2col_elem_kernel<T><<<blocks, threads, 0, s>>>((const T*)img, (T*)out, H, W, C, k, \
                                                   stride, pad, OW, total)
  switch (esize) {
    case 1: REPRO_IM2COL(uint8_t); break;
    case 2: REPRO_IM2COL(uint16_t); break;
    case 4: REPRO_IM2COL(uint32_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_IM2COL
  return (int)cudaGetLastError();
}

}  // extern "C"
