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
// A (P, M) the patch matrix exactly as im2col writes it.  The weights B
// come in one of two layouts: (N, M), contiguous in k (the public
// int8_gemm contract), or (M, N), contiguous in n -- a conv's
// (k, k, Cin, Cout) weights viewed as (k*k*Cin, Cout), so conv-as-GEMM
// re-lays out nothing.  The output (P, N) is the HWC feature map
// (OH, OW, Cout) and the residual is read in HWC.
// The Pallas kernel walks a sequential (N/bn, P/bp, M/bm) grid and carries
// the int32 sum in VMEM scratch from one grid step to the next.  Here a
// block owns a 64 x 64 output tile and a range of k.
// Bound: counted once, a ResNet-50 GEMM moves more bytes than the int8
// tensor cores need time for (62 MB a forward against 8.2 G operations:
// 18.5 us at 3.35 TB/s against 4.1 us at 1979 TOP/s), so the design is
// about keeping loads in flight on every SM:
// - int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, fragments loaded
//   with ldmatrix from shared memory where both operands are k-major in
//   rows padded to 80 bytes (64 bytes of k + 16), so the eight rows an
//   ldmatrix phase reads fall in eight different bank groups;
// - a ring of 4 stages, 64 bytes of k each, filled by 16-byte cp.async
//   copies where rows are 16-byte aligned (M % 16 == 0, and N % 16 == 0
//   for (M, N) weights).  (M, N) weights arrive as they lie, and before a
//   stage is used the block transposes its weight tile in shared memory,
//   4 k-rows x 16 n-bytes per thread with __byte_perm, into a k-major
//   tile.  Unaligned operands (conv1, M = 147) go through registers a
//   byte at a time, loaded before a stage's products and stored after
//   them.  Everything past P, N or M reads as zero.
// - split-K where the tile grid is small (P = 49 gives 8-32 tiles): the
//   grid's z axis splits the k-tiles, each block adds its int32 partial
//   into the tile's sum in a workspace (atomicAdd, in its own fragment
//   order), and the last block of a tile to arrive (a per-tile counter,
//   __threadfence + atomicAdd) reads the sum and runs the epilogue once.
//   int32 addition wraps and is associative mod 2^32, so any split, in
//   any order, gives the bits of one block.  That block writes the sum
//   and the counter back to 0, so the workspace stays zero between calls
//   without a memset.  The split comes from
//   repro_torch/kernels/int8_gemm.py::gemm_plan.
// - the conv mode (repro_int8_conv_gemm): A is not a patch matrix but the
//   HWC map itself, and each 16-byte cp.async of an A row computes its
//   source from (p, k): p -> (oy, ox), k -> (ki, kj, ci), the map's pixel
//   (oy * s - pad + ki, ox * s - pad + kj), zero-filled (source size 0)
//   outside the map (ConvRows).  A thread's rows are the same in every
//   k-tile, so their (oy * s - pad, ox * s - pad) are computed once; the
//   (ki, kj, ci) of a chunk by a shift where C is a power of two.  With
//   C % 16 == 0 a chunk never straddles two pixels.  The patch matrix
//   (9x the map for a 3x3 conv) is never written or read: this is
//   im2col folded into the GEMM (implicit GEMM).
// The epilogue runs in registers: bias, shift_round (half away from zero;
// a negative shift is a left shift), clip, residual, clip, ReLU, int8
// store.  `shift` is read from device memory, so a forward never syncs to
// the host per layer.
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

constexpr int kBK = 64;                // bytes of k per pipeline stage
constexpr int kRowB = kBK + 16;        // padded shared-memory row (bytes)
constexpr int kStages = 4;             // depth of the cp.async ring
constexpr int kMaxDevices = 64;        // devices whose kernel attributes are remembered

// Block tile BM x BN (p x n) over WM x WN warps; each warp owns a
// (BM/WM) x (BN/WN) piece as (BM/WM/16) x (BN/WN/8) m16n8 accumulators.
template <int BM_, int BN_, int WM_, int WN_>
struct GemmCfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kMI = BM / WM / 16, kNI = BN / WN / 8;
  static constexpr int kBBytes = BN * kRowB > kBK * (BN + 16) ? BN * kRowB : kBK * (BN + 16);
  static constexpr int kStageBytes = BM * kRowB + kBBytes;
  // the ring, plus two k-major B tiles when (M, N) weights arrive raw
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kSmemRaw = kSmem + 2 * BN * kRowB;
  static constexpr int kFrag = kMI * kNI * 4;          // int32 sums per thread
};
// 8 warps of 32 x 16 outputs: more warps per tile hide the latency of
// the short main loops and the epilogue.
typedef GemmCfg<64, 64, 2, 4> Tile64;                  // 256 threads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fill the rest.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col); wraps.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack4(const int8_t* src, int valid) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < valid) w |= (uint32_t)(uint8_t)src[b] << (8 * b);
  return w;
}

// A k-contiguous (rows, M) operand: R rows x 64 bytes of k per stage, as
// R*4 chunks of 16 bytes.  Async: one cp.async per chunk.  Bytes: the
// chunk is packed in registers (fetch) and stored later (stash).
template <int R, int NT>
struct KRows {
  static constexpr int kChunks = R * kBK / 16;
  static constexpr int kPer = (kChunks + NT - 1) / NT;
  uint32_t w[kPer][4];

  __device__ __forceinline__ static void async(const int8_t* src, int rows, int M, int r0,
                                               int k0, uint32_t dst) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kChunks) break;
      const int r = q >> 2, c = (q & 3) * 16;
      const bool ok = r0 + r < rows && k0 + c < M;
      cp_async16(dst + r * kRowB + c, ok ? src + (size_t)(r0 + r) * M + k0 + c : src,
                 ok ? 16 : 0);
    }
  }
  __device__ __forceinline__ void fetch(const int8_t* src, int rows, int M, int r0, int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kChunks) break;
      const int r = r0 + (q >> 2), c = k0 + (q & 3) * 16;
      const int8_t* row = src + (size_t)r * M;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c + 4 * j;
        w[i][j] = (r < rows && k < M) ? pack4(row + k, M - k) : 0u;
      }
    }
  }
  __device__ __forceinline__ void stash(int8_t* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kChunks) break;
      *reinterpret_cast<uint4*>(dst + (q >> 2) * kRowB + (q & 3) * 16) =
          make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
    }
  }
};

__device__ __forceinline__ void transpose4x4(const uint32_t* a, const uint32_t* b,
                                             const uint32_t* c, const uint32_t* d,
                                             uint32_t* out) {
  // rows a..d hold 4 k-rows x 16 n-bytes; out[n] gets the 4 k-bytes of column n
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t t0 = __byte_perm(a[w], b[w], 0x5140);
    const uint32_t t1 = __byte_perm(c[w], d[w], 0x5140);
    const uint32_t t2 = __byte_perm(a[w], b[w], 0x7362);
    const uint32_t t3 = __byte_perm(c[w], d[w], 0x7362);
    out[4 * w + 0] = __byte_perm(t0, t1, 0x5410);
    out[4 * w + 1] = __byte_perm(t0, t1, 0x7632);
    out[4 * w + 2] = __byte_perm(t2, t3, 0x5410);
    out[4 * w + 3] = __byte_perm(t2, t3, 0x7632);
  }
}

// (M, N) weights, n contiguous, with 16-byte aligned rows: each stage's 64
// k-rows x BN columns arrive as they lie (cp.async, rows padded to BN + 16
// bytes), then the block transposes them in shared memory, 4 k-rows x 16
// n-bytes per thread, into a k-major tile of BN rows.
template <int BN, int NT>
struct KNTile {
  static constexpr int kRaw = BN + 16;                 // padded raw row (bytes)
  static constexpr int kChunks = kBK * BN / 16;
  static constexpr int kBlocks = (kBK / 4) * (BN / 16);

  __device__ __forceinline__ static void async(const int8_t* src, int M, int N, int n0, int k0,
                                               uint32_t dst) {
#pragma unroll
    for (int i = 0; i < (kChunks + NT - 1) / NT; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kChunks) break;
      const int r = q / (BN / 16), c = (q % (BN / 16)) * 16;
      const bool ok = k0 + r < M && n0 + c < N;
      cp_async16(dst + r * kRaw + c, ok ? src + (size_t)(k0 + r) * N + n0 + c : src,
                 ok ? 16 : 0);
    }
  }
  __device__ __forceinline__ static void transpose(const int8_t* raw, int8_t* dst) {
#pragma unroll
    for (int i = 0; i < (kBlocks + NT - 1) / NT; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kBlocks) break;
      const int nc = q % (BN / 16), kq = q / (BN / 16);
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const uint4*>(raw + (4 * kq + j) * kRaw + 16 * nc);
      uint32_t w[16];
      transpose4x4(&v[0].x, &v[1].x, &v[2].x, &v[3].x, w);
      int8_t* col = dst + 16 * nc * kRowB + 4 * kq;
#pragma unroll
      for (int e = 0; e < 16; ++e) *reinterpret_cast<uint32_t*>(col + e * kRowB) = w[e];
    }
  }
};

// (M, N) weights whose rows are not 16-byte aligned: read byte by byte
// into registers (fetch), 4 k-rows x 16 n-bytes per block, packed k-major,
// and stored later (stash).
template <int BN, int NT>
struct KNBytes {
  static constexpr int kBlocks = (kBK / 4) * (BN / 16);
  static constexpr int kPer = (kBlocks + NT - 1) / NT;
  uint32_t w[kPer][16];

  __device__ __forceinline__ void fetch(const int8_t* src, int M, int N, int n0, int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kBlocks) break;
      const int k = k0 + 4 * (q % (kBK / 4)), n = n0 + 16 * (q / (kBK / 4));
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < M && n + e < N)
            word |= (uint32_t)(uint8_t)src[(size_t)(k + j) * N + n + e] << (8 * j);
        w[i][e] = word;
      }
    }
  }
  __device__ __forceinline__ void stash(int8_t* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kBlocks) break;
      int8_t* col = dst + 16 * (q / (kBK / 4)) * kRowB + 4 * (q % (kBK / 4));
#pragma unroll
      for (int e = 0; e < 16; ++e) *reinterpret_cast<uint32_t*>(col + e * kRowB) = w[i][e];
    }
  }
};

// The conv mode's geometry: patch row p, column k of the implicit patch
// matrix is map[iy, ix, ci] with (oy, ox) = (p / OW, p % OW),
// k = (ki * ks + kj) * C + ci, iy = oy * stride - pad + ki,
// ix = ox * stride - pad + kj, and 0 outside the (H, W) map.
struct ConvGeom {
  int H, W, C, ks, stride, pad, OW;
  int c_shift;       // log2(C) where C is a power of two, else -1
};

// A rows of the conv mode: R patch rows x 64 bytes of k per stage, gathered
// from the HWC map, one 16-byte cp.async per chunk (C % 16 == 0).  y0 / x0:
// each of the thread's rows' top-left pixel, fixed over the k-loop.
template <int R, int NT>
struct ConvRows {
  static constexpr int kChunks = R * kBK / 16;
  static constexpr int kPer = (kChunks + NT - 1) / NT;
  int y0[kPer], x0[kPer];

  __device__ __forceinline__ void init(const ConvGeom& g, int P, int r0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kChunks) break;
      const int p = r0 + (q >> 2);
      const int oy = p / g.OW, ox = p - oy * g.OW;
      // a row past P reads as zero: its pixel lies far above the map
      y0[i] = p < P ? oy * g.stride - g.pad : -(1 << 28);
      x0[i] = ox * g.stride - g.pad;
    }
  }
  __device__ __forceinline__ void async(const int8_t* img, const ConvGeom& g, int M, int k0,
                                        uint32_t dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q >= kChunks) break;
      const int r = q >> 2, c = (q & 3) * 16, k = k0 + c;
      const int seg = g.c_shift >= 0 ? k >> g.c_shift : k / g.C;
      const int ci = k - seg * g.C;
      const int ki = seg / g.ks, kj = seg - ki * g.ks;
      const int iy = y0[i] + ki, ix = x0[i] + kj;
      const bool ok = k < M && (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
      cp_async16(dst + r * kRowB + c, ok ? img + ((size_t)iy * g.W + ix) * g.C + ci : img,
                 ok ? 16 : 0);
    }
  }
};

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

// Grid (P tiles, N tiles, splits).  kVec: rows of both operands are
// 16-byte aligned; kKN: B is (M, N); kConv: A is the HWC map of geometry
// geom (the conv mode; with kVec and kKN).  kt_per k-tiles per split; with
// more than one split, ws holds each tile's BM * BN int32 sums and
// counters one int per tile (all zero on entry, zero on exit).
template <class C, bool kVec, bool kKN, bool kConv>
__global__ void __launch_bounds__(C::kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const int* __restrict__ bias, const int* __restrict__ shift,
                 const int8_t* __restrict__ res, int8_t* __restrict__ out,
                 int P, int N, int M, int relu, int kt_per, int* __restrict__ ws,
                 int* __restrict__ counters, ConvGeom geom) {
  static_assert(!kConv || (kVec && kKN), "the conv mode takes the aligned (M, N) path");
  constexpr int BM = C::BM, BN = C::BN, NT = C::kThreads, MI = C::kMI, NI = C::kNI;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % C::WM) * (BM / C::WM), wn0 = (warp / C::WM) * (BN / C::WN);
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt_all = (M + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * kt_per;
  const int nkt = min(kt_all, kt0 + kt_per) - kt0;

  // kVec && kKN: the stage's B region holds the raw (k, n) tile, which is
  // transposed into one of two k-major tiles past the ring (kb) before use
  constexpr bool kRaw = kVec && kKN;
  KRows<BM, NT> ra;
  KRows<BN, NT> rb;
  KNBytes<BN, NT> cb;
  ConvRows<BM, NT> ca;
  if constexpr (kConv) ca.init(geom, P, p0);

  auto a_of = [&](int st) { return smem + st * C::kStageBytes; };
  auto b_of = [&](int st) { return smem + st * C::kStageBytes + BM * kRowB; };
  auto kb_of = [&](int i) { return smem + kStages * C::kStageBytes + (i & 1) * BN * kRowB; };
  auto issue = [&](int kt, int st) {   // the asynchronous part of a stage
    if constexpr (kVec) {
      if constexpr (kConv) ca.async(A, geom, M, kt * kBK, smem_u32(a_of(st)));
      else KRows<BM, NT>::async(A, P, M, p0, kt * kBK, smem_u32(a_of(st)));
      if constexpr (kKN) KNTile<BN, NT>::async(B, M, N, n0, kt * kBK, smem_u32(b_of(st)));
      else KRows<BN, NT>::async(B, N, M, n0, kt * kBK, smem_u32(b_of(st)));
    }
  };
  auto fetch = [&](int kt) {           // the register-staged part: loads ...
    if constexpr (!kVec) {
      ra.fetch(A, P, M, p0, kt * kBK);
      if constexpr (kKN) cb.fetch(B, M, N, n0, kt * kBK);
      else rb.fetch(B, N, M, n0, kt * kBK);
    }
  };
  auto stash = [&](int st) {           // ... and stores
    if constexpr (!kVec) {
      ra.stash(a_of(st));
      if constexpr (kKN) cb.stash(b_of(st));
      else rb.stash(b_of(st));
    }
  };

  // the epilogue's operands, fetched (the residual into L2) now, so their
  // latency hides under the main loop
  if (res != nullptr && blockIdx.z == 0 && tid < BM && p0 + tid < P) {
    const int8_t* row = res + (size_t)(p0 + tid) * N;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + n0));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + min(n0 + BN, N) - 1));
  }
  const int s = *shift;
  int bn[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + j * 8 + 2 * (lane & 3) + e;
      bn[j][e] = bias != nullptr && n < N ? __ldg(bias + n) : 0;
    }

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) {
      issue(kt0 + st, st);
      fetch(kt0 + st);
      stash(st);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = i + kStages - 1;
    const bool more = nx < nkt;
    if (more) issue(kt0 + nx, nx % kStages);
    cp_async_commit();
    if (more) fetch(kt0 + nx);
    if constexpr (kRaw) {
      KNTile<BN, NT>::transpose(b_of(i % kStages), kb_of(i));
      __syncthreads();
    }

    const uint32_t a_base = smem_u32(a_of(i % kStages));
    const uint32_t b_base = smem_u32(kRaw ? kb_of(i) : b_of(i % kStages));
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a_base + (wm0 + mi * 16 + (lane & 15)) * kRowB + ks * 32 + (lane >> 4) * 16,
                    af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj)
        ldmatrix_x4(b_base + (wn0 + nj * 16 + ((lane >> 4) << 3) + (lane & 7)) * kRowB +
                        ks * 32 + ((lane >> 3) & 1) * 16,
                    bf[2 * nj][0], bf[2 * nj][1], bf[2 * nj + 1][0], bf[2 * nj + 1][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    if (more) stash(nx % kStages);
  }

  if (gridDim.z > 1) {   // split-K: add this block's partial; the last one finishes
    const int tile = blockIdx.x + gridDim.x * blockIdx.y;
    int* sum = ws + (size_t)tile * (BM * BN);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          atomicAdd(sum + ((i * NI + j) * 4 + r) * NT + tid, acc[i][j][r]);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int* e = sum + ((i * NI + j) * 4 + r) * NT + tid;
          acc[i][j][r] = __ldcg(e);
          __stcg(e, 0);
        }
    if (tid == 0) counters[tile] = 0;
  }

  // bias, shift_round, clip; + residual, clip; ReLU (as the clip's floor).
  // A thread holds two neighbouring columns of a row: with N even they
  // move as one 16-bit load and store.
  const int g = lane >> 2, t = lane & 3;
  const int lo = relu ? 0 : -128;
  const bool pairs = (N & 1) == 0 &&
                     ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(res)) & 1) == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wm0 + i * 16 + g + 8 * h;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * t;
        if (n >= N) continue;
        const size_t o = (size_t)p * N + n;
        int v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = min(max(shift_round((int)((uint32_t)acc[i][j][2 * h + e] + (uint32_t)bn[j][e]), s),
                         -128), 127);
        if (pairs) {
          if (res) {
            const uint16_t r = *reinterpret_cast<const uint16_t*>(res + o);
            v[0] += (int8_t)(r & 0xff);
            v[1] += (int8_t)(r >> 8);
          }
          *reinterpret_cast<uint16_t*>(out + o) =
              (uint16_t)((uint8_t)min(max(v[0], lo), 127) | (uint8_t)min(max(v[1], lo), 127) << 8);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= N) continue;
            if (res) v[e] += res[o + e];
            out[o + e] = (int8_t)min(max(v[e], lo), 127);
          }
        }
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

// The split of int8_gemm.py::gemm_plan: kt_per k-tiles in each of split
// pieces, and the scratch a split needs.
inline bool bad_split(int M, int split, int kt_per, void* ws, void* counters) {
  if (kt_per <= 0) return true;
  const int kt_all = (M + kBK - 1) / kBK;
  return split != (kt_all + kt_per - 1) / kt_per ||
         (split > 1 && (ws == nullptr || counters == nullptr));
}

template <class C, bool kVec, bool kKN, bool kConv = false>
int launch_gemm(const void* A, const void* B, const void* bias, const void* shift,
                const void* res, void* out, int P, int N, int M, int relu, int split,
                int kt_per, void* ws, void* counters, cudaStream_t s, ConvGeom g = {}) {
  const dim3 grid((P + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, split);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = int8_gemm_kernel<C, kVec, kKN, kConv>;
  const int smem = kVec && kKN ? C::kSmemRaw : C::kSmem;
  static bool configured[kMaxDevices] = {};   // the attributes, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || !configured[dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)   // all shared memory, no L1 carve-out: more blocks per SM
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::kThreads, smem, s>>>(
      (const int8_t*)A, (const int8_t*)B, (const int*)bias, (const int*)shift,
      (const int8_t*)res, (int8_t*)out, P, N, M, relu, kt_per, (int*)ws, (int*)counters, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (P, N) int8 <- post(A (P, M) . B^T + bias) with B (N, M), or B (M, N)
// when b_kn; bias and res may be null.  split and kt_per come from
// int8_gemm.py::gemm_plan; with split > 1, ws holds 64 * 64 int32 per
// output tile and counters one int per tile, all zero.
int repro_int8_gemm(const void* A, const void* B, const void* bias, const void* shift,
                    const void* res, void* out, int P, int N, int M, int relu, int b_kn,
                    int split, int kt_per, void* ws, void* counters, void* stream) {
  if (P <= 0 || N <= 0 || M <= 0 || shift == nullptr) return (int)cudaErrorInvalidValue;
  if (bad_split(M, split, kt_per, ws, counters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = M % 16 == 0 && aligned16(A) && aligned16(B) && (!b_kn || N % 16 == 0);
#define REPRO_GEMM(V, KN) \
  return launch_gemm<Tile64, V, KN>(A, B, bias, shift, res, out, P, N, M, relu, split, \
                                    kt_per, ws, counters, s)
  if (vec) {
    if (b_kn) REPRO_GEMM(true, true);
    REPRO_GEMM(true, false);
  }
  if (b_kn) REPRO_GEMM(false, true);
  REPRO_GEMM(false, false);
#undef REPRO_GEMM
}

// The conv mode: out (OH*OW, N) <- post(patches(img) . B^T + bias) with img
// the (H, W, C) int8 map and B the (ks*ks*C, N) weights; the patch matrix
// is gathered by the GEMM's A loads and never formed.  C and N multiples
// of 16, img and B 16-byte aligned.  split and kt_per come from
// int8_gemm.py::gemm_plan(OH*OW, N, ks*ks*C).
int repro_int8_conv_gemm(const void* img, const void* B, const void* bias, const void* shift,
                         const void* res, void* out, int H, int W, int C, int ks, int stride,
                         int pad, int N, int relu, int split, int kt_per, void* ws,
                         void* counters, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || ks <= 0 || stride <= 0 || pad < 0 || N <= 0 ||
      shift == nullptr || H + 2 * pad < ks || W + 2 * pad < ks)
    return (int)cudaErrorInvalidValue;
  if (C % 16 != 0 || N % 16 != 0 || !aligned16(img) || !aligned16(B))
    return (int)cudaErrorInvalidValue;
  const int OH = (H + 2 * pad - ks) / stride + 1, OW = (W + 2 * pad - ks) / stride + 1;
  const long long P = (long long)OH * OW, M = (long long)ks * ks * C;
  if (P > 0x7FFFFFFFLL || M > 0x7FFFFFFFLL || (long long)H * W * C > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (bad_split((int)M, split, kt_per, ws, counters)) return (int)cudaErrorInvalidValue;
  int c_shift = -1;
  if ((C & (C - 1)) == 0)
    for (c_shift = 0; (1 << c_shift) < C; ++c_shift) {}
  const ConvGeom g{H, W, C, ks, stride, pad, OW, c_shift};
  return launch_gemm<Tile64, true, true, true>(img, B, bias, shift, res, out, (int)P, N,
                                               (int)M, relu, split, kt_per, ws, counters,
                                               static_cast<cudaStream_t>(stream), g);
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
