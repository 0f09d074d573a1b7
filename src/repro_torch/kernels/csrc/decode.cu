// Hand-written Hopper (sm_90a) kernels for the single-token decode path.
//
// They replace the three Pallas TPU kernels of src/repro/kernels/decode.py
// (fused_qkv, fused_decode_attention, fused_mlp) and keep their numerical
// contract: float32 accumulation, one rounding to bf16 per matrix product,
// the bias added in bf16 after that rounding, RoPE in float32 on the rounded
// value, the -1e30 mask sentinel and max(l, 1e-30).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// Why the kernels look the way they do.  The decode batch is B <= 8 rows,
// far below a tensor-core tile, so every product here is a weight-streaming
// GEMV: each weight byte is used B times, about 16 operations per byte, far
// under the ~295 the H100 needs before arithmetic matters.  The attention
// reads each cached K and V byte for at most 8 query heads.  All of them
// are bound by the bytes they read from HBM.  The Pallas kernels walk a
// sequential grid on one TensorCore and carry sums in VMEM scratch from one
// grid step to the next; Hopper's blocks run in parallel and in no order.
// So every kernel here splits its reduction (the weight rows, or the cache
// slots) across blocks, writes float32 partials to a workspace, and lets
// the last block of each output tile combine them in a fixed order, so
// the result does not depend on which block finishes last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxB = 8;        // decode rows a launch may carry
constexpr float kNeg = -1e30f;  // mask sentinel (models.attention._NEG)
constexpr int kMaxDevices = 64; // devices whose kernel attributes are remembered

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 2^e for an int8 exponent e in [-126, 127], built from its bits: exact,
// where exp2f need not be.
__device__ __forceinline__ float pow2_exact(int e) { return __int_as_float((e + 127) << 23); }

// 8 int8 payloads times 2^e as 8 bf16 (exact: |q| <= 128 takes 8 bits, and
// q * 2^e with e >= -126 is a normal number or zero).
__device__ __forceinline__ uint4 dequant8(uint2 raw, float scale) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn((float)b[2 * i] * scale, (float)b[2 * i + 1] * scale);
  return out;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Prefer all of the SM's unified memory as shared memory (more blocks per
// SM), and allow up to `dyn_smem` bytes of dynamic shared memory, once per
// device for each kernel.
template <typename Kernel>
cudaError_t configure_once(Kernel kernel, bool* configured, int dyn_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && configured[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return err;
}

// ---------------------------------------------------- fused decode attention --
// Replaces repro/kernels/decode.py::fused_decode_attention
// (_decode_attn_kernel), launch 1 of 2; launch 2 is ctx @ wo + bo on the
// split-K GEMV below.
// Bound: the bytes of the K and V slots a lane may attend, read once
// (about 36 MB a layer at olmo-1b, B=8, Sk=584), plus wo in launch 2.
// Flash-decoding: grid (B*Hkv, S).  Block (b*Hkv + kh, s) owns chunk s of
// the cache, slots [s*C, s*C + C) (C and S from decode.py::attn_plan), for
// the G = Hq/Hkv query heads of kv-head kh, which share every K and V row
// it reads.  So at olmo-1b 128 (lane, kv-head) pairs give 1664 blocks of
// 48 slots, several per SM, where one block per pair (128 blocks) left
// most of the memory's bandwidth unused.
// - The block first works out which of its slots the lane may attend
//   (ring kv_positions, else col < kv_valid_len; causal col <= q_pos and
//   col > q_pos - window), from the device tensors alone.  A chunk with no
//   such slot issues no K or V load and writes an empty partial (l = 0).
// - Otherwise each warp takes a quarter of the chunk's slots through
//   every step on its own, with no block barrier between them: its K
//   rows, then its V rows (2*hd contiguous bytes each), go to shared
//   memory as 16-byte cp.async copies in two groups, so V is in flight
//   while the scores are computed; scores with hd/8 lanes per slot, 8
//   dims each, summed with shuffles (a masked slot scores -1e30); the
//   warp's softmax: m = its max, p = exp(s - m) (rounded to bf16 for the
//   PV product, as decode.py:321 does), l = sum of p in float32; PV with
//   each lane owning 8 dims of every head.  The four warps' states are
//   then rescaled to the chunk's max and added in a fixed order.
// - The partial (m[G], l[G], acc[G][hd]) goes to the workspace.  The last
//   block of a (lane, kv-head) to arrive (a counter) merges the partials
//   in split order, rescaling by exp(m_s - m) as the max grows, divides
//   by max(l, 1e-30), writes ctx in bf16 and sets the counter back to 0.
// - A lane with no slot to attend has p = 1 on every slot in the plain
//   version (exp(-1e30 - -1e30)), so its ctx is the mean of V over all Sk
//   slots: when every partial is empty, the merging block computes that.
// All sums run in a fixed order, so two calls give equal bits.
// The int8 cache (Q8; repro/models/transformer.py::kv_quantize): K and V
// are int8 payloads with one int8 exponent per (slot, kv-head).  Each
// warp loads its slots' 8-byte pieces and their exponents and writes
// q * 2^e, exact in bf16, into the same shared-memory chunk the bf16
// variant fills (K first, V after the scores); the chunk is sized in bf16
// as there, and everything after the load is the same code, so the result
// equals the bf16 variant's on the dequantized cache bit for bit while the
// cache's bytes halve.  (Holding a warp's K and V pieces in registers, all
// loads issued at once, timed no faster and spilled at (2, 128) and
// (4, 256): PERF.md.)
constexpr int kAtThreads = 128;                 // 4 warps
constexpr int kAtWarps = kAtThreads / 32;
constexpr int kAtMaxSlots = 256;                // slots a chunk may hold (decode.py ATTN_MAX_SLOTS)
constexpr int kAtChunkBytes = 16384;            // bytes of K a chunk may hold (ATTN_CHUNK_BYTES)
constexpr int kAtBatch = 8;                     // splits whose partials the merge loads at once

// Dynamic shared memory of a chunk of C slots: its K and V rows, the
// warps' PV sums, the float32 scores and the bf16 p.
__host__ __device__ inline int attn_smem_bytes(int C, int G, int HD) {
  return 2 * C * HD * 2 + kAtWarps * G * HD * 4 + G * C * 4 + G * C * 2;
}

// The rows [w0, w1) of a chunk starting at slot c0 of an int8 cache (lane
// and kv-head base `src`, their exponents from `ex`, one every Hkv bytes)
// into `dst` ([C][HD] bf16) as q * 2^e, one 8-byte piece a lane at a time.
template <int HD>
__device__ __forceinline__ void dequant_rows(bf16* dst, const int8_t* src, const int8_t* ex,
                                             int w0, int w1, int c0, size_t slot, int Hkv,
                                             int lane) {
  constexpr int LPS = HD / 8;
  for (int i = lane; i < (w1 - w0) * LPS; i += 32) {
    const int r = w0 + i / LPS, c = i % LPS;
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src + (size_t)(c0 + r) * slot + c * 8));
    *reinterpret_cast<uint4*>(dst + r * HD + c * 8) =
        dequant8(raw, pow2_exact(__ldg(ex + (size_t)(c0 + r) * Hkv)));
  }
}

template <int G, int HD, bool Q8>
__global__ void __launch_bounds__(kAtThreads)
attn_kernel(const bf16* __restrict__ q,
            const typename std::conditional<Q8, int8_t, bf16>::type* __restrict__ k,
            const typename std::conditional<Q8, int8_t, bf16>::type* __restrict__ v,
            const int8_t* __restrict__ ke, const int8_t* __restrict__ ve,
            const int* __restrict__ kvp, int kvp_stride,
            const int* __restrict__ limit, int limit_stride,
            const int* __restrict__ qpos, const int* __restrict__ win_ptr,
            int win_static, int causal, float scale, bf16* __restrict__ ctx,
            int Sk, int Hkv, int C, float* __restrict__ ws, int* __restrict__ counters) {
  constexpr int LPS = HD / 8;            // lanes per slot (16 bytes of a row each)
  constexpr int RPW = 32 / LPS;          // slots a warp covers per step
  // At HD 256 a slot fills the warp (LPS 32, RPW 1): the score shuffles
  // sum all 32 lanes, the PV shuffle loop below runs no step, and every
  // lane writes its own 8 dims of the warp's sum.
  static_assert(LPS >= 4 && LPS <= 32 && 32 % LPS == 0, "hd must be 32, 64, 128 or 256");
  constexpr int PART = G * (HD + 2);     // floats of a partial: m[G], l[G], acc[G][HD]
  extern __shared__ __align__(16) uint8_t at_smem[];
  __shared__ uint8_t ok[kAtMaxSlots];
  __shared__ float wm[kAtWarps][G], wl[kAtWarps][G];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dc = lane % LPS;             // this lane's 8 dims: [8 dc, 8 dc + 8)
  const int bk = blockIdx.x, b = bk / Hkv, kh = bk % Hkv;
  const int S = gridDim.y, c0 = blockIdx.y * C, n = min(C, Sk - c0);
  const int Hq = Hkv * G;
  const size_t slot = (size_t)Hkv * HD;  // elements between cache slots
  const auto* kb = k + ((size_t)b * Sk * Hkv + kh) * HD;
  const auto* vb = v + ((size_t)b * Sk * Hkv + kh) * HD;
  // the int8 cache's exponents of this lane and kv-head, one a slot
  const int8_t* keb = Q8 ? ke + (size_t)b * Sk * Hkv + kh : nullptr;
  const int8_t* veb = Q8 ? ve + (size_t)b * Sk * Hkv + kh : nullptr;
  float* part = ws + ((size_t)bk * S + blockIdx.y) * PART;

  // the slots of this chunk the lane may attend (decode.py:291-301)
  const long long row = causal ? qpos[b] : 0;
  const long long win = win_ptr != nullptr ? *win_ptr : win_static;
  const long long lim = limit != nullptr ? limit[(size_t)b * limit_stride] : Sk;
  int any = 0;
  for (int j = tid; j < n; j += kAtThreads) {
    long long col = c0 + j;
    bool valid;
    if (kvp != nullptr) {
      col = kvp[(size_t)b * kvp_stride + c0 + j];
      valid = col >= 0;  // ring slot never written
    } else {
      valid = col < lim;
    }
    if (causal) valid = valid && col <= row && col > row - win;
    ok[j] = valid;
    any |= valid;
  }
  any = __syncthreads_or(any);

  if (any) {
    bf16* ks = reinterpret_cast<bf16*>(at_smem);                           // [C][HD]
    bf16* vs = ks + C * HD;                                                // [C][HD]
    float* red = reinterpret_cast<float*>(vs + C * HD);                    // [warps][G][HD]
    float* sc = red + kAtWarps * G * HD;                                   // [G][C]
    bf16* pb = reinterpret_cast<bf16*>(sc + G * C);                        // [G][C]
    // each warp owns slots [w0, w1) of the chunk: it copies their rows and
    // takes them through scores, softmax and PV on its own
    const int per = (n + kAtWarps - 1) / kAtWarps;
    const int w0 = min(n, warp * per), w1 = min(n, w0 + per);
    if constexpr (Q8) {
      // dequantized as loaded; V after the scores
      dequant_rows<HD>(ks, kb, keb, w0, w1, c0, slot, Hkv, lane);
    } else {
      for (int i = lane; i < (w1 - w0) * LPS; i += 32) {
        const int r = w0 + i / LPS, c = i % LPS;
        cp_async16(smem_u32(ks + r * HD + c * 8), kb + (size_t)(c0 + r) * slot + c * 8, 16);
      }
      cp_async_commit();
      for (int i = lane; i < (w1 - w0) * LPS; i += 32) {
        const int r = w0 + i / LPS, c = i % LPS;
        cp_async16(smem_u32(vs + r * HD + c * 8), vb + (size_t)(c0 + r) * slot + c * 8, 16);
      }
      cp_async_commit();
    }

    // (q * scale) rounded to bf16 before the score product (decode.py:287)
    float qr[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(q + ((size_t)b * Hq + kh * G + g) * HD + dc * 8)),
              qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = round_bf16(qr[g][e] * scale);
    }
    cp_async_wait<1>();
    __syncwarp();

    for (int j0 = w0; j0 < w1; j0 += RPW) {
      const int j = j0 + lane / LPS;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      if (j < w1) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(ks + j * HD + dc * 8), kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(qr[g][e], kf[e], s[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int o = LPS / 2; o > 0; o >>= 1) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      if (j < w1 && dc == 0)
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g * C + j] = ok[j] ? s[g] : kNeg;
    }
    __syncwarp();

    // the warp's streaming-softmax state (decode.py:305-328)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = kNeg;
      for (int j = w0 + lane; j < w1; j += 32) mx = fmaxf(mx, sc[g * C + j]);
      mx = warp_max(mx);
      float l = 0.f;
      for (int j = w0 + lane; j < w1; j += 32) {
        const float p = expf(sc[g * C + j] - mx);
        l += p;
        pb[g * C + j] = __float2bfloat16(p);
      }
      l = warp_sum(l);
      if (lane == 0) {
        wm[warp][g] = mx;
        wl[warp][g] = l;
      }
    }
    if constexpr (Q8) dequant_rows<HD>(vs, vb, veb, w0, w1, c0, slot, Hkv, lane);
    else cp_async_wait<0>();
    __syncwarp();

    float acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    for (int j = w0 + lane / LPS; j < w1; j += RPW) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(vs + j * HD + dc * 8), vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = bf2f(pb[g * C + j]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    if (lane < LPS)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * G + g) * HD + dc * 8 + e] = acc[g][e];
    __syncthreads();

    // the chunk's state: the warps' states rescaled to the chunk's max (a
    // warp with no slot to attend has m = -1e30 and weighs exp(-1e30 - m) = 0)
    for (int i = tid; i < G * HD; i += kAtThreads) {
      const int g = i / HD;
      float m = wm[0][g];
#pragma unroll
      for (int w = 1; w < kAtWarps; ++w) m = fmaxf(m, wm[w][g]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kAtWarps; ++w) {
        const float c = expf(wm[w][g] - m);
        a += red[w * G * HD + i] * c;
        l += wl[w][g] * c;
      }
      __stcg(part + 2 * G + i, a);
      if (i % HD == 0) {
        __stcg(part + g, m);
        __stcg(part + G + g, l);
      }
    }
  } else if (tid < G) {   // no slot to attend: an empty partial
    __stcg(part + tid, kNeg);
    __stcg(part + G + tid, 0.f);
  }

  __threadfence();
  __syncthreads();
  if (S > 1) {
    if (tid == 0) s_last = atomicAdd(counters + bk, 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }

  // the last block of (b, kh): every chunk's partial in split order, in
  // one pass that rescales as the maximum grows, the loads of kAtBatch
  // splits in flight at a time.  A chunk with no slot to attend has l = 0
  // and is passed over.
  const float* parts = ws + (size_t)bk * S * PART;
  bf16* out = ctx + ((size_t)b * Hq + kh * G) * HD;
  bool seen = false;   // a chunk had a slot to attend (the same for every head)
  for (int i = tid; i < G * HD; i += kAtThreads) {
    const int g = i / HD;
    float m = -INFINITY, num = 0.f, den = 0.f;
    for (int z0 = 0; z0 < S; z0 += kAtBatch) {
      float ms[kAtBatch], ls[kAtBatch], as[kAtBatch];
#pragma unroll
      for (int u = 0; u < kAtBatch; ++u) {
        const bool in = z0 + u < S;
        const float* ps = parts + (size_t)(in ? z0 + u : 0) * PART;
        ms[u] = __ldcg(ps + g);
        ls[u] = in ? __ldcg(ps + G + g) : 0.f;
        as[u] = __ldcg(ps + 2 * G + i);
      }
#pragma unroll
      for (int u = 0; u < kAtBatch; ++u)
        if (ls[u] > 0.f) {
          const float mn = fmaxf(m, ms[u]);
          const float co = expf(m - mn), cs = expf(ms[u] - mn);
          den = den * co + ls[u] * cs;
          num = num * co + as[u] * cs;
          m = mn;
        }
    }
    seen = seen || m != -INFINITY;
    out[i] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  if (!__syncthreads_or(seen)) {
    // every slot masked: p = 1 on all Sk slots, ctx = their mean of V
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int j = lane / LPS + warp * RPW; j < Sk; j += kAtWarps * RPW) {
      float vf[8];
      if constexpr (Q8)
        unpack8(dequant8(__ldg(reinterpret_cast<const uint2*>(vb + (size_t)j * slot + dc * 8)),
                         pow2_exact(__ldg(veb + (size_t)j * Hkv))),
                vf);
      else
        unpack8(__ldg(reinterpret_cast<const uint4*>(vb + (size_t)j * slot + dc * 8)), vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += vf[e];
    }
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    float* red = reinterpret_cast<float*>(at_smem);
    if (lane < LPS)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp * HD + dc * 8 + e] = acc[e];
    __syncthreads();
    for (int i = tid; i < G * HD; i += kAtThreads) {
      const int d = i % HD;
      float a = red[d];
#pragma unroll
      for (int w = 1; w < kAtWarps; ++w) a += red[w * HD + d];
      out[i] = __float2bfloat16(a / (float)Sk);
    }
  }
  if (S > 1 && tid == 0) counters[bk] = 0;
}

// ------------------------------------------------ split-K tensor-core GEMV --
// Replaces repro/kernels/decode.py::fused_mlp (_mlp_kernel) in two
// launches (gate/up + activation into h, then h @ w_down + b_down), is
// launch 2 of fused_decode_attention (ctx @ wo + bo), and, as its own
// kernel qkv_gemv_kernel, replaces repro/kernels/decode.py::fused_qkv
// (_qkv_kernel).
// y[b, n] = epilogue(sum_k x[b, k] w[k, n]) for b < B <= 8.  The TPU
// kernel kept h in VMEM; here h (128 KB at B=8) stays in the 50 MB L2
// between the two launches.
// Bound: the bytes of w (33.6 MB for w_down at olmo-1b).  The design is
// about streaming them at the memory's rate from every SM:
// - wide tiles: a block owns 128 output columns and streams weight tiles
//   of 64 k-rows x 128 columns (256 contiguous bytes a row, whole sectors)
//   through a ring of 4 stages of 16-byte cp.async copies, rows swizzled
//   (16-byte chunk c of row r stored at c ^ (r & 7)) so ldmatrix is free
//   of bank conflicts;
// - tensor cores: the block computes the transpose, out^T (N, B) = W^T
//   (N, K) . x^T (K, B), with mma.sync m16n8k16 bf16 -> f32: the weight
//   tile is the A operand, read k-major from the row-major (k, n) tile by
//   ldmatrix.trans; x^T is the B operand, its 8 columns the decode rows
//   (rows past B read as zero), from a slice of x kept in shared memory;
// - split-K: the grid's y axis splits the k-tiles as finely as one wave
//   of one block per SM allows, so every SM streams an equal share
//   (repro_torch/kernels/decode.py::gemv_plan; 128 blocks of 16 k-tiles
//   at olmo-1b's MLP).  Each block writes its f32 partial to a
//   workspace; the last block of a column tile to arrive (a per-tile
//   counter, __threadfence + atomicAdd) sums the partials in split
//   order, so the result does not depend on which block finishes last,
//   and sets the counter back to 0.
// The epilogue keeps the contract: one rounding to bf16 of the f32 sum,
// then the bias in bf16; for the MLP's up pass (act >= 0) the activation
// in f32 with the rounding points of repro/kernels/decode.py::_mlp_kernel.
// With w1 (swiglu only), each block streams the tiles of w0 (gate) and w1
// (up) in turn and keeps both sums.
// act: -1 none (bias only), 0 swiglu, 1 gelu (tanh form, as
// jax.nn.gelu), 2 squared relu.
//
// QKV (bound: the 25.2 MB of wq, wk and wv at olmo-1b): one grid over the
// column tiles of all three weights, read where they lie (no copy or
// concatenation): tiles [0, tq) are wq's, then wk's, then wv's, and no
// tile straddles two matrices.  A head of hd <= 128 lies inside one tile;
// a 256-wide head spans two, and tile r of it holds dims [64r, 64r + 64)
// of both halves, so both columns of every RoPE pair meet in one tile
// (qkv_col; decode.py::qkv_columns).  Every block computes the cos and
// sin of its tile's B x 64 RoPE angles, pos * theta^(-2j/hd) as
// repro/kernels/decode.py:188-193 computes them, while its first weight
// tiles are in flight; the last block of a tile stages the rounded, biased
// tile (B x 128 f32) in shared memory, then rotates each pair of q and k
// columns in float32 with no fused multiply-adds.
constexpr int kGvThreads = 128;              // 4 warps
constexpr int kGvN = 128;                    // output columns of a block
constexpr int kGvMT = kGvN / (kGvThreads / 32) / 16;   // m16 column tiles of a warp
constexpr int kGvK = 64;                     // weight rows of a stage
constexpr int kGvStages = 4;
constexpr int kGvTile = kGvK * kGvN * 2;     // bytes of a stage
constexpr int kGvFrag = 4 * kGvMT;           // f32 sums per thread per matrix
constexpr int kGvMaxKt = 32;                 // k-tiles a split may take (decode.py GEMV_MAX_KT)
constexpr int kGvMaxSmem = kGvStages * kGvTile + kMaxB * (kGvMaxKt * kGvK + 8) * 2;

// Matrix column of local column lc of QKV tile tl (the tile's index within
// its matrix).
__device__ __forceinline__ int qkv_col(int tl, int lc, int hd) {
  if (hd <= kGvN) return tl * kGvN + lc;
  return (tl >> 1) * hd + (lc >= kGvN / 2 ? hd / 2 : 0) + (tl & 1) * (kGvN / 2) + (lc & (kGvN / 2 - 1));
}

struct QkvArgs {
  const bf16* w[3];        // wq, wk, wv (K, n[i]) row-major
  const bf16* bias[3];     // or all null
  bf16* y[3];              // q, k, v (B, n[i])
  int n[3];                // columns of each matrix
  int tiles[3];            // column tiles of each
  const int* pos;          // (B,) or null (position 0)
  int hd, rope;
  float theta;
};

// The shared body.  Grid (column tiles, splits); kt_per k-tiles per split.
// Shared memory: the ring, then the block's slice of x as B rows of
// xs_stride elements.  With more than one split, ws holds tiles * splits *
// nmat * 1024 floats and counters one int per column tile (zero on entry,
// zero on exit).  With kQkv, tl is the tile's index within its matrix, and
// rot says whether its columns are rotated.
template <bool kQkv>
__device__ __forceinline__ void gemv_body(
    const bf16* __restrict__ x, const bf16* __restrict__ w0, const bf16* __restrict__ w1,
    const bf16* __restrict__ bias, bf16* __restrict__ y, int B, int K, int N, int kt_per,
    int xs_stride, float* __restrict__ ws, int* __restrict__ counters, int act, int tl,
    int hd, bool rot, const int* __restrict__ pos, float theta) {
  extern __shared__ __align__(16) uint8_t gv_smem[];
  __shared__ int s_last;
  // QKV: cos and sin of each (decode row, RoPE pair of the tile)
  __shared__ float rope_cs[kQkv ? kMaxB * kGvN / 2 : 1], rope_sn[kQkv ? kMaxB * kGvN / 2 : 1];
  bf16* xs = reinterpret_cast<bf16*>(gv_smem + kGvStages * kGvTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nmat = w1 != nullptr ? 2 : 1;
  const int tile = blockIdx.x, n0 = tile * kGvN;
  const int kt0 = blockIdx.y * kt_per;
  const int nkt = min((K + kGvK - 1) / kGvK, kt0 + kt_per) - kt0;
  const int tiles = nkt * nmat;   // weight tiles this block streams
  auto col = [&](int lc) {        // the weight column of the tile's column lc
    if constexpr (kQkv) return qkv_col(tl, lc, hd);
    else return n0 + lc;
  };
  // QKV: the tile's RoPE pairs, (lc, lc + lhalf) for the p-th first-half column lc
  const int lhalf = min(hd, kGvN) / 2;
  auto pair_col = [&](int p) { return p / lhalf * (2 * lhalf) + p % lhalf; };

  // this block's slice of x, in the first copy group
  for (int q = tid; q < B * nkt * (kGvK / 8); q += kGvThreads) {
    const int b = q / (nkt * (kGvK / 8)), c = q % (nkt * (kGvK / 8));
    const int k = kt0 * kGvK + c * 8;
    const bool ok = k < K;
    cp_async16(smem_u32(xs + b * xs_stride + c * 8), ok ? x + (size_t)b * K + k : x,
               ok ? 16 : 0);
  }
  auto load = [&](int i) {   // weight tile i -> ring slot i % kGvStages
    const bf16* w = (i % nmat) ? w1 : w0;
    const int k0 = (kt0 + i / nmat) * kGvK;
    const uint32_t slot = smem_u32(gv_smem + (i % kGvStages) * kGvTile);
#pragma unroll
    for (int j = 0; j < kGvTile / 16 / kGvThreads; ++j) {
      const int q = tid + j * kGvThreads;
      const int r = q >> 4, c = q & 15;
      const int n = col(c * 8);
      const bool ok = k0 + r < K && n < N;
      cp_async16(slot + r * (kGvN * 2) + ((c ^ (r & 7)) << 4),
                 ok ? w + (size_t)(k0 + r) * N + n : w, ok ? 16 : 0);
    }
  };

  float acc0[kGvFrag], acc1[kGvFrag];
#pragma unroll
  for (int f = 0; f < kGvFrag; ++f) acc0[f] = acc1[f] = 0.f;

#pragma unroll
  for (int i = 0; i < kGvStages - 1; ++i) {
    if (i < tiles) load(i);
    cp_async_commit();
  }
  if constexpr (kQkv) {
    // the rotation's angles pos * theta^(-2j/hd), as repro/kernels/decode.py:188-193
    // computes them, while the first tiles are in flight
    if (rot)
      for (int i = tid; i < B * (kGvN / 2); i += kGvThreads) {
        const int b = i / (kGvN / 2);
        const int j = col(pair_col(i % (kGvN / 2))) % hd;
        const float freq = 1.0f / powf(theta, __fdiv_rn((float)(2 * j), (float)hd));
        const float ang = __fmul_rn((float)(pos != nullptr ? pos[b] : 0), freq);
        rope_sn[i] = sinf(ang);
        rope_cs[i] = cosf(ang);
      }
  }
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kGvStages - 2>();
    __syncthreads();
    if (i + kGvStages - 1 < tiles) load(i + kGvStages - 1);
    cp_async_commit();
    const uint32_t slot = smem_u32(gv_smem + (i % kGvStages) * kGvTile);
    const bf16* xk = xs + g * xs_stride + (i / nmat) * kGvK + 2 * t;
    const bool second = (i % nmat) != 0;
#pragma unroll
    for (int ks = 0; ks < kGvK / 16; ++ks) {
      uint32_t bx[2] = {0u, 0u};
      if (g < B) {
        bx[0] = *reinterpret_cast<const uint32_t*>(xk + ks * 16);
        bx[1] = *reinterpret_cast<const uint32_t*>(xk + ks * 16 + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kGvMT; ++mt) {
        const int j = lane >> 3;
        const int kr = ks * 16 + (j >> 1) * 8 + (lane & 7);
        const int c = (warp * kGvMT + mt) * 2 + (j & 1);   // 16-byte chunk of the row
        uint32_t a[4];
        ldmatrix_x4_trans(slot + kr * (kGvN * 2) + ((c ^ (kr & 7)) << 4), a);
        if (second) mma_bf16(acc1 + 4 * mt, a, bx);
        else mma_bf16(acc0 + 4 * mt, a, bx);
      }
    }
  }

  if (gridDim.y > 1) {   // split-K: publish this block's partial; the last one sums
    const int S = gridDim.y;
    float* mine = ws + (size_t)(tile * S + blockIdx.y) * nmat * (kGvFrag * kGvThreads);
#pragma unroll
    for (int f = 0; f < kGvFrag; ++f) {
      __stcg(mine + f * kGvThreads + tid, acc0[f]);
      if (nmat == 2) __stcg(mine + (kGvFrag + f) * kGvThreads + tid, acc1[f]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the partials in split order (deterministic), four splits' loads in
    // flight at a time
    float sum0[kGvFrag], sum1[kGvFrag];
#pragma unroll
    for (int f = 0; f < kGvFrag; ++f) sum0[f] = sum1[f] = 0.f;
    for (int z0 = 0; z0 < S; z0 += 4) {
      float p0[4][kGvFrag], p1[4][kGvFrag];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int z = z0 + u;
        const float* part = ws + (size_t)(tile * S + z) * nmat * (kGvFrag * kGvThreads) + tid;
#pragma unroll
        for (int f = 0; f < kGvFrag; ++f) {
          const bool other = z < S && z != (int)blockIdx.y;
          p0[u][f] = other ? __ldcg(part + f * kGvThreads) : acc0[f];
          p1[u][f] = other && nmat == 2 ? __ldcg(part + (kGvFrag + f) * kGvThreads) : acc1[f];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (z0 + u < S)
#pragma unroll
          for (int f = 0; f < kGvFrag; ++f) {
            sum0[f] += p0[u][f];
            sum1[f] += p1[u][f];
          }
    }
#pragma unroll
    for (int f = 0; f < kGvFrag; ++f) {
      acc0[f] = sum0[f];
      acc1[f] = sum1[f];
    }
    if (tid == 0) counters[tile] = 0;
  }

  if constexpr (kQkv) {
    // stage the tile rounded to bf16 and biased, so each RoPE pair meets
    // its partner (c +- hd/2, another warp's fragment), then rotate
    float* st = reinterpret_cast<float*>(gv_smem);   // [B][kGvN]; the ring is spent
    __syncthreads();
#pragma unroll
    for (int f = 0; f < kGvFrag; ++f) {
      const int lc = (warp * kGvMT + (f >> 2)) * 16 + g + ((f >> 1) & 1) * 8;
      const int b = 2 * t + (f & 1);
      const int n = col(lc);
      if (b >= B || n >= N) continue;
      float v = round_bf16(acc0[f]);
      if (bias != nullptr) v = round_bf16(v + bf2f(bias[n]));
      st[b * kGvN + lc] = v;
    }
    __syncthreads();
    for (int i = tid; i < B * (kGvN / 2); i += kGvThreads) {
      const int b = i / (kGvN / 2), lc = pair_col(i % (kGvN / 2));
      const int n = col(lc);   // its partner is column n + hd/2, at lc + lhalf
      if (n >= N) continue;
      float t1 = st[b * kGvN + lc], t2 = st[b * kGvN + lc + lhalf];
      if (rot) {
        // t1*cos - t2*sin | t2*cos + t1*sin, without fused multiply-adds so
        // the float32 value is the reference's
        const float cs = rope_cs[i], sn = rope_sn[i];
        const float r1 = __fsub_rn(__fmul_rn(t1, cs), __fmul_rn(t2, sn));
        t2 = __fadd_rn(__fmul_rn(t2, cs), __fmul_rn(t1, sn));
        t1 = r1;
      }
      y[(size_t)b * N + n] = __float2bfloat16(t1);
      y[(size_t)b * N + n + hd / 2] = __float2bfloat16(t2);
    }
    return;
  }

  // accumulator f = 4 * mt + r: column n0 + (warp*kGvMT + mt)*16 + g + 8*(r/2),
  // decode row 2t + r%2
#pragma unroll
  for (int f = 0; f < kGvFrag; ++f) {
    const int n = n0 + (warp * kGvMT + (f >> 2)) * 16 + g + ((f >> 1) & 1) * 8;
    const int b = 2 * t + (f & 1);
    if (b >= B || n >= N) continue;
    float v = round_bf16(acc0[f]);
    if (bias != nullptr) v = round_bf16(v + bf2f(bias[n]));
    if (act == 0) {
      const float sg = round_bf16(v / (1.0f + expf(-v)));
      v = round_bf16(sg * round_bf16(acc1[f]));
    } else if (act == 1) {
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      v = round_bf16(0.5f * v * (1.0f + tanhf(inner)));
    } else if (act == 2) {
      const float r = fmaxf(v, 0.f);
      v = round_bf16(r * r);
    }
    y[(size_t)b * N + n] = __float2bfloat16(v);
  }
}

__global__ void __launch_bounds__(kGvThreads)
gemv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
            const bf16* __restrict__ w1, const bf16* __restrict__ bias,
            bf16* __restrict__ y, int B, int K, int N, int kt_per, int xs_stride,
            float* __restrict__ ws, int* __restrict__ counters, int act) {
  gemv_body<false>(x, w0, w1, bias, y, B, K, N, kt_per, xs_stride, ws, counters, act, 0, 0,
                   false, nullptr, 0.f);
}

// fused_qkv: blockIdx.x runs over the tiles of wq, then wk, then wv.
__global__ void __launch_bounds__(kGvThreads)
qkv_gemv_kernel(const bf16* __restrict__ x, const QkvArgs a, int B, int K, int kt_per,
                int xs_stride, float* __restrict__ ws, int* __restrict__ counters) {
  const int tile = blockIdx.x;
  const int m = tile < a.tiles[0] ? 0 : tile < a.tiles[0] + a.tiles[1] ? 1 : 2;
  const int tl = tile - (m > 0 ? a.tiles[0] : 0) - (m > 1 ? a.tiles[1] : 0);
  const bf16* w = m == 0 ? a.w[0] : m == 1 ? a.w[1] : a.w[2];
  const bf16* bias = m == 0 ? a.bias[0] : m == 1 ? a.bias[1] : a.bias[2];
  bf16* y = m == 0 ? a.y[0] : m == 1 ? a.y[1] : a.y[2];
  const int N = m == 0 ? a.n[0] : m == 1 ? a.n[1] : a.n[2];
  gemv_body<true>(x, w, nullptr, bias, y, B, K, N, kt_per, xs_stride, ws, counters, -1, tl,
                  a.hd, a.rope != 0 && m < 2, a.pos, a.theta);
}

// The x slice's row stride and the dynamic shared memory of a split of
// kt_per k-tiles; -1 if the split does not match kt_per.
int gemv_launch_shape(int B, int K, int kt_per, int split, int* xs_stride, int* smem) {
  const int kt_all = (K + kGvK - 1) / kGvK;
  if (kt_per <= 0 || kt_per > kGvMaxKt || split != (kt_all + kt_per - 1) / kt_per) return -1;
  *xs_stride = kt_per * kGvK + 8;   // +16 bytes: conflict-free x reads
  *smem = kGvStages * kGvTile + B * *xs_stride * 2;
  return 0;
}

// attn_kernel<G, hd, Q8> for the call's G = Hq/Hkv and hd (the C entry
// points below say which it takes).
template <bool Q8>
int launch_attention(const void* q, const void* k, const void* v, const void* ke,
                     const void* ve, const void* kvp, int kvp_stride, const void* limit,
                     int limit_stride, const void* qpos, const void* win_ptr, int win_static,
                     int causal, float scale, void* ctx, int B, int Sk, int Hq, int Hkv, int hd,
                     int chunk, int splits, void* ws, void* counters, void* stream) {
  typedef typename std::conditional<Q8, int8_t, bf16>::type KV;
  if (B <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || chunk <= 0 || chunk % 16 != 0 ||
      chunk > kAtMaxSlots || chunk * hd * 2 > kAtChunkBytes ||
      splits != (Sk + chunk - 1) / chunk || ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv, splits);
#define REPRO_ATTN(GV, HDV)                                                            \
  if (G == GV && hd == HDV) {                                                          \
    static bool configured[kMaxDevices] = {};                                          \
    const int most = attn_smem_bytes(kAtChunkBytes / (2 * HDV), GV, HDV);              \
    const cudaError_t err = configure_once(attn_kernel<GV, HDV, Q8>, configured, most); \
    if (err != cudaSuccess) return (int)err;                                           \
    attn_kernel<GV, HDV, Q8><<<grid, kAtThreads, attn_smem_bytes(chunk, GV, HDV), s>>>( \
        (const bf16*)q, (const KV*)k, (const KV*)v, (const int8_t*)ke, (const int8_t*)ve, \
        (const int*)kvp, kvp_stride, (const int*)limit, limit_stride, (const int*)qpos,  \
        (const int*)win_ptr, win_static, causal, scale, (bf16*)ctx, Sk, Hkv, chunk,      \
        (float*)ws, (int*)counters);                                                   \
    return (int)cudaGetLastError();                                                    \
  }
  REPRO_ATTN(1, 32) REPRO_ATTN(1, 64) REPRO_ATTN(1, 128) REPRO_ATTN(1, 256)
  REPRO_ATTN(2, 32) REPRO_ATTN(2, 64) REPRO_ATTN(2, 128) REPRO_ATTN(2, 256)
  REPRO_ATTN(4, 32) REPRO_ATTN(4, 64) REPRO_ATTN(4, 128) REPRO_ATTN(4, 256)
  REPRO_ATTN(8, 32) REPRO_ATTN(8, 64) REPRO_ATTN(8, 128) REPRO_ATTN(8, 256)
  REPRO_ATTN(6, 32) REPRO_ATTN(6, 64) REPRO_ATTN(6, 128) REPRO_ATTN(6, 256)
  REPRO_ATTN(12, 32) REPRO_ATTN(12, 64) REPRO_ATTN(12, 128) REPRO_ATTN(12, 256)
#undef REPRO_ATTN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Hq*hd), k/v (B, Hkv*hd) <- x (B, K) @ wq/wk/wv (K, .) + bias, RoPE.
// kt_per and split come from decode.py::qkv_plan; with split > 1, ws holds
// tiles * split * 1024 floats and counters one zeroed int per tile.
int repro_fused_qkv(const void* x, const void* wq, const void* wk, const void* wv,
                    const void* bq, const void* bk, const void* bv, const void* pos,
                    void* q, void* k, void* v, int B, int K, int Hq, int Hkv, int hd,
                    int rope, float theta, int kt_per, int split, void* ws, void* counters,
                    void* stream) {
  if (B < 1 || B > kMaxB || K <= 0 || K % 8 != 0 || Hq <= 0 || Hkv <= 0 ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256))
    return (int)cudaErrorInvalidValue;
  int xs_stride = 0, smem = 0;
  if (gemv_launch_shape(B, K, kt_per, split, &xs_stride, &smem) != 0 ||
      (split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = configure_once(qkv_gemv_kernel, configured, kGvMaxSmem);
  if (err != cudaSuccess) return (int)err;
  QkvArgs a;
  a.w[0] = (const bf16*)wq; a.w[1] = (const bf16*)wk; a.w[2] = (const bf16*)wv;
  a.bias[0] = (const bf16*)bq; a.bias[1] = (const bf16*)bk; a.bias[2] = (const bf16*)bv;
  a.y[0] = (bf16*)q; a.y[1] = (bf16*)k; a.y[2] = (bf16*)v;
  a.n[0] = Hq * hd; a.n[1] = a.n[2] = Hkv * hd;
  for (int i = 0; i < 3; ++i) a.tiles[i] = (a.n[i] + kGvN - 1) / kGvN;
  a.pos = (const int*)pos;
  a.hd = hd;
  a.rope = rope;
  a.theta = theta;
  const dim3 grid(a.tiles[0] + a.tiles[1] + a.tiles[2], split);
  qkv_gemv_kernel<<<grid, kGvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, a, B, K, kt_per, xs_stride, (float*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

// y (B, N) <- epilogue(x (B, K) @ w0 (K, N) [, x @ w1]): act -1 adds the
// bias after one rounding to bf16; act 0..2 is the MLP's up pass (w1 only
// with swiglu).  kt_per and split come from decode.py::gemv_plan; with
// split > 1, ws holds tiles * split * (w1 ? 2 : 1) * 1024 floats and
// counters one zeroed int per 128-column tile.
int repro_gemv(const void* x, const void* w0, const void* w1, const void* bias, void* y,
               int B, int K, int N, int kt_per, int split, void* ws, void* counters,
               int act, void* stream) {
  if (B < 1 || B > kMaxB || K <= 0 || K % 8 != 0 || N <= 0 || N % 8 != 0 || act < -1 ||
      act > 2 || (act == 0) != (w1 != nullptr))
    return (int)cudaErrorInvalidValue;
  int xs_stride = 0, smem = 0;
  if (gemv_launch_shape(B, K, kt_per, split, &xs_stride, &smem) != 0)
    return (int)cudaErrorInvalidValue;
  if (split > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = configure_once(gemv_kernel, configured, kGvMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kGvN - 1) / kGvN, split);
  gemv_kernel<<<grid, kGvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w0, (const bf16*)w1, (const bf16*)bias, (bf16*)y, B, K, N,
      kt_per, xs_stride, (float*)ws, (int*)counters, act);
  return (int)cudaGetLastError();
}

// ctx (B, Hq*hd) <- single-token GQA of q (B, Hq, hd) over k/v (B, Sk, Hkv, hd),
// G = Hq/Hkv in 1, 2, 4, 6, 8, 12 (decode.py ATTN_GROUPS: nemotron-4-15b has
// 6, starcoder2-15b 12) and hd in 32, 64, 128, 256 (decode.py ATTN_HEAD_DIMS:
// gemma3-12b has 256, where a slot takes a whole warp); qr[G][8] and acc[G][8] are
// never live together, so G = 12 keeps them in registers (chip_smoke.py
// prints each instantiation's registers and spills from the ptxas report),
// in `splits` chunks of `chunk` slots (decode.py::attn_plan); ws holds
// B * Hkv * splits * (Hq/Hkv) * (hd + 2) floats and counters B * Hkv
// zeroed ints.
int repro_decode_attention(const void* q, const void* k, const void* v, const void* kvp,
                           int kvp_stride, const void* limit, int limit_stride,
                           const void* qpos, const void* win_ptr, int win_static,
                           int causal, float scale, void* ctx, int B, int Sk, int Hq,
                           int Hkv, int hd, int chunk, int splits, void* ws, void* counters,
                           void* stream) {
  return launch_attention<false>(q, k, v, nullptr, nullptr, kvp, kvp_stride, limit,
                                 limit_stride, qpos, win_ptr, win_static, causal, scale, ctx, B,
                                 Sk, Hq, Hkv, hd, chunk, splits, ws, counters, stream);
}

// The same over an int8 cache: k/v (B, Sk, Hkv, hd) int8 payloads and ke/ve
// (B, Sk, Hkv) int8 exponents, each slot's row worth q * 2^e.
int repro_decode_attention_q8(const void* q, const void* k, const void* v, const void* ke,
                              const void* ve, const void* kvp, int kvp_stride,
                              const void* limit, int limit_stride, const void* qpos,
                              const void* win_ptr, int win_static, int causal, float scale,
                              void* ctx, int B, int Sk, int Hq, int Hkv, int hd, int chunk,
                              int splits, void* ws, void* counters, void* stream) {
  if (ke == nullptr || ve == nullptr) return (int)cudaErrorInvalidValue;
  return launch_attention<true>(q, k, v, ke, ve, kvp, kvp_stride, limit, limit_stride, qpos,
                                win_ptr, win_static, causal, scale, ctx, B, Sk, Hq, Hkv, hd,
                                chunk, splits, ws, counters, stream);
}

}  // extern "C"
