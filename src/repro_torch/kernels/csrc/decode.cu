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
// under the ~295 the H100 needs before arithmetic matters.  All three are
// bound by the bytes they read from HBM.  The Pallas kernels walk a
// sequential grid on one TensorCore and carry sums in VMEM scratch from one
// grid step to the next; Hopper's blocks run in parallel and in no order,
// so here the sequential axis becomes a loop inside a block and every
// cross-block reduction is avoided by giving each block whole output
// columns.  No wgmma or TMA yet: these are the simple, correct versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads of a GEMV block
constexpr int kMaxB = 8;        // decode rows a launch may carry
constexpr int kMaxNC = 256;     // output columns a GEMV block may own
constexpr float kNeg = -1e30f;  // mask sentinel (models.attention._NEG)

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

// ------------------------------------------------------------------ GEMV --
// out[b * kMaxNC + c] = sum_k x[b, k] * w[k, n0 + c] in float32, for b < B
// and c < nc.  w is (K, N) row-major, the JAX package's (in, out) layout.
//
// The block's 256 threads split into nc/8 column chunks (8 bf16 = one
// 16-byte load) times 256/(nc/8) k-groups.  A k-group's threads read one
// contiguous run of a weight row, so a warp's loads are whole 32-byte
// sectors.  Each thread streams 8 rows per step, keeps B x 8 float32 sums
// in registers, and the k-groups are summed through shared memory at the
// end (one lane row at a time, so the scratch stays 8 KB): every column
// gets kThreads/nc adjacent threads of one warp, each adds 8 partials and
// the group finishes with shuffles, so the sum is deterministic.
template <int B>
__device__ void gemv_tile(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          int K, int N, int n0, int nc, float* red, float* out) {
  const int nchunks = nc / 8;
  const int nkg = kThreads / nchunks;
  const int t = threadIdx.x;
  const int chunk = t % nchunks;
  const int kg = t / nchunks;

  float acc[B][8];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[b][c] = 0.f;

  const bf16* wcol = w + n0 + chunk * 8;
  for (int k0 = kg * 8; k0 < K; k0 += nkg * 8) {
    float wf[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(wcol + (size_t)(k0 + r) * N));
      unpack8(u, wf[r]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float xf[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(x + (size_t)b * K + k0)), xf);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[b][c] = fmaf(xf[r], wf[r][c], acc[b][c]);
    }
  }

  const int tpc = kThreads / nc;  // threads per column, a power of two <= 32
  const int col = t / tpc, sub = t % tpc;
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int c = 0; c < 8; ++c) red[kg * nc + chunk * 8 + c] = acc[b][c];
    __syncthreads();
    float s = 0.f;
    for (int g = sub; g < nkg; g += tpc) s += red[g * nc + col];
    for (int o = tpc / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (sub == 0) out[b * kMaxNC + col] = s;
    __syncthreads();
  }
}

// -------------------------------------------------------------- fused QKV --
// Replaces repro/kernels/decode.py::fused_qkv (_qkv_kernel).
// Bound: the bytes of wq, wk and wv, read once (25.2 MB a layer at
// olmo-1b).  One block owns one head's head_dim columns of q, k or v
// (Hq + 2 Hkv blocks), so both RoPE halves of a head meet in its epilogue:
// round the float32 sum to bf16, add the bias in bf16, then rotate in
// float32 with angles pos * theta^(-2i/hd), as decode.py:188-193 computes.
template <int B>
__global__ void __launch_bounds__(kThreads)
qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
           const bf16* __restrict__ wk, const bf16* __restrict__ wv,
           const bf16* __restrict__ bq, const bf16* __restrict__ bk,
           const bf16* __restrict__ bv, const int* __restrict__ pos,
           bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v,
           int K, int Hq, int Hkv, int hd, int rope, float theta) {
  __shared__ float red[kThreads * 8];
  __shared__ float out[kMaxB * kMaxNC];

  const int blk = blockIdx.x;
  const bf16* w;
  const bf16* bias;
  bf16* y;
  int N, head;
  bool rot;
  if (blk < Hq) {
    w = wq; bias = bq; y = q; N = Hq * hd; head = blk; rot = rope != 0;
  } else if (blk < Hq + Hkv) {
    w = wk; bias = bk; y = k; N = Hkv * hd; head = blk - Hq; rot = rope != 0;
  } else {
    w = wv; bias = bv; y = v; N = Hkv * hd; head = blk - Hq - Hkv; rot = false;
  }
  const int n0 = head * hd;
  gemv_tile<B>(x, w, K, N, n0, hd, red, out);

  const int half = hd / 2;
  for (int i = threadIdx.x; i < B * hd; i += kThreads) {
    const int b = i / hd, c = i % hd;
    float val = round_bf16(out[b * kMaxNC + c]);
    if (bias != nullptr) val = round_bf16(val + bf2f(bias[n0 + c]));
    if (rot) {
      const bool lo = c < half;
      const int j = lo ? c : c - half;
      const int cp = lo ? c + half : c - half;
      float partner = round_bf16(out[b * kMaxNC + cp]);
      if (bias != nullptr) partner = round_bf16(partner + bf2f(bias[n0 + cp]));
      const float freq = 1.0f / powf(theta, __fdiv_rn((float)(2 * j), (float)hd));
      const float ang = __fmul_rn((float)(pos != nullptr ? pos[b] : 0), freq);
      const float sn = sinf(ang), cs = cosf(ang);
      // t1*cos - t2*sin | t2*cos + t1*sin, without fused multiply-adds so
      // the float32 value is the reference's
      val = lo ? __fsub_rn(__fmul_rn(val, cs), __fmul_rn(partner, sn))
               : __fadd_rn(__fmul_rn(val, cs), __fmul_rn(partner, sn));
    }
    y[(size_t)b * N + n0 + c] = __float2bfloat16(val);
  }
}

// ----------------------------------------------------- GEMV + bias (wo/down) --
// y[b, n] = bf16(bf16(sum_k x[b, k] w[k, n]) + bias[n]): the output
// projection of fused_decode_attention and the down projection of
// fused_mlp.  Bound: the bytes of w.  One block owns nc columns.
template <int B>
__global__ void __launch_bounds__(kThreads)
gemv_bias_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ y,
                 int K, int N, int nc) {
  __shared__ float red[kThreads * 8];
  __shared__ float out[kMaxB * kMaxNC];
  const int n0 = blockIdx.x * nc;
  gemv_tile<B>(x, w, K, N, n0, nc, red, out);
  for (int i = threadIdx.x; i < B * nc; i += kThreads) {
    const int b = i / nc, c = i % nc;
    float val = round_bf16(out[b * kMaxNC + c]);
    if (bias != nullptr) val = round_bf16(val + bf2f(bias[n0 + c]));
    y[(size_t)b * N + n0 + c] = __float2bfloat16(val);
  }
}

// ---------------------------------------------------- fused decode attention --
// Replaces repro/kernels/decode.py::fused_decode_attention
// (_decode_attn_kernel), launch 1 of 2.
// Bound: the bytes of the K and V cache, read once (38.3 MB a layer at
// olmo-1b, B=8, Sk=584), plus wo in launch 2.  One block per (lane,
// kv-head); its four warps take 32-slot tiles of Sk in turn, one slot per
// lane, and keep the running (max, denom, acc) softmax of decode.py:305-328
// in float32 registers.  p is rounded to bf16 before the PV product and
// the sum is divided by max(l, 1e-30) at the end, as the TPU kernel does.
// The warps' partial states are merged through shared memory, and ctx is
// written in bf16 to a (B, Hq*hd) scratch that gemv_bias_kernel turns into
// ctx @ wo + bo.  Only B*Hkv blocks are in flight (128 at olmo-1b): a
// split of Sk across blocks (flash-decoding) is later work.
template <int G, int HD>
__global__ void __launch_bounds__(128)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const int* __restrict__ kvp, int kvp_stride,
            const int* __restrict__ limit, int limit_stride,
            const int* __restrict__ qpos, const int* __restrict__ win_ptr,
            int win_static, int causal, float scale, bf16* __restrict__ ctx,
            int Sk, int Hkv) {
  constexpr int kWarps = 4;
  constexpr int DPL = HD / 32;  // head dims per lane in the PV sum
  __shared__ float qs[G][HD];
  __shared__ float wm[kWarps][G];
  __shared__ float wl[kWarps][G];
  __shared__ float wacc[kWarps][G][HD];

  const int b = blockIdx.x / Hkv, kh = blockIdx.x % Hkv;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // (q * scale) rounded to bf16 before the score product (decode.py:287)
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    qs[g][d] = round_bf16(bf2f(q[((size_t)b * Hq + kh * G + g) * HD + d]) * scale);
  }
  __syncthreads();

  const long long row = causal ? qpos[b] : 0;
  const long long win = win_ptr != nullptr ? *win_ptr : win_static;
  const int lim = limit != nullptr ? limit[(size_t)b * limit_stride] : Sk;
  const size_t slot = (size_t)Hkv * HD;  // elements between cache slots
  const bf16* kb = k + ((size_t)b * Sk * Hkv + kh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + kh) * HD;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * 32; t0 < Sk; t0 += kWarps * 32) {
    const int j = t0 + lane;
    const bool in_range = j < Sk;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    bool valid = false;
    if (in_range) {
      const bf16* kr = kb + (size_t)j * slot;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kf[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(kr + d0)), kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int c = 0; c < 8; ++c) s[g] = fmaf(qs[g][d0 + c], kf[c], s[g]);
      }
      long long col = j;
      if (kvp != nullptr) {
        col = kvp[(size_t)b * kvp_stride + j];
        valid = col >= 0;  // ring slot never written
      } else {
        valid = col < lim;
      }
      if (causal) valid = valid && col <= row && col > row - win;
    }

    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = valid ? s[g] : kNeg;
      const float m_new = fmaxf(m[g], warp_max(in_range ? sg : -INFINITY));
      const float corr = expf(m[g] - m_new);
      const float pg = in_range ? expf(sg - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(pg);
      m[g] = m_new;
      p[g] = round_bf16(pg);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
    }

    const int nkeys = min(32, Sk - t0);
    const bf16* vr = vb + (size_t)t0 * slot + lane * DPL;
    if (nkeys == 32) {
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = bf2f(vr[(size_t)i * slot + e]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pi = __shfl_sync(0xffffffffu, p[g], i);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pi, vf[e], acc[g][e]);
        }
      }
    } else {
      for (int i = 0; i < nkeys; ++i) {
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = bf2f(vr[(size_t)i * slot + e]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pi = __shfl_sync(0xffffffffu, p[g], i);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pi, vf[e], acc[g][e]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) wacc[warp][g][lane * DPL + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float mx = wm[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w][g] - mx);
      den += wl[w][g] * c;
      num += wacc[w][g][d] * c;
    }
    ctx[((size_t)b * Hq + kh * G + g) * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

// -------------------------------------------------------------- fused MLP --
// Replaces repro/kernels/decode.py::fused_mlp (_mlp_kernel), launch 1 of 2.
// Bound: the bytes of w_gate, w_up and w_down (100.7 MB a layer at
// olmo-1b).  Blocks over d_ff column slabs compute g = x @ w_gate (or
// w_up when ungated) and up = x @ w_up, each rounded to bf16, add b_up,
// apply the activation, and write h (B, d_ff) in bf16; launch 2
// (gemv_bias_kernel) computes h @ w_down + b_down.  The TPU kernel kept h
// in VMEM and summed the down projection across its sequential grid; here
// that would need a cross-block reduction (atomics, and a result that
// depends on their order).  h is 128 KB at B=8 -- it stays in the 50 MB
// L2 between the two launches, so writing it costs no HBM traffic worth
// counting, and the result is deterministic.
// act: 0 swiglu, 1 gelu (tanh form, as jax.nn.gelu), 2 squared relu.
template <int B>
__global__ void __launch_bounds__(kThreads)
mlp_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const bf16* __restrict__ bu,
              bf16* __restrict__ h, int K, int F, int nc, int act, int gated) {
  __shared__ float red[kThreads * 8];
  __shared__ float og[kMaxB * kMaxNC];
  __shared__ float ou[kMaxB * kMaxNC];
  const int n0 = blockIdx.x * nc;
  gemv_tile<B>(x, gated ? wg : wu, K, F, n0, nc, red, og);
  if (gated) gemv_tile<B>(x, wu, K, F, n0, nc, red, ou);
  for (int i = threadIdx.x; i < B * nc; i += kThreads) {
    const int b = i / nc, c = i % nc;
    float g = round_bf16(og[b * kMaxNC + c]);
    if (bu != nullptr) g = round_bf16(g + bf2f(bu[n0 + c]));
    float hv;
    if (act == 0) {
      const float sg = round_bf16(g / (1.0f + expf(-g)));
      hv = round_bf16(sg * round_bf16(ou[b * kMaxNC + c]));
    } else if (act == 1) {
      const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
      hv = round_bf16(0.5f * g * (1.0f + tanhf(inner)));
    } else {
      const float r = fmaxf(g, 0.f);
      hv = round_bf16(r * r);
    }
    h[(size_t)b * F + n0 + c] = __float2bfloat16(hv);
  }
}

bool gemv_shape_ok(int B, int K, int nc) {
  return B >= 1 && B <= kMaxB && K > 0 && K % 8 == 0 && nc >= 8 && nc <= kMaxNC &&
         nc % 8 == 0 && kThreads % (nc / 8) == 0;
}

}  // namespace

#define REPRO_DISPATCH_B(B, ...)                      \
  switch (B) {                                        \
    case 1: { constexpr int kB = 1; __VA_ARGS__; break; } \
    case 2: { constexpr int kB = 2; __VA_ARGS__; break; } \
    case 3: { constexpr int kB = 3; __VA_ARGS__; break; } \
    case 4: { constexpr int kB = 4; __VA_ARGS__; break; } \
    case 5: { constexpr int kB = 5; __VA_ARGS__; break; } \
    case 6: { constexpr int kB = 6; __VA_ARGS__; break; } \
    case 7: { constexpr int kB = 7; __VA_ARGS__; break; } \
    case 8: { constexpr int kB = 8; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;       \
  }

extern "C" {

// q (B, Hq*hd), k/v (B, Hkv*hd) <- x (B, K) @ wq/wk/wv (K, .) + bias, RoPE.
int repro_fused_qkv(const void* x, const void* wq, const void* wk, const void* wv,
                    const void* bq, const void* bk, const void* bv, const void* pos,
                    void* q, void* k, void* v, int B, int K, int Hq, int Hkv, int hd,
                    int rope, float theta, void* stream) {
  if (!gemv_shape_ok(B, K, hd) || Hq <= 0 || Hkv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hq + 2 * Hkv);
  REPRO_DISPATCH_B(B, qkv_kernel<kB><<<grid, kThreads, 0, s>>>(
      (const bf16*)x, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (const bf16*)bq, (const bf16*)bk, (const bf16*)bv, (const int*)pos,
      (bf16*)q, (bf16*)k, (bf16*)v, K, Hq, Hkv, hd, rope, theta));
  return (int)cudaGetLastError();
}

// y (B, N) <- bf16(x (B, K) @ w (K, N)) + bias, nc columns per block.
int repro_gemv_bias(const void* x, const void* w, const void* bias, void* y, int B,
                    int K, int N, int nc, void* stream) {
  if (!gemv_shape_ok(B, K, nc) || N <= 0 || N % nc != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / nc);
  REPRO_DISPATCH_B(B, gemv_bias_kernel<kB><<<grid, kThreads, 0, s>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (bf16*)y, K, N, nc));
  return (int)cudaGetLastError();
}

// ctx (B, Hq*hd) <- single-token GQA of q (B, Hq, hd) over k/v (B, Sk, Hkv, hd).
int repro_decode_attention(const void* q, const void* k, const void* v, const void* kvp,
                           int kvp_stride, const void* limit, int limit_stride,
                           const void* qpos, const void* win_ptr, int win_static,
                           int causal, float scale, void* ctx, int B, int Sk, int Hq,
                           int Hkv, int hd, void* stream) {
  if (B <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv);
#define REPRO_ATTN(GV, HDV)                                                          \
  if (G == GV && hd == HDV) {                                                        \
    attn_kernel<GV, HDV><<<grid, 128, 0, s>>>(                                       \
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kvp, kvp_stride, \
        (const int*)limit, limit_stride, (const int*)qpos, (const int*)win_ptr,      \
        win_static, causal, scale, (bf16*)ctx, Sk, Hkv);                             \
    return (int)cudaGetLastError();                                                  \
  }
  REPRO_ATTN(1, 32) REPRO_ATTN(1, 64) REPRO_ATTN(1, 128)
  REPRO_ATTN(2, 32) REPRO_ATTN(2, 64) REPRO_ATTN(2, 128)
  REPRO_ATTN(4, 32) REPRO_ATTN(4, 64) REPRO_ATTN(4, 128)
  REPRO_ATTN(8, 32) REPRO_ATTN(8, 64) REPRO_ATTN(8, 128)
#undef REPRO_ATTN
  return (int)cudaErrorInvalidValue;
}

// h (B, F) <- act(bf16(x @ wg) + bu [, bf16(x @ wu)]), nc columns per block.
int repro_mlp_up(const void* x, const void* wg, const void* wu, const void* bu, void* h,
                 int B, int K, int F, int nc, int act, int gated, void* stream) {
  if (!gemv_shape_ok(B, K, nc) || F <= 0 || F % nc != 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(F / nc);
  REPRO_DISPATCH_B(B, mlp_up_kernel<kB><<<grid, kThreads, 0, s>>>(
      (const bf16*)x, (const bf16*)wg, (const bf16*)wu, (const bf16*)bu, (bf16*)h, K,
      F, nc, act, gated));
  return (int)cudaGetLastError();
}

}  // extern "C"
