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
// grid step to the next; Hopper's blocks run in parallel and in no order.
// fused_qkv and the attention give each block whole output columns (or a
// head), so the sequential axis becomes a loop inside a block.  The GEMV
// behind fused_mlp and the attention's output projection splits the
// reduction across blocks instead, and sums the partials in a fixed order.

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

// ------------------------------------------------------ CUDA-core GEMV tile --
// fused_qkv's product: out[b * kMaxNC + c] = sum_k x[b, k] * w[k, n0 + c] in float32, for b < B
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
// written in bf16 to a (B, Hq*hd) scratch that gemv_kernel turns into
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

// ------------------------------------------------ split-K tensor-core GEMV --
// Replaces repro/kernels/decode.py::fused_mlp (_mlp_kernel) in two
// launches (gate/up + activation into h, then h @ w_down + b_down), and
// is launch 2 of fused_decode_attention (ctx @ wo + bo).
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
constexpr int kGvThreads = 128;              // 4 warps
constexpr int kGvN = 128;                    // output columns of a block
constexpr int kGvMT = kGvN / (kGvThreads / 32) / 16;   // m16 column tiles of a warp
constexpr int kGvK = 64;                     // weight rows of a stage
constexpr int kGvStages = 4;
constexpr int kGvTile = kGvK * kGvN * 2;     // bytes of a stage
constexpr int kGvFrag = 4 * kGvMT;           // f32 sums per thread per matrix
constexpr int kGvMaxKt = 32;                 // k-tiles a split may take (decode.py GEMV_MAX_KT)
constexpr int kMaxDevices = 64;              // devices whose kernel attributes are remembered

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

// Grid (column tiles, splits); kt_per k-tiles per split.  Shared memory:
// the ring, then the block's slice of x as B rows of xs_stride elements.
// With more than one split, ws holds tiles * splits * nmat * 1024 floats
// and counters one int per column tile (zero on entry, zero on exit).
__global__ void __launch_bounds__(kGvThreads)
gemv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
            const bf16* __restrict__ w1, const bf16* __restrict__ bias,
            bf16* __restrict__ y, int B, int K, int N, int kt_per, int xs_stride,
            float* __restrict__ ws, int* __restrict__ counters, int act) {
  extern __shared__ __align__(16) uint8_t gv_smem[];
  __shared__ int s_last;
  bf16* xs = reinterpret_cast<bf16*>(gv_smem + kGvStages * kGvTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nmat = w1 != nullptr ? 2 : 1;
  const int tile = blockIdx.x, n0 = tile * kGvN;
  const int kt0 = blockIdx.y * kt_per;
  const int nkt = min((K + kGvK - 1) / kGvK, kt0 + kt_per) - kt0;
  const int tiles = nkt * nmat;   // weight tiles this block streams

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
      const bool ok = k0 + r < K && n0 + c * 8 < N;
      cp_async16(slot + r * (kGvN * 2) + ((c ^ (r & 7)) << 4),
                 ok ? w + (size_t)(k0 + r) * N + n0 + c * 8 : w, ok ? 16 : 0);
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

// y (B, N) <- epilogue(x (B, K) @ w0 (K, N) [, x @ w1]): act -1 adds the
// bias after one rounding to bf16; act 0..2 is the MLP's up pass (w1 only
// with swiglu).  kt_per and split come from decode.py::gemv_plan; with
// split > 1, ws holds tiles * split * (w1 ? 2 : 1) * 1024 floats and
// counters one zeroed int per 128-column tile.
int repro_gemv(const void* x, const void* w0, const void* w1, const void* bias, void* y,
               int B, int K, int N, int kt_per, int split, void* ws, void* counters,
               int act, void* stream) {
  if (B < 1 || B > kMaxB || K <= 0 || K % 8 != 0 || N <= 0 || N % 8 != 0 || kt_per <= 0 ||
      kt_per > kGvMaxKt || act < -1 || act > 2 || (act == 0) != (w1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int kt_all = (K + kGvK - 1) / kGvK;
  if (split != (kt_all + kt_per - 1) / kt_per) return (int)cudaErrorInvalidValue;
  if (split > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const int xs_stride = kt_per * kGvK + 8;   // +16 bytes: conflict-free x reads
  const int smem = kGvStages * kGvTile + B * xs_stride * 2;
  static bool configured[kMaxDevices] = {};   // the attributes, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || !configured[dev])) {
    err = cudaFuncSetAttribute(gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGvStages * kGvTile + kMaxB * (kGvMaxKt * kGvK + 8) * 2);
    if (err == cudaSuccess)   // all shared memory, no L1 carve-out: more blocks per SM
      err = cudaFuncSetAttribute(gemv_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kGvN - 1) / kGvN, split);
  gemv_kernel<<<grid, kGvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w0, (const bf16*)w1, (const bf16*)bias, (bf16*)y, B, K, N,
      kt_per, xs_stride, (float*)ws, (int*)counters, act);
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

}  // extern "C"
