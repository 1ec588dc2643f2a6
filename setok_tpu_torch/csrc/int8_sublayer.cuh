// Building blocks of the int8 BERT attention and the unfused route's int8
// attention (fused_bert_attention_int8.cu and fused_attention_int8.cu, rows
// 4 and 7 of PERF.md's kernel table; fused_sublayer.cu takes rows_kernel for
// the post-norm MLP's trailing LayerNorm, wgmma_s8.cuh its STEP, warp_max,
// warp_sum and gelu_tanh). Each of those TPU kernels becomes a short chain
// of the three kernels below; every intermediate goes through device
// memory, and the numerics follow the JAX kernels operation by operation:
//
//   rows_kernel     one warp per row: optional LayerNorm
//                   ((x - mu) * rsqrt(var + eps) * g + b, f32; mu and var
//                   from f64 sums, rounded to f32 once), then either
//                   the f32 row or its int8 row quantisation,
//                   s = max(absmax, 1e-8) / 127, q = clip(rint(y / s), ±127).
//                   The scale of a row spans the whole row (every head, the
//                   whole 3072-wide hidden row), so the row is its own pass.
//   gemm_s8_kernel  int8 x int8 -> int32 on the tensor cores
//                   (mma.sync m16n8k32 s8, exact), a 128x128 tile per block
//                   with a two-stage cp.async ring over K, and the epilogue
//                   acc * x_scale * w_scale + bias in that order, then one of
//                   bf16(v * post_scale), resid + v or v.
//   attn_kernel     one block per (image, head, 64 queries); every score of
//                   the tile's rows stays in shared memory, so the softmax is
//                   the exact two-pass one of the JAX kernels (row max and
//                   sum in f32, p = exp(s - m), 1/l after PV, fully masked
//                   rows -> 0). Over bf16 q, k, v (the sublayer and BERT
//                   kernels) p is cast to bf16 for PV, as those JAX kernels
//                   do; over f32 q, k, v (fused_attention_int8) p stays f32.
//                   The products run on the CUDA cores as f32 FMAs: a bf16 x
//                   bf16 product is exact in f32, and the f32 one is the JAX
//                   kernel's f32 dot, so only the order of the f32 sums
//                   differs. The head dim is walked in chunks of 16 (scores)
//                   and 64 (PV), so a 384-wide head fits.
//
// Every multiply and add whose rounding the JAX kernel fixes is written with
// __fmul_rn/__fadd_rn so that nvcc contracts none of them into an FMA.
// Built without --use_fast_math: the divisions, sqrtf and expf are IEEE or
// the CUDA library's accurate forms.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One launch of a host entry point's chain: return the CUDA error, else count
// the launch in *launched.
#define STEP(call)                                  \
  do {                                              \
    cudaError_t e_ = (call);                        \
    if (e_ != cudaSuccess) return (int)e_;          \
    ++*launched;                                    \
  } while (0)

namespace int8k {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Rows: LayerNorm and/or int8 row quantisation. g == nullptr: no LayerNorm.
// q8 != nullptr: write the int8 row and its scale; y != nullptr: write the
// f32 row.

__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
            const float* __restrict__ b, float eps, int rows, int C,
            int8_t* __restrict__ q8, float* __restrict__ scale,
            float* __restrict__ y) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  const bool ln = g != nullptr;
  float mu = 0.f, r = 0.f;
  if (ln) {
    // statistics summed in f64 and rounded once: the f32 mean and variance
    // of an exact sum, whatever the order (the plain version's too)
    double s = 0.0;
    for (int c = lane; c < C; c += 32) s += (double)xr[c];
    mu = (float)(warp_sum(s) / (double)C);
    double v = 0.0;
    for (int c = lane; c < C; c += 32) {
      const double d = (double)__fsub_rn(xr[c], mu);
      v += d * d;
    }
    const float var = (float)(warp_sum(v) / (double)C);
    r = (float)rsqrt((double)__fadd_rn(var, eps));
  }
  auto val = [&](int c) {
    const float t = xr[c];
    return ln ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(t, mu), r), g[c]),
                          b[c])
              : t;
  };
  if (y != nullptr)
    for (int c = lane; c < C; c += 32) y[(size_t)row * C + c] = val(c);
  if (q8 != nullptr) {
    float m = 0.f;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(val(c)));
    const float s = fmaxf(warp_max(m), 1e-8f) / 127.0f;
    for (int c = lane; c < C; c += 32) {
      const float q = fminf(fmaxf(rintf(val(c) / s), -127.f), 127.f);
      q8[(size_t)row * C + c] = (int8_t)q;
    }
    if (lane == 0) scale[row] = s;
  }
}

inline cudaError_t launch_rows(const float* x, const float* g, const float* b,
                               float eps, int rows, int C, int8_t* q8,
                               float* scale, float* y, cudaStream_t s) {
  constexpr int kWarps = kThreads / 32;
  rows_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      x, g, b, eps, rows, C, q8, scale, y);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 GEMM: out[M, N] = epilogue(A[M, K] . W[N, K]^T), both row-major int8
// (W in the torch (out, in) layout, so each column of the product reads a
// contiguous row of W). K % 16 == 0, N even.

enum Epilogue { kBf16 = 0, kResid = 2, kF32 = 3 };

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int BKP = 48;   // padded smem row: fragment loads hit 32 banks

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x³))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi) as float32
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_s8_kernel(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
               const int8_t* __restrict__ W,
               const float* __restrict__ w_scale,
               const float* __restrict__ bias,
               const float* __restrict__ resid, void* __restrict__ out,
               int ldo, float post_scale, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM][BKP];
  __shared__ __align__(16) int8_t Bs[2][BN][BKP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int lr = tid >> 1, lc = (tid & 1) * 16;

  auto load = [&](int stage, int k0) {
    const int am = m0 + lr, bn = n0 + lr, kc = k0 + lc;
    const bool pa = am < M && kc < K, pb = bn < N && kc < K;
    cp_async16(&As[stage][lr][lc], pa ? A + (size_t)am * K + kc : A, pa);
    cp_async16(&Bs[stage][lr][lc], pb ? W + (size_t)bn * K + kc : W, pb);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
    unsigned a[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = wm + mi * 16 + g;
      a[mi][0] = *reinterpret_cast<const unsigned*>(&As[s][r][t * 4]);
      a[mi][1] = *reinterpret_cast<const unsigned*>(&As[s][r + 8][t * 4]);
      a[mi][2] = *reinterpret_cast<const unsigned*>(&As[s][r][16 + t * 4]);
      a[mi][3] = *reinterpret_cast<const unsigned*>(&As[s][r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + g;
      bf[ni][0] = *reinterpret_cast<const unsigned*>(&Bs[s][c][t * 4]);
      bf[ni][1] = *reinterpret_cast<const unsigned*>(&Bs[s][c][16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        int* d = acc[mi][ni];
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
              "r"(bf[ni][0]), "r"(bf[ni][1]));
      }
    __syncthreads();
  }

  // accumulator layout of m16n8: rows g and g+8, columns 2t and 2t+1
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float as = a_scale[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + t * 2 + e;
          if (col >= N) continue;
          const float v = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[mi][ni][half * 2 + e], as),
                        w_scale[col]),
              bias[col]);
          const size_t at = (size_t)row * ldo + col;
          if (EPI == kBf16)
            static_cast<__nv_bfloat16*>(out)[at] =
                __float2bfloat16_rn(__fmul_rn(v, post_scale));
          else if (EPI == kResid)
            static_cast<float*>(out)[at] = __fadd_rn(resid[at], v);
          else
            static_cast<float*>(out)[at] = v;
        }
    }
}

template <int EPI>
inline cudaError_t launch_gemm(const int8_t* A, const float* a_scale,
                               const int8_t* W, const float* w_scale,
                               const float* bias, const float* resid,
                               void* out, int ldo, float post_scale, int M,
                               int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_s8_kernel<EPI><<<grid, kThreads, 0, s>>>(
      A, a_scale, W, w_scale, bias, resid, out, ldo, post_scale, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention over bf16 or f32 q, k, v of one head (columns h*D .. h*D+D-1 of
// their rows): o = softmax(q.k^T + mask bias) v, f32. Element (b, i, j) of
// the mask is mask[b*m_sb + i*m_sr + j] (m_sr = 0: a key mask), nonzero =
// attend; mask == nullptr: none.

constexpr int TQ = 64;     // queries per block
constexpr int TK = 64;     // keys per score tile
constexpr int DC = 16;     // head-dim (scores) or key (PV) chunk
constexpr int AS = TQ + 4; // padded stride of the chunk buffers
constexpr int kMaxKeys = 768;

inline size_t attn_smem_bytes(int Nk) {
  const int nkp = (Nk + TK - 1) / TK * TK;
  return sizeof(float) * ((size_t)TQ * (nkp + 4) + TQ + 2 * DC * AS);
}

__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// p as the PV product reads it: rounded to bf16 beside bf16 inputs
__device__ __forceinline__ float p_value(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float p_value(float p, const float*) { return p; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, long long q_sb, int q_sr,
            const T* __restrict__ k, const T* __restrict__ v, long long kv_sb,
            int kv_sr,
            const uint8_t* __restrict__ mask, long long m_sb, int m_sr,
            float* __restrict__ o, long long o_sb, int o_sr, int Nq, int Nk,
            int D) {
  extern __shared__ __align__(16) float smem[];
  const int nkp = (Nk + TK - 1) / TK * TK;
  const int SP = nkp + 4;
  float* S = smem;               // TQ x SP scores, then p
  float* lr_s = S + TQ * SP;     // TQ: 1/l, or 0 on fully masked rows
  float* A_s = lr_s + TQ;        // DC x AS: q chunk, [d][query]
  float* B_s = A_s + DC * AS;    // DC x AS: k chunk [d][key], v chunk [key][d]

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * q_sb + (size_t)h * D;
  const T* kb = k + b * kv_sb + (size_t)h * D;
  const T* vb = v + b * kv_sb + (size_t)h * D;

  // 1. scores of the tile's TQ rows against every key
  const int lrow = tid >> 2, ld = (tid & 3) * 4;   // 64 rows x 4 groups of 4
  for (int j0 = 0; j0 < nkp; j0 += TK) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int gd = d0 + ld, gi = i0 + lrow, gj = j0 + lrow;
      const float4 qa = (gi < Nq && gd < D)
                            ? load_x4(qb + (size_t)gi * q_sr + gd)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 ka = (gj < Nk && gd < D)
                            ? load_x4(kb + (size_t)gj * kv_sr + gd)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      A_s[(ld + 0) * AS + lrow] = qa.x;
      A_s[(ld + 1) * AS + lrow] = qa.y;
      A_s[(ld + 2) * AS + lrow] = qa.z;
      A_s[(ld + 3) * AS + lrow] = qa.w;
      B_s[(ld + 0) * AS + lrow] = ka.x;
      B_s[(ld + 1) * AS + lrow] = ka.y;
      B_s[(ld + 2) * AS + lrow] = ka.z;
      B_s[(ld + 3) * AS + lrow] = ka.w;
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        const float4 a4 = *reinterpret_cast<const float4*>(&A_s[dd * AS + ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&B_s[dd * AS + tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(&S[(ty * 4 + r) * SP + j0 + tx * 4]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // 2. softmax, one warp per row: mask bias, max and sum in f32; p is kept
  //    as PV reads it (p_value); padding keys get p = 0
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < TQ; r += kThreads / 32) {
    float* Sr = S + r * SP;
    const int i = min(i0 + r, Nq - 1);
    const uint8_t* mr = mask ? mask + b * m_sb + (size_t)i * m_sr : nullptr;
    float m = -INFINITY;
    for (int j = lane; j < Nk; j += 32) {
      float s = Sr[j];
      if (mr) {
        const float mf = mr[j] ? 1.f : 0.f;
        s = __fadd_rn(s, __fmul_rn(kNegInf, __fsub_rn(1.f, mf)));
        Sr[j] = s;
      }
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nkp; j += 32) {
      if (j < Nk) {
        const float p = expf(__fsub_rn(Sr[j], m));
        l += p;
        Sr[j] = p_value(p, q);
      } else {
        Sr[j] = 0.f;
      }
    }
    l = warp_sum(l);
    if (lane == 0) lr_s[r] = m > 0.5f * kNegInf ? 1.f / fmaxf(l, 1e-30f) : 0.f;
  }
  __syncthreads();

  // 3. o = (p v) * (1/l), 64 columns of the head at a time
  const int vk = tid >> 4, vd = (tid & 15) * 4;    // 16 keys x 16 groups of 4
  for (int c0 = 0; c0 < D; c0 += 64) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int j0 = 0; j0 < nkp; j0 += DC) {
      const int gj = j0 + vk, gd = c0 + vd;
      *reinterpret_cast<float4*>(&B_s[vk * AS + vd]) =
          (gj < Nk && gd < D) ? load_x4(vb + (size_t)gj * kv_sr + gd)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DC; ++kk) {
        const float4 b4 = *reinterpret_cast<const float4*>(&B_s[kk * AS + tx * 4]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = S[(ty * 4 + r) * SP + j0 + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(p, bv[c], acc[r][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= Nq) continue;
      float* orow = o + b * o_sb + (size_t)i * o_sr + (size_t)h * D;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = c0 + tx * 4 + c;
        if (d < D) orow[d] = __fmul_rn(acc[r][c], lr_s[ty * 4 + r]);
      }
    }
  }
}

template <typename T>
inline cudaError_t launch_attn(const T* q, long long q_sb, int q_sr,
                               const T* k, const T* v, long long kv_sb,
                               int kv_sr, const uint8_t* mask, long long m_sb,
                               int m_sr, float* o, long long o_sb, int o_sr,
                               int B, int H, int Nq, int Nk, int D,
                               cudaStream_t s) {
  const size_t smem = attn_smem_bytes(Nk);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nq + TQ - 1) / TQ, H, B);
  attn_kernel<T><<<grid, kThreads, smem, s>>>(q, q_sb, q_sr, k, v, kv_sb,
                                              kv_sr, mask, m_sb, m_sr, o,
                                              o_sb, o_sr, Nq, Nk, D);
  return cudaGetLastError();
}

}  // namespace int8k
