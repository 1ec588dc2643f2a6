// Masked flash attention on the card: the forward (with its log-sum-exp),
// the dq gradient and the dk/dv gradients.
//
// Replaces setok_tpu/kernels/flash_attention.py:120 (flash_attention, a
// jax.custom_vjp over three pallas_calls: the forward at :146, dq at :185,
// dk/dv at :208). q: (B, H, Lq, D), k/v: (B, H, Lk, D) in float32 or
// bfloat16; mask: (B, Lq, Lk) bytes, nonzero = attend, holes anywhere (the
// Setokim splice masks image slots and pads mid-sequence). Lq and Lk are any
// lengths; D is 64 or 128. Outputs are float32 (o, lse, dq, dk, dv, delta);
// the wrapper casts o and the gradients to the input type.
//
// The TPU kernels keep the whole of K/V (forward, dq) or Q/dO (dk/dv) of a
// head resident in VMEM, one program per tile of the other side. A block on
// Hopper has at most 227 KB of shared memory, and at Lk = 2048, D = 128 the
// K and V of one head take 1 MB, so each block here loops over tiles of the
// other side instead:
//
//   forward  one block per (64 queries, head, batch row); two sweeps over
//            64-key tiles. Sweep 1 takes the exact row max m of the masked
//            scores; sweep 2 recomputes the scores, p = exp(s - m) * mask in
//            float32, sums l over the unrounded p, rounds p to the input
//            type (the JAX kernel's p.astype(v.dtype)) and accumulates P.V
//            in float32. o = acc / l, zero for a row without a valid key;
//            lse = m + log(l). Two sweeps keep the JAX rounding of p: an
//            online-softmax rescale would round p against a running max.
//   dq       one block per (64 queries, head, batch row) over key tiles:
//            p = exp(s - lse) * mask, dp = dO.V^T, delta = rowsum(dO * o)
//            (computed once here and written out for dk/dv),
//            ds = p * (dp - delta) * scale, dq += ds.K.
//   dk/dv    one block per (64 keys, head, batch row) over query tiles: the
//            same p and ds, dv += P^T.dO, dk += dS^T.Q. Each block owns its
//            keys' rows, so no atomics and the sums are deterministic.
//
// The bf16 kernels (the training path) are built for Hopper's tensor cores.
// What bounds them: at B = 4, H = 32, L = 2048, D = 128 the training splice
// mask leaves 29.6 % of the score cells, and each product over them costs
// 4.1e10 FLOP. The forward does two such passes (S and P.V), dq four and
// dk/dv six (below): 0.08, 0.16 and 0.25 ms at the bf16 peak of 989
// TFLOP/s. The forward's bytes (q, k, v, the mask, f32 o and lse) take
// 0.09 ms at 3.35 TB/s, the backward's 0.04: the forward is bound by
// bytes, the backward by operations. The two-sweep forward computes S
// twice, three passes over its non-empty tiles. What the design does:
//
//   * Every product on mma.sync m16n8k16 (bf16 in, f32 accumulation; the
//     forward's S sums each 16-wide slice of D from zero and adds the
//     slices in f32, chunk_scores says why).
//     S = Q.K^T, P.V and dP = dO.V^T take bf16 operands as they stand: the
//     products are exact in f32, so only the order of the sums differs from
//     the JAX f32 kernel. dq = dS.K, dv = P^T.dO and dk = dS^T.Q have one
//     f32 operand, which is split in two bf16 terms, hi = bf16(x) and
//     lo = bf16(x - hi), each an MMA against the bf16-exact other operand:
//     x is kept to 2^-16 relative, far inside the 1e-4 gradient bar (TF32,
//     at 2^-11, misses it). Four MMA passes for dq, six for dk/dv.
//   * No round trip through shared memory for P or dS. A warp owns 16 rows
//     of the output (queries for the forward and dq, keys for dk/dv), and
//     the forward keeps its rows' Q fragments in registers for both
//     sweeps, its P going from the score accumulators into the A fragment
//     of P.V 16 keys at a time. dk/dv computes S^T =
//     K.Q^T and dP^T = V.dO^T, so that in both kernels two adjacent n8
//     accumulator tiles of S and dP form one k16 A fragment of the next
//     product. dq keeps its rows' Q and dO fragments in registers for the
//     whole sweep; dk/dv keeps its 64 keys' K and V in shared memory. K,
//     V, Q and dO reach the B operand through ldmatrix / ldmatrix.trans
//     from one copy each, in 64-row tiles whose 16-byte chunks are XOR-
//     swizzled by row, so that every ldmatrix is free of bank conflicts.
//   * Empty tiles are skipped. Before its sweep(s) a block reads the mask of
//     its 64-row slab once, 16 bytes a load (narrower where Lk is not a
//     multiple of 16), and classes each 64 x 64 tile as empty, full or
//     mixed (a block-wide OR and AND of the bytes). An empty tile, whose
//     contribution is exactly zero (p = 0), costs no load and no arithmetic;
//     a full one no mask test; only a mixed one stages its mask tile in
//     shared memory. At the training mask 67.6 % of the tiles are empty.
//   * The next non-empty tile's bf16 operands (and mask, lse, delta) are in
//     flight through cp.async (16-byte copies, zero-filled past L) into a
//     two-stage ring while this one computes. 128 threads a block; shared
//     memory about 75 KB (forward, dq) and 107 KB (dk/dv) at D = 128, so
//     that three forward blocks and two backward blocks fit an SM; dk/dv's
//     2 x 16 x D f32 accumulators take 128 registers a thread.
//
// float32 inputs, off the training path, keep the CUDA-core kernels (f32
// tiles in shared memory, register micro-tiles of 4 x 4, 4 x 2 and
// 4 x 4·D/64 outputs per thread), which compute every tile and read the mask
// per element: their bound is the f32 peak of 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using namespace mma16;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Rows [r0, r0 + n) of an (L, D) float32 slab → shared memory, row-major
// (rm[r * ldr + d]) and/or transposed (tr[d * ldt + r]); rows past L are 0.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int L, int r0, int n, int D,
                                          float* rm, int ldr, float* tr,
                                          int ldt) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int g = r0 + r;
    const float v = g < L ? src[(size_t)g * D + d] : 0.f;
    if (rm != nullptr) rm[r * ldr + d] = v;
    if (tr != nullptr) tr[d * ldt + r] = v;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]);
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x, v[1] = t.y;
}

// acc[i][j] += sum_k a[k * lda + i] * b[k * ldb + j]: both operands k-major
// in shared memory, `a` and `b` already offset to the thread's outputs.
template <int NA, int NB>
__device__ __forceinline__ void outer(const float* a, int lda, const float* b,
                                      int ldb, int K, float (&acc)[NA][NB]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[NA], bv[NB];
    load_vec<NA>(a + k * lda, av);
    load_vec<NB>(b + k * ldb, bv);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][s * 4 + e] += sum_k a[k * lda + i] * b[k * ldb + 64 * s + e]: the
// (rows x D) accumulators, each thread 4 rows and D/16 columns in D/64
// groups of 4, `b` already offset by the thread's tx * 4.
template <int D>
__device__ __forceinline__ void outer_d(const float* a, int lda,
                                        const float* b, int ldb, int K,
                                        float (&acc)[4][D / 16]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[4];
    load_vec<4>(a + k * lda, av);
#pragma unroll
    for (int s = 0; s < D / 64; ++s) {
      float bv[4];
      load_vec<4>(b + k * ldb + 64 * s, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][s * 4 + e] = fmaf(av[i], bv[e], acc[i][s * 4 + e]);
    }
  }
}

__device__ __forceinline__ bool attends(const uint8_t* __restrict__ mrow,
                                        int i, int j, int Lq, int Lk) {
  return i < Lq && j < Lk && mrow[(size_t)i * Lk + j] != 0;
}

// ---------------------------------------------------------------------------
// forward, float32 inputs: 64 queries per block, 64-key tiles, two sweeps
// on the CUDA cores

constexpr int kFwdBQ = 64, kFwdBK = 64;

template <int D>
constexpr size_t fwd_smem_floats() {
  return (size_t)D * (kFwdBQ + 4) * 2 + (size_t)kFwdBK * (D + 4) +
         (size_t)kFwdBK * (kFwdBQ + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Lq, int Lk,
                     float scale) {
  constexpr int LT = kFwdBQ + 4;  // transposed tiles: [D][64 + 4]
  constexpr int LV = D + 4;       // row-major V: [64][D + 4]
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // Q^T of the block's queries
  float* kt = qt + D * LT;      // K^T of the key tile
  float* vs = kt + D * LT;      // V of the key tile
  float* pt = vs + kFwdBK * LV; // P^T of the tile

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * H + h;
  const float* qh = q + head * Lq * D;
  const float* kh = k + head * Lk * D;
  const float* vh = v + head * Lk * D;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int q0 = blockIdx.x * kFwdBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(qh, Lq, q0, kFwdBQ, D, nullptr, 0, qt, LT);

  float m[4], l[4];
  bool any[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = kNegInf, l[r] = 0.f, any[r] = false;

  // sweep 1: the exact row max of the masked scores
  for (int k0 = 0; k0 < Lk; k0 += kFwdBK) {
    __syncthreads();
    load_tile(kh, Lk, k0, kFwdBK, D, nullptr, 0, kt, LT);
    __syncthreads();
    float s[4][4] = {};
    outer<4, 4>(qt + ty * 4, LT, kt + tx * 4, LT, D, s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = attends(mb, q0 + ty * 4 + r, k0 + tx * 4 + c, Lq, Lk);
        m[r] = fmaxf(m[r], ok ? s[r][c] * scale : kNegInf);
        any[r] = any[r] || ok;
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
      any[r] = __shfl_xor_sync(0xffffffffu, (int)any[r], off) || any[r];
    }

  // sweep 2: p = exp(s - m), l over the unrounded p, O += round(P).V
  float acc[4][D / 16] = {};
  for (int k0 = 0; k0 < Lk; k0 += kFwdBK) {
    __syncthreads();
    load_tile(kh, Lk, k0, kFwdBK, D, nullptr, 0, kt, LT);
    load_tile(vh, Lk, k0, kFwdBK, D, vs, LV, nullptr, 0);
    __syncthreads();
    float s[4][4] = {};
    outer<4, 4>(qt + ty * 4, LT, kt + tx * 4, LT, D, s);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = attends(mb, q0 + ty * 4 + r, k0 + tx * 4 + c, Lq, Lk);
        pr[r] = ok ? expf(s[r][c] * scale - m[r]) : 0.f;
        l[r] += pr[r];
      }
      *reinterpret_cast<float4*>(pt + (tx * 4 + c) * LT + ty * 4) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
    }
    __syncthreads();
    outer_d<D>(pt + ty * 4, LT, vs + tx * 4, LV, kFwdBK, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= Lq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    const float valid = any[r] ? 1.f : 0.f;
    float* orow = o + (head * Lq + i) * D + tx * 4;
#pragma unroll
    for (int s = 0; s < D / 64; ++s) {
      float4 t;
      t.x = (acc[r][s * 4 + 0] / lr) * valid;
      t.y = (acc[r][s * 4 + 1] / lr) * valid;
      t.z = (acc[r][s * 4 + 2] / lr) * valid;
      t.w = (acc[r][s * 4 + 3] / lr) * valid;
      *reinterpret_cast<float4*>(orow + 64 * s) = t;
    }
    if (tx == 0) lse[head * Lq + i] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// dq, float32 inputs: 64 queries per block, 32-key tiles, every tile, on
// the CUDA cores

constexpr int kDqBQ = 64, kDqBK = 32;

template <int D>
constexpr size_t dq_smem_floats() {
  return (size_t)D * (kDqBQ + 4) * 2 + (size_t)D * (kDqBK + 4) * 2 +
         (size_t)kDqBK * (D + 4) + (size_t)kDqBK * (kDqBQ + 4) + 2 * kDqBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ delta, int H, int Lq, int Lk,
                        float scale) {
  constexpr int LQ = kDqBQ + 4;   // [D][64 + 4]
  constexpr int LK = kDqBK + 4;   // [D][32 + 4]
  constexpr int LR = D + 4;       // row-major [32][D + 4]
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // Q^T
  float* dot = qt + D * LQ;      // dO^T
  float* kt = dot + D * LQ;      // K^T of the key tile
  float* vt = kt + D * LK;       // V^T of the key tile
  float* kr = vt + D * LK;       // K of the key tile, row-major
  float* dst = kr + kDqBK * LR;  // dS^T of the tile: [key][query]
  float* lse_s = dst + kDqBK * LQ;
  float* delta_s = lse_s + kDqBQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * H + h;
  const float* qh = q + head * Lq * D;
  const float* kh = k + head * Lk * D;
  const float* vh = v + head * Lk * D;
  const float* oh = o + head * Lq * D;
  const float* doh = dout + head * Lq * D;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int q0 = blockIdx.x * kDqBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(qh, Lq, q0, kDqBQ, D, nullptr, 0, qt, LQ);
  load_tile(doh, Lq, q0, kDqBQ, D, nullptr, 0, dot, LQ);
  // delta = rowsum(dO * o), a warp per row
  for (int r = warp; r < kDqBQ; r += kThreads / 32) {
    const int i = q0 + r;
    float sum = 0.f;
    if (i < Lq)
      for (int d = lane; d < D; d += 32)
        sum = fmaf(doh[(size_t)i * D + d], oh[(size_t)i * D + d], sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = i < Lq ? lse[head * Lq + i] : 0.f;
      if (i < Lq) delta[head * Lq + i] = sum;
    }
  }

  float acc[4][D / 16] = {};
  for (int k0 = 0; k0 < Lk; k0 += kDqBK) {
    __syncthreads();
    load_tile(kh, Lk, k0, kDqBK, D, kr, LR, kt, LK);
    load_tile(vh, Lk, k0, kDqBK, D, nullptr, 0, vt, LK);
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
    outer<4, 2>(qt + ty * 4, LQ, kt + tx * 2, LK, D, s);
    outer<4, 2>(dot + ty * 4, LQ, vt + tx * 2, LK, D, dp);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = attends(mb, q0 + ty * 4 + r, k0 + tx * 2 + c, Lq, Lk);
        const float p = ok ? expf(s[r][c] * scale - lse_s[ty * 4 + r]) : 0.f;
        ds[r] = p * (dp[r][c] - delta_s[ty * 4 + r]) * scale;
      }
      *reinterpret_cast<float4*>(dst + (tx * 2 + c) * LQ + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    outer_d<D>(dst + ty * 4, LQ, kr + tx * 4, LR, kDqBK, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= Lq) continue;
    float* row = dq + (head * Lq + i) * D + tx * 4;
#pragma unroll
    for (int s = 0; s < D / 64; ++s)
      *reinterpret_cast<float4*>(row + 64 * s) =
          make_float4(acc[r][s * 4], acc[r][s * 4 + 1], acc[r][s * 4 + 2],
                      acc[r][s * 4 + 3]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv, float32 inputs: 64 keys per block, 32-query tiles

constexpr int kKvBK = 64, kKvBQ = 32;

template <int D>
constexpr size_t dkv_smem_floats() {
  return (size_t)D * (kKvBK + 4) * 2 + (size_t)D * (kKvBQ + 4) * 2 +
         (size_t)kKvBQ * (D + 4) * 2 + (size_t)kKvBQ * (kKvBK + 4) * 2 +
         2 * kKvBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Lq, int Lk,
                         float scale) {
  constexpr int LK = kKvBK + 4;  // [D][64 + 4] and [32][64 + 4]
  constexpr int LQ = kKvBQ + 4;  // [D][32 + 4]
  constexpr int LR = D + 4;      // row-major [32][D + 4]
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // K^T of the block's keys
  float* vt = kt + D * LK;       // V^T of the block's keys
  float* qt = vt + D * LK;       // Q^T of the query tile
  float* dot = qt + D * LQ;      // dO^T of the query tile
  float* qr = dot + D * LQ;      // Q, row-major
  float* dor = qr + kKvBQ * LR;  // dO, row-major
  float* ps = dor + kKvBQ * LR;  // P of the tile: [query][key]
  float* dss = ps + kKvBQ * LK;  // dS of the tile: [query][key]
  float* lse_s = dss + kKvBQ * LK;
  float* delta_s = lse_s + kKvBQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * H + h;
  const float* qh = q + head * Lq * D;
  const float* kh = k + head * Lk * D;
  const float* vh = v + head * Lk * D;
  const float* doh = dout + head * Lq * D;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int k0 = blockIdx.x * kKvBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(kh, Lk, k0, kKvBK, D, nullptr, 0, kt, LK);
  load_tile(vh, Lk, k0, kKvBK, D, nullptr, 0, vt, LK);

  float acc_k[4][D / 16] = {}, acc_v[4][D / 16] = {};
  for (int q0 = 0; q0 < Lq; q0 += kKvBQ) {
    __syncthreads();
    load_tile(qh, Lq, q0, kKvBQ, D, qr, LR, qt, LQ);
    load_tile(doh, Lq, q0, kKvBQ, D, dor, LR, dot, LQ);
    for (int r = threadIdx.x; r < kKvBQ; r += kThreads) {
      const int i = q0 + r;
      lse_s[r] = i < Lq ? lse[head * Lq + i] : 0.f;
      delta_s[r] = i < Lq ? delta[head * Lq + i] : 0.f;
    }
    __syncthreads();
    // s and dp transposed: rows are the block's keys, columns the queries
    float s[4][2] = {}, dp[4][2] = {};
    outer<4, 2>(kt + ty * 4, LK, qt + tx * 2, LQ, D, s);
    outer<4, 2>(vt + ty * 4, LK, dot + tx * 2, LQ, D, dp);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int il = tx * 2 + c;
      float p4[4], ds4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = attends(mb, q0 + il, k0 + ty * 4 + r, Lq, Lk);
        const float p = ok ? expf(s[r][c] * scale - lse_s[il]) : 0.f;
        p4[r] = p;
        ds4[r] = p * (dp[r][c] - delta_s[il]) * scale;
      }
      *reinterpret_cast<float4*>(ps + il * LK + ty * 4) =
          make_float4(p4[0], p4[1], p4[2], p4[3]);
      *reinterpret_cast<float4*>(dss + il * LK + ty * 4) =
          make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
    }
    __syncthreads();
    outer_d<D>(ps + ty * 4, LK, dor + tx * 4, LR, kKvBQ, acc_v);
    outer_d<D>(dss + ty * 4, LK, qr + tx * 4, LR, kKvBQ, acc_k);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty * 4 + r;
    if (j >= Lk) continue;
    float* krow = dk + (head * Lk + j) * D + tx * 4;
    float* vrow = dv + (head * Lk + j) * D + tx * 4;
#pragma unroll
    for (int s = 0; s < D / 64; ++s) {
      *reinterpret_cast<float4*>(krow + 64 * s) =
          make_float4(acc_k[r][s * 4], acc_k[r][s * 4 + 1],
                      acc_k[r][s * 4 + 2], acc_k[r][s * 4 + 3]);
      *reinterpret_cast<float4*>(vrow + 64 * s) =
          make_float4(acc_v[r][s * 4], acc_v[r][s * 4 + 1],
                      acc_v[r][s * 4 + 2], acc_v[r][s * 4 + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 backward on the tensor cores (the header says why): 4 warps a
// block, each the owner of 16 output rows; 64 x 64 tiles of the other side
// through a two-stage cp.async ring; empty tiles skipped

constexpr int kBwdThreads = 128;
constexpr int kBwdTile = 64;
constexpr int kMaskLd = 80;  // a staged mask tile's row: 64 bytes + 16
constexpr uint8_t kEmpty = 0, kMixed = 1, kFull = 2;

// rows [r0, r0 + 64) of an (L, D) bf16 slab → a swizzled shared tile by
// cp.async, rows past L zero-filled
template <int D>
__device__ __forceinline__ void cp_tile(uint32_t dst,
                                        const __nv_bfloat16* src, int L,
                                        int r0) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kBwdTile * kChunks / kBwdThreads; ++i) {
    const int idx = threadIdx.x + i * kBwdThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = r0 + r < L;
    cp_async16(dst + swz<D>(r, c), src + (size_t)(in ? r0 + r : 0) * D + c * 8,
               in ? 16 : 0);
  }
}

// mask bytes (qi, kj .. kj + 15), zero past Lq and Lk. kAligned: one
// 16-byte load (Lk a multiple of 16, the mask 16-byte aligned); else loads
// of `vec` bytes (the widest power of two that divides Lk and the mask's
// address, so that every load is aligned and in or out of range whole)
template <bool kAligned>
__device__ __forceinline__ uint4 mask_chunk(const uint8_t* __restrict__ mb,
                                            int Lq, int Lk, int qi, int kj,
                                            int vec) {
  const bool in = qi < Lq && kj < Lk;
  const uint8_t* p = mb + (in ? (size_t)qi * Lk + kj : 0);
  if (kAligned)
    return in ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0, 0, 0, 0);
  unsigned long long w0 = 0, w1 = 0;
  const int n = in ? min(16, Lk - kj) : 0;
  for (int i = 0; i < n; i += vec) {
    unsigned long long bits;
    if (vec == 8)
      bits = __ldg(reinterpret_cast<const unsigned long long*>(p + i));
    else if (vec == 4)
      bits = __ldg(reinterpret_cast<const unsigned int*>(p + i));
    else if (vec == 2)
      bits = __ldg(reinterpret_cast<const unsigned short*>(p + i));
    else
      bits = __ldg(p + i);
    if (i < 8)
      w0 |= bits << (8 * i);
    else
      w1 |= bits << (8 * (i - 8));
  }
  return make_uint4((uint32_t)w0, (uint32_t)(w0 >> 32), (uint32_t)w1,
                    (uint32_t)(w1 >> 32));
}

__device__ __forceinline__ bool has_zero_byte(uint32_t w) {
  return ((w - 0x01010101u) & ~w & 0x80808080u) != 0;
}

constexpr int kClassBatch = 8;  // tiles whose mask loads are in flight at once

// the class of each 64 x 64 mask tile of the block's slab → cls[t]; tile t
// starts at (q0 + t * dq, k0 + t * dk). Cells past Lq or Lk count as masked,
// so a ragged edge tile is never full. Each thread reads 2 chunks of 16
// bytes a tile, the chunks of kClassBatch tiles at once, and a warp and then
// the block OR and AND the flags of 32 tiles at a time.
template <bool kAligned>
__device__ void classify_tiles(uint8_t* cls, uint32_t* red,
                               const uint8_t* __restrict__ mb, int Lq,
                               int Lk, int q0, int k0, int dq, int dk,
                               int n_tiles, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int n = min(32, n_tiles - t0);
    uint32_t any = 0, all = 0;
    for (int t1 = 0; t1 < n; t1 += kClassBatch) {
      uint4 c[kClassBatch][2];
#pragma unroll
      for (int u = 0; u < kClassBatch; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + t1 + u, idx = threadIdx.x + i * kBwdThreads;
          c[u][i] = mask_chunk<kAligned>(
              mb, t < n_tiles ? Lq : 0, Lk, q0 + t * dq + (idx >> 2),
              k0 + t * dk + (idx & 3) * 16, vec);
        }
#pragma unroll
      for (int u = 0; u < kClassBatch; ++u) {
        bool a = false, f = true;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 x = c[u][i];
          a = a || (x.x | x.y | x.z | x.w) != 0;
          f = f && !has_zero_byte(x.x) && !has_zero_byte(x.y) &&
              !has_zero_byte(x.z) && !has_zero_byte(x.w);
        }
        any |= (uint32_t)a << (t1 + u);
        all |= (uint32_t)f << (t1 + u);
      }
    }
    any = __reduce_or_sync(0xffffffffu, any);
    all = __reduce_and_sync(0xffffffffu, all);
    if (lane == 0) red[warp] = any, red[kBwdThreads / 32 + warp] = all;
    __syncthreads();
    if (threadIdx.x < n) {
      uint32_t a = 0, f = 0xffffffffu;
#pragma unroll
      for (int w = 0; w < kBwdThreads / 32; ++w)
        a |= red[w], f &= red[kBwdThreads / 32 + w];
      const int t = threadIdx.x;
      cls[t0 + t] = (a >> t & 1) ? ((f >> t & 1) ? kFull : kMixed) : kEmpty;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void classify(uint8_t* cls, uint32_t* red,
                                         const uint8_t* __restrict__ mb,
                                         int Lq, int Lk, int q0, int k0,
                                         int dq, int dk, int n_tiles,
                                         int vec) {
  if (vec == 16)
    classify_tiles<true>(cls, red, mb, Lq, Lk, q0, k0, dq, dk, n_tiles, vec);
  else
    classify_tiles<false>(cls, red, mb, Lq, Lk, q0, k0, dq, dk, n_tiles, vec);
}

__device__ __forceinline__ int next_tile(const uint8_t* cls, int t, int n) {
  while (t < n && cls[t] == kEmpty) ++t;
  return t;
}

// the (64 x 64) mask tile at (q0, k0) → shared [query][kMaskLd], zero past
// Lq and Lk: by cp.async where the rows are 16-byte aligned, else by loads
__device__ __forceinline__ void stage_mask(uint8_t* dst,
                                           const uint8_t* __restrict__ mb,
                                           int Lq, int Lk, int q0, int k0,
                                           int vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kBwdThreads;
    const int r = idx >> 2, c = (idx & 3) * 16;
    const int qi = q0 + r, kj = k0 + c;
    uint8_t* d = dst + r * kMaskLd + c;
    if (vec == 16) {
      const bool in = qi < Lq && kj < Lk;
      cp_async16(smem_addr(d), in ? mb + (size_t)qi * Lk + kj : mb,
                 in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) =
          mask_chunk<false>(mb, Lq, Lk, qi, kj, vec);
    }
  }
}

// ---------------------------------------------------------------------------
// forward, bfloat16 inputs (the training path): the header's two sweeps on
// the tensor cores, built from the backward's pieces. 4 warps a block, each
// the owner of 16 query rows, whose Q fragments it keeps in registers for
// both sweeps. Before the sweeps the block classes the 64 x 64 tiles of its
// mask slab: empty tiles cost nothing in either sweep (their p is exactly
// 0, so m, l and o get no bit from them), full ones take no mask test, and
// only mixed ones stage their mask tile in shared memory. The next
// non-empty tile's K (sweep 1) or K, V and mask (sweep 2) are in flight
// through cp.async while this one computes. Each 16-key chunk of a tile
// runs S = Q.K^T (K's B fragments by ldmatrix from the swizzled row-major
// tile), and in sweep 2 turns its two n8 score tiles into the bf16 A
// fragment of P.V at once (V's B fragments by ldmatrix.trans from its
// row-major tile), so that a thread holds Q (D/16 x 4 registers), the
// (16 x D) output (D/8 x 4) and one chunk's scores (8).

// the class of every 64 x 64 tile of the mask, once a call for all heads:
// one block per (64-row slab, batch row), classes[(b * nq + slab) * nk + t]
__global__ void __launch_bounds__(kBwdThreads)
    flash_classes_kernel(const uint8_t* __restrict__ mask,
                         uint8_t* __restrict__ classes, int Lq, int Lk,
                         int vec) {
  __shared__ uint32_t red[2 * kBwdThreads / 32];
  extern __shared__ uint8_t slab_cls[];
  const int nk = (Lk + kBwdTile - 1) / kBwdTile;
  classify(slab_cls, red, mask + (size_t)blockIdx.y * Lq * Lk, Lq, Lk,
           blockIdx.x * kBwdTile, 0, 0, kBwdTile, nk, vec);
  uint8_t* out = classes + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * nk;
  for (int t = threadIdx.x; t < nk; t += kBwdThreads) out[t] = slab_cls[t];
}

// the forward's shared memory (bytes): two stages of (K tile, V tile, mask
// tile), then the block's row of tile classes
template <int D>
struct FwdSmem {
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kStage = 2 * kTile + kBwdTile * kMaskLd;
  static constexpr int kCls = 2 * kStage;
  static size_t bytes(int n_tiles) {
    return (size_t)kCls + ((n_tiles + 15) & ~15);
  }
};

// key tile t's K (and V, unless vh is null) and, if mixed, its mask tile
// into ring stage st
template <int D>
__device__ __forceinline__ void fwd_stage(unsigned char* smem, int st,
                                          const __nv_bfloat16* kh,
                                          const __nv_bfloat16* vh,
                                          const uint8_t* mb,
                                          const uint8_t* cls, int t, int Lq,
                                          int Lk, int q0, int vec) {
  using S = FwdSmem<D>;
  unsigned char* stage = smem + st * S::kStage;
  const int k0 = t * kBwdTile;
  cp_tile<D>(smem_addr(stage), kh, Lk, k0);
  if (vh != nullptr) cp_tile<D>(smem_addr(stage + S::kTile), vh, Lk, k0);
  if (cls[t] == kMixed)
    stage_mask(stage + 2 * S::kTile, mb, Lq, Lk, q0, k0, vec);
}

// s[nt][e] = Q.K^T of the warp's rows and keys kc*16 + nt*8 .. +7 of the
// K tile at shared address ks (the m16n8 accumulator layout). Each 16-wide
// slice of D is one MMA from a zero accumulator, and the D/16 slice sums
// are added in f32 (round to nearest): chained MMAs align every product to
// the running sum and truncate, and at D = 128 over ~700 keys a row that
// error flipped more bf16 roundings of p than a reordering of the f32 sums
// does (NVIDIA H100 80GB HBM3 at 700 W, (130, 1000, 128) with a random
// mask: 97.5 % of o within 1e-5 of the largest, against 99.1 % for the
// plain version's float64-score twin).
template <int D>
__device__ __forceinline__ void chunk_scores(float (&s)[2][4],
                                             uint32_t (&qf)[D / 16][4],
                                             uint32_t ks, int kc, int lane) {
  const int rb = kc * 16 + halves_row(lane);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t kb[4];
    ldsm_x4(kb, ks + swz<D>(rb, 2 * c + halves_chunk(lane)));
    float t[2][4] = {};
    mma_bf16(t[0], qf[c], kb[0], kb[1]);
    mma_bf16(t[1], qf[c], kb[2], kb[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = c == 0 ? t[nt][e] : __fadd_rn(s[nt][e], t[nt][e]);
  }
}

// the mask bytes of the thread's row `row` and keys kl, kl + 1 of a staged
// mask tile (both 1 in a full tile)
__device__ __forceinline__ uint32_t mask_pair(const uint8_t* ms, bool full,
                                              int row, int kl) {
  return full ? 0x0101u
              : *reinterpret_cast<const uint16_t*>(ms + row * kMaskLd + kl);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 3)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const uint8_t* __restrict__ classes,
                         float* __restrict__ o, float* __restrict__ lse,
                         int H, int Lq, int Lk, float scale, int vec) {
  using S = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  unsigned char* smem = fwd_smem;
  uint8_t* cls = smem + S::kCls;
  const uint32_t base = smem_addr(smem);

  const int b = blockIdx.z;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int q0 = blockIdx.x * kBwdTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (Lk + kBwdTile - 1) / kBwdTile;
  const size_t head = (size_t)b * H + blockIdx.y;
  const __nv_bfloat16* kh = k + head * Lk * D;
  const __nv_bfloat16* vh = v + head * Lk * D;

  // the block's Q into stage 1's K slot, its slab's tile classes
  cp_tile<D>(base + S::kStage, q + head * Lq * D, Lq, q0);
  cp_async_commit();
  {
    const uint8_t* row = classes + ((size_t)b * gridDim.x + blockIdx.x) *
                                       n_tiles;
    for (int i = threadIdx.x; i < n_tiles; i += kBwdThreads) cls[i] = row[i];
    __syncthreads();
  }

  int t = next_tile(cls, 0, n_tiles);
  if (t < n_tiles)
    fwd_stage<D>(smem, 0, kh, nullptr, mb, cls, t, Lq, Lk, q0, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the warp's 16 rows of Q as A fragments, for both sweeps
  uint32_t qf[D / 16][4];
  {
    const int r = warp * 16 + pairs_row(lane);
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      ldsm_x4(qf[c], base + S::kStage + swz<D>(r, 2 * c + pairs_chunk(lane)));
  }
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  __syncthreads();

  // sweep 1: the exact row max of the masked scores
  float m[2] = {kNegInf, kNegInf};
  bool any[2] = {false, false};
  for (int st = 0; t < n_tiles; st ^= 1) {
    const int tn = next_tile(cls, t + 1, n_tiles);
    if (tn < n_tiles)
      fwd_stage<D>(smem, st ^ 1, kh, nullptr, mb, cls, tn, Lq, Lk, q0, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t ks = base + st * S::kStage;
    const uint8_t* ms = smem + st * S::kStage + 2 * S::kTile;
    const bool full = cls[t] == kFull;
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {
      float s[2][4];
      chunk_scores<D>(s, qf, ks, kc, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const uint32_t m2 =
              mask_pair(ms, full, row[e2], kc * 16 + nt * 8 + 2 * t4);
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const bool ok = (m2 >> (8 * e1)) & 0xffu;
            m[e2] = fmaxf(m[e2],
                          ok ? __fmul_rn(s[nt][e2 * 2 + e1], scale) : kNegInf);
            any[e2] = any[e2] || ok;
          }
        }
    }
    __syncthreads();
    t = tn;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
      any[r] = __shfl_xor_sync(0xffffffffu, (int)any[r], off) || any[r];
    }

  // sweep 2: p = exp(s - m), l over the unrounded p, O += bf16(P).V
  t = next_tile(cls, 0, n_tiles);
  if (t < n_tiles) fwd_stage<D>(smem, 0, kh, vh, mb, cls, t, Lq, Lk, q0, vec);
  cp_async_commit();
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int st = 0; t < n_tiles; st ^= 1) {
    const int tn = next_tile(cls, t + 1, n_tiles);
    if (tn < n_tiles)
      fwd_stage<D>(smem, st ^ 1, kh, vh, mb, cls, tn, Lq, Lk, q0, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t ks = base + st * S::kStage, vs = ks + S::kTile;
    const uint8_t* ms = smem + st * S::kStage + 2 * S::kTile;
    const bool full = cls[t] == kFull;
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {
      float s[2][4];
      chunk_scores<D>(s, qf, ks, kc, lane);
      // P of keys kc*16 .. +15 in bf16: the A fragment of P.V
      uint32_t pf[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const uint32_t m2 =
              mask_pair(ms, full, row[e2], kc * 16 + nt * 8 + 2 * t4);
          float p[2];
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            p[e1] = (m2 >> (8 * e1)) & 0xffu
                        ? expf(__fmul_rn(s[nt][e2 * 2 + e1], scale) - m[e2])
                        : 0.f;
            l[e2] += p[e1];
          }
          pf[nt * 2 + e2] = pack_bf16(p[0], p[1]);
        }
      // O += P.V: V's B fragments by ldmatrix.trans of the V tile
      const int ra = kc * 16 + pairs_row(lane);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + swz<D>(ra, 2 * c + pairs_chunk(lane)));
        mma_bf16(acc[2 * c], pf, vb[0], vb[1]);
        mma_bf16(acc[2 * c + 1], pf, vb[2], vb[3]);
      }
    }
    __syncthreads();
    t = tn;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int i = q0 + row[e2];
    if (i >= Lq) continue;
    const float lr = fmaxf(l[e2], 1e-30f);
    const float valid = any[e2] ? 1.f : 0.f;
    float* orow = o + (head * Lq + i) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2((acc[n][2 * e2] / lr) * valid,
                      (acc[n][2 * e2 + 1] / lr) * valid);
    if (t4 == 0) lse[head * Lq + i] = m[e2] + logf(lr);
  }
}

// dq: shared memory (bytes) — two stages of (K tile, V tile, mask tile),
// the block's lse and delta, the classifier's words, the tile classes
template <int D>
struct DqSmem {
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kStage = 2 * kTile + kBwdTile * kMaskLd;
  static constexpr int kRows = 2 * kStage;
  static constexpr int kRed = kRows + 2 * kBwdTile * 4;
  static constexpr int kCls = kRed + 2 * kBwdThreads / 32 * 4;
  static size_t bytes(int n_tiles) {
    return (size_t)kCls + ((n_tiles + 15) & ~15);
  }
};

template <int D>
__device__ __forceinline__ void dq_stage(unsigned char* smem, int st,
                                         const __nv_bfloat16* kh,
                                         const __nv_bfloat16* vh,
                                         const uint8_t* mb, const uint8_t* cls,
                                         int t, int Lq, int Lk, int q0,
                                         int vec) {
  using S = DqSmem<D>;
  unsigned char* stage = smem + st * S::kStage;
  const int k0 = t * kBwdTile;
  cp_tile<D>(smem_addr(stage), kh, Lk, k0);
  cp_tile<D>(smem_addr(stage + S::kTile), vh, Lk, k0);
  if (cls[t] == kMixed)
    stage_mask(stage + 2 * S::kTile, mb, Lq, Lk, q0, k0, vec);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ delta, int H, int Lq, int Lk,
                        float scale, int vec) {
  using S = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  unsigned char* smem = bwd_smem;
  float* lse_s = reinterpret_cast<float*>(smem + S::kRows);
  float* delta_s = lse_s + kBwdTile;
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + S::kRed);
  uint8_t* cls = smem + S::kCls;
  const uint32_t base = smem_addr(smem);

  const int b = blockIdx.z;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int q0 = blockIdx.x * kBwdTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (Lk + kBwdTile - 1) / kBwdTile;
  const size_t head = (size_t)b * H + blockIdx.y;
  const __nv_bfloat16* kh = k + head * Lk * D;
  const __nv_bfloat16* vh = v + head * Lk * D;
  const __nv_bfloat16* oh = o + head * Lq * D;
  const __nv_bfloat16* doh = dout + head * Lq * D;

  // the block's Q and dO into stage 1's K and V slots
  cp_tile<D>(base + S::kStage, q + head * Lq * D, Lq, q0);
  cp_tile<D>(base + S::kStage + S::kTile, doh, Lq, q0);
  cp_async_commit();

  // delta = rowsum(dO * o), written out for dk/dv: two threads a row, each
  // with all its 16-byte loads in flight at once
  {
    static_assert(2 * kBwdTile == kBwdThreads, "two threads a row");
    constexpr int kLoads = D / 16;
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int i = q0 + r;
    float sum = 0.f;
    if (i < Lq) {
      const size_t at = (size_t)i * D + half * (D / 2);
      uint4 dov[kLoads], ov[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        dov[j] = __ldg(reinterpret_cast<const uint4*>(doh + at) + j);
        ov[j] = __ldg(reinterpret_cast<const uint4*>(oh + at) + j);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const auto* x = reinterpret_cast<const __nv_bfloat162*>(&dov[j]);
        const auto* y = reinterpret_cast<const __nv_bfloat162*>(&ov[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x[e]);
          const float2 yf = __bfloat1622float2(y[e]);
          sum = fmaf(xf.x, yf.x, sum);
          sum = fmaf(xf.y, yf.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[r] = sum;
      lse_s[r] = i < Lq ? lse[head * Lq + i] : 0.f;
      if (i < Lq) delta[head * Lq + i] = sum;
    }
  }
  classify(cls, red, mb, Lq, Lk, q0, 0, 0, kBwdTile, n_tiles, vec);

  int t = next_tile(cls, 0, n_tiles);
  if (t < n_tiles) dq_stage<D>(smem, 0, kh, vh, mb, cls, t, Lq, Lk, q0, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the warp's 16 rows of Q and dO as A fragments, for the whole sweep
  uint32_t qf[D / 16][4], df[D / 16][4];
  {
    const int r = warp * 16 + pairs_row(lane);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint32_t off = swz<D>(r, 2 * c + pairs_chunk(lane));
      ldsm_x4(qf[c], base + S::kStage + off);
      ldsm_x4(df[c], base + S::kStage + S::kTile + off);
    }
  }
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float lse_r[2] = {lse_s[row[0]], lse_s[row[1]]};
  const float del_r[2] = {delta_s[row[0]], delta_s[row[1]]};
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int st = 0; t < n_tiles; st ^= 1) {
    const int tn = next_tile(cls, t + 1, n_tiles);
    if (tn < n_tiles)
      dq_stage<D>(smem, st ^ 1, kh, vh, mb, cls, tn, Lq, Lk, q0, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t ks = base + st * S::kStage, vs = ks + S::kTile;
    const uint8_t* ms = smem + st * S::kStage + 2 * S::kTile;
    const bool full = cls[t] == kFull;
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {
      // S and dP of the warp's rows and keys kc*16 .. +15 (two n8 tiles)
      float s[2][4] = {}, dp[2][4] = {};
      const int rb = kc * 16 + halves_row(lane);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t kb[4], vb[4];
        const uint32_t off = swz<D>(rb, 2 * c + halves_chunk(lane));
        ldsm_x4(kb, ks + off);
        ldsm_x4(vb, vs + off);
        mma_bf16(s[0], qf[c], kb[0], kb[1]);
        mma_bf16(s[1], qf[c], kb[2], kb[3]);
        mma_bf16(dp[0], df[c], vb[0], vb[1]);
        mma_bf16(dp[1], df[c], vb[2], vb[3]);
      }
      // dS, split hi/lo, as the A fragment of keys kc*16 .. +15
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int kl = kc * 16 + nt * 8 + 2 * t4;
          uint32_t m2 = 0x0101u;
          if (!full)
            m2 = *reinterpret_cast<const uint16_t*>(ms + row[e2] * kMaskLd +
                                                    kl);
          float ds[2];
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int e = e2 * 2 + e1;
            const float p = (m2 >> (8 * e1)) & 0xffu
                                ? expf(s[nt][e] * scale - lse_r[e2])
                                : 0.f;
            ds[e1] = p * (dp[nt][e] - del_r[e2]) * scale;
          }
          split_bf16(ds[0], ds[1], hi[nt * 2 + e2], lo[nt * 2 + e2]);
        }
      // dq += dS.K: K^T's B fragments by ldmatrix.trans of the K tile
      const int ra = kc * 16 + pairs_row(lane);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t kb[4];
        ldsm_x4_t(kb, ks + swz<D>(ra, 2 * c + pairs_chunk(lane)));
        mma_bf16(acc[2 * c], hi, kb[0], kb[1]);
        mma_bf16(acc[2 * c], lo, kb[0], kb[1]);
        mma_bf16(acc[2 * c + 1], hi, kb[2], kb[3]);
        mma_bf16(acc[2 * c + 1], lo, kb[2], kb[3]);
      }
    }
    __syncthreads();
    t = tn;
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int i = q0 + row[e2];
    if (i >= Lq) continue;
    float* out = dq + (head * Lq + i) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]);
  }
}

// dk/dv: shared memory (bytes) — the block's K and V, two stages of (Q
// tile, dO tile, mask tile, lse, delta), the classifier's words, the classes
template <int D>
struct DkvSmem {
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kStage =
      2 * kTile + kBwdTile * kMaskLd + 2 * kBwdTile * 4;
  static constexpr int kRed = kRing + 2 * kStage;
  static constexpr int kCls = kRed + 2 * kBwdThreads / 32 * 4;
  static size_t bytes(int n_tiles) {
    return (size_t)kCls + ((n_tiles + 15) & ~15);
  }
};

template <int D>
__device__ __forceinline__ void dkv_stage(unsigned char* smem, int st,
                                          const __nv_bfloat16* qh,
                                          const __nv_bfloat16* doh,
                                          const float* lse_h,
                                          const float* delta_h,
                                          const uint8_t* mb,
                                          const uint8_t* cls, int t, int Lq,
                                          int Lk, int k0, int vec) {
  using S = DkvSmem<D>;
  unsigned char* stage = smem + S::kRing + st * S::kStage;
  const int q0 = t * kBwdTile;
  cp_tile<D>(smem_addr(stage), qh, Lq, q0);
  cp_tile<D>(smem_addr(stage + S::kTile), doh, Lq, q0);
  {
    // lse (threads 0-63) and delta (64-127) of the tile's queries
    const int r = threadIdx.x & (kBwdTile - 1);
    const bool in = q0 + r < Lq;
    const float* src = threadIdx.x < kBwdTile ? lse_h : delta_h;
    cp_async4(smem_addr(stage + 2 * S::kTile + kBwdTile * kMaskLd +
                        threadIdx.x * 4),
              src + (in ? q0 + r : 0), in ? 4 : 0);
  }
  if (cls[t] == kMixed)
    stage_mask(stage + 2 * S::kTile, mb, Lq, Lk, q0, k0, vec);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Lq, int Lk, float scale, int vec) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  unsigned char* smem = bwd_smem;
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + S::kRed);
  uint8_t* cls = smem + S::kCls;
  const uint32_t base = smem_addr(smem);

  const int b = blockIdx.z;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int k0 = blockIdx.x * kBwdTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (Lq + kBwdTile - 1) / kBwdTile;
  const size_t head = (size_t)b * H + blockIdx.y;
  const __nv_bfloat16* qh = q + head * Lq * D;
  const __nv_bfloat16* doh = dout + head * Lq * D;
  const float* lse_h = lse + head * Lq;
  const float* delta_h = delta + head * Lq;

  // the block's K and V, resident for the sweep
  cp_tile<D>(base, k + head * Lk * D, Lk, k0);
  cp_tile<D>(base + S::kTile, v + head * Lk * D, Lk, k0);
  cp_async_commit();
  classify(cls, red, mb, Lq, Lk, 0, k0, kBwdTile, 0, n_tiles, vec);

  int t = next_tile(cls, 0, n_tiles);
  if (t < n_tiles)
    dkv_stage<D>(smem, 0, qh, doh, lse_h, delta_h, mb, cls, t, Lq, Lk, k0,
                 vec);
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int key[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int ra = warp * 16 + pairs_row(lane);  // K and V A-fragment rows
  for (int st = 0; t < n_tiles; st ^= 1) {
    const int tn = next_tile(cls, t + 1, n_tiles);
    if (tn < n_tiles)
      dkv_stage<D>(smem, st ^ 1, qh, doh, lse_h, delta_h, mb, cls, tn, Lq, Lk,
                   k0, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    unsigned char* stage = smem + S::kRing + st * S::kStage;
    const uint32_t qs = smem_addr(stage), ds = qs + S::kTile;
    const uint8_t* ms = stage + 2 * S::kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(ms + kBwdTile * kMaskLd);
    const float* del_s = lse_s + kBwdTile;
    const bool full = cls[t] == kFull;
#pragma unroll 1
    for (int qc = 0; qc < kBwdTile / 16; ++qc) {
      // S^T = K.Q^T and dP^T = V.dO^T of the warp's keys and queries
      // qc*16 .. +15 (two n8 tiles)
      float s[2][4] = {}, dp[2][4] = {};
      const int rb = qc * 16 + halves_row(lane);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t ka[4], va[4], qb[4], db[4];
        const uint32_t off_a = swz<D>(ra, 2 * c + pairs_chunk(lane));
        const uint32_t off_b = swz<D>(rb, 2 * c + halves_chunk(lane));
        ldsm_x4(ka, base + off_a);
        ldsm_x4(va, base + S::kTile + off_a);
        ldsm_x4(qb, qs + off_b);
        ldsm_x4(db, ds + off_b);
        mma_bf16(s[0], ka, qb[0], qb[1]);
        mma_bf16(s[1], ka, qb[2], qb[3]);
        mma_bf16(dp[0], va, db[0], db[1]);
        mma_bf16(dp[1], va, db[2], db[3]);
      }
      // P^T and dS^T, split hi/lo, as A fragments over queries qc*16 .. +15
      uint32_t phi[4], plo[4], shi[4], slo[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ql = qc * 16 + nt * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(del_s + ql);
        const float lq[2] = {l2.x, l2.y}, dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float p[2], dsv[2];
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int e = e2 * 2 + e1;
            const bool ok =
                full || ms[(ql + e1) * kMaskLd + key[e2]] != 0;
            p[e1] = ok ? expf(s[nt][e] * scale - lq[e1]) : 0.f;
            dsv[e1] = p[e1] * (dp[nt][e] - dl[e1]) * scale;
          }
          split_bf16(p[0], p[1], phi[nt * 2 + e2], plo[nt * 2 + e2]);
          split_bf16(dsv[0], dsv[1], shi[nt * 2 + e2], slo[nt * 2 + e2]);
        }
      }
      // dv += P^T.dO and dk += dS^T.Q: B fragments by ldmatrix.trans
      const int rq = qc * 16 + pairs_row(lane);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t db[4], qb[4];
        const uint32_t off = swz<D>(rq, 2 * c + pairs_chunk(lane));
        ldsm_x4_t(db, ds + off);
        ldsm_x4_t(qb, qs + off);
        mma_bf16(acc_v[2 * c], phi, db[0], db[1]);
        mma_bf16(acc_v[2 * c], plo, db[0], db[1]);
        mma_bf16(acc_v[2 * c + 1], phi, db[2], db[3]);
        mma_bf16(acc_v[2 * c + 1], plo, db[2], db[3]);
        mma_bf16(acc_k[2 * c], shi, qb[0], qb[1]);
        mma_bf16(acc_k[2 * c], slo, qb[0], qb[1]);
        mma_bf16(acc_k[2 * c + 1], shi, qb[2], qb[3]);
        mma_bf16(acc_k[2 * c + 1], slo, qb[2], qb[3]);
      }
    }
    __syncthreads();
    t = tn;
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int j = k0 + key[e2];
    if (j >= Lk) continue;
    float* krow = dk + (head * Lk + j) * D + 2 * t4;
    float* vrow = dv + (head * Lk + j) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(krow + n * 8) =
          make_float2(acc_k[n][2 * e2], acc_k[n][2 * e2 + 1]);
      *reinterpret_cast<float2*>(vrow + n * 8) =
          make_float2(acc_v[n][2 * e2], acc_v[n][2 * e2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches: the kernel instantiation for (input type, D), its dynamic shared
// memory raised above 48 KB first

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool shape_ok(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && (D == 64 || D == 128);
}

// the widest load (16, 8, 4, 2 or 1 bytes) that keeps every mask row's
// 16-byte chunks aligned
int mask_vec(const void* mask, int Lk) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  int vec = 16;
  while (vec > 1 && (Lk % vec != 0 || addr % vec != 0)) vec >>= 1;
  return vec;
}

// bf16: the class map (into `classes`, B x ceil(Lq/64) x ceil(Lk/64)
// bytes), then the forward; *launched counts each kernel queued
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const uint8_t* mask, uint8_t* classes, float* o, float* lse,
                int B, int H, int Lq, int Lk, float scale, int device,
                void* stream, int* launched) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int nq = (Lq + kBwdTile - 1) / kBwdTile;
    const int nk = (Lk + kBwdTile - 1) / kBwdTile;
    const int vec = mask_vec(mask, Lk);
    const size_t bytes = FwdSmem<D>::bytes(nk);
    cudaError_t err = prepare(flash_fwd_mma_kernel<D>, bytes, device);
    if (err != cudaSuccess) return err;
    flash_classes_kernel<<<dim3(nq, B), kBwdThreads, (nk + 15) & ~15, s>>>(
        mask, classes, Lq, Lk, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    flash_fwd_mma_kernel<D><<<dim3(nq, H, B), kBwdThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, classes, o, lse, H, Lq,
        Lk, scale, vec);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err;
  } else {
    const dim3 grid((Lq + kFwdBQ - 1) / kFwdBQ, H, B);
    const size_t floats = fwd_smem_floats<D>();
    cudaError_t err =
        prepare(flash_fwd_kernel<D>, floats * sizeof(float), device);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<grid, kThreads, floats * sizeof(float), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, o, lse, H, Lq, Lk, scale);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err;
  }
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v,
               const uint8_t* mask, const void* o, const void* dout,
               const float* lse, float* dqo, float* delta, int B, int H,
               int Lq, int Lk, float scale, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((Lq + kBwdTile - 1) / kBwdTile, H, B);
    const size_t bytes = DqSmem<D>::bytes((Lk + kBwdTile - 1) / kBwdTile);
    const cudaError_t err = prepare(flash_dq_mma_kernel<D>, bytes, device);
    if (err != cudaSuccess) return err;
    flash_dq_mma_kernel<D><<<grid, kBwdThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, dqo, delta, H, Lq, Lk, scale,
        mask_vec(mask, Lk));
  } else {
    const dim3 grid((Lq + kDqBQ - 1) / kDqBQ, H, B);
    const size_t bytes = dq_smem_floats<D>() * sizeof(float);
    const cudaError_t err = prepare(flash_dq_f32_kernel<D>, bytes, device);
    if (err != cudaSuccess) return err;
    flash_dq_f32_kernel<D><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, dqo, delta, H, Lq, Lk, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v,
                const uint8_t* mask, const void* dout, const float* lse,
                const float* delta, float* dko, float* dvo, int B, int H,
                int Lq, int Lk, float scale, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((Lk + kBwdTile - 1) / kBwdTile, H, B);
    const size_t bytes = DkvSmem<D>::bytes((Lq + kBwdTile - 1) / kBwdTile);
    const cudaError_t err = prepare(flash_dkv_mma_kernel<D>, bytes, device);
    if (err != cudaSuccess) return err;
    flash_dkv_mma_kernel<D><<<grid, kBwdThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse,
        delta, dko, dvo, H, Lq, Lk, scale, mask_vec(mask, Lk));
  } else {
    const dim3 grid((Lk + kKvBK - 1) / kKvBK, H, B);
    const size_t bytes = dkv_smem_floats<D>() * sizeof(float);
    const cudaError_t err = prepare(flash_dkv_f32_kernel<D>, bytes, device);
    if (err != cudaSuccess) return err;
    flash_dkv_f32_kernel<D><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse,
        delta, dko, dvo, H, Lq, Lk, scale);
  }
  return cudaGetLastError();
}

// dynamic shared memory bytes a block and resident blocks per SM of one
// bf16 tensor-core kernel
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, size_t bytes, int device, int* info) {
  cudaError_t err = prepare(kernel, bytes, device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kBwdThreads, bytes);
  info[0] = (int)bytes;
  info[1] = blocks;
  return err;
}

}  // namespace

// bf16: 1 for bfloat16 inputs, 0 for float32. Each entry returns the CUDA
// error of its launch (0 on success) and sets *launched to the number of
// kernels queued (the bf16 forward: 2, its class map and itself; else 1).

// classes: scratch of B x ceil(Lq/64) x ceil(Lk/64) bytes for the bf16
// forward's tile classes (unused for float32)
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const uint8_t* mask, uint8_t* classes, float* o,
                         float* lse, int B, int H, int Lq, int Lk, int D,
                         int bf16, float scale, int device, void* stream,
                         int* launched) {
  *launched = 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)(D == 64 ? fwd<__nv_bfloat16, 64>(q, k, v, mask, classes, o,
                                                  lse, B, H, Lq, Lk, scale,
                                                  device, stream, launched)
                         : fwd<__nv_bfloat16, 128>(q, k, v, mask, classes, o,
                                                   lse, B, H, Lq, Lk, scale,
                                                   device, stream, launched));
  return (int)(D == 64 ? fwd<float, 64>(q, k, v, mask, classes, o, lse, B, H,
                                        Lq, Lk, scale, device, stream,
                                        launched)
                       : fwd<float, 128>(q, k, v, mask, classes, o, lse, B,
                                         H, Lq, Lk, scale, device, stream,
                                         launched));
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const uint8_t* mask, const void* o, const void* dout,
                        const float* lse, float* dqo, float* delta, int B,
                        int H, int Lq, int Lk, int D, int bf16, float scale,
                        int device, void* stream, int* launched) {
  *launched = 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16)
    err = D == 64
              ? dq<__nv_bfloat16, 64>(q, k, v, mask, o, dout, lse, dqo, delta,
                                      B, H, Lq, Lk, scale, device, stream)
              : dq<__nv_bfloat16, 128>(q, k, v, mask, o, dout, lse, dqo,
                                       delta, B, H, Lq, Lk, scale, device,
                                       stream);
  else
    err = D == 64 ? dq<float, 64>(q, k, v, mask, o, dout, lse, dqo, delta, B,
                                  H, Lq, Lk, scale, device, stream)
                  : dq<float, 128>(q, k, v, mask, o, dout, lse, dqo, delta, B,
                                   H, Lq, Lk, scale, device, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const uint8_t* mask, const void* dout,
                         const float* lse, const float* delta, float* dko,
                         float* dvo, int B, int H, int Lq, int Lk, int D,
                         int bf16, float scale, int device, void* stream,
                         int* launched) {
  *launched = 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16)
    err = D == 64
              ? dkv<__nv_bfloat16, 64>(q, k, v, mask, dout, lse, delta, dko,
                                       dvo, B, H, Lq, Lk, scale, device,
                                       stream)
              : dkv<__nv_bfloat16, 128>(q, k, v, mask, dout, lse, delta, dko,
                                        dvo, B, H, Lq, Lk, scale, device,
                                        stream);
  else
    err = D == 64 ? dkv<float, 64>(q, k, v, mask, dout, lse, delta, dko, dvo,
                                   B, H, Lq, Lk, scale, device, stream)
                  : dkv<float, 128>(q, k, v, mask, dout, lse, delta, dko, dvo,
                                    B, H, Lq, Lk, scale, device, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// kernel 0: the bf16 forward, 1: the bf16 dq kernel, 2: the bf16 dk/dv
// kernel, at head_dim D and sweep length L (Lk for the forward and dq, Lq
// for dk/dv). info[0] = dynamic shared memory bytes a block, info[1] =
// resident blocks per SM. Returns the CUDA error.
extern "C" int flash_kernel_info(int kernel, int D, int L, int device,
                                 int* info) {
  if (!(D == 64 || D == 128) || L < 1 || kernel < 0 || kernel > 2)
    return (int)cudaErrorInvalidValue;
  const int n = (L + kBwdTile - 1) / kBwdTile;
  cudaError_t err;
  if (kernel == 0)
    err = D == 64 ? kernel_info(flash_fwd_mma_kernel<64>,
                                FwdSmem<64>::bytes(n), device, info)
                  : kernel_info(flash_fwd_mma_kernel<128>,
                                FwdSmem<128>::bytes(n), device, info);
  else if (kernel == 1)
    err = D == 64 ? kernel_info(flash_dq_mma_kernel<64>, DqSmem<64>::bytes(n),
                                device, info)
                  : kernel_info(flash_dq_mma_kernel<128>,
                                DqSmem<128>::bytes(n), device, info);
  else
    err = D == 64 ? kernel_info(flash_dkv_mma_kernel<64>,
                                DkvSmem<64>::bytes(n), device, info)
                  : kernel_info(flash_dkv_mma_kernel<128>,
                                DkvSmem<128>::bytes(n), device, info);
  return (int)err;
}
