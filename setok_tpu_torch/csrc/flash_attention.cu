// Masked flash attention on the card: the forward (with its log-sum-exp),
// the dq gradient and the dk/dv gradients.
//
// Replaces setok_tpu/kernels/flash_attention.py:120 (flash_attention, a
// jax.custom_vjp over three pallas_calls: the forward at :146, dq at :185,
// dk/dv at :208). q: (B, H, Lq, D), k/v: (B, H, Lk, D) in float32 or
// bfloat16; mask: (B, Lq, Lk) bytes, nonzero = attend, holes anywhere (the
// Setokim splice masks image slots and pads mid-sequence). Lq and Lk are any
// lengths; D is 64 or 128.
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
//   dq       one block per (64 queries, head, batch row), over 32-key
//            tiles: p = exp(s - lse) * mask, dp = dO.V^T, delta = rowsum(dO
//            * o) (computed once here and written out for dk/dv),
//            ds = p * (dp - delta) * scale, dq += ds.K.
//   dk/dv    one block per (64 keys, head, batch row), over 32-query tiles:
//            the same p and ds, dv += P^T.dO, dk += dS^T.Q. Each block owns
//            its keys' rows, so no atomics.
//
// The bf16 forward's two products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulation, as the JAX kernel's dots). Every
// other product runs on the CUDA cores in float32 from tiles held in shared
// memory as float32 (register micro-tiles of 4 x 4, 4 x 2 and 4 x 4·D/64
// outputs per thread): the backward's f32 products cannot take TF32, which
// misses the 2e-4 gradient bar of tests/test_flash_attention.py. Outputs
// are float32 (o, lse, dq, dk, dv, delta); the wrapper casts o and the
// gradients to the input type.
//
// What bounds it (H100 SXM data sheet). At B = 4, H = 32, L = 2048, D = 128
// one product over the full square is 1.37e11 FLOP: the forward's two bf16
// products take 0.28 ms at 989 TFLOP/s, the backward's seven f32 products
// 14.4 ms at 67 TFLOP/s. The training mask (causal, holes, pads) leaves
// ~30 % of the cells, so the forward is bound by its bytes (q, k, v, the
// mask, o: 0.085 ms at 3.35 TB/s) and dq and dk/dv by their operations.
// This version computes every tile, masked or not, and the forward's
// scores twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows [r0, r0 + n) of an (L, D) slab → float32 shared memory, row-major
// (rm[r * ldr + d]) and/or transposed (tr[d * ldt + r]); rows past L are 0.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int L,
                                          int r0, int n, int D, float* rm,
                                          int ldr, float* tr, int ldt) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int g = r0 + r;
    const float v = g < L ? to_f32(src[(size_t)g * D + d]) : 0.f;
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
// forward, bfloat16 inputs: the same two sweeps with the products on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulation: the JAX
// kernel's dots, products exact, sums in f32). 4 warps, 16 query rows each;
// a thread holds its rows' Q fragments, the (16 x 64) score tile of a key
// tile as 8 accumulator fragments, and the (16 x D) output as D/8. P, in
// bf16, goes from the score fragments straight into the A fragments of
// P.V (the layouts line up). K is kept [key][d] and V transposed [d][key]
// in shared memory, rows padded by 8 values so that each fragment load of
// a warp touches 32 distinct banks.

constexpr int kMmaThreads = 128;
constexpr int kMmaBQ = 64, kMmaBK = 64;

template <int D>
constexpr size_t fwd_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)kMmaBQ * (D + 8) + (size_t)kMmaBK * (D + 8) +
          (size_t)D * (kMmaBK + 8));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + n) of an (L, D) bf16 slab → shared [r][ld] (transposed:
// [d][ldt]), 16 bytes a thread; rows past L are 0
template <int D>
__device__ __forceinline__ void load_bf16_tile(
    const __nv_bfloat16* __restrict__ src, int L, int r0, int n,
    __nv_bfloat16* rm, int ld, __nv_bfloat16* tr, int ldt) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < n * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < L)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    if (rm != nullptr) *reinterpret_cast<uint4*>(rm + r * ld + c) = v;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c + i) * ldt + r] = e[i];
    }
  }
}

// s[nb][e] = Q.K^T of the thread's row (e < 2: g, else g + 8) and key
// nb * 8 + t4 * 2 + (e & 1) of the tile; `kr` is the K tile offset by the
// thread's (g, t4)
template <int D>
__device__ __forceinline__ void mma_scores(const uint32_t (&qf)[D / 16][4],
                                           const __nv_bfloat16* kr,
                                           float (&s)[kMmaBK / 8][4]) {
#pragma unroll
  for (int nb = 0; nb < kMmaBK / 8; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    const __nv_bfloat16* r = kr + nb * 8 * (D + 8);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      mma_bf16(s[nb], qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3],
               ld32(r + kc * 16), ld32(r + kc * 16 + 8));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ o, float* __restrict__ lse,
                         int H, int Lq, int Lk, float scale) {
  constexpr int LQ = D + 8, LV = kMmaBK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * LQ;   // [key][d]
  __nv_bfloat16* vt = ks + kMmaBK * LQ;   // [d][key]

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * H + h;
  const __nv_bfloat16* kh = k + head * Lk * D;
  const __nv_bfloat16* vh = v + head * Lk * D;
  const uint8_t* mb = mask + (size_t)b * Lq * Lk;
  const int q0 = blockIdx.x * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this thread's two query rows: g and g + 8 of the warp's 16
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_bf16_tile<D>(q + head * Lq * D, Lq, q0, kMmaBQ, qs, LQ, nullptr, 0);
  __syncthreads();
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* r = qs + (warp * 16 + g) * LQ + t4 * 2;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      qf[kc][0] = ld32(r + kc * 16);
      qf[kc][1] = ld32(r + 8 * LQ + kc * 16);
      qf[kc][2] = ld32(r + kc * 16 + 8);
      qf[kc][3] = ld32(r + 8 * LQ + kc * 16 + 8);
    }
  }


  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  bool any[2] = {false, false};
  float s[kMmaBK / 8][4];

  // sweep 1: the exact row max of the masked scores
  for (int k0 = 0; k0 < Lk; k0 += kMmaBK) {
    __syncthreads();
    load_bf16_tile<D>(kh, Lk, k0, kMmaBK, ks, LQ, nullptr, 0);
    __syncthreads();
    mma_scores<D>(qf, ks + g * LQ + t4 * 2, s);
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            attends(mb, rows[e >> 1], k0 + nb * 8 + t4 * 2 + (e & 1), Lq, Lk);
        m[e >> 1] = fmaxf(m[e >> 1], ok ? s[nb][e] * scale : kNegInf);
        any[e >> 1] = any[e >> 1] || ok;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
      any[r] = __shfl_xor_sync(0xffffffffu, (int)any[r], off) || any[r];
    }

  // sweep 2: p = exp(s - m), l over the unrounded p, O += bf16(P).V
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kMmaBK) {
    __syncthreads();
    load_bf16_tile<D>(kh, Lk, k0, kMmaBK, ks, LQ, nullptr, 0);
    load_bf16_tile<D>(vh, Lk, k0, kMmaBK, nullptr, 0, vt, LV);
    __syncthreads();
    mma_scores<D>(qf, ks + g * LQ + t4 * 2, s);
    uint32_t pf[kMmaBK / 16][4];
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            attends(mb, rows[e >> 1], k0 + nb * 8 + t4 * 2 + (e & 1), Lq, Lk);
        p[e] = ok ? expf(s[nb][e] * scale - m[e >> 1]) : 0.f;
        l[e >> 1] += p[e];
      }
      // n-block nb is keys [8 nb, 8 nb + 8): the low or high half of the
      // 16-key A fragment of chunk nb / 2
      pf[nb >> 1][(nb & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const __nv_bfloat16* vr = vt + (nd * 8 + g) * LV + t4 * 2;
#pragma unroll
      for (int kc = 0; kc < kMmaBK / 16; ++kc)
        mma_bf16(acc[nd], pf[kc][0], pf[kc][1], pf[kc][2], pf[kc][3],
                 ld32(vr + kc * 16), ld32(vr + kc * 16 + 8));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    if (i >= Lq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    const float valid = any[r] ? 1.f : 0.f;
    float* orow = o + (head * Lq + i) * D + t4 * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8) =
          make_float2((acc[nd][2 * r] / lr) * valid,
                      (acc[nd][2 * r + 1] / lr) * valid);
    if (t4 == 0) lse[head * Lq + i] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// dq: 64 queries per block, 32-key tiles

constexpr int kDqBQ = 64, kDqBK = 32;

template <int D>
constexpr size_t dq_smem_floats() {
  return (size_t)D * (kDqBQ + 4) * 2 + (size_t)D * (kDqBK + 4) * 2 +
         (size_t)kDqBK * (D + 4) + (size_t)kDqBK * (kDqBQ + 4) + 2 * kDqBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    const T* __restrict__ o, const T* __restrict__ dout,
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
  const T* qh = q + head * Lq * D;
  const T* kh = k + head * Lk * D;
  const T* vh = v + head * Lk * D;
  const T* oh = o + head * Lq * D;
  const T* doh = dout + head * Lq * D;
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
        sum = fmaf(to_f32(doh[(size_t)i * D + d]),
                   to_f32(oh[(size_t)i * D + d]), sum);
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
// dk/dv: 64 keys per block, 32-query tiles

constexpr int kKvBK = 64, kKvBQ = 32;

template <int D>
constexpr size_t dkv_smem_floats() {
  return (size_t)D * (kKvBK + 4) * 2 + (size_t)D * (kKvBQ + 4) * 2 +
         (size_t)kKvBQ * (D + 4) * 2 + (size_t)kKvBQ * (kKvBK + 4) * 2 +
         2 * kKvBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
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
  const T* qh = q + head * Lq * D;
  const T* kh = k + head * Lk * D;
  const T* vh = v + head * Lk * D;
  const T* doh = dout + head * Lq * D;
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

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const uint8_t* mask, float* o, float* lse, int B, int H,
                int Lq, int Lk, float scale, int device, void* stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((Lq + kMmaBQ - 1) / kMmaBQ, H, B);
    const size_t bytes = fwd_mma_smem_bytes<D>();
    const cudaError_t err = prepare(flash_fwd_mma_kernel<D>, bytes, device);
    if (err != cudaSuccess) return err;
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, o, lse, H, Lq, Lk, scale);
    return cudaGetLastError();
  } else {
    const dim3 grid((Lq + kFwdBQ - 1) / kFwdBQ, H, B);
    const size_t floats = fwd_smem_floats<D>();
    const cudaError_t err =
        prepare(flash_fwd_kernel<D>, floats * sizeof(float), device);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<grid, kThreads, floats * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, o, lse, H, Lq, Lk, scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v,
               const uint8_t* mask, const void* o, const void* dout,
               const float* lse, float* dqo, float* delta, int B, int H,
               int Lq, int Lk, float scale, int device, void* stream) {
  const dim3 grid((Lq + kDqBQ - 1) / kDqBQ, H, B);
  const size_t floats = dq_smem_floats<D>();
  const cudaError_t err =
      prepare(flash_dq_kernel<T, D>, floats * sizeof(float), device);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, D><<<grid, kThreads, floats * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, dqo, delta, H, Lq, Lk, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v,
                const uint8_t* mask, const void* dout, const float* lse,
                const float* delta, float* dko, float* dvo, int B, int H,
                int Lq, int Lk, float scale, int device, void* stream) {
  const dim3 grid((Lk + kKvBK - 1) / kKvBK, H, B);
  const size_t floats = dkv_smem_floats<D>();
  const cudaError_t err =
      prepare(flash_dkv_kernel<T, D>, floats * sizeof(float), device);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, D><<<grid, kThreads, floats * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      dko, dvo, H, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16: 1 for bfloat16 inputs, 0 for float32. Each entry returns the CUDA
// error of its launch (0 on success) and sets *launched to 1 once the kernel
// is queued.

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const uint8_t* mask, float* o, float* lse, int B,
                         int H, int Lq, int Lk, int D, int bf16, float scale,
                         int device, void* stream, int* launched) {
  *launched = 0;
  if (!shape_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16)
    err = D == 64 ? fwd<__nv_bfloat16, 64>(q, k, v, mask, o, lse, B, H, Lq,
                                           Lk, scale, device, stream)
                  : fwd<__nv_bfloat16, 128>(q, k, v, mask, o, lse, B, H, Lq,
                                            Lk, scale, device, stream);
  else
    err = D == 64 ? fwd<float, 64>(q, k, v, mask, o, lse, B, H, Lq, Lk, scale,
                                   device, stream)
                  : fwd<float, 128>(q, k, v, mask, o, lse, B, H, Lq, Lk,
                                    scale, device, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
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
