// Unmasked softmax attention over bf16 q, k and v on the tensor cores: the
// core of the float `Attention` route (ops/blocks.py `Attention.forward`)
// in one kernel, so that the (B, H, N, N) scores never reach device memory.
//
// Replaces no Pallas kernel: the JAX package writes this attention as
// einsum -> softmax -> einsum (setok_tpu/ops/blocks.py `Attention`), which
// XLA fuses on the TPU. Eager PyTorch runs the chain as six to eight passes
// over the scores (the q.k^T product, the scale, the cast up, the softmax,
// the cast down, p.v, and the head transposes around them); this kernel is
// the card's counterpart of XLA's fusion.
//
// What it computes, for each batch row b, head h and query row i:
//
//   s_j = (q_i . k_j) * scale    bf16 products summed in f32, the scale in f32
//   m   = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j         (f32)
//   o_i = (sum_j bf16(p_j) v_j) / l             (f32 sums, one division)
//
// and writes o_i in bf16. m and l run over 64-key tiles (the online
// softmax): when a tile raises a row's max, l and the P.V sums are rescaled
// by exp(m_old - m_new), so p rounds to bf16 against the running max. That
// differs from the two-pass arithmetic of the plain version
// (kernels/attention_bf16.py `attention_bf16_plain`) by rounding only.
//
// Inputs: q, k, v of shape (B, N, H, D) in bf16, read through their
// strides (the qkv projection's (B, N, 3, H, D) output as it stands: no
// transpose copies), the last axis contiguous and every row 16-byte
// aligned. Output o: (B, N, H, D) bf16, contiguous, i.e. (B, N, H * D) as
// `proj` takes it. D is any multiple of 8 up to 128; N any length from 1.
//
// What bounds it: at the so400m ViT's call (B = 32, H = 16, N = 729,
// D = 72) the products are 4 B H N^2 D = 78.4 GFLOP (79 us at 989 TFLOP/s)
// and the bytes 215 MB (q, k, v read once, o written once; 64 us at 3.35
// TB/s): operations, and beside them B H N^2 = 272 M exponentials on the
// SMs' special-function units (73 us at 16 a clock an SM). mma.sync reaches
// about two thirds of the tensor cores' rate, and with 32 rows a warp the
// K and V fragments cost one shared-memory byte per 32 FLOP. On an H100
// (700 W) this design took 0.415 ms a call against 0.456-0.466 for 16 rows
// a warp (64 a block), two or three stages alike. What the design does:
//
//   * One block of 4 warps per (128 query rows, head, batch row) up to
//     D = 72: a warp owns 32 rows (two m16 tiles), so each K and V fragment
//     it reads from shared memory feeds two MMAs, and each key tile fetched
//     from L2 serves 128 queries. At the so400m shape the grid is 6 query
//     tiles x 16 heads x 32 rows, 2 blocks an SM. Past D = 72 a warp owns
//     16 rows (64 a block), as the accumulators grow.
//   * Q stays in shared memory (its A fragments by ldmatrix at each key
//     tile: registers go to the accumulators). K and V come in tiles of 64
//     keys through a cp.async ring (three stages up to D = 72, else two;
//     16-byte copies, zero-filled past N), one barrier a tile. A shared row
//     is (D/8 | 1) 16-byte chunks: an odd count puts the 8 rows an ldmatrix
//     reads in 8 different bank groups without a swizzle (D = 72 is 9
//     chunks as it stands; D = 64 pads to 9).
//   * S = Q.K^T on mma.sync m16n8k16 (bf16 in, f32 sums), and where D is 8
//     past a multiple of 16 one m16n8k8 step more (D = 72: 4 + 1). K's B
//     fragments by ldmatrix from its row-major tile.
//   * The mask of keys past N (in the last tile only, -1e30 in
//     registers), the tile's row max (of the unscaled scores, then a quad
//     shuffle), the rescale and p = 2^(s c - m c), c = scale * log2(e), in
//     one FFMA and one ex2, stay in the accumulator layout. Two adjacent n8
//     score tiles become one bf16 A fragment of P.V (16 keys) without a
//     round trip through shared memory, and V's B fragments come by
//     ldmatrix.trans (D/8 n8 tiles: D = 72 is 4 pairs and one x2).
//   * o is divided by the row sum once and written as bf16 pairs straight
//     into (B, N, H, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma16;

constexpr int kThreads = 128;   // 4 warps of 16 query rows
constexpr int kRows = 64;       // query rows a block, keys a tile
constexpr float kNegInf = -1e30f;  // keys past N; exp(kNegInf - m) = 0

// a shared row of D bf16 values: D / 8 chunks of 16 bytes, padded to an
// odd count
template <int D>
struct Tile {
  static constexpr int kChunks = D / 8;
  static constexpr int kPitch = (kChunks | 1) * 16;  // bytes a row
  static constexpr int kBytes = kRows * kPitch;
};

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c (16 x 8) += a (16 x 8, rows g and g + 8, k 2t4 and 2t4 + 1) . b (8 x 8)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// rows r0 .. r0 + 63 of a (N, D) operand whose rows lie `stride` elements
// apart → the shared tile at dst, zero past N
template <int D>
__device__ __forceinline__ void cp_rows(uint32_t dst,
                                        const __nv_bfloat16* __restrict__ src,
                                        long long stride, int N, int r0) {
  using T = Tile<D>;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < kRows * T::kChunks; idx += kThreads) {
    const int r = idx / T::kChunks, c = idx - r * T::kChunks;
    const bool in = r0 + r < N;
    const __nv_bfloat16* p = in ? src + (r0 + r) * stride + c * 8 : src;
    cp_async16(dst + r * T::kPitch + c * 16, p, in ? 16 : 0);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kMt m16 row tiles a warp (4 warps: 64 kMt query rows a block) and a ring
// of kStages key tiles; Q stays in shared memory
template <int D, int kMt, int kStages>
struct Config {
  using T = Tile<D>;
  static constexpr int kQRows = 4 * 16 * kMt;
  static constexpr int kQBytes = kQRows * T::kPitch;
  static constexpr int kSmem = kQBytes + kStages * 2 * T::kBytes;
};

template <int D, int kMt, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int N, int H,
                          long long qsb, long long qsn, long long qsh,
                          long long ksb, long long ksn, long long ksh,
                          long long vsb, long long vsn, long long vsh,
                          float scale_log2e) {
  using T = Tile<D>;
  using C = Config<D, kMt, kStages>;
  constexpr int kK16 = D / 16;          // m16n8k16 steps of Q.K^T
  constexpr bool kK8 = (D % 16) != 0;   // and one m16n8k8 step
  constexpr int kNt = D / 8;            // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_addr(smem), ring = qs + C::kQBytes;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::kQRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const __nv_bfloat16* kh = k + b * ksb + h * ksh;
  const __nv_bfloat16* vh = v + b * vsb + h * vsh;
  const int n_tiles = (N + kRows - 1) / kRows;

  // Q and key tiles 0 .. kStages - 2, one cp.async group a tile
  for (int r0 = 0; r0 < C::kQRows; r0 += kRows)
    cp_rows<D>(qs + r0 * T::kPitch, q + b * qsb + h * qsh, qsn, N,
               q0 + r0);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      cp_rows<D>(ring + t * 2 * T::kBytes, kh, ksn, N, t * kRows);
      cp_rows<D>(ring + t * 2 * T::kBytes + T::kBytes, vh, vsn, N,
                 t * kRows);
    }
    cp_async_commit();
  }

  // where Q's A fragments of the warp's rows lie: row tile mt is rows
  // warp * 16 kMt + 16 mt .. + 15
  const uint32_t qa = qs + (warp * 16 * kMt + pairs_row(lane)) * T::kPitch +
                      pairs_chunk(lane) * 16;
  const uint32_t qa8 = qs + (warp * 16 * kMt + (lane & 15)) * T::kPitch +
                       (T::kChunks - 1) * 16;

  // running max (of the unscaled scores) and this thread's part of the
  // row sums, of rows g and g + 8 of each row tile
  float m[kMt][2], l[kMt][2];
  float acc[kMt][kNt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) m[mt][r] = kNegInf, l[mt][r] = 0.f;
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // key tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage takes tile t + kStages - 1
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        const uint32_t st = ring + (tn % kStages) * 2 * T::kBytes;
        cp_rows<D>(st, kh, ksn, N, tn * kRows);
        cp_rows<D>(st + T::kBytes, vh, vsn, N, tn * kRows);
      }
      cp_async_commit();
    }
    const uint32_t ks = ring + (t % kStages) * 2 * T::kBytes;
    const uint32_t vs = ks + T::kBytes;

    // S = Q.K^T of the warp's rows and the tile's 64 keys: s[mt][nt]
    // holds keys nt * 8 .. + 7 in the m16n8 accumulator layout
    float s[kMt][8][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kK16; ++c) {
      uint32_t a[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        ldsm_x4(a[mt], qa + mt * 16 * T::kPitch + 2 * c * 16);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (n2 * 16 + halves_row(lane)) * T::kPitch +
                        (2 * c + halves_chunk(lane)) * 16);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_bf16(s[mt][2 * n2], a[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * n2 + 1], a[mt], kb[2], kb[3]);
        }
      }
    }
    if constexpr (kK8) {
      uint32_t a8[kMt][2];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        ldsm_x2(a8[mt], qa8 + mt * 16 * T::kPitch);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (half * 32 + lane) * T::kPitch +
                        (T::kChunks - 1) * 16);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_bf16_k8(s[mt][half * 4 + i], a8[mt][0], a8[mt][1], kb[i]);
      }
    }

    // keys past N to kNegInf, the tile's row max of the unscaled scores
    // (the scale is positive: the max commutes with it), the rescale
    const int k0 = t * kRows;
    const bool edge = k0 + kRows > N;
    float ms[kMt][2];   // the running max times scale * log2(e)
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge && k0 + nt * 8 + 2 * t4 + (e & 1) >= N)
            s[mt][nt][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // exp((m - mx) * scale); 0 at the first tile, whose key 0 is real
        const float alpha = ex2((m[mt][r] - mx[r]) * scale_log2e);
        m[mt][r] = mx[r];
        ms[mt][r] = mx[r] * scale_log2e;
        l[mt][r] *= alpha;
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
      }
    }

    // 16 keys at a time: p = exp(s * scale - m * scale) = 2^(s c - m c),
    // c = scale * log2(e), in one FFMA; l over the unrounded p, then
    // O += bf16(P).V
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pf[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int nt = 2 * kc + half;
            const float p0 =
                ex2(fmaf(s[mt][nt][2 * r], scale_log2e, -ms[mt][r]));
            const float p1 =
                ex2(fmaf(s[mt][nt][2 * r + 1], scale_log2e, -ms[mt][r]));
            l[mt][r] += p0 + p1;
            pf[mt][half * 2 + r] = pack_bf16(p0, p1);
          }
      const uint32_t vr = vs + (kc * 16 + pairs_row(lane)) * T::kPitch;
#pragma unroll
      for (int c = 0; c < kNt / 2; ++c) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vr + (2 * c + pairs_chunk(lane)) * 16);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_bf16(acc[mt][2 * c], pf[mt], vb[0], vb[1]);
          mma_bf16(acc[mt][2 * c + 1], pf[mt], vb[2], vb[3]);
        }
      }
      if constexpr (kNt % 2 != 0) {
        uint32_t vb[2];
        ldsm_x2_t(vb, vs + (kc * 16 + (lane & 15)) * T::kPitch +
                          (kNt - 1) * 16);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
          mma_bf16(acc[mt][kNt - 1], pf[mt], vb[0], vb[1]);
      }
    }
  }

  // the row sums across the quad, one division, bf16 pairs out
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int i = q0 + warp * 16 * kMt + mt * 16 + (lane >> 2) + 8 * r;
      if (i >= N) continue;
      __nv_bfloat16* orow =
          o + (((long long)b * N + i) * H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < kNt; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(__fdiv_rn(acc[mt][n][2 * r], lr),
                      __fdiv_rn(acc[mt][n][2 * r + 1], lr));
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int N, int H, const long long* st, float scale,
                   int device, cudaStream_t stream) {
  // up to D = 72 two row tiles a warp (128 query rows a block), three key
  // tiles in flight, 2 blocks an SM (245 registers at D = 72); past it one
  // row tile a warp and two stages, as the accumulators grow
  constexpr int kMt = D <= 72 ? 2 : 1, kStages = D <= 72 ? 3 : 2;
  auto kernel = attention_bf16_kernel<D, kMt, kStages, 2>;
  using C = Config<D, kMt, kStages>;
  static bool raised[32] = {};
  if (C::kSmem > 48 * 1024 && !raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const dim3 grid((N + C::kQRows - 1) / C::kQRows, H, B);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      N, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 at the given element strides (batch, row,
// head for each of q, k, v, in that order: 9 values); o: (B, N, H, D) bf16
// contiguous. Returns a CUDA error code, 0 after one launch.
extern "C" int attention_bf16(const void* q, const void* k, const void* v,
                              void* o, int B, int N, int H, int D,
                              const long long* strides, float scale,
                              int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || H < 1 || H > 65535 || D < 8 ||
      D > 128 || D % 8 != 0 || device < 0 || device >= 32)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define ATTENTION_BF16_CASE(d) \
  case d:                      \
    return (int)launch<d>(q, k, v, o, B, N, H, strides, scale, device, s);
    ATTENTION_BF16_CASE(8)
    ATTENTION_BF16_CASE(16)
    ATTENTION_BF16_CASE(24)
    ATTENTION_BF16_CASE(32)
    ATTENTION_BF16_CASE(40)
    ATTENTION_BF16_CASE(48)
    ATTENTION_BF16_CASE(56)
    ATTENTION_BF16_CASE(64)
    ATTENTION_BF16_CASE(72)
    ATTENTION_BF16_CASE(80)
    ATTENTION_BF16_CASE(88)
    ATTENTION_BF16_CASE(96)
    ATTENTION_BF16_CASE(104)
    ATTENTION_BF16_CASE(112)
    ATTENTION_BF16_CASE(120)
    ATTENTION_BF16_CASE(128)
#undef ATTENTION_BF16_CASE
  }
  return (int)cudaErrorInvalidValue;
}
