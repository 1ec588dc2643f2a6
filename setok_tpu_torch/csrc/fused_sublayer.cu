// The int8 transformer sublayers of the ViT, the tokenizer Blocks, the pixel
// decoder and the Q-Former FFN.
//
// Replaces setok_tpu/kernels/fused_sublayer.py:
//   attn_sublayer_int8  out = x + proj(attn(qkv(LN x)))         (:196)
//   mlp_sublayer_int8   out = x + fc2(gelu_tanh(fc1(LN x)))     (:347)
//   mlp_postnorm_int8   out = LN(x + fc2(gelu_tanh(fc1 x)))     (:304)
// Each TPU kernel is one Pallas program per image or per 256 rows that keeps
// everything in VMEM.
//
// What bounds them (H100 SXM data sheet, B=64 images of N=256, C=768): the
// int8 products. Attention: 2*B*N*C*4C = 77.3 G int8 operations (39 us at
// 1,979 TOP/s) plus 4*B*N^2*C = 12.9 G bf16 for the scores and PV (13 us at
// 989 TFLOP/s): 0.0521 ms, against 30 us for the f32 input and output. MLP:
// 4*M*C*3072 = 154.6 G int8 operations at M = 16,384 rows, 0.0781 ms.
//
// What the design does: a block on Hopper has at most 227 KB of shared
// memory, so each sublayer is a chain of launches with the intermediates in
// device memory, the int8 products on the persistent wgmma GEMM of
// wgmma_s8.cuh (TMA ring, m64n256k32 s8, exact s32 sums) and the pieces of
// the unfused MLP (fused_mlp.cu, row 6) shared:
//
//   attention  quant_rows_kernel  LN and quantisation in one read of x (the
//                                 row in registers, f64 statistics rounded
//                                 once); clears omax
//              wgmma GEMM, qkv    bf16((acc * xs) * s + b), the q columns'
//                                 s and b pre-multiplied by the softmax
//                                 scale (the wrapper folds it, as JAX does)
//              attn_mma_kernel    the attention on the tensor cores (below);
//                                 o in f32 and each row's |o| maximum over
//                                 the heads, by atomicMax on its bits
//              hidden_quant       o -> int8 with max(omax, 1e-8) / 127, one
//                                 read of o
//              wgmma GEMM, proj   x + ((acc * os) * s + b)      5 launches
//   MLP        quant_rows_kernel  LN and quantisation (as above); clears hmax
//              wgmma GEMM, fc1    gelu_tanh((acc * xs) * s1 + b1), f32, and
//                                 the rows' |h| maxima by atomicMax
//              hidden_quant       h -> int8, one read of h
//              wgmma GEMM, fc2    x + ((acc * hs) * s2 + b2)    4 launches
//   post-norm  as the MLP without the LN in front, the residual epilogue
//              writing z, then rows_kernel: LN(z)               5 launches
//
// Every multiply and add is rounded as written (__fmul_rn / __fadd_rn), in
// the JAX kernels' order, the residual added last: the MLPs give their plain
// versions' values to the bit.
//
// The attention (attn_mma_kernel): one block of 4 warps per (image, head,
// 64 queries), each warp the owner of 16 query rows. The head's Q tile, its
// K tiles of 64 keys and its V tiles (64 keys x 64 head columns, as many a
// stage as its bytes hold) come from the (B*N, 3C) bf16 qkv rows by
// cp.async (16-byte copies: the row stride is 6C bytes and the head offsets
// multiples of 2D, both of 16) into swizzled shared tiles, through a ring
// of up to 4 stages.
//   * Scores: S = Q.K^T is taken exactly, on the FP64 tensor cores (mma.sync
//     m16n8k4 f64; every bf16 x bf16 product and every sum of up to 768 of
//     them is exact in f64) and rounded once to f32. The plain version's
//     scores are the same exact values (a float64 product), so the two
//     agree on every score and so on every bf16 rounding of p. Scores
//     summed in float32 in any other order than the plain version's flip
//     enough of those roundings, and the int8 steps of o behind them, to
//     fail the 0.99 share bar: a float32 plain version against its own
//     float64-score twin reads 0.985 at chip_smoke.py's B = 4 ViT case
//     (NVIDIA H100 80GB HBM3, 700 W), and a bf16 MMA of the scores (each
//     16-wide slice of D from zero) fell under the bar at B = 3 and 4.
//   * Softmax: every score of the block's rows stays in shared memory (64 x
//     N f32: 64 KB at N = 256), so the softmax is the exact full-row one of
//     the JAX kernel: the mask as the -1e30 * (1 - m) bias, the row max
//     kept in registers as the scores are made (each thread's two rows,
//     reduced over the row's 4 lanes), p = exp(s - m) and l in f32 in the
//     MMA fragment layout, p rounded to bf16 only once the row's max is
//     known (an online softmax would round p against a running max) and
//     written in place over the scores.
//   * PV on mma.sync m16n8k16 bf16 from the bf16 p (ldmatrix) and V
//     (ldmatrix.trans), each 16-key slice from zero and added in f32; D =
//     384 walks 6 column passes, D = 48 is three k16 slices. o = PV * (1/l)
//     after PV, 0 on a fully masked row.

#include "mma_bf16.cuh"
#include "wgmma_s8.cuh"

namespace {

using namespace mma16;
using namespace wg;

constexpr float kNegInf = -1e30f;
constexpr int kAttnThreads = 128;   // 4 warps of 16 query rows
constexpr int kQueries = 64;        // query rows a block
constexpr int kKeys = 64;           // keys a K or V tile
constexpr int kVCols = 64;          // head columns a PV pass
constexpr int kMaxKeys = 768;

// bf16 value i of the 8 packed in v, exactly as a double
__device__ __forceinline__ double bf16_at(const uint4& v, int i) {
  const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return (double)__uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// c (16 x 8, f64) += a (16 x 4) . b (4 x 8) on the FP64 tensor cores (sm_90's
// m16n8k4 shape; m8n8k4 runs slower there): lane (g, t4) gives
// A[g][t4], A[g + 8][t4] and B[t4][g], holds C[g][2t4], C[g][2t4 + 1],
// C[g + 8][2t4], C[g + 8][2t4 + 1]
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

constexpr int kMaxStages = 4;
constexpr int kSubTile = kKeys * 2 * kVCols;   // a 64-key x 64-column V tile

// the attention's shared memory (byte offsets): the block's Q tile, the
// ring of K / V tiles and the scores (64 rows of sp floats, p in bf16 in
// place)
struct AttnSmem {
  int row_bytes;   // a Q or K tile row: D rounded up to 64 values, bf16
  int stage;       // a ring stage: a K tile, or row_bytes / 128 V tiles
  int sp;          // floats a score row: the keys rounded up to 64, + 4
  int ring, s, total;
};

__host__ __device__ inline AttnSmem attn_smem(int N, int D, int stages) {
  AttnSmem a;
  a.row_bytes = (D + 63) / 64 * 128;
  a.stage = kKeys * a.row_bytes;
  a.sp = (N + kKeys - 1) / kKeys * kKeys + 4;
  a.ring = kQueries * a.row_bytes;
  a.s = a.ring + stages * a.stage;
  a.total = a.s + kQueries * a.sp * 4;
  return a;
}

// all but the newest n (1 .. kMaxStages - 1) groups of cp.async copies done
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// qkv: (B*N, 3C) bf16, head h's q, k and v in columns h*D, C + h*D and 2C +
// h*D. mask: (B, N, N) bytes, nonzero = attend, or null. o: (B*N, C) f32;
// omax[row] takes the row's |o| maximum by atomicMax on its bits. stages:
// the ring's depth, 1 .. kMaxStages.
__global__ void __launch_bounds__(kAttnThreads, 2)
attn_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                const uint8_t* __restrict__ mask, float* __restrict__ o,
                unsigned* __restrict__ omax, int N, int C, int D,
                int stages) {
  extern __shared__ __align__(128) unsigned char attn_buf[];
  const AttnSmem L = attn_smem(N, D, stages);
  const uint32_t base = smem_addr(attn_buf);
  float* S = reinterpret_cast<float*>(attn_buf + L.s);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueries;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;   // the warp's first row of the block's 64
  const int ld = 3 * C;
  const __nv_bfloat16* rows = qkv + (size_t)b * N * ld;
  const int nt = (N + kKeys - 1) / kKeys;          // key tiles
  const int passes = (D + kVCols - 1) / kVCols;   // PV column passes
  // a V unit: the pass's columns of `per` key tiles, as many as a stage holds
  const int per = L.stage / kSubTile;
  const int vunits = (nt + per - 1) / per;
  const int units = nt + passes * vunits;         // K tiles, then V units

  // rows [r0, r0 + 64) of qkv columns [col, col + width) → the swizzled
  // tile at dst, rows past N zero-filled; 8 lanes a row, 16 bytes each
  auto load_tile = [&](uint32_t dst, int r0, int col, int width,
                       int row_bytes) {
    for (int r = threadIdx.x >> 3; r < kKeys; r += kAttnThreads / 8) {
      const bool in = r0 + r < N;
      const __nv_bfloat16* src =
          rows + (size_t)(in ? r0 + r : 0) * ld + col;
      for (int c = threadIdx.x & 7; c < width / 8; c += 8)
        cp_async16(dst + swz(r, c, row_bytes), src + c * 8, in ? 16 : 0);
    }
  };
  auto stage_of = [&](int u) {
    return base + L.ring + (u % stages) * L.stage;
  };
  // unit u: K tile u, or V unit q of pass p (its key tiles one after another
  // in the stage)
  auto issue = [&](int u) {
    if (u < nt) {
      load_tile(stage_of(u), u * kKeys, C + h * D, D, L.row_bytes);
    } else {
      const int p = (u - nt) / vunits, q = (u - nt) % vunits;
      const int c0 = p * kVCols;
      for (int i = 0; i < per && q * per + i < nt; ++i)
        load_tile(stage_of(u) + i * kSubTile, (q * per + i) * kKeys,
                  2 * C + h * D + c0, min(kVCols, D - c0), 2 * kVCols);
    }
  };
  // wait for unit u's tile, stages - 1 more in flight behind it; every
  // warp sees it
  auto arrive = [&](int u) {
    if (stages > 1 && u + stages - 1 < units) issue(u + stages - 1);
    cp_async_commit();
    cp_async_wait_n(stages - 1);
    __syncthreads();
    return stage_of(u);
  };
  // every warp is done with unit u's tile
  auto release = [&](int u) {
    __syncthreads();
    if (stages == 1 && u + 1 < units) {
      issue(u + 1);
      cp_async_commit();
    }
  };

  load_tile(base, q0, h * D, D, L.row_bytes);
  for (int u = 0; u < (stages > 1 ? stages - 1 : 1) && u < units; ++u) {
    issue(u);
    cp_async_commit();
  }

  // the thread's two rows (g, g + 8 of the warp's 16) and their mask rows
  // (a row past N reads row N - 1's: its output is not written)
  const uint8_t* mr[2] = {nullptr, nullptr};
  if (mask != nullptr)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      mr[e2] =
          mask + ((size_t)b * N + min(q0 + wrow + g + 8 * e2, N - 1)) * N;

  // 1. S = Q.K^T of the warp's rows, key tile by key tile: in f64 on the
  //    tensor cores, exact, rounded once to f32; the mask bias added, and
  //    the running row max over the thread's scores; into S
  float rmax[2] = {-INFINITY, -INFINITY};
  for (int u = 0; u < nt; ++u) {
    const uint32_t kt = arrive(u);
    const unsigned char* ks = attn_buf + (kt - base);
    double acc[8][4] = {};   // rows g, g + 8 of 8 n8 key tiles
    for (int c0 = 0; c0 < D / 8; c0 += 4) {
      // lane t4 takes 16-byte chunk c0 + t4 (8 values of D) of its A rows
      // and B keys, k step i its value i: every d once, in either operand
      const int c = c0 + t4;
      const bool in = c < D / 8;
      uint4 qa[2], kb[8];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        qa[mt] = in ? *reinterpret_cast<const uint4*>(
                          attn_buf + swz(wrow + 8 * mt + g, c, L.row_bytes))
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        kb[n] = in ? *reinterpret_cast<const uint4*>(
                         ks + swz(n * 8 + g, c, L.row_bytes))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const double a0 = bf16_at(qa[0], i), a1 = bf16_at(qa[1], i);
#pragma unroll
        for (int n = 0; n < 8; ++n) dmma(acc[n], a0, a1, bf16_at(kb[n], i));
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = u * kKeys + n * 8 + 2 * t4;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = (float)acc[n][2 * e2 + e];
          if (col + e >= N) {
            v[e] = -INFINITY;   // a padding key: no part of the row
          } else if (mr[e2] != nullptr) {
            const float mf = mr[e2][col + e] ? 1.f : 0.f;
            v[e] = __fadd_rn(v[e], __fmul_rn(kNegInf, __fsub_rn(1.f, mf)));
          }
          rmax[e2] = fmaxf(rmax[e2], v[e]);
        }
        *reinterpret_cast<float2*>(S + (wrow + g + 8 * e2) * L.sp + col) =
            make_float2(v[0], v[1]);
      }
    }
    release(u);
  }

  // 2. the softmax in the same layout: the row max over the 4 lanes of a
  //    row, p = exp(s - m) and l in f32, bf16 p written in place over the
  //    row's scores a key tile at a time (tile t's p lies over the scores
  //    of tiles <= t / 2, already read)
  float m[2], lr[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    m[e2] = fmaxf(rmax[e2], __shfl_xor_sync(0xffffffffu, rmax[e2], 1));
    m[e2] = fmaxf(m[e2], __shfl_xor_sync(0xffffffffu, m[e2], 2));
  }
  float l[2] = {0.f, 0.f};
  __syncwarp();
  for (int t = 0; t < nt; ++t) {
    float2 sv[2][8];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sv[e2][n] = *reinterpret_cast<const float2*>(
            S + (wrow + g + 8 * e2) * L.sp + t * kKeys + n * 8 + 2 * t4);
    __syncwarp();
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      __nv_bfloat162* pr =
          reinterpret_cast<__nv_bfloat162*>(S + (wrow + g + 8 * e2) * L.sp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = t * kKeys + n * 8 + 2 * t4;
        const float p0 = expf(__fsub_rn(sv[e2][n].x, m[e2]));
        const float p1 = expf(__fsub_rn(sv[e2][n].y, m[e2]));
        l[e2] += p0;
        l[e2] += p1;
        pr[col / 2] = __floats2bfloat162_rn(p0, p1);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 1);
    l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 2);
    lr[e2] = m[e2] > 0.5f * kNegInf ? 1.f / fmaxf(l[e2], 1e-30f) : 0.f;
  }

  // 3. o = (P.V) * (1/l), 64 head columns a pass, key tile by key tile
  const uint32_t p_rows = base + L.s + (wrow + pairs_row(lane)) * L.sp * 4;
  float omx[2] = {0.f, 0.f};
  for (int p = 0; p < passes; ++p) {
    const int c0 = p * kVCols, width = min(kVCols, D - c0);
    float acc[8][4];
    for (int t = 0; t < nt; ++t) {
      const int u = nt + p * vunits + t / per;
      const uint32_t vt = stage_of(u) + (t % per) * kSubTile;
      if (t % per == 0) arrive(u);
#pragma unroll
      for (int kq = 0; kq < kKeys / 16; ++kq) {
        uint32_t pf[4];
        ldsm_x4(pf, p_rows + (t * 8 + 2 * kq + pairs_chunk(lane)) * 16);
        float a[8][4] = {};
#pragma unroll
        for (int c = 0; c < kVCols / 16; ++c) {
          if (16 * c >= width) continue;
          uint32_t vb[4];
          ldsm_x4_t(vb, vt + swz(kq * 16 + pairs_row(lane),
                                 2 * c + pairs_chunk(lane), 2 * kVCols));
          mma_bf16(a[2 * c], pf, vb[0], vb[1]);
          mma_bf16(a[2 * c + 1], pf, vb[2], vb[3]);
        }
        const bool first = t == 0 && kq == 0;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = first ? a[n][e] : __fadd_rn(acc[n][e], a[n][e]);
      }
      if (t % per == per - 1 || t == nt - 1) release(u);
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int i = q0 + wrow + g + 8 * e2;
      if (i >= N) continue;
      float* orow = o + ((size_t)b * N + i) * C + h * D + c0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (8 * n >= width) continue;
        const float o0 = __fmul_rn(acc[n][2 * e2], lr[e2]);
        const float o1 = __fmul_rn(acc[n][2 * e2 + 1], lr[e2]);
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o0, o1);
        omx[e2] = fmaxf(omx[e2], fmaxf(fabsf(o0), fabsf(o1)));
      }
    }
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    float mx = omx[e2];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const int i = q0 + wrow + g + 8 * e2;
    if (t4 == 0 && i < N)
      atomicMax(omax + (size_t)b * N + i, __float_as_uint(mx));
  }
}

// the attention's ring depth (as many stages as fit, at most kMaxStages,
// so that two blocks share an SM where they can) and shared memory, or
// stages 0 where the shape does not fit
cudaError_t attn_launch_shape(int N, int D, int device, int* stages,
                              int* smem) {
  int limit = 0, per_sm = 0;   // the card's opt-in shared memory a block, SM
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = raise_smem_limit(reinterpret_cast<const void*>(attn_mma_kernel),
                           device, limit);
  if (err != cudaSuccess) return err;
  // two blocks an SM (1 KB of each reserved), else one
  const int pair = per_sm / 2 - 1024;
  *stages = 0;
  const int caps[2] = {pair, limit};
  for (int cap : caps)
    for (int st = kMaxStages; st >= 1 && *stages == 0; --st)
      if (attn_smem(N, D, st).total <= cap &&
          (st >= 2 || cap == limit)) {
        *stages = st;
        *smem = attn_smem(N, D, st).total;
      }
  return cudaSuccess;
}

}  // namespace

// x, out: (B*N, C) f32. w_qkv (3C, C) int8 with scales s_qkv and bias b_qkv
// (3C), the q columns pre-scaled; w_proj (C, C). mask: (B, N, N) bytes,
// nonzero = attend, or null. Scratch, each 16-byte aligned: x8 (B*N*C)
// int8 (then o's int8 rows), xs (B*N) f32, qkv (B*N*3C) bf16, o (B*N*C) f32,
// omax (B*N) u32. Takes C % 16 == 0, C <= 1024, D = C / H a multiple of 16,
// N <= 768 and a shared-memory need within the card's: else
// cudaErrorInvalidValue, nothing launched. Each launch counts one in
// *launched; returns the CUDA error of the first launch that failed, else 0.
extern "C" int attn_sublayer_int8_f32(
    const float* x, const float* ln_g, const float* ln_b, float ln_eps,
    const int8_t* w_qkv, const float* s_qkv, const float* b_qkv,
    const int8_t* w_proj, const float* s_proj, const float* b_proj,
    const uint8_t* mask, float* out, int8_t* x8, float* xs,
    __nv_bfloat16* qkv, float* o, unsigned* omax, int B, int N, int C, int H,
    int device, void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || N < 1 || N > kMaxKeys || H < 1 || C % H != 0 ||
      (C / H) % 16 != 0 || C % 16 != 0 || C > kRowHeld || !aligned16(x) ||
      !aligned16(ln_g) || !aligned16(ln_b) || !aligned16(w_qkv) ||
      !aligned16(w_proj) || !aligned16(x8) || !aligned16(qkv) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, D = C / H;
  int sms = 0, stages = 0, smem = 0;
  err = sm_count(device, &sms);
  if (err == cudaSuccess)
    err = attn_launch_shape(N, D, device, &stages, &smem);
  if (err != cudaSuccess) return (int)err;
  if (stages == 0) return (int)cudaErrorInvalidValue;

  STEP(launch_quant_rows(x, 0, M, C, RowLn{ln_g, ln_b, ln_eps}, x8, xs, omax,
                         nullptr, 0, s));
  STEP((launch_gemm<kBInt8, false>(x8, w_qkv, QkvEpi{qkv, xs, s_qkv, b_qkv},
                                   nullptr, nullptr, 0, M, 3 * C, C, device,
                                   s)));
  attn_mma_kernel<<<dim3((N + kQueries - 1) / kQueries, H, B), kAttnThreads,
                    smem, s>>>(qkv, mask, o, omax, N, C, D, stages);
  STEP(cudaGetLastError());
  STEP(launch_hidden_quant(o, omax, M, C, x8, sms, s));
  const MlpFc2Epi<true> proj{out, omax, s_proj, b_proj, x};
  STEP((launch_gemm<kBInt8, false>(x8, w_proj, proj, nullptr, nullptr, 0, M,
                                   C, C, device, s)));
  return 0;
}

// x, out: (M, C) f32; w1 (Hd, C), w2 (C, Hd) int8 with per-row scales.
// ln_g == null: the post-norm form (no LN before fc1, LN(ln2_g, ln2_b)
// after the residual). Scratch, each 16-byte aligned: x8 (M*C) int8, xs
// (M) f32, h (M*Hd) f32, h8 (M*Hd) int8, hmax (M) u32, z (M*C) f32
// (post-norm only). Takes C and Hd multiples of 16 and, with the LN in
// front, C <= 1024: else cudaErrorInvalidValue, nothing launched.
extern "C" int mlp_int8_f32(
    const float* x, const float* ln_g, const float* ln_b, float ln_eps,
    const int8_t* w1, const float* s1, const float* b1, const int8_t* w2,
    const float* s2, const float* b2, const float* ln2_g, const float* ln2_b,
    float ln2_eps, float* out, int8_t* x8, float* xs, float* h, int8_t* h8,
    unsigned* hmax, float* z, int M, int C, int Hd, int device, void* stream,
    int* launched) {
  *launched = 0;
  const bool post = ln2_g != nullptr;
  if (M < 1 || C < 16 || C % 16 != 0 || Hd < 16 || Hd % 16 != 0 ||
      (post && (ln_g != nullptr || z == nullptr)) ||
      (ln_g != nullptr &&
       (C > kRowHeld || !aligned16(ln_g) || !aligned16(ln_b))) ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(x8) ||
      !aligned16(h) || !aligned16(h8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;

  STEP(launch_quant_rows(x, 0, M, C, RowLn{ln_g, ln_b, ln_eps}, x8, xs, hmax,
                         nullptr, 0, s));
  STEP((launch_gemm<kBInt8, false>(x8, w1, MlpFc1Epi{h, xs, s1, b1, hmax},
                                   nullptr, nullptr, 0, M, Hd, C, device,
                                   s)));
  STEP(launch_hidden_quant(h, hmax, M, Hd, h8, sms, s));
  const MlpFc2Epi<true> fc2{post ? z : out, hmax, s2, b2, x};
  STEP((launch_gemm<kBInt8, false>(h8, w2, fc2, nullptr, nullptr, 0, M, C, Hd,
                                   device, s)));
  if (post)
    STEP(int8k::launch_rows(z, ln2_g, ln2_b, ln2_eps, M, C, nullptr, nullptr,
                            out, s));
  return 0;
}
