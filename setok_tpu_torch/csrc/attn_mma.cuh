// The tensor-core attention of the int8 attention sublayers: rows 2
// (attn_sublayer_int8, fused_sublayer.cu), 4 (fused_bert_attention_int8)
// and 7 (fused_attention_int8) of PERF.md's kernel table.
//
//   o = softmax(q.k^T + mask bias) v, f32, and each row's |o| maximum over
//   the heads, posted by atomicMax on its bits (the scale of o's int8 row
//   quantisation, read by hidden_quant_kernel)
//
// One block of 4 warps per (image, head, 64 queries), each warp the owner of
// 16 query rows. Q rows (B*Nq, ldq) and K / V rows (B*Nk, ldkv), head h in
// columns h*D .. h*D + D - 1 of each, come by cp.async (16-byte copies) into
// swizzled shared tiles through a ring of up to 4 stages. The mask, where
// there is one, is a byte per (b, i, j) at b*m_sb + i*m_sr + j, nonzero =
// attend: (B, Nq, Nk) with m_sr = Nk (rows 2 and 7), or a (B, Nk) key mask
// with m_sr = 0 (row 4); it enters as the JAX kernels' -1e30 * (1 - m) bias.
//
//   * Scores: S = Q.K^T on the FP64 tensor cores (mma.sync m16n8k4 f64;
//     m8n8k4 runs slower on sm_90), rounded once to f32. Beside bf16 q, k
//     (rows 2 and 4) every product and every sum of up to 768 of them is
//     exact in f64, so the score is the exact one; beside f32 q, k (row 7)
//     every product is exact and the sums are f64 sums, so the rounded score
//     is the float64 product's (the plain versions take exact_scores=True).
//     A float32 sum in any other order than the plain version's flips bf16
//     roundings of p or int8 steps of o behind them (PERF.md §6).
//   * Softmax: every score of the block's rows stays in shared memory (64 x
//     Nk f32: 64 KB at Nk = 256), so the softmax is the exact full-row one of
//     the JAX kernels: the row max kept in registers as the scores are made
//     (each thread's two rows, reduced over the row's 4 lanes), p = exp(s -
//     m) and l in f32 in the MMA fragment layout, p written in place over
//     the scores once the row's max is known: in bf16 beside bf16 v (as the
//     JAX kernels cast it), in f32 beside f32 v. o = PV * (1/max(l, 1e-30))
//     after PV, 0 on a fully masked row.
//   * PV: beside bf16 v on mma.sync m16n8k16 bf16 (ldmatrix p, ldmatrix.trans
//     V), each 16-key slice from zero and added in f32; beside f32 v on the
//     FP64 tensor cores again (exact products, f64 sums rounded once).
//
// The f32 form walks D in slices of 32 (a whole f32 Q tile at D = 384 is 96
// KB): a unit of the ring is a Q slice and a K slice of one key tile, the
// f64 accumulator (16 rows x 64 keys, 64 registers a lane) kept across a
// key tile's slices. Its V tiles are 64 keys x 64 columns; a lane's 8
// n-tiles of an m16n8k4 product take columns 8g + n of the 64 (g = lane /
// 4), so that its B values are 8 adjacent floats (two 16-byte loads) and
// its outputs two runs of 8. Swizzles keep every 16-byte load of a quarter
// warp in its own bank group.
//
// Everything here has internal linkage: each library that includes it gets
// its own kernels and launch helpers (a kernel or static shared through a
// header is one object across the libraries, GNU unique symbols).

#pragma once

#include <type_traits>

#include "mma_bf16.cuh"
#include "wgmma_s8.cuh"

namespace {
namespace attn {

using namespace mma16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;   // 4 warps of 16 query rows
constexpr int kQueries = 64;    // query rows a block
constexpr int kKeys = 64;       // keys a K or V tile
constexpr int kVCols = 64;      // head columns a PV pass
constexpr int kMaxKeys = 768;
constexpr int kMaxStages = 4;
constexpr int kSubTile = kKeys * 2 * kVCols;   // bf16 V tile, 64 x 64
constexpr int kDSlice = 32;                    // f32: D values a Q/K slice
constexpr int kSlice = kKeys * kDSlice * 4;    // f32: a Q or K slice, 8 KB
constexpr int kVTile32 = kKeys * kVCols * 4;   // f32: a V tile, 16 KB

// one call's operands; rows and strides in elements of the operand type (the
// kernel takes them as __restrict__ parameters)
struct Args {
  const void* q;
  const void* k;
  const void* v;
  int ldq, ldkv;
  const uint8_t* mask;
  long long m_sb;
  int m_sr;
  float* o;
  unsigned* omax;
  int ldo;
  int Nq, Nk, D, stages;
};

// the attention's shared memory (byte offsets): bf16, the block's Q tile
// then the ring; f32, the ring alone (Q comes a slice a unit). Then the
// scores, 64 rows of sp floats, p in place.
struct Smem {
  int row_bytes;   // bf16: a Q or K tile row, D rounded up to 64 values
  int stage;       // a ring stage
  int sp;          // floats a score row: the keys rounded up to 64, + 4
  int ring, s, total;
};

template <bool F32>
__host__ __device__ inline Smem smem_of(int Nk, int D, int stages) {
  Smem a;
  a.sp = (Nk + kKeys - 1) / kKeys * kKeys + 4;
  if (F32) {
    a.row_bytes = 0;
    a.stage = 2 * kSlice;   // == kVTile32
    a.ring = 0;
  } else {
    a.row_bytes = (D + 63) / 64 * 128;
    a.stage = kKeys * a.row_bytes;
    a.ring = kQueries * a.row_bytes;
  }
  a.s = a.ring + stages * a.stage;
  a.total = a.s + kQueries * a.sp * 4;
  return a;
}

// bf16 value i of the 8 packed in v, exactly as a double
__device__ __forceinline__ double bf16_at(const uint4& v, int i) {
  const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return (double)__uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ float f32_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// f32 Q / K slice, 128-byte rows: rows 2p and 2p + 1 (read together by a
// quarter warp) in opposite halves of the bank groups
__device__ __forceinline__ uint32_t swz_slice(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (((r & 1) << 2) | ((r >> 1) & 3))) << 4));
}

// f32 V tile, 256-byte rows: the 4 key rows of a k step, chunks 2g and 2g +
// 1 of a quarter warp's two g, in 8 different bank groups
__device__ __forceinline__ uint32_t swz_v(int r, int c) {
  return (uint32_t)(r * 256 + ((c ^ ((r & 1) | ((r & 2) << 1))) << 4));
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

template <bool F32, typename T = std::conditional_t<F32, float, __nv_bfloat16>>
__global__ void __launch_bounds__(kThreads, 2)
attn_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ o, unsigned* __restrict__ omax, int ldq,
                int ldkv, long long m_sb, int m_sr, int ldo, int Nq, int Nk,
                int D, int stages) {
  extern __shared__ __align__(128) unsigned char attn_buf[];
  const Smem L = smem_of<F32>(Nk, D, stages);
  const uint32_t base = smem_addr(attn_buf);
  float* S = reinterpret_cast<float*>(attn_buf + L.s);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueries;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;   // the warp's first row of the block's 64
  const T* qrows = q + (size_t)b * Nq * ldq + h * D;
  const T* krows = k + (size_t)b * Nk * ldkv + h * D;
  const T* vrows = v + (size_t)b * Nk * ldkv + h * D;
  const int nt = (Nk + kKeys - 1) / kKeys;        // key tiles
  const int passes = (D + kVCols - 1) / kVCols;   // PV column passes
  // score units of a key tile: f32 its D slices, bf16 the whole tile
  const int ds = F32 ? (D + kDSlice - 1) / kDSlice : 1;
  const int sunits = nt * ds;
  // a V unit: the pass's columns of `per` key tiles, as many as a stage holds
  const int per = F32 ? 1 : L.stage / kSubTile;
  const int vunits = (nt + per - 1) / per;
  const int units = sunits + passes * vunits;   // score units, then V units

  // bf16: rows [r0, r0 + 64) of src (n rows of ld), `width` values from
  // each → the swizzled tile at dst, rows past n zero-filled; 8 lanes a
  // row, 16 bytes each
  auto load_bf16 = [&](uint32_t dst, const __nv_bfloat16* src, int ld, int n,
                       int r0, int width, int row_bytes) {
    for (int r = threadIdx.x >> 3; r < kKeys; r += kThreads / 8) {
      const bool in = r0 + r < n;
      const __nv_bfloat16* p = src + (size_t)(in ? r0 + r : 0) * ld;
      for (int c = threadIdx.x & 7; c < width / 8; c += 8)
        cp_async16(dst + swz(r, c, row_bytes), p + c * 8, in ? 16 : 0);
    }
  };
  // f32: a Q or K slice (width 16 or 32 values, 128-byte rows)
  auto load_slice = [&](uint32_t dst, const float* src, int ld, int n,
                        int r0, int width) {
    const int c = threadIdx.x & 7;
    if (c >= width / 4) return;
    for (int r = threadIdx.x >> 3; r < kKeys; r += kThreads / 8) {
      const bool in = r0 + r < n;
      cp_async16(dst + swz_slice(r, c),
                 src + (size_t)(in ? r0 + r : 0) * ld + c * 4, in ? 16 : 0);
    }
  };
  // f32: a V tile, 64 keys x 64 columns (256-byte rows), the columns past
  // width zero-filled
  auto load_v32 = [&](uint32_t dst, const float* src, int ld, int n, int r0,
                      int width) {
    const int c = threadIdx.x & 15;
    const bool col_in = c < width / 4;
    for (int r = threadIdx.x >> 4; r < kKeys; r += kThreads / 16) {
      const bool in = r0 + r < n && col_in;
      cp_async16(dst + swz_v(r, c),
                 src + (size_t)(in ? r0 + r : 0) * ld + (col_in ? c * 4 : 0),
                 in ? 16 : 0);
    }
  };
  auto stage_of = [&](int u) {
    return base + L.ring + (u % stages) * L.stage;
  };
  // unit u: a score unit (f32: key tile u / ds, D slice u % ds; bf16: key
  // tile u), or V unit w of pass p (its key tiles one after another in the
  // stage)
  auto issue = [&](int u) {
    if (u < sunits) {
      if constexpr (F32) {
        const int d0 = (u % ds) * kDSlice, w = min(kDSlice, D - d0);
        load_slice(stage_of(u), qrows + d0, ldq, Nq, q0, w);
        load_slice(stage_of(u) + kSlice, krows + d0, ldkv, Nk,
                   (u / ds) * kKeys, w);
      } else {
        load_bf16(stage_of(u), krows, ldkv, Nk, u * kKeys, D, L.row_bytes);
      }
    } else {
      const int p = (u - sunits) / vunits, w = (u - sunits) % vunits;
      const int c0 = p * kVCols, width = min(kVCols, D - c0);
      if constexpr (F32) {
        load_v32(stage_of(u), vrows + c0, ldkv, Nk, w * kKeys, width);
      } else {
        for (int i = 0; i < per && w * per + i < nt; ++i)
          load_bf16(stage_of(u) + i * kSubTile, vrows + c0, ldkv, Nk,
                    (w * per + i) * kKeys, width, 2 * kVCols);
      }
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

  // the prologue commits stages - 1 groups (1 at stages = 1), empty ones
  // past the last unit: arrive(u) counts on unit u's group having exactly
  // stages - 1 newer ones once it has committed its own, also where a call
  // has fewer units than that (64 keys of a 64-wide head: 2 units)
  if constexpr (!F32) load_bf16(base, qrows, ldq, Nq, q0, D, L.row_bytes);
  for (int u = 0; u < (stages > 1 ? stages - 1 : 1); ++u) {
    if (u < units) issue(u);
    cp_async_commit();
  }

  // the thread's two rows (g, g + 8 of the warp's 16) and their mask rows
  // (a row past Nq reads row Nq - 1's: its output is not written)
  const uint8_t* mr[2] = {nullptr, nullptr};
  if (mask != nullptr)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      mr[e2] = mask + b * m_sb +
               (size_t)min(q0 + wrow + g + 8 * e2, Nq - 1) * m_sr;

  // 1. S = Q.K^T of the warp's rows, key tile by key tile: in f64 on the
  //    tensor cores, rounded once to f32; the mask bias added, and the
  //    running row max over the thread's scores; into S
  float rmax[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < nt; ++t) {
    double acc[8][4] = {};   // rows g, g + 8 of 8 n8 key tiles
    if constexpr (F32) {
      for (int j = 0; j < ds; ++j) {
        const int u = t * ds + j;
        const unsigned char* qs = attn_buf + (arrive(u) - base);
        const unsigned char* ks = qs + kSlice;
        const int chunks = min(kDSlice, D - j * kDSlice) / 4;
        // lane t4 takes 16-byte chunk c0 + t4 (4 values of D) of its A rows
        // and B keys, k step i its value i
        for (int c0 = 0; c0 < chunks; c0 += 4) {
          const int c = c0 + t4;
          float4 qa[2], kb[8];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            qa[mt] = *reinterpret_cast<const float4*>(
                qs + swz_slice(wrow + 8 * mt + g, c));
#pragma unroll
          for (int n = 0; n < 8; ++n)
            kb[n] = *reinterpret_cast<const float4*>(
                ks + swz_slice(n * 8 + g, c));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const double a0 = f32_at(qa[0], i), a1 = f32_at(qa[1], i);
#pragma unroll
            for (int n = 0; n < 8; ++n)
              dmma(acc[n], a0, a1, (double)f32_at(kb[n], i));
          }
        }
        release(u);
      }
    } else {
      const uint32_t kt = arrive(t);
      const unsigned char* ks = attn_buf + (kt - base);
      for (int c0 = 0; c0 < D / 8; c0 += 4) {
        // lane t4 takes 16-byte chunk c0 + t4 (8 values of D) of its A rows
        // and B keys, k step i its value i: every d once, in either operand
        const int c = c0 + t4;
        const bool in = c < D / 8;
        uint4 qa[2], kb[8];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          qa[mt] = in ? *reinterpret_cast<const uint4*>(
                            attn_buf +
                            swz(wrow + 8 * mt + g, c, L.row_bytes))
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
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = t * kKeys + n * 8 + 2 * t4;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float sc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[e] = (float)acc[n][2 * e2 + e];
          if (col + e >= Nk) {
            sc[e] = -INFINITY;   // a padding key: no part of the row
          } else if (mr[e2] != nullptr) {
            const float mf = mr[e2][col + e] ? 1.f : 0.f;
            sc[e] = __fadd_rn(sc[e], __fmul_rn(kNegInf, __fsub_rn(1.f, mf)));
          }
          rmax[e2] = fmaxf(rmax[e2], sc[e]);
        }
        *reinterpret_cast<float2*>(S + (wrow + g + 8 * e2) * L.sp + col) =
            make_float2(sc[0], sc[1]);
      }
    }
    if constexpr (!F32) release(t);
  }

  // 2. the softmax in the same layout: the row max over the 4 lanes of a
  //    row, p = exp(s - m) and l in f32, p written in place over the row's
  //    scores a key tile at a time (bf16: tile t's p lies over the scores
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
      float* srow = S + (wrow + g + 8 * e2) * L.sp;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = t * kKeys + n * 8 + 2 * t4;
        const float p0 = expf(__fsub_rn(sv[e2][n].x, m[e2]));
        const float p1 = expf(__fsub_rn(sv[e2][n].y, m[e2]));
        l[e2] += p0;
        l[e2] += p1;
        if constexpr (F32)
          *reinterpret_cast<float2*>(srow + col) = make_float2(p0, p1);
        else
          reinterpret_cast<__nv_bfloat162*>(srow)[col / 2] =
              __floats2bfloat162_rn(p0, p1);
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
  float omx[2] = {0.f, 0.f};
  for (int p = 0; p < passes; ++p) {
    const int c0 = p * kVCols, width = min(kVCols, D - c0);
    if constexpr (F32) {
      double acc[8][4] = {};   // n-tile n, column 2 t4 + e: head column
                               // c0 + 8 (2 t4 + e) + n
      const float* p_rows = S + (wrow + g) * L.sp + t4;
      for (int t = 0; t < nt; ++t) {
        const int u = sunits + p * vunits + t;
        const unsigned char* vs = attn_buf + (arrive(u) - base);
#pragma unroll 4
        for (int kq = 0; kq < kKeys / 4; ++kq) {
          const int key = t * kKeys + 4 * kq;
          const double a0 = p_rows[key], a1 = p_rows[8 * L.sp + key];
          const float4 v0 = *reinterpret_cast<const float4*>(
              vs + swz_v(4 * kq + t4, 2 * g));
          const float4 v1 = *reinterpret_cast<const float4*>(
              vs + swz_v(4 * kq + t4, 2 * g + 1));
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            dmma(acc[n], a0, a1, (double)f32_at(v0, n));
            dmma(acc[n + 4], a0, a1, (double)f32_at(v1, n));
          }
        }
        release(u);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int i = q0 + wrow + g + 8 * e2;
        if (i >= Nq) continue;
        float* orow = o + ((size_t)b * Nq + i) * ldo + h * D + c0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * (2 * t4 + e);
          if (col >= width) continue;
          float ov[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            ov[n] = __fmul_rn((float)acc[n][2 * e2 + e], lr[e2]);
            omx[e2] = fmaxf(omx[e2], fabsf(ov[n]));
          }
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(ov[0], ov[1], ov[2], ov[3]);
          *reinterpret_cast<float4*>(orow + col + 4) =
              make_float4(ov[4], ov[5], ov[6], ov[7]);
        }
      }
    } else {
      const uint32_t p_rows =
          base + L.s + (wrow + pairs_row(lane)) * L.sp * 4;
      float acc[8][4];
      for (int t = 0; t < nt; ++t) {
        const int u = sunits + p * vunits + t / per;
        const uint32_t vt = stage_of(u) + (t % per) * kSubTile;
        if (t % per == 0) arrive(u);
#pragma unroll
        for (int kq = 0; kq < kKeys / 16; ++kq) {
          uint32_t pf[4];
          ldsm_x4(pf, p_rows + (t * 8 + 2 * kq + pairs_chunk(lane)) * 16);
          float pv[8][4] = {};
#pragma unroll
          for (int c = 0; c < kVCols / 16; ++c) {
            if (16 * c >= width) continue;
            uint32_t vb[4];
            ldsm_x4_t(vb, vt + swz(kq * 16 + pairs_row(lane),
                                   2 * c + pairs_chunk(lane), 2 * kVCols));
            mma_bf16(pv[2 * c], pf, vb[0], vb[1]);
            mma_bf16(pv[2 * c + 1], pf, vb[2], vb[3]);
          }
          const bool first = t == 0 && kq == 0;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[n][e] = first ? pv[n][e] : __fadd_rn(acc[n][e], pv[n][e]);
        }
        if (t % per == per - 1 || t == nt - 1) release(u);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int i = q0 + wrow + g + 8 * e2;
        if (i >= Nq) continue;
        float* orow = o + ((size_t)b * Nq + i) * ldo + h * D + c0 + 2 * t4;
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
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    float mx = omx[e2];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const int i = q0 + wrow + g + 8 * e2;
    if (t4 == 0 && i < Nq)
      atomicMax(omax + (size_t)b * Nq + i, __float_as_uint(mx));
  }
}

// the ring's depth (as many stages as fit, at most kMaxStages, so that two
// blocks share an SM where they can, with at least 2 stages) and the shared
// memory of a call with Nk keys of head width D; stages 0 where the shape
// does not fit. Raises the kernel's shared-memory limit once.
template <bool F32>
cudaError_t launch_shape(int Nk, int D, int device, int* stages, int* smem) {
  int limit = 0, per_sm = 0;   // the card's opt-in shared memory a block, SM
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = wg::raise_smem_limit(
        reinterpret_cast<const void*>(attn_mma_kernel<F32>), device, limit);
  if (err != cudaSuccess) return err;
  // two blocks an SM (1 KB of each reserved), else one
  const int pair = per_sm / 2 - 1024;
  *stages = 0;
  const int caps[2] = {pair, limit};
  for (int cap : caps)
    for (int st = kMaxStages; st >= 1 && *stages == 0; --st)
      if (smem_of<F32>(Nk, D, st).total <= cap &&
          (st >= 2 || cap == limit)) {
        *stages = st;
        *smem = smem_of<F32>(Nk, D, st).total;
      }
  return cudaSuccess;
}

// o and omax of B images of H heads; a.stages and smem from launch_shape
template <bool F32>
cudaError_t launch(const Args& a, int B, int H, int smem, cudaStream_t s) {
  using T = std::conditional_t<F32, float, __nv_bfloat16>;
  attn_mma_kernel<F32><<<dim3((a.Nq + kQueries - 1) / kQueries, H, B),
                         kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, a.o, a.omax, a.ldq, a.ldkv, a.m_sb,
      a.m_sr, a.ldo, a.Nq, a.Nk, a.D, a.stages);
  return cudaGetLastError();
}

// the C entries' checks of a call: at least one row and key, at most
// kMaxKeys keys, head width D = C / H a multiple of 16
inline bool takes(int B, int Nq, int Nk, int C, int H) {
  return B >= 1 && Nq >= 1 && Nk >= 1 && Nk <= kMaxKeys && H >= 1 &&
         C % H == 0 && (C / H) % 16 == 0;
}

}  // namespace attn
}  // namespace
