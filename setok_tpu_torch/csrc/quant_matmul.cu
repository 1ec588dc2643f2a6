// w8a8 and w4a8 matrix products: the serving trunk's linears and the int8
// SeTok's Dense(quant8).
//
// Replaces setok_tpu/kernels/quant_matmul.py:
//   quant_matmul    x (M, K) float . W8 (K, N) int8, per-channel scales (:54)
//   quant4_matmul   the same over half-packed int4 nibbles, per-channel or
//                   per-group scales                                   (:226)
// The TPU kernel is one Pallas program per (256-row, N-block) tile that
// reads x in its own type, quantises its rows, unpacks the nibbles in VMEM,
// runs the MXU and writes out_dtype from its epilogue. Here each call is two
// launches, which read x and write the output in their own types too
// (float32, bfloat16 or float16 each):
//
//   quant_rows_kernel  x -> x8, xs; s = max(absmax, 1e-8) / 127,
//                      q = clip(rint(x / s), +-127): a block per row at
//                      M <= 8 (a decode step's 4 rows of up to 11008), a
//                      warp per row above; 8 values a load
//   M <= 8:         gemv_kernel  one warp per output channel streams its
//                   weight row (16 bytes a lane), dp4a over the int8 rows
//   M >  8, int8:   wgmma_gemm_kernel  Hopper's warpgroup MMA (below)
//   M >  8, int4:   gemm_kernel  128x128 tiles, mma.sync m16n8k32 s8 from a
//                   two-stage ring; the int4 bytes are loaded to registers
//                   and unpacked into the shared B tile
//
// Weights are in the torch (out, in) layout: W8 (N, K), packed (N, K/2) with
// logical input row i in the low nibble of byte i and row i + K/2 in its high
// nibble. The int products are exact (int32); the epilogue is the JAX
// kernel's, (float(acc) * xs) * ws rounded once to the output type, or for
// groups one float32 accumulator acc_f = acc_f + float(dot_g) * s[g] over
// the low plane's groups, then the high plane's, and acc_f * xs.
//
// What bounds them (H100 SXM data sheet). Decode, M = 4: the weight bytes,
// 4096 x 11008 int8 = 45 MB in 13.5 us (int4 half of it); the products are
// 0.36 G int8 operations, 0.2 us. The int8 SeTok's Dense at 384 px (M =
// 36,864, 768 -> 2304, bf16 in and out): 130 G int8 operations, 66 us at
// 1979 TOP/s, against 0.23 GB of x and output, 68 us at 3.35 TB/s.
//
// The int8 GEMM (M > 8) is persistent and warp-specialised: 384 threads, a
// producer warpgroup whose one thread keeps TMA loads of 128-row x8 tiles
// and 256-row W tiles, 128 bytes of K each, in flight into a four-stage
// ring (128-byte swizzle, mbarriers; TMA zero-fills past M, N and the
// ragged last k-slice), and two consumer warpgroups of 64 rows x 256
// columns of s32 accumulators each (128 registers a thread) that run
// wgmma.mma_async m64n256k32 s8 with both operands K-major in shared memory
// (x8 (M, K) row-major and W (N, K), as int8 wgmma requires). A consumer
// releases a stage once the next stage's products are issued, and its
// epilogue writes (float(acc) * xs) * ws in that order (__fmul_rn, no
// contraction) while the producer already fills the ring for the block's
// next tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // libcuda at run time (dlsym), nothing is linked
#include <cuda_fp16.h>
#include <dlfcn.h>

#include "int8_sublayer.cuh"

using namespace int8k;

namespace {

enum Mode { kW8 = 0, kW4 = 1, kW4G = 2 };

constexpr int kWarps = kThreads / 32;

// four sign-extended int8 values from the low / high nibbles of four bytes
__device__ __forceinline__ int lo_nibbles(unsigned w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int hi_nibbles(unsigned w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int dot16(uint4 a, uint4 b, int acc) {
  acc = __dp4a((int)a.x, (int)b.x, acc);
  acc = __dp4a((int)a.y, (int)b.y, acc);
  acc = __dp4a((int)a.z, (int)b.z, acc);
  return __dp4a((int)a.w, (int)b.w, acc);
}

// eight values of x as float32 (exact from bf16 and f16), 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// the epilogue's float32 value(s), rounded once to the output type
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ---------------------------------------------------------------------------
// Row quantisation: GROUP threads a row (kThreads: a block per row, for the
// few long rows of a decode step; 32: a warp per row). K % 16 == 0 and x
// 16-byte aligned, so every row starts on a 16-byte boundary. Each thread
// has kRowLoads 16-byte loads in flight: so400m's 5,832 rows of 4304 are
// less than one wave of warps, each a long chain of loads.

constexpr int kRowLoads = 4;

template <typename T, int GROUP>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const T* __restrict__ x, int M, int K,
                  int8_t* __restrict__ q8, float* __restrict__ scale) {
  constexpr int kStep = GROUP * 8;   // values a sweep of the group
  __shared__ float red[kWarps];
  const int row = blockIdx.x * (kThreads / GROUP) + threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const bool in = row < M;
  const T* xr = x + (size_t)(in ? row : 0) * K;
  float m = 0.f;
  if (in)
    for (int c0 = lane * 8; c0 < K; c0 += kRowLoads * kStep) {
      float v[kRowLoads][8];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (c0 + u * kStep < K) load8(xr + c0 + u * kStep, v[u]);
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (c0 + u * kStep < K)
#pragma unroll
          for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[u][i]));
    }
  m = warp_max(m);
  if (GROUP > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    m = red[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  }
  if (!in) return;
  const float s = fmaxf(m, 1e-8f) / 127.0f;
  int8_t* qr = q8 + (size_t)row * K;
  for (int c0 = lane * 8; c0 < K; c0 += kRowLoads * kStep) {
    float v[kRowLoads][8];
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u)
      if (c0 + u * kStep < K) load8(xr + c0 + u * kStep, v[u]);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      if (c0 + u * kStep >= K) continue;
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = (int)fminf(fmaxf(rintf(v[u][i] / s), -127.f), 127.f);
        w[i >> 2] |= (uint32_t)(q & 0xff) << (8 * (i & 3));
      }
      *reinterpret_cast<uint2*>(qr + c0 + u * kStep) = make_uint2(w[0], w[1]);
    }
  }
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// M <= MR rows: one warp per output channel. Groups (kW4G): each lane's
// 16-byte chunk lies in one group (G % 16 == 0); its exact int dots go to the
// warp's per-(row, group) sums in shared memory (integer atomics, so the
// order does not matter), and lane m then runs row m's float accumulation in
// the JAX kernel's group order.

template <int MODE, int MR, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
            const int8_t* __restrict__ W, const float* __restrict__ ws,
            int n_scales, OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ int gsum[];   // kW4G: kWarps x MR x n_scales
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  int acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0;

  if (MODE == kW8) {
    const int8_t* row = W + (size_t)n * K;
    for (int k = lane * 16; k < K; k += 512) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + k));
#pragma unroll
      for (int m = 0; m < MR; ++m)
        if (m < M)
          acc[m] = dot16(
              w, __ldg(reinterpret_cast<const uint4*>(x8 + (size_t)m * K + k)),
              acc[m]);
    }
  } else {
    const int kh = K / 2;
    const int8_t* row = W + (size_t)n * kh;
    int* sums = gsum + warp * MR * n_scales;
    const int n_half = n_scales / 2;
    const int G = MODE == kW4G ? kh / n_half : 0;
    if (MODE == kW4G) {
      for (int i = lane; i < MR * n_scales; i += 32) sums[i] = 0;
      __syncwarp();
    }
    for (int i = lane * 16; i < kh; i += 512) {
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(row + i));
      const uint4 lo = make_uint4(lo_nibbles(p.x), lo_nibbles(p.y),
                                  lo_nibbles(p.z), lo_nibbles(p.w));
      const uint4 hi = make_uint4(hi_nibbles(p.x), hi_nibbles(p.y),
                                  hi_nibbles(p.z), hi_nibbles(p.w));
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        if (m >= M) continue;
        const int8_t* xr = x8 + (size_t)m * K;
        const int dl =
            dot16(lo, __ldg(reinterpret_cast<const uint4*>(xr + i)), 0);
        const int dh =
            dot16(hi, __ldg(reinterpret_cast<const uint4*>(xr + kh + i)), 0);
        if (MODE == kW4G) {
          atomicAdd(&sums[m * n_scales + i / G], dl);
          atomicAdd(&sums[m * n_scales + n_half + i / G], dh);
        } else {
          acc[m] += dl + dh;
        }
      }
    }
    if (MODE == kW4G) {
      __syncwarp();
      if (lane < M) {
        float accf = 0.f;
        for (int g = 0; g < n_scales; ++g)
          accf = __fadd_rn(accf, __fmul_rn((float)sums[lane * n_scales + g],
                                           ws[(size_t)g * N + n]));
        store1(out + (size_t)lane * N + n, __fmul_rn(accf, xs[lane]));
      }
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    int v = acc[m];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && m < M)
      store1(out + (size_t)m * N + n,
             __fmul_rn(__fmul_rn((float)v, xs[m]), ws[n]));
  }
}

// ---------------------------------------------------------------------------
// M > 8, int4: the tiled product of int8_sublayer.cuh's gemm_s8_kernel, with
// the packed B tile loaded to registers and unpacked into shared memory. A
// k-tile of BK = 32 logical rows lies in one nibble plane (K/2 % BK == 0)
// and, grouped, in one group (G % BK == 0).

template <int MODE, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
            const int8_t* __restrict__ W, const float* __restrict__ ws,
            int n_scales, OutT* __restrict__ out, int M, int N, int K) {
  static_assert(MODE == kW4 || MODE == kW4G, "int4 only");
  __shared__ __align__(16) int8_t As[2][BM][BKP];
  __shared__ __align__(16) int8_t Bs[2][BN][BKP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int lr = tid >> 1, lc = (tid & 1) * 16;
  const int kh = K / 2;
  const int G = MODE == kW4G ? kh / (n_scales / 2) : 0;
  const int bn = n0 + lr;

  auto load_a = [&](int stage, int k0) {
    const int am = m0 + lr, kc = k0 + lc;
    const bool pa = am < M && kc < K;
    cp_async16(&As[stage][lr][lc], pa ? A + (size_t)am * K + kc : A, pa);
  };
  // the 16 packed bytes of the tile's row lr, columns lc.., of its plane
  auto load_b = [&](int k0) -> uint4 {
    const int kp = (k0 >= kh ? k0 - kh : k0) + lc;
    return bn < N ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)bn * kh
                                                         + kp))
                  : make_uint4(0, 0, 0, 0);
  };
  auto store_b = [&](int stage, int k0, uint4 p) {
    const bool high = k0 >= kh;
    auto un = [&](unsigned w) { return high ? hi_nibbles(w) : lo_nibbles(w); };
    *reinterpret_cast<uint4*>(&Bs[stage][lr][lc]) =
        make_uint4(un(p.x), un(p.y), un(p.z), un(p.w));
  };

  int acc[4][4][4];
  float accf[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        accf[i][j][e] = 0.f;
      }

  const int KT = K / BK;
  load_a(0, 0);
  store_b(0, 0, load_b(0));
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    uint4 next = make_uint4(0, 0, 0, 0);
    if (kt + 1 < KT) {
      load_a((kt + 1) & 1, (kt + 1) * BK);
      next = load_b((kt + 1) * BK);
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
    if (kt + 1 < KT) store_b((kt + 1) & 1, (kt + 1) * BK, next);
    // the end of a group: scale its exact dot into the float accumulator
    if (MODE == kW4G && ((kt + 1) * BK) % G == 0) {
      const int grp = kt * BK / G;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + t * 2 + e;
          const float sc = col < N ? ws[(size_t)grp * N + col] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int q = half * 2 + e;
              accf[mi][ni][q] = __fadd_rn(
                  accf[mi][ni][q], __fmul_rn((float)acc[mi][ni][q], sc));
              acc[mi][ni][q] = 0;
            }
        }
    }
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
          const int q = half * 2 + e;
          store1(out + (size_t)row * N + col,
                 MODE == kW4G
                     ? __fmul_rn(accf[mi][ni][q], as)
                     : __fmul_rn(__fmul_rn((float)acc[mi][ni][q], as),
                                 ws[col]));
        }
    }
}

// ---------------------------------------------------------------------------
// M > 8, int8: the wgmma GEMM of the header

constexpr int kQmBM = 128, kQmBN = 256, kQmBK = 128, kQmStages = 4;
constexpr int kQmThreads = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int kQmABytes = kQmBM * kQmBK, kQmBBytes = kQmBN * kQmBK;
constexpr int kQmStageBytes = kQmABytes + kQmBBytes;
// the ring, its full and empty barriers, and slack to align it to 1024
constexpr size_t kQmSmem = 1024 + (size_t)kQmStages * kQmStageBytes +
                           2 * kQmStages * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// the (box) tile of `map` at (inner c0, outer c1) → shared dst, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle, 8
// rows (1024 bytes) a core-matrix group; `addr` may step along K inside the
// 128 bytes (the tile itself is 1024-aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulators in place around the asynchronous products, so that
// no ordinary instruction reading or writing them moves across a fence or
// a wait
__device__ __forceinline__ void fence_regs(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[128] += A (64 x 32, shared, K-major) . B (256 x 32, shared, K-major)^T,
// s8 x s8 -> s32: one wgmma of the warpgroup
__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <typename OutT>
__global__ void __launch_bounds__(kQmThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char qm_smem[];
  const uint32_t ring = (smem_u32(qm_smem) + 1023u) & ~1023u;
  const uint32_t bars = ring + kQmStages * kQmStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kQmStages + s); };
  const int n_tiles = (N + kQmBN - 1) / kQmBN;
  const int n_work = (M + kQmBM - 1) / kQmBM * n_tiles;
  const int k_tiles = (K + kQmBK - 1) / kQmBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQmStages; ++s) {
      mbar_init(full(s), 1);   // the producer's arrival, with the TMA bytes
      mbar_init(empty(s), 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kQmBM, n0 = tile % n_tiles * kQmBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t a = ring + stage * kQmStageBytes;
          mbar_expect_tx(full(stage), kQmStageBytes);
          tma_load_2d(a, &map_x, kt * kQmBK, m0, full(stage));
          tma_load_2d(a + kQmABytes, &map_w, kt * kQmBK, n0, full(stage));
          if (++stage == kQmStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // a consumer warpgroup: rows wg * 64 .. +63 of the tile, all 256 columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7, wl = threadIdx.x & 127;
    const int g = (wl & 31) >> 2, t4 = wl & 3;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kQmBM, n0 = tile % n_tiles * kQmBN;
      int d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0;
      fence_regs(d);
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full(stage), phase);
        const uint32_t a = ring + stage * kQmStageBytes + wg * 64 * kQmBK;
        const uint32_t b = ring + stage * kQmStageBytes + kQmABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQmBK / 32; ++kk)
          wgmma_s8_m64n256k32(d, sw128_desc(a + kk * 32),
                              sw128_desc(b + kk * 32));
        wgmma_commit();
        // the previous stage's products are done: release its buffers
        wgmma_wait<1>();
        if (prev >= 0 && wl == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == kQmStages) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(d);
      if (prev >= 0 && wl == 0) mbar_arrive(empty(prev));

      // d[4j + 2h + e] is (row g + 8h, column 8j + 2 t4 + e) of the
      // warp's 16 rows
      const int r0 = m0 + wg * 64 + (wl >> 5) * 16 + g;
      const float as[2] = {r0 < M ? xs[r0] : 0.f,
                           r0 + 8 < M ? xs[r0 + 8] : 0.f};
      const bool pairs = (N & 1) == 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        const float w0 = ws[col], w1 = two ? ws[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= M) continue;
          const float v0 = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * h], as[h]),
                                     w0);
          const float v1 =
              __fmul_rn(__fmul_rn((float)d[4 * j + 2 * h + 1], as[h]), w1);
          OutT* p = out + (size_t)row * N + col;
          if (two && pairs) {
            store2(p, v0, v1);
          } else {
            store1(p, v0);
            if (two) store1(p + 1, v1);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// the TMA map of a (rows, K) int8 matrix in boxes of box_rows x 128 bytes,
// 128-byte swizzle, zeros past its edges
bool int8_tile_map(CUtensorMap* map, const void* base, int rows, int K,
                   int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kQmBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
cudaError_t launch_wgmma(const int8_t* x8, const float* xs, const int8_t* w,
                         const float* ws, OutT* out, int M, int N, int K,
                         int device, cudaStream_t s) {
  CUtensorMap map_x, map_w;
  if (!int8_tile_map(&map_x, x8, M, K, kQmBM) ||
      !int8_tile_map(&map_w, w, N, K, kQmBN))
    return cudaErrorInvalidValue;
  static unsigned ready = 0;  // devices whose shared-memory limit is raised
  if (device < 32 && !(ready >> device & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_gemm_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kQmSmem);
    if (err != cudaSuccess) return err;
    ready |= 1u << device;
  }
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int work = (M + kQmBM - 1) / kQmBM * ((N + kQmBN - 1) / kQmBN);
  const int blocks = work < sms ? work : sms;   // persistent: one per SM
  wgmma_gemm_kernel<OutT><<<blocks, kQmThreads, kQmSmem, s>>>(
      map_x, map_w, xs, ws, out, M, N, K);
  return cudaGetLastError();
}

template <int MODE, int MR, typename OutT>
cudaError_t launch_gemv(const int8_t* x8, const float* xs, const int8_t* W,
                        const float* ws, int n_scales, OutT* out, int M,
                        int N, int K, cudaStream_t s) {
  const size_t smem =
      MODE == kW4G ? sizeof(int) * (size_t)kWarps * MR * n_scales : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_kernel<MODE, MR, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gemv_kernel<MODE, MR, OutT>
      <<<(N + kWarps - 1) / kWarps, kThreads, smem, s>>>(
          x8, xs, W, ws, n_scales, out, M, N, K);
  return cudaGetLastError();
}

template <int MODE, typename OutT>
cudaError_t launch_product(const int8_t* x8, const float* xs, const int8_t* W,
                           const float* ws, int n_scales, OutT* out, int M,
                           int N, int K, int device, cudaStream_t s) {
  if (M <= 1)
    return launch_gemv<MODE, 1>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if (M <= 2)
    return launch_gemv<MODE, 2>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if (M <= 4)
    return launch_gemv<MODE, 4>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if (M <= 8)
    return launch_gemv<MODE, 8>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if constexpr (MODE == kW8) {
    return launch_wgmma(x8, xs, W, ws, out, M, N, K, device, s);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<MODE, OutT><<<grid, kThreads, 0, s>>>(x8, xs, W, ws,
                                                      n_scales, out, M, N, K);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_quant_rows(const void* x, int M, int K, int8_t* x8,
                              float* xs, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (M <= 8)
    quant_rows_kernel<T, kThreads><<<M, kThreads, 0, s>>>(xt, M, K, x8, xs);
  else
    quant_rows_kernel<T, 32>
        <<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(xt, M, K, x8, xs);
  return cudaGetLastError();
}

template <typename OutT>
int run(const void* x, int x_type, const int8_t* w, const float* ws,
        int n_scales, int bits, void* out, int8_t* x8, float* xs, int M,
        int N, int K, int device, cudaStream_t s, int* launched) {
  STEP(x_type == 0   ? launch_quant_rows<float>(x, M, K, x8, xs, s)
       : x_type == 1 ? launch_quant_rows<__nv_bfloat16>(x, M, K, x8, xs, s)
                     : launch_quant_rows<__half>(x, M, K, x8, xs, s));
  OutT* o = static_cast<OutT*>(out);
  if (bits == 8)
    STEP(launch_product<kW8>(x8, xs, w, ws, 1, o, M, N, K, device, s));
  else if (n_scales > 1)
    STEP(launch_product<kW4G>(x8, xs, w, ws, n_scales, o, M, N, K, device,
                              s));
  else
    STEP(launch_product<kW4>(x8, xs, w, ws, 1, o, M, N, K, device, s));
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x: (M, K) of x_type; w: (N, K) int8 (bits 8) or (N, K/2) packed (bits 4);
// ws: (n_scales, N) f32, n_scales 1 or K/G; out: (M, N) of out_type. Types:
// 0 float32, 1 bfloat16, 2 float16. scratch: x8 (M*K int8) at its start,
// then xs (M float32) at the next multiple of 16 bytes. x, w and scratch
// 16-byte aligned. Each launch counts one in *launched; returns the CUDA
// error of the first launch that failed, else 0.
extern "C" int quant_matmul(const void* x, int x_type, const int8_t* w,
                            const float* ws, int n_scales, int bits,
                            void* out, int out_type, void* scratch, int M,
                            int N, int K, int device, void* stream,
                            int* launched) {
  *launched = 0;
  const bool grouped = n_scales > 1;
  if (M < 1 || N < 1 || K < 32 || K % 16 != 0 || (bits != 8 && bits != 4) ||
      x_type < 0 || x_type > 2 || out_type < 0 || out_type > 2 ||
      !aligned16(x) || !aligned16(w) || !aligned16(scratch) ||
      (bits == 8 && grouped) ||
      (bits == 4 && (K % (2 * BK) != 0 ||
                     (grouped && (n_scales % 2 != 0 ||
                                  (K / 2) % (n_scales / 2) != 0 ||
                                  ((K / 2) / (n_scales / 2)) % BK != 0)))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* x8 = static_cast<int8_t*>(scratch);
  float* xs = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                       ((size_t)M * K + 15) / 16 * 16);
  if (out_type == 0)
    return run<float>(x, x_type, w, ws, n_scales, bits, out, x8, xs, M, N, K,
                      device, s, launched);
  if (out_type == 1)
    return run<__nv_bfloat16>(x, x_type, w, ws, n_scales, bits, out, x8, xs,
                              M, N, K, device, s, launched);
  return run<__half>(x, x_type, w, ws, n_scales, bits, out, x8, xs, M, N, K,
                     device, s, launched);
}
