// w8a8 and w4a8 matrix products of the serving trunk's linears.
//
// Replaces setok_tpu/kernels/quant_matmul.py:
//   quant_matmul    x (M, K) f32 . W8 (K, N) int8, per-channel scales (:54)
//   quant4_matmul   the same over half-packed int4 nibbles, per-channel or
//                   per-group scales                                   (:226)
// The TPU kernel is one Pallas program per (256-row, N-block) tile that
// quantises its rows, unpacks the nibbles in VMEM and runs the MXU. Here each
// call is two launches:
//
//   quant_rows_kernel  one block per row: x -> x8, xs,
//                      s = max(absmax, 1e-8) / 127, q = clip(rint(x / s), +-127)
//   M <= 8:  gemv_kernel   one warp per output channel streams its weight row
//                          (16 bytes a lane), dp4a over the <= 8 int8 rows
//   M >  8:  gemm_kernel   128x128 tiles, mma.sync m16n8k32 s8 from a
//                          two-stage ring; int4 bytes are loaded to registers
//                          and unpacked into the shared B tile
//
// Weights are in the torch (out, in) layout: W8 (N, K), packed (N, K/2) with
// logical input row i in the low nibble of byte i and row i + K/2 in its high
// nibble. The int products are exact (int32); the epilogue is the JAX
// kernel's: (float(acc) * xs) * ws, or for groups one float32 accumulator
// acc_f = acc_f + float(dot_g) * s[g] over the low plane's groups, then the
// high plane's, and acc_f * xs.
//
// What bounds them (H100 SXM data sheet). Decode, M = 4: the weight bytes,
// 4096 x 11008 int8 = 45 MB in 13.5 us (int4 half of it); the products are
// 0.36 G int8 operations, 0.2 us. Prefill, M = 512: 46 G int8 operations,
// 23 us at 1979 TOP/s, against 45 MB. This first version streams the weight
// with plain 16-byte loads and multiplies with mma.sync (not wgmma); PERF.md
// carries its times beside those bounds.

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

// ---------------------------------------------------------------------------
// Row quantisation, one block per row (a decode step has 4 rows of up to
// 11008: a warp per row left most of the card idle).

__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const float* __restrict__ x, int K, int8_t* __restrict__ q8,
                  float* __restrict__ scale) {
  __shared__ float red[kWarps];
  const float* xr = x + (size_t)blockIdx.x * K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float m = 0.f;
  for (int c = tid; c < K; c += kThreads) m = fmaxf(m, fabsf(xr[c]));
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  const float s = fmaxf(m, 1e-8f) / 127.0f;
  int8_t* qr = q8 + (size_t)blockIdx.x * K;
  for (int c = tid; c < K; c += kThreads)
    qr[c] = (int8_t)fminf(fmaxf(rintf(xr[c] / s), -127.f), 127.f);
  if (tid == 0) scale[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// M <= MR rows: one warp per output channel. Groups (kW4G): each lane's
// 16-byte chunk lies in one group (G % 16 == 0); its exact int dots go to the
// warp's per-(row, group) sums in shared memory (integer atomics, so the
// order does not matter), and lane m then runs row m's float accumulation in
// the JAX kernel's group order.

template <int MODE, int MR>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
            const int8_t* __restrict__ W, const float* __restrict__ ws,
            int n_scales, float* __restrict__ out, int M, int N, int K) {
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
        out[(size_t)lane * N + n] = __fmul_rn(accf, xs[lane]);
      }
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    int v = acc[m];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && m < M)
      out[(size_t)m * N + n] =
          __fmul_rn(__fmul_rn((float)v, xs[m]), ws[n]);
  }
}

// ---------------------------------------------------------------------------
// M > 8: the tiled product of int8_sublayer.cuh's gemm_s8_kernel, with the
// B tile either copied (kW8) or loaded to registers and unpacked (kW4,
// kW4G). A k-tile of BK = 32 logical rows lies in one nibble plane
// (K/2 % BK == 0) and, grouped, in one group (G % BK == 0).

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
            const int8_t* __restrict__ W, const float* __restrict__ ws,
            int n_scales, float* __restrict__ out, int M, int N, int K) {
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
  // kW8: the B tile by cp.async; kW4: the 16 packed bytes of the tile's
  // row lr, columns lc.., of the tile's plane
  auto load_b = [&](int stage, int k0) -> uint4 {
    if (MODE == kW8) {
      const int kc = k0 + lc;
      const bool pb = bn < N && kc < K;
      cp_async16(&Bs[stage][lr][lc], pb ? W + (size_t)bn * K + kc : W, pb);
      return make_uint4(0, 0, 0, 0);
    }
    const int kp = (k0 >= kh ? k0 - kh : k0) + lc;
    return bn < N ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)bn * kh
                                                         + kp))
                  : make_uint4(0, 0, 0, 0);
  };
  auto store_b = [&](int stage, int k0, uint4 p) {
    if (MODE == kW8) return;
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

  const int KT = (K + BK - 1) / BK;   // kW8: the last tile may be half
  load_a(0, 0);
  store_b(0, 0, load_b(0, 0));
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    uint4 next = make_uint4(0, 0, 0, 0);
    if (kt + 1 < KT) {
      load_a((kt + 1) & 1, (kt + 1) * BK);
      next = load_b((kt + 1) & 1, (kt + 1) * BK);
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
          out[(size_t)row * N + col] =
              MODE == kW4G
                  ? __fmul_rn(accf[mi][ni][q], as)
                  : __fmul_rn(__fmul_rn((float)acc[mi][ni][q], as), ws[col]);
        }
    }
}

template <int MODE, int MR>
cudaError_t launch_gemv(const int8_t* x8, const float* xs, const int8_t* W,
                        const float* ws, int n_scales, float* out, int M,
                        int N, int K, cudaStream_t s) {
  const size_t smem =
      MODE == kW4G ? sizeof(int) * (size_t)kWarps * MR * n_scales : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_kernel<MODE, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gemv_kernel<MODE, MR><<<(N + kWarps - 1) / kWarps, kThreads, smem, s>>>(
      x8, xs, W, ws, n_scales, out, M, N, K);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_product(const int8_t* x8, const float* xs, const int8_t* W,
                           const float* ws, int n_scales, float* out, int M,
                           int N, int K, cudaStream_t s) {
  if (M <= 1) return launch_gemv<MODE, 1>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if (M <= 2) return launch_gemv<MODE, 2>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if (M <= 4) return launch_gemv<MODE, 4>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  if (M <= 8) return launch_gemv<MODE, 8>(x8, xs, W, ws, n_scales, out, M, N, K, s);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<MODE><<<grid, kThreads, 0, s>>>(x8, xs, W, ws, n_scales, out, M,
                                              N, K);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) f32; w: (N, K) int8 (bits 8) or (N, K/2) packed (bits 4);
// ws: (n_scales, N) f32, n_scales 1 or K/G. out: (M, N) f32. Scratch: x8
// (M*K) int8, xs (M) f32.
extern "C" int quant_matmul_f32(const float* x, const int8_t* w,
                                const float* ws, int n_scales, int bits,
                                float* out, int8_t* x8, float* xs, int M,
                                int N, int K, int device, void* stream,
                                int* launched) {
  *launched = 0;
  const bool grouped = n_scales > 1;
  if (M < 1 || N < 1 || K < 32 || K % 16 != 0 || (bits != 8 && bits != 4) ||
      (bits == 8 && grouped) ||
      (bits == 4 && (K % (2 * BK) != 0 ||
                     (grouped && (n_scales % 2 != 0 ||
                                  (K / 2) % (n_scales / 2) != 0 ||
                                  ((K / 2) / (n_scales / 2)) % BK != 0)))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quant_rows_kernel<<<M, kThreads, 0, s>>>(x, K, x8, xs);
  STEP(cudaGetLastError());
  if (bits == 8)
    STEP(launch_product<kW8>(x8, xs, w, ws, 1, out, M, N, K, s));
  else if (grouped)
    STEP(launch_product<kW4G>(x8, xs, w, ws, n_scales, out, M, N, K, s));
  else
    STEP(launch_product<kW4>(x8, xs, w, ws, 1, out, M, N, K, s));
  return 0;
}
